"""Conf-key / documentation drift check, on the port.

Every configuration key the port defines (``*_KEY = "raft..."`` constants
in ``ratis_tpu_torch/conf/keys.py``) must appear in
``docs/configurations.md`` or in the README's port section, and every key
either names must exist in the code.  ``docs/`` describes the JAX package
and stays as it is, so the port's own keys (``raft.torch.engine.device``)
are documented in the README's port section (the lines under its
``PORT_SECTION`` heading, up to the next heading of that level), in a
table row with a default and a meaning like any other.  Run directly::

    python -m ratis_tpu_torch.tools.check_conf_docs

or through the tier-1 test ``tests/test_torch_tools.py``.

Doc key grammar (inside backticks, in tables or prose):

- a full dotted key: ``raft.server.rpc.timeout.min``
- suffix alternation on ONE line: ``raft.x.y.min/.max`` or a later
  bare ``.suffix`` token — the suffix replaces the previous key's last
  segment (multi-segment suffixes replace one segment, so
  ``raft.a.b.enabled/.warn.threshold`` yields ``raft.a.b.warn.threshold``);
- a family wildcard: ``raft.grpc.tls.*`` — matches every code key under
  that prefix (and must match at least one, or the wildcard itself is
  drift).
"""

from __future__ import annotations

import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEYS_PY = os.path.join(_REPO, "ratis_tpu_torch", "conf", "keys.py")
DOCS_MD = os.path.join(_REPO, "docs", "configurations.md")
README_MD = os.path.join(_REPO, "README.md")
# the heading of the README's section on the port
PORT_SECTION = "## PyTorch/CUDA port"

_CODE_KEY_RE = re.compile(
    r'^\s*[A-Z0-9_]+_KEY\s*=\s*(?:\\\s*)?$|'
    r'_KEY\s*=\s*"(raft[a-z0-9_.\-]+)"')
# a _KEY assignment whose string literal wrapped to the next line
_CONT_STR_RE = re.compile(r'^\s*"(raft[a-z0-9_.\-]+)"')
_DOC_TOKEN_RE = re.compile(r"`([a-z0-9_.\-*/]+)`|"
                           r"(?<![`\w.])(raft\.[a-z0-9_.\-]+[a-z0-9_\-])")


def code_keys(path: str = KEYS_PY) -> set[str]:
    """Every dotted key string assigned to a ``*_KEY`` constant."""
    keys: set[str] = set()
    pending = False  # previous line was `X_KEY = \` (wrapped literal)
    for line in open(path):
        if pending:
            m = _CONT_STR_RE.match(line)
            if m:
                keys.add(m.group(1))
            pending = False
            continue
        m = re.search(r'_KEY\s*=\s*"(raft[a-z0-9_.\-]+)"', line)
        if m:
            keys.add(m.group(1))
        elif re.search(r'_KEY\s*=\s*\\\s*$', line):
            pending = True
    return keys


def doc_lines(docs_md: str = DOCS_MD, readme_md: str = README_MD) -> list:
    """The documentation's lines: all of ``docs_md``, then the README's
    port section (its ``PORT_SECTION`` heading and what follows, up to the
    next heading of that level)."""
    lines = open(docs_md).read().splitlines()
    level = PORT_SECTION.split()[0] + " "
    inside = False
    for line in open(readme_md).read().splitlines():
        if line.startswith(PORT_SECTION):
            inside = True
        elif inside and line.startswith(level):
            break
        if inside:
            lines.append(line)
    return lines


def doc_keys(lines=None) -> tuple[set[str], set[str]]:
    """(exact keys, wildcard prefixes) named by the documentation's
    ``lines`` (default ``doc_lines()``)."""
    exact: set[str] = set()
    wildcards: set[str] = set()
    for line in doc_lines() if lines is None else lines:
        if line.lstrip().startswith("#"):
            # section headings name namespaces (`raft.server.*`) for
            # orientation; only table/prose wildcards COVER keys
            continue
        last: str | None = None
        for m in _DOC_TOKEN_RE.finditer(line):
            token = m.group(1) or m.group(2)
            for part in token.split("/"):
                if not part:
                    continue
                if part.startswith("raft."):
                    if part.endswith(".*"):
                        wildcards.add(part[:-2])
                    else:
                        exact.add(part)
                        last = part
                elif part.startswith(".") and last is not None:
                    # suffix alternation: replace the previous key's last
                    # segment with this (possibly multi-segment) suffix
                    base = last.rsplit(".", 1)[0]
                    key = base + part
                    exact.add(key)
                    last = key
    return exact, wildcards


def doc_rows(lines=None) -> dict[str, tuple[str, str]]:
    """key -> (default cell, meaning cell) for every key named in the
    first cell of a markdown table row of ``lines`` (default
    ``doc_lines()``).  Suffix alternation expands the
    same way as :func:`doc_keys`, and all expanded keys share the row's
    default/meaning cells (the doc writes them as ``a / b`` pairs)."""
    rows: dict[str, tuple[str, str]] = {}
    for line in doc_lines() if lines is None else lines:
        stripped = line.strip()
        if not stripped.startswith("|"):
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if len(cells) < 3 or set(cells[0]) <= {"-", " ", ":"}:
            continue  # not a row, or the |---|---| separator
        last: str | None = None
        for m in _DOC_TOKEN_RE.finditer(cells[0]):
            token = m.group(1) or m.group(2)
            for part in token.split("/"):
                if not part:
                    continue
                if part.startswith("raft."):
                    key = part[:-2] + ".*" if part.endswith(".*") else part
                    rows[key] = (cells[1], cells[2])
                    last = part if part.startswith("raft.") \
                        and not part.endswith(".*") else last
                elif part.startswith(".") and last is not None:
                    key = last.rsplit(".", 1)[0] + part
                    rows[key] = (cells[1], cells[2])
                    last = key
    return rows


def check(keys_py: str = KEYS_PY, docs_md: str = DOCS_MD,
          readme_md: str = README_MD) -> list[str]:
    """Drift findings; empty = code and docs agree."""
    code = code_keys(keys_py)
    lines = doc_lines(docs_md, readme_md)
    exact, wildcards = doc_keys(lines)
    rows = doc_rows(lines)
    problems: list[str] = []
    for key in sorted(code):
        if key in exact:
            # exact documentation must be a TABLE row carrying a default
            # and a meaning — a bare mention in prose reads as documented
            # while telling an operator nothing
            row = rows.get(key)
            if row is None:
                covered = any(key.startswith(w + ".") for w in wildcards)
                if not covered:
                    problems.append(
                        f"key has no default-and-meaning table row in "
                        f"docs/configurations.md or the README's port "
                        f"section: {key}")
            elif not row[0] or not row[1]:
                problems.append(
                    f"table row for {key} is missing its "
                    f"{'default' if not row[0] else 'meaning'} cell")
            continue
        if any(key.startswith(w + ".") for w in wildcards):
            continue
        problems.append(f"key not documented in docs/configurations.md "
                        f"or the README's port section: {key}")
    for key in sorted(exact):
        if key not in code:
            problems.append(f"documented key missing from conf/keys.py: "
                            f"{key}")
    for w in sorted(wildcards):
        if not any(key.startswith(w + ".") for key in code):
            problems.append(f"documented wildcard matches no key: {w}.*")
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(p, file=sys.stderr)
    if problems:
        print(f"{len(problems)} conf/doc drift problem(s)", file=sys.stderr)
        return 1
    print(f"ok: {len(code_keys())} keys in sync with docs/configurations.md "
          f"and the README's port section")
    return 0


if __name__ == "__main__":
    sys.exit(main())
