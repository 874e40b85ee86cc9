"""Metric-name / documentation drift check on the port (mirrors
``check_conf_docs``).

Every metric name the port registers on a ``RatisMetricRegistry``
(``.counter("...")``, ``.timer("...")``, ``.histogram("...")``,
``.gauge("...", ...)``, and the ``labeled("name", ...)`` form inside any
of those) anywhere in ``ratis_tpu_torch/`` must be named in
``docs/metrics.md``, the catalog written by hand, which a new registry
family could silently miss.  Run directly::

    python -m ratis_tpu_torch.tools.check_metrics_docs

or through the tier-1 test ``tests/test_torch_tools.py``.

Doc grammar: a metric is documented when its name appears in backticks
anywhere in docs/metrics.md; ``/``-separated alternatives inside one
backtick pair (``` `a`/`b` ``` or ``` `a/b` ```) each count, and a part
that starts lowercase with no capital boundary of its own is also tried
as a SUFFIX alternation on the previous part's trailing camel-case word
(``numRetryCacheHits/Misses`` names both counters).  Only string
literals register; dynamically composed names (f-strings, variables) are
the caller's responsibility and are skipped here.
"""

from __future__ import annotations

import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(_REPO, "ratis_tpu_torch")
DOCS_MD = os.path.join(_REPO, "docs", "metrics.md")

# .counter("name"), .timer("name"), .histogram("name"),
# .gauge("name", ...), and labeled("name", ...) anywhere (labeled names
# always end up as registry names through one of the four).
_REG_RE = re.compile(
    r"\.(?:counter|timer|histogram|gauge)\(\s*\"([A-Za-z_][A-Za-z0-9_]*)\"")
_LABELED_RE = re.compile(r"\blabeled\(\s*\"([A-Za-z_][A-Za-z0-9_]*)\"")
_DOC_TOKEN_RE = re.compile(r"`([^`]+)`")
_WORD_SPLIT_RE = re.compile(r"[A-Z][a-z0-9]*$")


def code_metric_names(root: str = PKG) -> dict[str, list[str]]:
    """metric name -> files registering it (string-literal sites only)."""
    out: dict[str, list[str]] = {}
    for dirpath, _dirs, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for fn in files:
            if not fn.endswith(".py") or fn == "check_metrics_docs.py":
                continue  # this module's docstring names the grammar
            path = os.path.join(dirpath, fn)
            text = open(path).read()
            rel = os.path.relpath(path, _REPO)
            for m in (*_REG_RE.finditer(text), *_LABELED_RE.finditer(text)):
                out.setdefault(m.group(1), [])
                if rel not in out[m.group(1)]:
                    out[m.group(1)].append(rel)
    return out


def doc_metric_names(path: str = DOCS_MD) -> set[str]:
    """Every metric name the doc can be said to document."""
    names: set[str] = set()
    text = open(path).read()
    for m in _DOC_TOKEN_RE.finditer(text):
        token = m.group(1)
        # `dispatches{reason=...}` documents the labeled family name
        token = token.split("{", 1)[0]
        parts = [p for p in token.split("/") if p]
        prev = None
        for part in parts:
            part = part.strip().strip(".,;:()")
            if not part or " " in part:
                prev = None
                continue
            names.add(part)
            if prev is not None:
                # suffix alternation: `numRetryCacheHits/Misses` — replace
                # the previous name's trailing camel word with this part
                tail = _WORD_SPLIT_RE.search(prev)
                if tail is not None and part[0].isupper():
                    names.add(prev[:tail.start()] + part)
            prev = part
    return names


def check(root: str = PKG, docs_md: str = DOCS_MD) -> list[str]:
    """Drift findings; empty = every registered metric is documented."""
    code = code_metric_names(root)
    doc = doc_metric_names(docs_md)
    problems = []
    for name in sorted(code):
        if name not in doc:
            problems.append(
                f"metric not documented in docs/metrics.md: {name} "
                f"(registered in {', '.join(code[name])})")
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(p, file=sys.stderr)
    if problems:
        print(f"{len(problems)} metric/doc drift problem(s)",
              file=sys.stderr)
        return 1
    print(f"ok: {len(code_metric_names())} registered metric names "
          f"covered by docs/metrics.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
