"""Static gate against the O(G) Python tax creeping back into the port's
hot paths.

The per-group host bookkeeping (heartbeat due-ness, hibernation clocks,
cache expiry, client-window GC, watch frontiers) lives in the vectorized
upkeep plane; the remaining ``for ... divisions`` walks in the tick/sweep
modules are a short, deliberate allowlist (the legacy-mode sweep, the
low-rate resync backstop, shutdown, introspection endpoints, and the
measured-baseline walk).  This gate AST-scans those modules of
``ratis_tpu_torch/`` for any loop or comprehension whose iterable
mentions ``divisions`` and fails on a site that is not allowlisted — AND
on an allowlist entry that no longer matches anything, so the list can
only shrink with the code.  Run directly::

    python -m ratis_tpu_torch.tools.check_hot_loops

or through the tier-1 test ``tests/test_torch_tools.py``.

Scope: only the modules on the tick/sweep call paths are scanned (chaos
harnesses, shell, and bench tooling legitimately walk the fleet).  A new
per-group walk belongs either behind a legacy-mode gate (and on the
allowlist, with a review) or — preferably — as a channel on the
UpkeepPlane.
"""

from __future__ import annotations

import ast
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Modules on the tick/sweep call paths (relative to the repo root).
SCANNED = (
    "ratis_tpu_torch/server/server.py",
    "ratis_tpu_torch/server/division.py",
    "ratis_tpu_torch/server/leader.py",
    "ratis_tpu_torch/server/upkeep.py",
    "ratis_tpu_torch/server/watchdog.py",
    "ratis_tpu_torch/server/pause_monitor.py",
    "ratis_tpu_torch/metrics/timeseries.py",
    # the placement control loop must stay O(servers + k): it scores the
    # ledger/sketch rollups, never the division fleet
    "ratis_tpu_torch/placement/policy.py",
    "ratis_tpu_torch/placement/actuate.py",
    "ratis_tpu_torch/placement/controller.py",
    # the mesh plane sits INSIDE the tick: its slicing helpers must stay
    # layout code — any divisions walk here would run per tick on the
    # fast path
    "ratis_tpu_torch/parallel/__init__.py",
    "ratis_tpu_torch/parallel/mesh.py",
)

# (file, qualified function) -> why this per-group walk is allowed to stay.
ALLOWLIST: dict[tuple[str, str], str] = {
    ("ratis_tpu_torch/server/server.py", "HeartbeatScheduler._run"):
        "legacy-mode sweep (raft.tpu.upkeep.enabled unset)",
    ("ratis_tpu_torch/server/server.py", "HeartbeatScheduler._plane_resync"):
        "low-rate O(G) re-arm backstop (raft.tpu.upkeep.resync-sweeps)",
    ("ratis_tpu_torch/server/server.py", "RaftServer.close"):
        "shutdown, runs once",
    ("ratis_tpu_torch/server/server.py", "RaftServer.get_division"):
        "error-path message formatting",
    ("ratis_tpu_torch/server/server.py", "RaftServer.divisions_info"):
        "GET /divisions introspection endpoint",
    ("ratis_tpu_torch/server/watchdog.py", "StallWatchdog.sample"):
        "watchdog cadence is seconds, not the sweep tick",
    ("ratis_tpu_torch/server/pause_monitor.py",
     "PauseMonitor._step_down_leaders"):
        "pause recovery, runs only after a detected stall",
    ("ratis_tpu_torch/metrics/timeseries.py", "legacy_division_walk"):
        "measured baseline the lag ledger replaced (bench/tests only)",
}


class _Finder(ast.NodeVisitor):
    """Collect (qualname, lineno) of every loop/comprehension whose
    iterable's source mentions ``divisions``."""

    def __init__(self) -> None:
        self.stack: list[str] = []
        self.sites: list[tuple[str, int]] = []

    def _qual(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _check_iter(self, it: ast.AST, lineno: int) -> None:
        if "divisions" in ast.unparse(it):
            self.sites.append((self._qual(), lineno))

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter, node.lineno)
        self.generic_visit(node)

    def visit_AsyncFor(self, node: ast.AsyncFor) -> None:
        self._check_iter(node.iter, node.lineno)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._check_iter(node.iter, getattr(node.iter, "lineno", 0))
        self.generic_visit(node)


def scan_source(rel: str, source: str) -> list[tuple[str, str, int]]:
    """(file, qualname, lineno) of every divisions-iteration in one file."""
    finder = _Finder()
    finder.visit(ast.parse(source))
    return [(rel, qual, lineno) for qual, lineno in finder.sites]


def check(repo: str = _REPO,
          scanned=SCANNED, allowlist=ALLOWLIST) -> list[str]:
    """Gate findings; empty = every per-group walk is accounted for."""
    sites: list[tuple[str, str, int]] = []
    for rel in scanned:
        path = os.path.join(repo, rel)
        sites.extend(scan_source(rel, open(path).read()))
    problems = []
    matched: set[tuple[str, str]] = set()
    for rel, qual, lineno in sites:
        key = (rel, qual)
        if key in allowlist:
            matched.add(key)
        else:
            problems.append(
                f"new per-group walk in a tick/sweep module: "
                f"{rel}:{lineno} ({qual}) — vectorize it through the "
                f"UpkeepPlane or gate it behind legacy mode + allowlist")
    for key in sorted(set(allowlist) - matched):
        problems.append(
            f"stale allowlist entry (no matching loop): {key[0]} "
            f"({key[1]}) — remove it from check_hot_loops.ALLOWLIST")
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(p, file=sys.stderr)
    if problems:
        print(f"{len(problems)} hot-loop problem(s)", file=sys.stderr)
        return 1
    print(f"ok: {len(SCANNED)} tick/sweep modules scanned, "
          f"{len(ALLOWLIST)} allowlisted per-group walks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
