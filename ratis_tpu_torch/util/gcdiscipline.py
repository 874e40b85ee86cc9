"""Heap discipline for multi-raft hosts (opt-in, ``raft.tpu.gc.*``).

A host carrying thousands of divisions holds millions of long-lived Python
objects.  CPython's automatic gen-2 collection walks ALL of them: measured
on this machine, a single gen-2 pass over a 10k-group heap took 52s — far
past the pause-monitor step-down threshold, so one background GC pass can
depose every leader on the server (the reference documents the identical
JVM failure mode and answers it with JvmPauseMonitor,
ratis-common/.../util/JvmPauseMonitor.java:38; this module removes the
pause instead of just detecting it).

The discipline, applied by ``RaftServer.start()`` when
``raft.tpu.gc.discipline`` is set:

- **Thresholds**: slow the gen1->gen2 promotion cascade
  (``gc.set_threshold(700, 1000, 1000)``) so automatic full collections
  become rare while the division fleet is being built.
- **Seal**: once the group set has been idle for ``raft.tpu.gc.freeze-idle``
  (i.e. bring-up is over), run ONE deliberate full collection and
  ``gc.freeze()`` the surviving heap into the permanent generation.  Frozen
  objects are never traversed again, so later gen-2 passes only walk the
  (small) post-bring-up allocation frontier.  The seal re-runs after any
  later group add/remove burst, keeping new divisions frozen too.

Everything is process-global (CPython has one collector), so multiple
in-process servers share one janitor; the module keeps refcounts and
restores the original thresholds when the last disciplined server closes.
"""

from __future__ import annotations

import gc
import logging
import time

LOG = logging.getLogger(__name__)

_DISCIPLINE_THRESHOLDS = (700, 1000, 1000)

_active = 0                 # servers with discipline enabled
_saved_thresholds = None    # thresholds to restore when _active drops to 0
_mutation_clock = 0.0       # monotonic time of the last group-set mutation
_sealed_at = -1.0           # _mutation_clock value covered by the last seal
_last_seal_s = 0.0          # monotonic time of the last seal (any cause)
seal_count = 0              # total seals this process (observable for tests)


def enable() -> None:
    """Apply the thresholds (idempotent; refcounted across servers)."""
    global _active, _saved_thresholds, _last_seal_s
    if _active == 0:
        _saved_thresholds = gc.get_threshold()
        gc.set_threshold(*_DISCIPLINE_THRESHOLDS)
        # the refreeze cadence counts from server start, not process
        # start — otherwise the first interval is already elapsed and the
        # re-seal fires mid-bring-up, the exact window it must avoid
        _last_seal_s = time.monotonic()
    _active += 1


def disable() -> None:
    global _active
    if _active == 0:
        return
    _active -= 1
    if _active == 0:
        if _saved_thresholds is not None:
            gc.set_threshold(*_saved_thresholds)
        # Thaw everything the seals froze: a closed server's division fleet
        # is cycle-rich garbage now, and a permanently-frozen heap would
        # leak it for the rest of the process.
        gc.unfreeze()


def note_mutation() -> None:
    """A group was added/removed: the heap grew, a (re-)seal is due once
    the burst settles."""
    global _mutation_clock
    _mutation_clock = time.monotonic()


def seal_due(idle_s: float) -> bool:
    if _mutation_clock <= _sealed_at:
        return False  # nothing new since the last seal
    return time.monotonic() - _mutation_clock >= idle_s


def refreeze_due(interval_s: float) -> bool:
    """Process-global steady-state cadence gate: several in-process
    servers' janitors share one collector, so one seal serves them all."""
    return time.monotonic() - _last_seal_s >= interval_s


def seal() -> float:
    """One deliberate full collection + freeze; returns its duration so
    callers can log/assert the pause they chose to take now instead of
    letting the collector take it mid-consensus later."""
    global _sealed_at, _last_seal_s, seal_count
    _sealed_at = _mutation_clock
    _last_seal_s = time.monotonic()
    seal_count += 1
    t0 = time.monotonic()
    gc.collect()
    gc.freeze()
    took = time.monotonic() - t0
    LOG.info("heap sealed: %d objects frozen in %.2fs",
             gc.get_freeze_count(), took)
    return took
