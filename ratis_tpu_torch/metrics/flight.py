"""Cluster flight recorder: the last window of telemetry, dumped on
failure.

A stall, a chaos failure, or a bench regression used to leave only the
final snapshot — the history that explains it was gone by the time
anyone looked.  The flight recorder pairs with the telemetry sampler
(:mod:`ratis_tpu_torch.metrics.timeseries`): its artifact is the last N
seconds of samples + the stall watchdog's journal (with monotonic
``seq`` ids) + recent trace spans (when the host-path tracer is on) +
the hot-group sketch, serialized as one replayable JSON document.

Dump triggers (all wired by :class:`~ratis_tpu_torch.server.server.RaftServer`
and the chaos runner):

- **watchdog degradation**: any organic detection (commit-stall,
  election-churn, follower-lag, stuck-lane) dumps once per episode
  (debounced — a stall that journals five kinds of fallout must not
  write five artifacts);
- **chaos scenario failure**: the scenario runner attaches every live
  server's flight snapshot to the existing (seed, scenario, journal)
  replay artifact;
- **SIGTERM**: a terminating server writes its final window so a kill
  during an incident preserves the incident;
- **explicit request**: ``GET /flightrecorder`` serves the same payload
  over the introspection endpoint (``?dump=1`` also writes the file).

Artifacts only write when ``raft.tpu.telemetry.flight-dir`` is set; the
HTTP route serves regardless (telemetry on is the only requirement).
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import signal
import time
from typing import Optional

LOG = logging.getLogger(__name__)

ARTIFACT_VERSION = 1
# recent trace spans attached per dump: newest per stage, bounded so a
# 4096-deep ring cannot balloon the artifact
SPANS_PER_STAGE = 64


def _recent_spans(limit_per_stage: int = SPANS_PER_STAGE) -> list[dict]:
    """Newest spans per stage from the process tracer (empty when
    tracing is off) as JSON-safe rows."""
    from ratis_tpu_torch.trace import get_tracer
    from ratis_tpu_torch.trace.tracer import STAGE_NAMES
    tracer = get_tracer()
    if not tracer.enabled:
        return []
    by_stage: dict = {}
    for tid, stage, t0, dur, tag, _origin in tracer.snapshot():
        by_stage.setdefault(stage, []).append((t0, tid, dur, tag))
    out = []
    for stage, rows in sorted(by_stage.items()):
        for t0, tid, dur, tag in sorted(rows)[-limit_per_stage:]:
            out.append({"stage": STAGE_NAMES[stage], "trace_id": tid,
                        "t0_ns": t0, "dur_ns": dur, "tag": tag})
    return out


class FlightRecorder:
    """One per telemetry-enabled server."""

    def __init__(self, server, sampler, dump_dir: str = "",
                 min_dump_interval_s: float = 10.0):
        self.server = server
        self.sampler = sampler
        self.dump_dir = dump_dir
        self.min_dump_interval_s = min_dump_interval_s
        self._last_dump_mono: Optional[float] = None
        self.dumps = sampler.registry.counter("flightDumps")

    # ------------------------------------------------------------- payload

    def snapshot(self, reason: str) -> dict:
        """The full flight artifact as a JSON-safe dict."""
        watchdog = self.server.watchdog
        return {
            "version": ARTIFACT_VERSION,
            "reason": reason,
            "t": round(time.time(), 3),
            "peer": str(self.server.peer_id),
            "pid": os.getpid(),
            "interval_s": self.sampler.interval_s,
            "window_s": self.sampler.window_s,
            "samples": list(self.sampler.samples),
            "events": (watchdog.events() if watchdog is not None else []),
            "hot_groups": self.sampler.hotgroups_info(),
            "lag_ledger": self._lag_block(),
            "spans": _recent_spans(),
        }

    def _lag_block(self) -> Optional[dict]:
        """The lag & health ledger at dump time (same payload as GET
        /lag); None only if the engine is mid-teardown — a flight dump
        must never fail over its own observability."""
        try:
            return self.server.lag_info()
        except Exception:
            LOG.exception("%s flight: lag ledger snapshot failed",
                          self.server.peer_id)
            return None

    def flightrecorder_info(self, query: Optional[dict] = None) -> dict:
        """``GET /flightrecorder[?dump=1]``: the live payload; with
        ``dump=1`` (and a configured flight-dir) also write the file and
        report its path."""
        snap = self.snapshot("request")
        if query and query.get("dump", ["0"])[0] not in ("0", "", "false"):
            path = self.dump("request", force=True)
            snap["dumped_to"] = str(path) if path else None
        return snap

    # --------------------------------------------------------------- dumps

    def dump(self, reason: str,
             path: "str | None" = None,
             force: bool = False) -> Optional[pathlib.Path]:
        """Write one artifact; returns its path (None when no flight-dir
        is configured and no explicit ``path`` given, or when debounced).
        ``force`` skips the debounce (SIGTERM, explicit requests)."""
        if path is None:
            if not self.dump_dir:
                return None
            now = time.monotonic()
            if (not force and self._last_dump_mono is not None
                    and now - self._last_dump_mono
                    < self.min_dump_interval_s):
                return None
            self._last_dump_mono = now
            d = pathlib.Path(self.dump_dir)
            d.mkdir(parents=True, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)
            out = d / (f"flight-{self.server.peer_id}-{safe}-"
                       f"{int(time.time() * 1e3)}.json")
        else:
            out = pathlib.Path(path)
            out.parent.mkdir(parents=True, exist_ok=True)
        try:
            out.write_text(json.dumps(self.snapshot(reason), indent=1,
                                      sort_keys=True))
        except OSError as e:
            LOG.warning("%s flight recorder: dump failed: %s",
                        self.server.peer_id, e)
            return None
        self.dumps.inc()
        LOG.warning("%s flight recorder: dumped %s artifact to %s",
                    self.server.peer_id, reason, out)
        return out

    def on_watchdog_event(self, record: dict) -> None:
        """Watchdog emit hook: organic degradations dump (debounced);
        chaos-injected fault journaling does not — the scenario runner
        attaches flight snapshots to its own artifact instead."""
        from ratis_tpu_torch.server.watchdog import (KIND_FAULT_RECOVERED,
                                               KIND_INJECTED_FAULT)
        if record.get("kind") in (KIND_INJECTED_FAULT,
                                  KIND_FAULT_RECOVERED):
            return
        self.dump(f"watchdog-{record.get('kind', 'event')}")


# --------------------------------------------------------------- SIGTERM

_SIGTERM_RECORDERS: list = []
_SIGTERM_ARMED = False
_SIGTERM_PREV = None


def _on_sigterm(signum, frame) -> None:
    for rec in list(_SIGTERM_RECORDERS):
        try:
            rec.dump("sigterm", force=True)
        except Exception:
            LOG.exception("flight recorder: sigterm dump failed")
    prev = _SIGTERM_PREV
    if callable(prev):
        prev(signum, frame)
    else:
        # restore default disposition and re-deliver so the process
        # still terminates the way the sender asked
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def install_sigterm_dump(recorder: FlightRecorder) -> bool:
    """Register ``recorder`` for a last-gasp dump on SIGTERM.  Safe to
    call per server (one process-wide handler fans out to every
    registered recorder); returns False when handlers cannot be
    installed (non-main thread)."""
    global _SIGTERM_ARMED, _SIGTERM_PREV
    if recorder in _SIGTERM_RECORDERS:
        return True
    if not _SIGTERM_ARMED:
        try:
            _SIGTERM_PREV = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:          # not the main thread
            return False
        _SIGTERM_ARMED = True
    _SIGTERM_RECORDERS.append(recorder)
    return True


def uninstall_sigterm_dump(recorder: FlightRecorder) -> None:
    try:
        _SIGTERM_RECORDERS.remove(recorder)
    except ValueError:
        pass
