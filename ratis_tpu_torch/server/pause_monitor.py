"""Event-loop pause monitor.

Capability parity with the reference JvmPauseMonitor
(ratis-common/src/main/java/org/apache/ratis/util/JvmPauseMonitor.java:38,145,
wired per-server at RaftServerProxy.java:243): a sentinel sleeps for a short
interval and measures how late it wakes.  In the JVM the deviation exposes GC
stop-the-world pauses; here it exposes anything that stalls the asyncio loop
— a synchronous XLA compile, GIL-holding native code, CPU starvation.

A stalled loop cannot send heartbeats, so its leaderships are already dying
at the followers; detecting the pause locally lets the server abdicate
immediately (via the same leadership-stale path the engine uses) instead of
serving stale reads or holding client requests it can no longer commit —
the reference handler's leader.stepDown on pause > election timeout.

With tracing on, every wake is a ``loop.lag`` span (``trace/``): t0 the
time the sentinel was due, its length the lateness, its tag the process
CPU microseconds since the previous wake.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ratis_tpu_torch.trace.tracer import STAGE_LOOP_LAG, TRACER

LOG = logging.getLogger(__name__)


class PauseMonitor:
    def __init__(self, server, interval_s: Optional[float] = None,
                 warn_s: Optional[float] = None,
                 stepdown_s: Optional[float] = None):
        from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
        self.server = server
        p = server.properties
        keys = RaftServerConfigKeys.PauseMonitor
        self.interval_s = (interval_s if interval_s is not None
                           else keys.interval(p).seconds)
        self.warn_s = warn_s if warn_s is not None \
            else keys.warn_threshold(p).seconds
        # Default step-down threshold: the engine's leadership-staleness
        # window (2x max election timeout, floored at 1s so ordinary loop
        # queueing under load never abdicates) — a pause that long means
        # followers may already be electing a successor.
        self.stepdown_s = (stepdown_s if stepdown_s is not None else max(
            1.0, RaftServerConfigKeys.Rpc.timeout_max(p).seconds * 2))
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self.pause_count = 0
        self.stepdown_count = 0
        self.max_pause_s = 0.0
        # detections in the server registry, not just the log (reference
        # JvmPauseMonitor publishes the same pair through its metrics):
        # numPauses counter + longestPauseMs gauge, scraped at
        # ratis_server_numPauses_total / ratis_server_longestPauseMs.
        from ratis_tpu_torch.metrics.registry import (MetricRegistries,
                                                MetricRegistryInfo)
        info = MetricRegistryInfo(prefix=str(server.peer_id),
                                  application="ratis", component="server",
                                  name="pause_monitor")
        self.registry = MetricRegistries.global_registries().create(info)
        self.num_pauses = self.registry.counter("numPauses")
        self.num_stepdowns = self.registry.counter("numStepDowns")
        self.registry.gauge("longestPauseMs",
                            lambda: round(self.max_pause_s * 1e3, 3))

    def start(self) -> None:
        self._running = True
        self._task = asyncio.create_task(
            self._run(), name=f"pause-monitor-{self.server.peer_id}")

    async def close(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        from ratis_tpu_torch.metrics.registry import MetricRegistries
        MetricRegistries.global_registries().remove(self.registry.info)

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        cpu_ns = 0
        while self._running:
            t0 = loop.time()
            await asyncio.sleep(self.interval_s)
            pause = loop.time() - t0 - self.interval_s
            if TRACER.enabled:
                cpu_ns = self._record_lag(t0, pause, cpu_ns)
            if pause <= self.warn_s:
                continue
            self.pause_count += 1
            self.num_pauses.inc()
            self.max_pause_s = max(self.max_pause_s, pause)
            LOG.warning("%s: event loop paused ~%.0fms (threshold %.0fms)",
                        self.server.peer_id, pause * 1e3, self.warn_s * 1e3)
            if pause > self.stepdown_s:
                await self._step_down_leaders(pause)

    def _record_lag(self, t0: float, pause: float, cpu0_ns: int) -> int:
        """One ``loop.lag`` span for this wake (the loop's clock is the
        monotonic clock the tracer's ns share); returns the process CPU
        ns now, the next wake's base (0: no previous wake)."""
        cpu_ns = time.process_time_ns()
        due = int((t0 + self.interval_s) * 1e9)
        TRACER.record(0, STAGE_LOOP_LAG, due, due + int(max(pause, 0) * 1e9),
                      tag=(cpu_ns - cpu0_ns) // 1000 if cpu0_ns else 0)
        return cpu_ns

    async def _step_down_leaders(self, pause: float) -> None:
        for div in list(self.server.divisions.values()):
            if div.is_leader():
                self.stepdown_count += 1
                self.num_stepdowns.inc()
                await div.change_to_follower(
                    div.state.current_term, None,
                    reason=f"event loop paused {pause * 1e3:.0f}ms, beyond "
                           f"the election timeout")
