"""Continuous telemetry: a per-server background time-series sampler.

PR 4 gave every server a point-in-time introspection plane; this module
adds *history*.  Reference analog: the per-server rate/percentile
registries of ratis-metrics (``RaftServerMetricsImpl`` keeps dropwizard
meters exactly so operators can see trends, not samples); the TPU-native
equivalent is one background task per server
(``raft.tpu.telemetry.*``) that takes counter deltas of the registries
the server already maintains at a fixed cadence into a bounded ring of
samples, derives rates (commits/s, acks/s, rewinds/s) and log2-bucket
latency quantiles, and feeds a **space-saving top-k hot-group sketch**
(commits + pending per group) — the zipf hot-group imbalance ROADMAP
item 4's admission control must react to is invisible without per-group
accounting over time.

Design constraints (all asserted by tests/test_telemetry.py):

- **off = zero cost**: the sampler only exists when
  ``raft.tpu.telemetry.enabled`` is set; nothing on any request path.
- **bounded memory**: the sample ring holds ``window / interval``
  entries, the sketch exactly ``k`` counters (Metwally et al.'s
  space-saving: an untracked key evicts the minimum counter and
  inherits its count as error bound — the classical top-k guarantee in
  O(k) space), the latency histogram 64 log2 buckets.
- **torn-snapshot free**: one pass reads live division/engine state the
  same way the stall watchdog does (synchronous reads, ``list()`` over
  the division map, per-division failures swallowed) so group
  register/unregister churn mid-pass never corrupts a sample.

Served at ``GET /timeseries`` (JSON; ``?since=<seq>`` returns only newer
samples so pollers — ``shell top``, the flight recorder — read
incrementally) and ``GET /hotgroups``.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import math
import time
from typing import Optional

import numpy as np

LOG = logging.getLogger(__name__)


def legacy_division_walk(server, last_commit: dict,
                         sketch=None) -> tuple[int, int]:
    """The PR 8 per-division sampling walk, kept verbatim as the
    measured baseline the lag ledger replaced (bench and the pass-cost
    test run it back-to-back against ``TelemetrySampler.sample``).
    Returns (pending_total, leading)."""
    pending_total = 0
    seen = set()
    for div in list(server.divisions.values()):
        try:
            if not div.is_leader() or div.leader_ctx is None:
                continue
            gid = div.group_id
            seen.add(gid)
            commit = int(div.state.log.get_last_committed_index())
            pending = len(div.leader_ctx.pending)
        except Exception:
            continue  # unregistering mid-pass: skip, never tear
        pending_total += pending
        delta = commit - last_commit.get(gid, commit)
        last_commit[gid] = commit
        if (delta > 0 or pending > 0) and sketch is not None:
            sketch.offer(gid, max(0, delta), aux=pending)
    if len(last_commit) > len(seen):
        for gid in list(last_commit):
            if gid not in seen:
                last_commit.pop(gid, None)
    return pending_total, len(seen)


def log2_bucket(value_s: float) -> int:
    """Bucket index for a latency value: bucket i spans
    [2^(i-40), 2^(i-39)) seconds, i.e. bucket 0 ≈ 0.9ns and bucket 63
    ≈ 8e6s — the full range any host-side latency can take."""
    if value_s <= 0:
        return 0
    return max(0, min(63, int(math.log2(value_s) + 40)))


def bucket_upper_s(i: int) -> float:
    """Upper bound of bucket ``i`` in seconds."""
    return 2.0 ** (i - 39)


class Log2Buckets:
    """64-bucket log2 latency histogram with quantile readout.

    Unlike the registry ``Timekeeper`` reservoir (uniform over the whole
    stream), this accumulates the sampler's *windowed* latency
    observations, so quantiles answer "over the telemetry window" — and
    the bucket array is what makes merging across processes a plain
    element-wise sum."""

    __slots__ = ("counts", "total")

    def __init__(self) -> None:
        self.counts = [0] * 64
        self.total = 0

    def update(self, value_s: float, n: int = 1) -> None:
        if n <= 0:
            return
        self.counts[log2_bucket(value_s)] += n
        self.total += n

    def quantile_s(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (log2
        resolution: within 2x of the true value, which is what a trend
        view needs)."""
        if self.total <= 0:
            return 0.0
        rank = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return bucket_upper_s(i)
        return bucket_upper_s(63)

    def snapshot(self) -> dict:
        return {"count": self.total,
                "p50_ms": round(self.quantile_s(0.50) * 1e3, 3),
                "p90_ms": round(self.quantile_s(0.90) * 1e3, 3),
                "p99_ms": round(self.quantile_s(0.99) * 1e3, 3),
                # sparse encoding: {bucket index: count}, mergeable by sum
                "buckets": {str(i): c for i, c in enumerate(self.counts)
                            if c}}


class SpaceSavingSketch:
    """Metwally-style space-saving heavy hitters over group commit load.

    Exactly ``k`` tracked keys.  ``offer(key, inc)`` either bumps a
    tracked counter or evicts the current minimum, the newcomer
    inheriting its count as the per-key overestimate bound (``err``).
    Guarantees: every key with true count > total/k is tracked, and
    ``count - err <= true <= count``."""

    def __init__(self, k: int) -> None:
        self.k = max(1, int(k))
        # key -> [count, err, aux]; aux carries the last-seen pending
        # depth for the /hotgroups payload (not part of the sketch math)
        self._entries: dict = {}
        self.total = 0

    def offer(self, key, inc: int = 1, aux=None) -> None:
        self.total += max(0, inc)
        e = self._entries.get(key)
        if e is not None:
            e[0] += max(0, inc)
            if aux is not None:
                e[2] = aux
            return
        if len(self._entries) < self.k:
            # room: admit even a zero-delta key (a group with PENDING
            # load but no commits yet is exactly a queue worth watching)
            self._entries[key] = [max(0, inc), 0, aux]
            return
        if inc <= 0:
            return  # never evict a tracked hitter for a zero-delta key
        # evict the minimum counter; the newcomer inherits its count
        victim = min(self._entries, key=lambda x: self._entries[x][0])
        floor = self._entries.pop(victim)[0]
        self._entries[key] = [floor + inc, floor, aux]

    def top(self, n: Optional[int] = None) -> list[dict]:
        items = sorted(self._entries.items(), key=lambda kv: -kv[1][0])
        if n is not None:
            items = items[:n]
        return [{"key": k, "count": c, "err": err, "aux": aux}
                for k, (c, err, aux) in items]

    def __len__(self) -> int:
        return len(self._entries)


class TelemetrySampler:
    """One per server (``RaftServer`` creates it behind
    ``raft.tpu.telemetry.enabled``): samples counter deltas into the
    ring, maintains the latency buckets and the hot-group sketch."""

    def __init__(self, server, interval_s: Optional[float] = None,
                 window_s: Optional[float] = None,
                 top_k: Optional[int] = None):
        from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
        keys = RaftServerConfigKeys.Telemetry
        p = server.properties
        self.server = server
        self.interval_s = (interval_s if interval_s is not None
                           else keys.interval(p).seconds)
        window = (window_s if window_s is not None
                  else keys.window(p).seconds)
        self.window_s = window
        self.capacity = max(2, int(round(window / max(1e-3,
                                                      self.interval_s))))
        self.samples: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.sketch = SpaceSavingSketch(
            top_k if top_k is not None else keys.hot_groups(p))
        self.latency = Log2Buckets()
        self._seq = 0
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._t_start = time.monotonic()
        self._last_mono: Optional[float] = None
        self._last_counts: dict = {}
        self._last_timer: tuple = (0, 0.0)   # dispatchLatency (count, sum)
        # Per-slot commit baselines for the hot-group deltas, generation-
        # guarded: a slot's baseline is valid only while alloc_gen matches
        # AND the slot led at the previous pass — first sight as leader
        # anchors at the current commit (delta 0), exactly the old dict
        # walk's anchor/prune semantics, but O(1) numpy instead of O(G).
        self._prev_commit = np.full(server.engine.state.capacity, -1,
                                    np.int32)
        self._prev_gen = np.full(server.engine.state.capacity, -1,
                                 np.int32)
        # own registry so the sampler's cost/coverage is itself scraped
        from ratis_tpu_torch.metrics.registry import (MetricRegistries,
                                                MetricRegistryInfo)
        self._info = MetricRegistryInfo(
            prefix=str(server.peer_id), application="ratis",
            component="server", name="telemetry")
        reg = MetricRegistries.global_registries().create(self._info)
        self.registry = reg
        self._samples_taken = reg.counter("telemetrySamples")
        self._sample_cost = reg.timer("telemetrySampleCost")
        reg.gauge("telemetrySeriesLen", lambda: len(self.samples))
        reg.gauge("telemetryHotGroupsTracked", lambda: len(self.sketch))

    @property
    def tracked_groups(self) -> int:
        """Slots with a live commit baseline (led at the last pass)."""
        return int((self._prev_gen >= 0).sum())

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._running = True
        self._task = asyncio.create_task(
            self._run(), name=f"telemetry-{self.server.peer_id}")

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
        MetricRegistries.global_registries().remove(self._info)

    async def _run(self) -> None:
        while self._running:
            await asyncio.sleep(self.interval_s)
            try:
                self.sample()
            except asyncio.CancelledError:
                raise
            except Exception:
                # telemetry must never take the server down with it
                LOG.exception("%s telemetry sample failed",
                              self.server.peer_id)

    # ------------------------------------------------------------- sampling

    def sample(self) -> dict:
        """One sampling pass (synchronous reads only; public so tests and
        harnesses can force a pass).  Returns the appended sample."""
        with self._sample_cost.time():
            s = self._sample_locked()
        self._samples_taken.inc()
        return s

    def _counter_reads(self) -> dict:
        srv = self.server
        em = srv.engine.metrics
        rm = srv.replication.metrics
        return {
            "commits": em.get("commit_advances", 0),
            "acks": em.get("acks", 0),
            "ticks": em.get("ticks", 0),
            "dispatches": em.get("batched_dispatches", 0),
            "rewinds": (rm.get("rewinds", 0)
                        + rm.get("windowed_rewinds", 0)),
            "events": (srv.watchdog.event_count()
                       if srv.watchdog is not None else 0),
            "fsyncs": self._fsync_reads(),
            "shed": (srv.serving.admission.shed_total
                     if getattr(srv, "serving", None) is not None else 0),
            # upkeep plane (raft.tpu.upkeep.enabled; 0s when off): sweeps
            # that found nothing due — the idle-cost signal the vectorized
            # plane exists to maximize — and total vectorized sweeps
            "upkeep_idle_skips": sum(pl.idle_skips
                                     for pl in getattr(srv, "upkeep", [])),
            "upkeep_sweeps": sum(pl.sweeps
                                 for pl in getattr(srv, "upkeep", [])),
        }

    def _fsync_reads(self) -> int:
        """Cumulative fsync count across this server's log workers (per
        device in memory mode, per shard for the shared durable store)."""
        from ratis_tpu_torch.server.log.segmented import LogWorker
        prefix = f"{self.server.peer_id}:"
        total = 0
        for name, worker in list(LogWorker._instances.items()):
            if name.startswith(prefix):
                total += worker.sync_count
        return total

    def _sample_locked(self) -> dict:
        now_mono = time.monotonic()
        counts = self._counter_reads()
        dt = (now_mono - self._last_mono
              if self._last_mono is not None else self.interval_s)
        dt = max(1e-6, dt)
        rates = {f"{k}_per_s": round(
            max(0, counts[k] - self._last_counts.get(k, 0)) / dt, 3)
            for k in ("commits", "acks", "rewinds", "dispatches",
                      "fsyncs", "shed")}
        # dispatch latency over THIS interval: timer (count, sum) delta
        # feeds the windowed log2 buckets the quantiles read from
        timer = self.server.engine._m.dispatch_timer
        t_count, t_sum = timer.count, timer.mean_s * timer.count
        dc = t_count - self._last_timer[0]
        if dc > 0:
            self.latency.update((t_sum - self._last_timer[1]) / dc, dc)
        self._last_timer = (t_count, t_sum)
        # Per-group commit deltas -> hot-group sketch; pending depth is
        # queue state the admission-control round reads.  The ledger pass
        # replaces the per-division Python walk from PR 8 (str()/attribute
        # chasing over 1024 divisions measured ~14ms/pass): one fused
        # device pass + one fetch, then O(1) numpy here.  LEADER rows only
        # — the leader is where a group's load lands (and where pending
        # queues); a follower walk would triple-count every commit across
        # replicas — and gid OBJECTS as keys (payloads stringify).
        engine = self.server.engine
        led = engine.ledger.sample()
        if len(self._prev_commit) != led.capacity:
            pc = np.full(led.capacity, -1, np.int32)
            pg = np.full(led.capacity, -1, np.int32)
            n = min(led.capacity, len(self._prev_commit))
            pc[:n] = self._prev_commit[:n]
            pg[:n] = self._prev_gen[:n]
            self._prev_commit, self._prev_gen = pc, pg
        anchored = (self._prev_gen == led.gen) & led.leader_mask
        delta = np.where(anchored, led.commit - self._prev_commit, 0)
        pending = np.where(led.leader_mask, led.pending, 0)
        self._prev_commit = led.commit
        self._prev_gen = np.where(led.leader_mask, led.gen,
                                  -1).astype(np.int32)
        # python touches ONLY the slots with something to offer
        for slot in np.nonzero(led.leader_mask
                               & ((delta > 0) | (pending > 0)))[0]:
            listener = engine._listeners.get(int(slot))
            if listener is None:
                continue  # detached mid-pass
            self.sketch.offer(listener.group_id,
                              max(0, int(delta[slot])),
                              aux=int(pending[slot]))
        pending_total = int(pending.sum())
        try:
            occupancy = round(
                len(engine.state.active) / max(1, engine.state.capacity), 4)
        except Exception:
            occupancy = 0.0
        sample = {
            "seq": self._seq,
            "t": round(time.time(), 3),
            "up_s": round(now_mono - self._t_start, 3),
            "rates": rates,
            "totals": counts,
            "occupancy": occupancy,
            "pending": pending_total,
            "divisions": len(self.server.divisions),
            "leading": led.leading,
            "lag": int(max(0, int(led.worst_lag.max()))
                       if led.worst_lag.size else 0),
            "latency": {"p50_ms": round(
                self.latency.quantile_s(0.50) * 1e3, 3),
                "p99_ms": round(self.latency.quantile_s(0.99) * 1e3, 3)},
        }
        self._seq += 1
        self._last_mono = now_mono
        self._last_counts = counts
        self.samples.append(sample)
        return sample

    # ------------------------------------------------------------- payloads

    def maybe_sample(self) -> None:
        """Freshness fill for scrape handlers: take one synchronous pass
        when the newest sample is at least a full interval old (a
        rung-end scraper must see the load it just drove, not a sample
        from before it), without ever beating the background cadence."""
        now = time.monotonic()
        if self._last_mono is None or now - self._last_mono \
                >= self.interval_s:
            try:
                self.sample()
            except Exception:
                LOG.exception("%s telemetry on-demand sample failed",
                              self.server.peer_id)

    def series(self, since: Optional[int] = None) -> list[dict]:
        """Samples with ``seq > since``, oldest first (None = all held)."""
        if since is None:
            return list(self.samples)
        return [s for s in self.samples if s["seq"] > since]

    def timeseries_info(self, query: Optional[dict] = None) -> dict:
        """``GET /timeseries[?since=<seq>]`` payload."""
        self.maybe_sample()
        since = None
        if query:
            try:
                since = int(query.get("since", [None])[0])
            except (TypeError, ValueError):
                since = None
        samples = self.series(since)
        return {
            "peer": str(self.server.peer_id),
            "pid": __import__("os").getpid(),
            "interval_s": self.interval_s,
            "window_s": self.window_s,
            "seq": self._seq - 1,           # newest sample's seq (-1 none)
            "count": len(samples),
            "latency": self.latency.snapshot(),
            "samples": samples,
        }

    def hotgroups_info(self, query: Optional[dict] = None) -> dict:
        """``GET /hotgroups`` payload: the sketch's top-k with the
        space-saving error bound and each group's share of tracked
        commit load."""
        self.maybe_sample()
        n = None
        if query:
            try:
                n = int(query.get("n", [None])[0])
            except (TypeError, ValueError):
                n = None
        total = max(1, self.sketch.total)
        srv = self.server
        groups = []
        for e in self.sketch.top(n):
            gid = e["key"]
            div = srv.divisions.get(gid)
            groups.append({
                "group": str(gid),
                "commits": e["count"],
                "err": e["err"],
                "pending": e["aux"] or 0,
                "share": round(e["count"] / total, 4),
                # guaranteed lower bound (count - err)/total: under
                # uniform load this reads ~0 while `share` reads the
                # sketch's ~1/k overestimate floor — share_min is the
                # honest skew signal
                "share_min": round(
                    max(0, e["count"] - e["err"]) / total, 4),
                # placement facts: does THIS server lead the group, and
                # on which loop shard does it live here
                "led": div is not None and div.is_leader(),
                "shard": srv.shard_of_group(gid),
            })
        return {
            "peer": str(self.server.peer_id),
            "pid": __import__("os").getpid(),
            "k": self.sketch.k,
            "tracked": len(self.sketch),
            "total_commits": self.sketch.total,
            "groups": groups,
        }
