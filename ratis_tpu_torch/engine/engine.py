"""QuorumEngine: one tick loop advances every group's consensus math.

This is the replacement for the reference's thread-per-division daemons
(FollowerState timeout thread FollowerState.java:64, LeaderStateImpl
EventProcessor LeaderStateImpl.java:108-190): a single asyncio task per
server drains packed ack events and, in one pass over the group batch,

- advances leader commit indexes (ops.quorum.update_commit),
- fires follower election timeouts (ops.quorum.election_timeout),
- detects stale leadership (ops.quorum.check_leadership),

then invokes per-division callbacks for the few groups whose state changed.
Below ``scalar_fallback_threshold`` active groups the same math runs through
:mod:`ratis_tpu_torch.ops.reference` (no device dispatch); above it, the
batched kernels take over (the 10k-group path): the hand-written CUDA
kernels of :mod:`ratis_tpu_torch.ops` when the engine's ``device`` is a
CUDA device, their plain-torch versions when it is the CPU.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import threading
import time
import zlib
from typing import Callable, Optional, Protocol

import numpy as np
import torch

from ratis_tpu_torch.engine.state import (GroupBatchState, NO_DEADLINE,
                                    ROLE_CANDIDATE, ROLE_FOLLOWER,
                                    ROLE_LEADER, ROLE_LISTENER, ROLE_UNUSED)
from ratis_tpu_torch.metrics.hops import hop
from ratis_tpu_torch.ops import quorum as q
from ratis_tpu_torch.ops import reference as ref
from ratis_tpu_torch.parallel.mesh import (pad_to_mesh, same_card,
                                           shard_device_state)
from ratis_tpu_torch.trace.tracer import STAGE_ENGINE, TRACER, profiling

_PACK_SENTINEL = q.PACK_SENTINEL

LOG = logging.getLogger(__name__)


def _plane_positions(sl: np.ndarray, width: int) -> np.ndarray:
    """Each item's position in planes of ``width`` columns laid end to end:
    its plane ``sl`` times ``width``, plus the number of items of the same
    plane before it (items keep their order within a plane)."""
    order = np.argsort(sl, kind="stable")
    srt = sl[order]
    pos = np.empty(len(sl), np.int64)
    # a sorted item's rank in its plane: its index less its plane's first
    pos[order] = srt * width + np.arange(len(sl)) - np.searchsorted(srt, srt)
    return pos


# Why the sweep gate let a batched dispatch through — the dispatch count at
# scale is THE batched-mode cost driver, so its composition is a first-class
# labeled counter set instead of a guess.
DISPATCH_REASONS = ("upload", "commit", "dirty", "votes", "sweep", "backlog")


class EngineMetrics:
    """The engine's observability surface: a real ``RatisMetricRegistry``
    ("engine" component) instead of the plain dict of earlier rounds.

    Carries what the dict could not express: a per-sweep dispatch-latency
    timer (host -> XLA -> host wall per batched dispatch), batch
    lane-occupancy gauges (live rows vs padded capacity per packed tensor
    — the "are we actually batching" TPU signal), an ack-batch size
    histogram, and the per-reason dispatch counters as labeled counters.
    The old dict keys stay readable through :class:`_EngineMetricsView`
    (``engine.metrics``) for bench/test compatibility."""

    def __init__(self, engine: "QuorumEngine", prefix: str) -> None:
        from ratis_tpu_torch.metrics.registry import (MetricRegistries,
                                                MetricRegistryInfo, labeled)
        info = MetricRegistryInfo(prefix=prefix, application="ratis",
                                  component="engine", name="quorum_engine")
        self.registry = MetricRegistries.global_registries().create(info)
        r = self.registry
        # the historical dict keys, now real counters (names preserved so
        # the scrape and the dict view agree)
        self.ticks = r.counter("ticks")
        self.acks = r.counter("acks")
        self.commit_advances = r.counter("commit_advances")
        self.batched_dispatches = r.counter("batched_dispatches")
        self.refresh_rows = r.counter("refresh_rows")
        self.fast_ticks = r.counter("fast_ticks")
        self.refresh_ticks = r.counter("refresh_ticks")
        self.idle_skips = r.counter("idle_skips")
        self.reasons = {reason: r.counter(labeled("dispatches",
                                                  reason=reason))
                        for reason in DISPATCH_REASONS}
        # host->XLA->host wall clock of one batched dispatch (upload +
        # kernel + output download), and the packed ack batch it carried
        self.dispatch_timer = r.timer("dispatchLatency")
        self.ack_batch = r.histogram("ackBatchSize")
        # Lane occupancy: live rows vs padded lane capacity for the two
        # packed tensors the kernel consumes — the [G, P] group batch and
        # the [7, E] event pack of the LAST dispatch.  Occupancy near 0
        # means the server pays full-width dispatches for a few live lanes.
        r.gauge("laneGroupsLive", lambda: len(engine.state.active))
        r.gauge("laneGroupsCapacity", lambda: engine.state.capacity)
        r.gauge("laneOccupancyGroups",
                lambda: len(engine.state.active) / engine.state.capacity)
        r.gauge("laneEventsLastDispatch", lambda: engine._last_event_rows)
        r.gauge("laneEventCapacityLastDispatch",
                lambda: engine._last_event_cap)
        r.gauge("laneOccupancyEvents",
                lambda: (engine._last_event_rows / engine._last_event_cap
                         if engine._last_event_cap else 0.0))

    def unregister(self) -> None:
        from ratis_tpu_torch.metrics.registry import MetricRegistries
        MetricRegistries.global_registries().remove(self.registry.info)


class _EngineMetricsView:
    """Dict-shaped read view over :class:`EngineMetrics` — the
    ``engine.metrics`` the bench and tests already consume.  Supports
    ``m["ticks"]``, ``m.get``, iteration, and ``m[k] = v`` (tests reset
    counters through it); the per-reason dispatch counters appear under
    their historical ``dispatch_<reason>`` keys only once non-zero, like
    the dict they replace."""

    _PLAIN = ("ticks", "acks", "commit_advances", "batched_dispatches",
              "refresh_rows", "fast_ticks", "refresh_ticks", "idle_skips")

    def __init__(self, em: EngineMetrics) -> None:
        self._em = em

    def _counter(self, key: str):
        if key in self._PLAIN:
            return getattr(self._em, key)
        if key.startswith("dispatch_"):
            return self._em.reasons.get(key[len("dispatch_"):])
        return None

    def __getitem__(self, key: str) -> int:
        c = self._counter(key)
        if c is None:
            raise KeyError(key)
        return c.count

    def __setitem__(self, key: str, value: int) -> None:
        c = self._counter(key)
        if c is None:
            raise KeyError(key)
        c._value = int(value)

    def get(self, key: str, default=None):
        c = self._counter(key)
        return default if c is None else c.count

    def __contains__(self, key: str) -> bool:
        return self._counter(key) is not None

    def keys(self) -> list[str]:
        return [*self._PLAIN,
                *(f"dispatch_{r}" for r, c in self._em.reasons.items()
                  if c.count)]

    def __iter__(self):
        return iter(self.keys())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __len__(self) -> int:
        return len(self.keys())

    def __repr__(self) -> str:
        return repr(dict(self.items()))


class EngineListener(Protocol):
    """What a division implements to be driven by the engine."""

    async def on_election_timeout(self) -> None: ...

    async def on_commit_advance(self, new_commit: int) -> None: ...

    async def on_leadership_stale(self) -> None: ...


class Clock:
    """Millisecond clock relative to a movable epoch (int32-friendly).

    The epoch advances when the engine rebases (see
    QuorumEngine._maybe_rebase_epoch), keeping now_ms well inside int32 for
    arbitrarily long uptimes."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now_ms(self) -> int:
        return int((time.monotonic() - self._t0) * 1000)

    def advance_epoch(self, delta_ms: int) -> None:
        self._t0 += delta_ms / 1000.0


class QuorumEngine:
    # Which engine (if any) owns the process's torch.profiler session: one
    # session per process, and co-hosted servers each build an engine, so
    # only the first profiled engine starts it (raft.tpu.engine.profile-dir)
    _profiling_owner = None

    def __init__(self, max_groups: int = 1024, max_peers: int = 8,
                 tick_interval_s: float = 0.002,
                 scalar_fallback_threshold: int = 16,
                 leadership_timeout_ms: int = 300,
                 use_device: bool = False,
                 mesh=None, profile_dir: Optional[str] = None,
                 name: str = "", device: "str | torch.device" = "cuda"):
        # The torch device of the resident state and the batched kernels
        # (raft.torch.engine.device).  No CPU default: "cuda" without CUDA
        # raises here rather than running the plain versions in its place.
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "QuorumEngine(device='cuda'): CUDA is not available; "
                    "pass device='cpu' to run the plain-torch kernels")
        elif self.device.type != "cpu":
            raise ValueError(f"QuorumEngine device {device!r}: the "
                             f"kernels run on 'cuda' or 'cpu'")
        else:
            # The plain versions run on the event loop's thread over
            # [G, P] tensors too small to gain from torch's intra-op pool.
            # Beside other busy processes each reduction waited on that
            # pool for tens of ms and the loop paused for seconds (elections
            # then failed); one intra-op thread keeps each op on this one.
            torch.set_num_threads(1)
        # Optional parallel.mesh.GroupMesh: the resident state is S
        # contiguous slices of G/S rows on the engine's device, each group
        # pinned to a slot inside its crc32 slice; the fast tick ships
        # slice-routed [7, S, E] event planes (kernel K5) so a slice's
        # events only ever touch its own rows.
        self.mesh = mesh
        n_slices = 1
        if mesh is not None:
            if not same_card(mesh.device, self.device):
                raise ValueError(f"mesh on {mesh.device}, engine on "
                                 f"{self.device}")
            n_slices = int(mesh.n_slices)
            # auto-pad: mesh size no longer needs to divide max-groups —
            # padded rows stay ROLE_UNUSED and cost nothing
            max_groups = pad_to_mesh(max_groups, n_slices)
        # raft.tpu.engine.profile-dir: the owner's torch.profiler session
        # (``_start_profiling``), its Chrome trace written there at close
        self.profile_dir = profile_dir
        self._profiler = None
        self.trace_file = None
        self.state = GroupBatchState(max_groups, max_peers,
                                     n_slices=n_slices)
        self.clock = Clock()
        self.tick_interval_s = tick_interval_s
        self.scalar_fallback_threshold = scalar_fallback_threshold
        self.leadership_timeout_ms = leadership_timeout_ms
        self.use_device = use_device
        self._listeners: dict[int, EngineListener] = {}
        self._ack_ring: list[tuple[int, int, int, int]] = []  # (slot, peer, match, t)
        self._vote_ring: list[tuple[int, int, bool]] = []  # (slot, peer, granted)
        self._vote_rounds: dict[int, asyncio.Future] = {}
        # slot -> [flush | SENTINEL, deadline | SENTINEL]: high-rate scalar
        # mutations packed into the fast tick instead of dirty-row refreshes
        self._slot_updates: dict[int, list] = {}
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._running = False
        # Device-resident copy of the batch state (ops.quorum.DeviceState,
        # updated in place by the kernels);
        # None until the first batched tick, invalidated on rebase/regrow.
        self._dev = None
        # The prepared calls of the fast tick (K1, or K5 on a mesh engine)
        # and the refresh tick (K2), both bound to ``_dev``, and of the vote
        # pass (K3): pinned staging buffers and their device copies, built
        # at first use and again when capacity regrows.
        self._fast_plan: Optional[q.FastPlan] = None
        self._refresh_plan: Optional[q.RefreshPlan] = None
        self._tally_plan: Optional[q.TallyPlan] = None
        # Next time the scalar path sweeps leaders for staleness; the batched
        # kernel checks every tick for free, the scalar path throttles the
        # O(leaders) python sweep to timeout/4.
        self._next_staleness_ms = 0
        # Batched-path dispatch gate: when a tick has NO events to ship and
        # the next follower deadline / staleness sweep is not due yet, the
        # device dispatch is skipped entirely (the dominant idle cost at
        # high group counts is the fixed per-dispatch overhead, not the
        # kernel).  0 forces the first dispatch.
        self._next_sweep_ms = 0
        # A listener without the sync commit hook has an undelivered commit
        # riding the tick path; the sweep gate must not skip while set.
        self._tick_commit_pending = False
        # largest compiled event bucket (lowered by prewarm): dispatch
        # chunks never exceed it, so no fresh jit shape mid-run
        self._event_bucket_cap = self._MAX_EVENT_BUCKET
        # last-dispatch packed-event lane fill (read by the occupancy
        # gauges; see EngineMetrics)
        self._last_event_rows = 0
        self._last_event_cap = 0
        # monotonic time of the last completed tick (engine freshness for
        # the /health endpoint); None until the loop runs once
        self.last_tick_monotonic: Optional[float] = None
        # Real metric registry ("engine" component); engine.metrics keeps
        # the historical dict read surface over it.
        self._m = EngineMetrics(
            self, name or f"engine-{id(self):x}")
        self.metrics = _EngineMetricsView(self._m)
        # Lag & health ledger over the same host mirrors (one fused pass +
        # one fetch per telemetry tick; engine/ledger.py).
        from ratis_tpu_torch.engine.ledger import LagLedger
        self.ledger = LagLedger(self, name or f"engine-{id(self):x}")
        # Cross-shard intake safety (raft.tpu.server.loop-shards): divisions
        # pinned to worker event loops call the intake methods from their
        # own threads while the tick task reads/swaps the same rings and
        # mirror on the engine's home loop.  An RLock (re-entrant: an
        # inline-commit callback may re-enter intake synchronously)
        # serializes the mutation windows; the home loop lets off-loop
        # intake wake the tick via call_soon_threadsafe.  With one loop
        # (the default) every acquisition is uncontended.
        # Checked for the loop-sharded server (server/shards.py): worker
        # loops reach only the intake (on_ack*, on_flush*, on_deadline, the
        # vote-round calls, attach/detach).  The tick, with its prepared
        # calls (FastPlan, RefreshPlan, TallyPlan) and their pinned
        # buffers, runs in the engine's task on the home loop, and the
        # ledger samples (LedgerPlan) come from the watchdog, the
        # telemetry sampler and the HTTP routes, all tasks of the home
        # loop (tools/plan_recorder.py counts any prepared call made on
        # another thread; the multi-process harness reports it: 0).
        self._lock = threading.RLock()
        # off-loop wake already scheduled and not yet fired (guarded by
        # the intake lock): dedupes call_soon_threadsafe notify storms
        self._wake_pending = False
        self._home_loop: Optional[asyncio.AbstractEventLoop] = None
        # slot -> loop the listener's division runs on (for cross-shard
        # callback dispatch); absent/same-loop listeners take the direct
        # await path, identical to the unsharded runtime.
        self._listener_loops: dict[int, asyncio.AbstractEventLoop] = {}

    # -- registration --------------------------------------------------------

    def slice_of(self, key: bytes) -> int:
        """Owning mesh slice for a group id: the same crc32 pin as
        LoopShardPool.shard_of, taken modulo the slice count — so whenever
        the mesh size divides loop-shards, one slice maps to a whole
        shard-set and intake for a slice's groups arrives from a stable
        subset of loops."""
        return zlib.crc32(key) % self.state.n_slices

    def attach(self, listener: EngineListener,
               slice_idx: int = -1) -> int:
        """Register a listener; ``slice_idx`` pins the group's slot inside
        one mesh slice's row range (divisions pass slice_of(group id);
        -1 = lowest slice with room, the non-mesh default)."""
        with self._lock:
            slot = self.state.allocate(slice_idx)
            self._listeners[slot] = listener
        try:
            self._listener_loops[slot] = asyncio.get_running_loop()
        except RuntimeError:
            pass  # attached outside a loop (tests): direct-await path
        return slot

    def detach(self, slot: int) -> None:
        self.end_vote_round(slot)
        with self._lock:
            self._listeners.pop(slot, None)
            self._listener_loops.pop(slot, None)
            self.state.release(slot)
            # the released row's queued acks and vote replies go with it:
            # a division attached to the same row before the next tick
            # must not take them (the refresh writes the row from the
            # mirror, then the tick scatters the acks over it)
            self._ack_ring = [a for a in self._ack_ring if a[0] != slot]
            self._vote_ring = [v for v in self._vote_ring if v[0] != slot]

    # -- event intake (transport/appender threads call these) ---------------

    def on_ack(self, slot: int, peer_slot: int, match_index: int) -> None:
        """Record a follower ack: update the host mirror eagerly, try the
        O(P) commit advance INLINE, and queue the packed event for the
        device (which applies the same scatter-max at the next tick, so
        host and device stay in agreement).

        The inline commit is the latency-critical redesign: commits used to
        advance only inside the engine tick task, and under load that task
        is one of thousands competing for the event loop — profiling at
        1024 groups measured it scheduled ~50x/s, putting 100ms+ of pure
        queueing delay into EVERY commit (and the client pipelines that
        wait on them).  The per-ack math is a [P]-element majority-min
        (P <= 8); the device keeps the work that actually batches — the
        O(G) timeout/staleness/lease sweeps."""
        with self._lock:
            self._on_ack_locked(slot, peer_slot, match_index,
                                self.clock.now_ms())

    def on_ack_batch(self, rows) -> None:
        """Packed ack intake: ``rows`` is a sequence of
        ``(slot, peer_slot, match_index)`` rows (list of tuples or an
        ``[N, 3]`` int array).  Applies exactly the per-row operations of
        :meth:`on_ack` — mirror scatter-max, ring append, inline commit —
        in row order, under ONE intake-lock acquisition, so a follower
        reply frame carrying N co-hosted groups' acks costs one lock
        round-trip and (via the wake dedupe in :meth:`_wake_set`) at most
        one tick wake instead of N.  Commit advancement is bit-identical
        to feeding the same rows through scalar ``on_ack`` one by one
        (asserted in tests/test_loop_shards.py)."""
        if rows is None or len(rows) == 0:
            return
        if isinstance(rows, np.ndarray):
            rows = rows.tolist()
        with self._lock:
            now = self.clock.now_ms()
            for slot, peer_slot, match_index in rows:
                self._on_ack_locked(int(slot), int(peer_slot),
                                    int(match_index), now)

    def _on_ack_locked(self, slot: int, peer_slot: int, match_index: int,
                       now: int) -> None:
        s = self.state
        if s.match_index[slot, peer_slot] < match_index:
            s.match_index[slot, peer_slot] = match_index
        if s.last_ack_ms[slot, peer_slot] < now:
            s.last_ack_ms[slot, peer_slot] = now
        self._ack_ring.append((slot, peer_slot, match_index, now))
        self._try_commit_inline(slot, match_index)

    def _try_commit_inline(self, slot: int, hint: int) -> None:
        """Advance ``slot``'s commit from the host mirror if possible and
        deliver the (synchronous) listener callback immediately.  Listeners
        without the sync hook keep the tick-driven path: their mirror is
        left untouched so the device/tick dispatch still fires for them."""
        s = self.state
        if s.role[slot] != ROLE_LEADER:
            return
        if hint <= int(s.commit_index[slot]):
            return  # the triggering value cannot raise the majority-min
        listener = self._listeners.get(slot)
        cb = getattr(listener, "on_commit_advance_now", None)
        if cb is None:
            # tick path owns this listener's commits: force the next tick
            # through the dispatch (the sweep gate must not skip it)
            self._tick_commit_pending = True
            self._wake_set()
            return
        new_commit, did = ref.update_commit(
            s.match_index[slot].tolist(), int(s.self_slot[slot]),
            int(s.flush_index[slot]), s.conf_cur[slot].tolist(),
            s.conf_old[slot].tolist(), int(s.commit_index[slot]),
            int(s.first_leader_index[slot]), True)
        if did:
            s.commit_index[slot] = new_commit
            self._m.commit_advances.inc()
            cb(new_commit)

    def on_flush(self, slot: int, flush_index: int) -> None:
        """A log's flush frontier advanced: update the mirror and queue a
        packed slot update for the fast tick path (these fire on every
        append — routing them through mark_dirty would force the dirty-row
        refresh on every tick)."""
        with self._lock:
            self._on_flush_locked(slot, flush_index)

    def on_flush_batch(self, rows) -> None:
        """Packed flush intake (envelope sweep intake): ``rows`` is a
        sequence of ``(slot, flush_index)`` rows — one multi-group append
        frame's flush advances.  Applies exactly the per-row operations of
        :meth:`on_flush`, in row order, under ONE intake-lock acquisition,
        so a frame carrying N co-hosted groups' appends costs one lock
        round-trip (and, via the wake dedupe, at most one tick wake)
        instead of N."""
        if not rows:
            return
        with self._lock:
            for slot, flush_index in rows:
                self._on_flush_locked(int(slot), int(flush_index))

    def _on_flush_locked(self, slot: int, flush_index: int) -> None:
        s = self.state
        if flush_index < int(s.flush_index[slot]):
            # regression (follower truncate): rare — take the refresh
            # path, the device-side scatter-max would ignore a lower
            # value
            s.flush_index[slot] = flush_index
            s.mark_dirty(slot)
            self._wake_set()
            return
        s.flush_index[slot] = flush_index
        u = self._slot_updates.get(slot)
        if u is None:
            self._slot_updates[slot] = [flush_index, _PACK_SENTINEL]
        elif u[0] == _PACK_SENTINEL or flush_index > u[0]:
            u[0] = flush_index
        # A leader's own flush counts toward quorum: try the commit
        # inline (single-peer groups commit on flush alone).
        self._try_commit_inline(slot, flush_index)

    def on_deadline(self, slot: int, deadline_ms: int) -> None:
        """(Re-)arm a follower election deadline; same packed-update route.
        No wake: a postponed deadline needs no immediate tick."""
        with self._lock:
            s = self.state
            s.election_deadline_ms[slot] = deadline_ms
            if deadline_ms < self._next_sweep_ms:
                self._next_sweep_ms = deadline_ms  # earlier than planned
            u = self._slot_updates.get(slot)
            if u is None:
                self._slot_updates[slot] = [_PACK_SENTINEL, deadline_ms]
            else:
                u[1] = deadline_ms

    # -- cross-loop plumbing (loop sharding) ---------------------------------

    def _wake_set(self) -> None:
        """Wake the tick loop from any thread: direct on the home loop,
        call_soon_threadsafe from a shard loop (asyncio.Event.set is not
        thread-safe).  Off-loop wakes are DEDUPED under the intake lock:
        a burst of cross-shard acks/flushes schedules ONE home-loop
        callback, not one per caller — profiling showed notify storms
        queueing thousands of redundant call_soon_threadsafe callbacks
        behind the very tick they all wanted to wake."""
        home = self._home_loop
        if home is not None:
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not home:
                with self._lock:
                    if self._wake_pending:
                        return  # a scheduled wake already covers this burst
                    self._wake_pending = True
                try:
                    hop("engine_wake")
                    home.call_soon_threadsafe(self._wake_fire)
                except RuntimeError:
                    # home loop closing: nothing left to wake
                    with self._lock:
                        self._wake_pending = False
                return
        if not self._wake.is_set():
            hop("engine_wake")
        self._wake.set()

    def _wake_fire(self) -> None:
        """Home-loop half of the deduped off-loop wake: clear the pending
        latch FIRST (a wake requested after this point must schedule a
        fresh callback — the event below may be consumed immediately),
        then set the event."""
        with self._lock:
            self._wake_pending = False
        self._wake.set()

    @staticmethod
    def _resolve_future(fut: asyncio.Future, result: str) -> None:
        """set_result on the future's OWN loop (vote futures are created on
        the division's shard loop; the tick resolves them from the home
        loop)."""
        floop = fut.get_loop()
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if floop is running:
            if not fut.done():
                fut.set_result(result)
            return

        def _set() -> None:
            if not fut.done():
                fut.set_result(result)

        try:
            floop.call_soon_threadsafe(_set)
        except RuntimeError:
            pass  # owner loop closed: the round's division is gone

    @staticmethod
    def _cancel_future(fut: asyncio.Future) -> None:
        floop = fut.get_loop()
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if floop is running:
            if not fut.done():
                fut.cancel()
            return

        def _cancel() -> None:
            if not fut.done():
                fut.cancel()

        try:
            floop.call_soon_threadsafe(_cancel)
        except RuntimeError:
            pass

    # -- batched vote rounds (SURVEY §3.3 HOT LOOP #2) -----------------------

    @property
    def tally_batched(self) -> bool:
        """Whether candidate vote rounds run through the engine's batched
        tally (the per-division scalar loop stays below the threshold —
        same policy as the commit/timeout math)."""
        return (self.use_device
                or len(self.state.active) >= self.scalar_fallback_threshold)

    def begin_vote_round(self, slot: int, deadline_ms: int) -> asyncio.Future:
        """Open a vote round for ``slot``: reset the grant/reject masks
        (self-grant pre-set), arm the round deadline, and return a future
        the tick resolves with "PASSED" / "REJECTED" / "TIMEOUT".  The
        conf masks and priorities were already synced via set_conf."""
        with self._lock:
            s = self.state
            s.vote_grants[slot] = False
            s.vote_rejects[slot] = False
            s.vote_grants[slot, s.self_slot[slot]] = True
            s.vote_deadline_ms[slot] = deadline_ms
            old = self._vote_rounds.pop(slot, None)
            if old is not None:
                self._cancel_future(old)
            fut = asyncio.get_running_loop().create_future()
            self._vote_rounds[slot] = fut
        self._wake_set()
        return fut

    def on_vote_reply(self, slot: int, peer_slot: int, granted: bool) -> None:
        with self._lock:
            if slot not in self._vote_rounds:
                return
            self._vote_ring.append((slot, peer_slot, granted))
        self._wake_set()

    def end_vote_round(self, slot: int) -> None:
        """Abandon a round (candidate stopped / stepped down / special
        reply handled inline): cancel its future and disarm the deadline."""
        with self._lock:
            self.state.vote_deadline_ms[slot] = NO_DEADLINE
            fut = self._vote_rounds.pop(slot, None)
        if fut is not None:
            self._cancel_future(fut)

    def expire_vote_round(self, slot: int) -> None:
        """Every peer has replied or failed: pull the round deadline to now
        so the next tick resolves it through the timeout-path tally — the
        outstanding==0 early exit of the reference's waitForResults (a
        majority gated only on a SILENT higher-priority peer must not wait
        out the full randomized deadline once that peer's RPC has failed)."""
        with self._lock:
            if slot not in self._vote_rounds:
                return
            s = self.state
            now = np.int32(self.clock.now_ms())
            if s.vote_deadline_ms[slot] > now:
                s.vote_deadline_ms[slot] = now
        self._wake_set()

    def _vote_pass(self, now: int) -> list[tuple[asyncio.Future, str]]:
        """Apply queued vote replies and tally EVERY open round in one
        prepared call (the open rounds' rows up, one launch, the tally
        down); returns (future, result) pairs to resolve."""
        s = self.state
        events, self._vote_ring = self._vote_ring, []
        for slot, peer, granted in events:
            if slot not in self._vote_rounds:
                continue
            if s.vote_grants[slot, peer] or s.vote_rejects[slot, peer]:
                continue  # first reply wins (waitForResults putIfAbsent)
            if granted:
                s.vote_grants[slot, peer] = True
            else:
                s.vote_rejects[slot, peer] = True
        if not self._vote_rounds:
            return []
        rounds = list(self._vote_rounds.items())
        slots = np.fromiter(self._vote_rounds, np.int64, len(rounds))
        passed, passed_on_timeout, rejected, _ = self._tally_rounds(slots)
        # a round is decided on a reject, a strict pass or its deadline
        decided = (rejected | passed
                   | (now >= s.vote_deadline_ms[slots])).tolist()
        out: list[tuple[asyncio.Future, str]] = []
        for i, (slot, fut) in enumerate(rounds):
            if fut.done():
                self._vote_rounds.pop(slot)
                continue
            if not decided[i]:
                continue  # round still open
            if rejected[i]:
                result = "REJECTED"
            elif passed[i]:
                result = "PASSED"
            else:
                result = ("PASSED" if passed_on_timeout[i] else "TIMEOUT")
            self._vote_rounds.pop(slot)
            s.vote_deadline_ms[slot] = NO_DEADLINE
            out.append((fut, result))
        return out

    def _tally_rounds(self, slots: np.ndarray) -> np.ndarray:
        """The vote tally of the mirror rows ``slots`` on the engine's
        device (the tally is row-local): bool [4, R]
        (ops.quorum.VoteTally rows), R = len(slots).  The rows travel as
        bit words (kernel K3's row entry), padded to a bucket."""
        s = self.state
        r = len(slots)
        rcap = self._bucket(r)
        plan = self._tally_plan
        if plan is None or plan.max_rows < self._bucket(s.capacity):
            plan = self._tally_plan = q.TallyPlan(
                s.max_peers, self._bucket(s.capacity), self.device)
        v = plan.views(rcap)
        s.priority.take(slots, axis=0, out=v.priority[:r])
        s.self_priority.take(slots, out=v.self_priority[:r])
        for words, mask in zip(v.masks, (s.vote_grants, s.vote_rejects,
                                         s.conf_cur, s.conf_old)):
            q.pack_mask_bits(mask.take(slots, axis=0), words[:r])
        return plan.run(rcap)[:, :r]

    def regress_match(self, slot: int, peer_slot: int, match_index: int) -> None:
        """A follower provably lost acked entries (volatile-log restart):
        lower the mirror AND clamp any acks for this (group, peer) still
        queued in the ring — otherwise the next tick's scatter-max replays a
        pre-restart ack and silently restores the lost match."""
        with self._lock:
            self._ack_ring = [
                (g, p,
                 min(m, match_index) if (g, p) == (slot, peer_slot) else m, t)
                for g, p, m, t in self._ack_ring]
            self.state.match_index[slot, peer_slot] = match_index
            self.state.mark_dirty(slot)

    def notify(self) -> None:
        """Wake the tick loop early (e.g. flush index advanced)."""
        self._wake_set()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._running = True
        self._home_loop = asyncio.get_running_loop()
        if self.profile_dir and QuorumEngine._profiling_owner is None:
            self._start_profiling()
        self._task = asyncio.create_task(self._run(), name="quorum-engine")

    def _start_profiling(self) -> None:
        """Start the process's ``torch.profiler`` session, CPU activity and
        CUDA activity on a card, and own it.  If it cannot start (another
        session is active in the process: a second would silently take
        the first one's place), log it and own nothing."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            if torch.autograd.profiler._is_profiler_enabled:
                raise RuntimeError("a torch.profiler session is already "
                                   "active in this process")
            prof = profile(activities=activities)
            prof.start()
        except Exception:
            LOG.exception("could not start the torch profiler")
            return
        self._profiler = prof
        QuorumEngine._profiling_owner = self
        LOG.info("engine profiling -> %s", self.profile_dir)

    def _stop_profiling(self) -> None:
        """Stop the owned session, write its Chrome trace into
        ``profile_dir`` (``trace_file``: the pid and the time in its name,
        as each server process of a multi-process deployment owns a
        session, and a process may profile one cluster after another) and
        release ownership."""
        prof, self._profiler = self._profiler, None
        QuorumEngine._profiling_owner = None
        self.trace_file = os.path.join(
            self.profile_dir,
            f"engine-trace-{os.getpid()}-{time.time_ns()}.json")
        try:
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(self.trace_file)
        except Exception:
            LOG.exception("could not write the torch profiler trace")

    async def close(self) -> None:
        self._running = False
        if QuorumEngine._profiling_owner is self:
            self._stop_profiling()
        if self._task is not None:
            self._wake.set()
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # drop the engine registry from the global scrape surface; the
        # counters stay readable through engine.metrics (tests inspect a
        # closed cluster's engines)
        self._m.unregister()
        self.ledger.unregister()

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while self._running:
            if self._wake.is_set():
                # busy: events already queued — tick now, skip the timer
                # allocation wait_for would make (hot at high group counts).
                # NOTE: pacing dispatches at a tick_interval floor was tried
                # here and measured ~2.5x WORSE end-to-end at 1024 groups:
                # commit latency compounds through the sequential per-group
                # write pipelines, so ticking at the front of the loop
                # backlog beats amortizing dispatch overhead.
                await asyncio.sleep(0)
            else:
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           self.tick_interval_s)
                except asyncio.TimeoutError:
                    pass
            self._wake.clear()
            t0 = loop.time()
            await self.tick()
            self.last_tick_monotonic = loop.time()
            cost = loop.time() - t0
            if cost > self.tick_interval_s:
                # Self-pacing: a dispatch that cost more than the tick
                # interval (big [G, P] batch on a slow backend) must not
                # monopolize the event loop — sleeping roughly one tick-cost
                # bounds the engine's duty cycle at ~50% and lets more acks
                # accumulate per dispatch.  Capped: one pathological tick
                # (wedged backend, measured wall-clock inflated by other
                # coroutines) must not impose an unbounded second stall on
                # every group's quorum/election processing.
                await asyncio.sleep(min(cost, 8 * self.tick_interval_s))

    # -- the tick ------------------------------------------------------------

    # Rebase when now_ms passes this (half of int32 max, lots of margin).
    _REBASE_THRESHOLD_MS = 1 << 30
    _REBASE_KEEP_MS = 3_600_000  # keep the last hour of history meaningful

    def _maybe_rebase_epoch(self, now: int) -> int:
        """Shift the clock epoch forward and subtract the delta from every
        stored time so int32 never wraps (see ops.quorum time convention)."""
        if now < self._REBASE_THRESHOLD_MS:
            return now
        s = self.state
        delta = now - self._REBASE_KEEP_MS
        self.clock.advance_epoch(delta)
        s.last_ack_ms -= np.int32(delta)
        np.maximum(s.last_ack_ms, 0, out=s.last_ack_ms)
        mask = s.election_deadline_ms != NO_DEADLINE
        s.election_deadline_ms[mask] -= np.int32(delta)
        vmask = s.vote_deadline_ms != NO_DEADLINE
        s.vote_deadline_ms[vmask] -= np.int32(delta)
        self._ack_ring = [(g, p, m, max(0, t - delta))
                          for g, p, m, t in self._ack_ring]
        for u in self._slot_updates.values():
            if u[1] != _PACK_SENTINEL and u[1] != NO_DEADLINE:
                u[1] = max(0, u[1] - delta)
        self._next_staleness_ms = 0
        self._next_sweep_ms = 0  # pre-rebase timestamp would gate forever
        self._dev = None  # wholesale time shift: re-upload the device state
        return now - delta

    # Ack/flush backlog bound for the sweep-gated batched path: beyond this
    # many queued events, ship them even with no sweep due (keeps the ring
    # far below the chunking cap and the device's staleness inputs fresh).
    _EVENT_BACKLOG_MAX = 8192

    async def tick(self) -> None:
        # The math pass runs under the intake lock: shard-loop intake
        # (on_ack/on_flush/...) and the tick swap/read the same rings and
        # host mirror.  The lock is released BEFORE listener callbacks —
        # holding a threading lock across awaits would stall every shard's
        # intake for the duration of division code.
        if QuorumEngine._profiling_owner is self \
                or (TRACER.enabled and profiling()):
            # a named range a tick's math pass in the profiler's trace
            # (the listener callbacks below may park: outside it): the
            # owner of the session annotates its ticks, and with tracing
            # on every engine annotates under any owner's session
            with self._lock, torch.profiler.record_function("engine_tick"):
                changed, votes = self._tick_locked()
        else:
            with self._lock:
                changed, votes = self._tick_locked()
        for fut, result in votes:
            self._resolve_future(fut, result)

        # dispatch callbacks outside the math pass; a listener pinned to a
        # different shard loop gets its callback ON that loop
        running = asyncio.get_running_loop()
        for slot, kind, value in changed:
            listener = self._listeners.get(slot)
            if listener is None:
                continue
            if kind == "commit":
                self._m.commit_advances.inc()
                coro = listener.on_commit_advance(value)
            elif kind == "timeout":
                coro = listener.on_election_timeout()
            else:  # "stale"
                if getattr(listener, "hibernating", False):
                    continue  # requested silence; cheap skip, no coroutine
                coro = listener.on_leadership_stale()
            lloop = self._listener_loops.get(slot)
            if lloop is None or lloop is running:
                await coro
            else:
                try:
                    await asyncio.wrap_future(
                        asyncio.run_coroutine_threadsafe(coro, lloop))
                except RuntimeError:
                    coro.close()  # shard loop gone (server closing)

    def _tick_locked(self) -> tuple[list, list]:
        """One tick's math pass (caller holds the intake lock).  Returns
        (changed listener events, resolved vote futures)."""
        s = self.state
        now = self._maybe_rebase_epoch(self.clock.now_ms())
        self._m.ticks.inc()

        active = s.active
        if not active:
            self._ack_ring.clear()
            s.dirty.clear()
            self._slot_updates.clear()
            self._dev = None
            return [], []

        use_batched = (self.use_device
                       or len(active) >= self.scalar_fallback_threshold)
        if use_batched and self._dev is not None \
                and not self._tick_commit_pending \
                and not s.dirty and not self._vote_rounds \
                and not self._vote_ring and now < self._next_sweep_ms \
                and (len(self._ack_ring) + len(self._slot_updates)
                     < self._EVENT_BACKLOG_MAX):
            # Nothing the device could DECIDE right now: commits already
            # advanced inline at intake, and no deadline/staleness sweep is
            # due.  Let events accumulate — the next dispatch carries a
            # bigger packed batch (the shape the kernel wants) and the
            # engine's dispatch rate drops from per-tick to per-sweep.
            self._m.idle_skips.inc()
            return [], []
        if use_batched:
            # why did the gate let this dispatch through? (the labeled
            # dispatches{reason=...} counters; see EngineMetrics)
            reasons = self._m.reasons
            if self._dev is None:
                reasons["upload"].inc()
            elif self._tick_commit_pending:
                reasons["commit"].inc()
            elif s.dirty:
                reasons["dirty"].inc()
            elif self._vote_rounds or self._vote_ring:
                reasons["votes"].inc()
            elif now >= self._next_sweep_ms:
                reasons["sweep"].inc()
            else:
                reasons["backlog"].inc()

        acks = self._ack_ring
        self._ack_ring = []
        self._m.acks.inc(len(acks))

        # The host mirror was updated eagerly at ack intake (on_ack), where
        # the commit advance now happens inline; the events still travel to
        # the device below so the resident state applies the same
        # scatter-max and stays in agreement without ever downloading the
        # [G, P] arrays.
        touched: set[int] = set(s.dirty)
        touched.update(a[0] for a in acks)

        if use_batched:
            self._tick_commit_pending = False
            changed = self._tick_batched(acks, now)
            self._next_sweep_ms = self._compute_next_sweep(now)
        else:
            # flush advances queued as packed updates still need their
            # slots' commit math in the scalar pass (mirror already has the
            # values)
            touched.update(self._slot_updates)
            self._slot_updates.clear()
            # host-only mutations make any retained device copy stale; drop
            # it so a later crossing back over the threshold re-uploads
            s.dirty.clear()
            self._dev = None
            self._tick_commit_pending = False
            changed = self._tick_scalar(touched, now)

        votes = (self._vote_pass(now)
                 if (self._vote_rounds or self._vote_ring) else [])
        return changed, votes

    def _compute_next_sweep(self, now: int) -> int:
        """Earliest time the device must be consulted again with no new
        events: the soonest armed follower deadline, bounded by the
        staleness-sweep cadence (timeout/4, matching the scalar path) —
        but only when this server leads anything (a follower-only or idle
        server has no leaderships to check for staleness)."""
        s = self.state
        dl = np.where(s.role == ROLE_FOLLOWER, s.election_deadline_ms,
                      NO_DEADLINE)
        nxt = int(dl.min()) if dl.size else NO_DEADLINE
        if bool((s.role == ROLE_LEADER).any()):
            nxt = min(nxt, now + max(1, self.leadership_timeout_ms // 4))
        return nxt

    # -- scalar path ---------------------------------------------------------

    def _tick_scalar(self, touched: set[int], now: int
                     ) -> list[tuple[int, str, int]]:
        """Python fallback for small group counts: commit math only for
        slots with new acks / flush advances (``touched``); the O(leaders)
        staleness sweep runs at most every leadership_timeout/4."""
        s = self.state
        changed: list[tuple[int, str, int]] = []
        check_stale = now >= self._next_staleness_ms
        if check_stale:
            self._next_staleness_ms = now + max(
                1, self.leadership_timeout_ms // 4)
        unit = (TRACER.open_unit(STAGE_ENGINE) if touched and TRACER.enabled
                else None)

        for slot in list(s.active):
            role = s.role[slot]
            if role == ROLE_LEADER:
                if slot in touched:
                    new_commit, did = ref.update_commit(
                        s.match_index[slot].tolist(), int(s.self_slot[slot]),
                        int(s.flush_index[slot]), s.conf_cur[slot].tolist(),
                        s.conf_old[slot].tolist(), int(s.commit_index[slot]),
                        int(s.first_leader_index[slot]), True)
                    if did:
                        s.commit_index[slot] = new_commit
                        changed.append((slot, "commit", new_commit))
                if check_stale and ref.check_leadership(
                        s.last_ack_ms[slot].tolist(), int(s.self_slot[slot]),
                        s.conf_cur[slot].tolist(), s.conf_old[slot].tolist(),
                        now, self.leadership_timeout_ms, True):
                    changed.append((slot, "stale", 0))
            elif role == ROLE_FOLLOWER and now >= s.election_deadline_ms[slot]:
                s.election_deadline_ms[slot] = NO_DEADLINE  # re-armed by div
                changed.append((slot, "timeout", 0))
        if unit is not None:
            TRACER.close_unit(unit, len(touched))
        return changed

    # -- batched path --------------------------------------------------------

    def _fast_plan_for(self, dev) -> q.FastPlan:
        """The fast tick's prepared call bound to ``dev``: K1, or K5 over
        the slices on a mesh engine (events pre-routed per slice, [7, S,
        E]); built once per state shape, re-bound when the state was
        re-uploaded."""
        plan = self._fast_plan
        if plan is None or plan.capacity != dev.match_index.shape[0]:
            plan = self._fast_plan = q.FastPlan(
                dev, self._MAX_EVENT_BUCKET,
                None if self.mesh is None else self.state.n_slices)
        elif plan.state is not dev:
            plan.bind(dev)
        return plan

    def _fast_events(self, ecap: int) -> np.ndarray:
        """The fast plan's packed tick of ``ecap`` columns in each of its
        planes (int32 [7, S, E]: one plane, or one per slice on a mesh
        engine; pinned on a card), the device state uploaded first if
        there is none."""
        if self._dev is None:
            self._dev = self._upload_device_state()
        return self._fast_plan_for(self._dev).events(ecap)

    def _refresh_plan_for(self, dev) -> q.RefreshPlan:
        """The refresh tick's prepared call (K2) bound to ``dev``: built
        once per state shape, re-bound when the state was re-uploaded.  A
        mesh engine's refresh runs on the flat state with global rows."""
        plan = self._refresh_plan
        if plan is None or plan.capacity != dev.match_index.shape[0]:
            plan = self._refresh_plan = q.RefreshPlan(
                dev, self._bucket(self.state.capacity),
                self._MAX_EVENT_BUCKET)
        elif plan.state is not dev:
            plan.bind(dev)
        return plan

    def prewarm(self) -> None:
        """Build and load the kernels, and launch each of them once.

        On a CUDA engine the first use of the kernels compiles them with
        nvcc (seconds per source, all in parallel): done inside the event
        loop, that stall would fire election timeouts, so servers call this
        before they start electing.  Runs the real tick path (one refresh
        tick, one fast tick) against the idle state, then the vote tally
        and the ledger pass once; listeners never fire because outputs are
        filtered by the active set.  A CPU engine runs the plain versions
        once (nothing to build)."""
        if self.device.type == "cuda":
            from ratis_tpu_torch.ops import _build
            _build.build_all()
        s = self.state
        now = self.clock.now_ms()
        saved_dirty = set(s.dirty)
        # full upload + the fast tick (K1, or K5 on a mesh engine)
        self._tick_batched([(0, 0, -1, now)], now)
        s.dirty = {0}
        self._tick_batched([(0, 0, -1, now)], now)   # K2
        self._tally_rounds(np.zeros(1, np.int64))    # K3
        self.ledger.prewarm()                         # K4
        s.dirty = saved_dirty
        self._dev = None  # drop the prewarm device copy; re-upload on use

    def _upload_device_state(self):
        s = self.state
        dev = q.device_state_from_numpy(
            (s.match_index, s.last_ack_ms, s.self_mask, s.conf_cur,
             s.conf_old, s.role, s.flush_index, s.commit_index,
             s.first_leader_index, s.election_deadline_ms), self.device)
        if self.mesh is not None:
            dev = shard_device_state(self.mesh, dev)
        return dev

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 << (max(1, n) - 1).bit_length()

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad size for event/dirty batches: 64 * 4^k.  Coarser than plain
        pow2 so the jit compiles O(few) shape buckets instead of one per
        power of two — padding costs bytes, recompiles cost tens of
        milliseconds (CPU) to tens of seconds (remote TPU)."""
        b = 64
        while b < n:
            b *= 4
        return b

    def _pack_tick(self, acks, updates: dict) -> np.ndarray:
        """Pack acks + slot updates into the fast plan's [7, E] tick
        (column layout documented at ops.quorum.engine_step_resident_fast)
        and return it: acks first in intake order, then the updates;
        padding columns name slot PACK_SENTINEL (dropped: they land in no
        row, so no kernel tile lists them) and are invalid acks with
        sentinel updates."""
        n = len(acks) + len(updates)
        ecap = self._bucket(n)
        self._last_event_rows, self._last_event_cap = n, ecap
        evp = self._fast_events(ecap)[:, 0]
        evp[...] = _PACK_SENTINEL
        evp[1] = 0  # peer
        evp[4] = 0  # valid
        k = len(acks)
        if k:
            evp[:4, :k] = np.fromiter(
                itertools.chain.from_iterable(acks), np.int32,
                4 * k).reshape(k, 4).T
            evp[4, :k] = 1
        if updates:
            u = len(updates)
            evp[0, k:k + u] = np.fromiter(updates, np.int32, u)
            evp[5:, k:k + u] = np.fromiter(
                itertools.chain.from_iterable(updates.values()), np.int32,
                2 * u).reshape(u, 2).T
        return evp

    def _pack_tick_sliced(self, acks, updates: dict) -> np.ndarray:
        """Slice-routed fast-tick packing into the fast plan's [7, S, E]
        tick, SLICE-LOCAL row indices (ops.quorum.
        engine_step_resident_fast_sliced, kernel K5), returned: plane s
        holds only the events of slice s's rows, acks first in intake
        order, then its slot updates in queue order.  E is the bucket of
        the FULLEST slice; the other planes are padded to it, with
        columns as ``_pack_tick`` pads."""
        s = self.state
        n_slices, rows = s.n_slices, s.slice_rows
        na, nu = len(acks), len(updates)
        a = np.fromiter(itertools.chain.from_iterable(acks), np.int32,
                        4 * na).reshape(na, 4)  # slot,peer,match,t
        asl = a[:, 0] // rows
        ack_counts = np.bincount(asl, minlength=n_slices)
        counts = ack_counts
        if nu:
            us = np.fromiter(updates, np.int32, nu)
            uv = np.fromiter(itertools.chain.from_iterable(updates.values()),
                             np.int32, 2 * nu).reshape(nu, 2)  # flush,dl
            usl = us // rows
            counts = ack_counts + np.bincount(usl, minlength=n_slices)
        n = int(counts.max())
        ecap = self._bucket(n)
        self._last_event_rows, self._last_event_cap = n, ecap
        evp = self._fast_events(ecap)
        planes = evp.reshape(7, n_slices * ecap)  # a view: planes end to end
        planes[...] = _PACK_SENTINEL
        planes[1] = 0  # peer
        planes[4] = 0  # valid
        if na:
            pos = _plane_positions(asl, ecap)
            a[:, 0] %= rows
            planes[:4, pos] = a.T
            planes[4, pos] = 1
        if nu:
            pos = _plane_positions(usl, ecap) + ack_counts[usl]
            planes[0, pos] = us % rows
            planes[5:, pos] = uv.T
        return evp

    # Hard ceiling on one dispatch's event bucket (64 * 4^4).  A backlog
    # tick must NEVER exceed the largest COMPILED bucket: the next bucket
    # would be a brand-new jit shape, and that compile (measured minutes
    # on the CPU backend at E=65536, 12.9s at E=8192->16384) lands
    # synchronously on the event loop mid-run.  Oversized batches are
    # processed as bounded-shape chunks instead; prewarm() lowers the
    # effective cap to the largest bucket it actually compiled.
    _MAX_EVENT_BUCKET = 16384

    def _tick_batched(self, acks, now: int) -> list[tuple[int, str, int]]:
        cap = min(self._MAX_EVENT_BUCKET, self._event_bucket_cap)
        if len(acks) + len(self._slot_updates) <= cap:
            return self._tick_batched_pass(acks, now)
        # Pathological backlog (the loop was stalled long enough for >16k
        # events to queue): run bounded chunks through the same kernels.
        # Duplicate commit events self-suppress in _collect_changed (device
        # value vs mirror) and deadline disarms persist on device, so the
        # chunk merge is a plain concatenation.
        changed: list[tuple[int, str, int]] = []
        updates_all, self._slot_updates = self._slot_updates, {}
        idx = 0
        first = True
        while first or idx < len(acks) or updates_all:
            first = False
            chunk = acks[idx:idx + cap]
            idx += cap
            room = cap - len(chunk)
            upd: dict[int, list] = {}
            while room > 0 and updates_all:
                k, v = updates_all.popitem()
                upd[k] = v
                room -= 1
            self._slot_updates = upd
            changed.extend(self._tick_batched_pass(chunk, now))
        return changed

    def _tick_batched_pass(self, acks, now: int) -> list[tuple[int, str, int]]:
        # dispatch-latency timer: host -> XLA -> host wall for this sweep
        # (pack + upload + kernel + output download), recorded even on an
        # exception path so a wedged backend shows up in the p99
        with self._m.dispatch_timer.time():
            self._m.ack_batch.update(len(acks))
            if not TRACER.enabled:
                return self._tick_batched_dispatch(acks, now)
            # engine.dispatch (process-level unit): the device round trip
            # of one dispatch, tag = packed event count
            unit = TRACER.open_unit(STAGE_ENGINE)
            try:
                return self._tick_batched_dispatch(acks, now)
            finally:
                TRACER.close_unit(unit, len(acks))

    def _tick_batched_dispatch(self, acks, now: int
                               ) -> list[tuple[int, str, int]]:
        s = self.state
        self._m.batched_dispatches.inc()

        if self._dev is None or self._dev.match_index.shape != s.match_index.shape:
            # first batched tick / capacity regrow / epoch rebase: one full
            # upload, after which only dirty rows and events travel.
            self._dev = self._upload_device_state()
            s.dirty.clear()
            self._slot_updates.clear()  # the full upload carried them

        if not s.dirty:
            # Fast path (the steady state under load): the acks and the
            # packed slot updates straight into the fast plan's pinned
            # buffer, then ONE prepared call (the bytes up, one launch of
            # K1 or K5, the [4, G] outputs down).  Flush advances and
            # deadline re-arms travel as packed updates alongside the
            # acks, so routine traffic never needs a refresh.
            self._m.fast_ticks.inc()
            updates, self._slot_updates = self._slot_updates, {}
            # mesh: slice-routed [7, S, E] planes for the sliced kernel;
            # single device: the flat [7, E] pack
            if self.mesh is not None:
                self._pack_tick_sliced(acks, updates)
            else:
                self._pack_tick(acks, updates)
            out = self._fast_plan.run(self._last_event_cap, now,
                                      self.leadership_timeout_ms)
            return self._collect_changed(out[0], out[1] != 0, out[2] != 0,
                                         out[3] != 0)

        # dirty-row refresh: O(changed slots) host->device.  Slots with
        # queued packed updates fold in here — the mirror already holds
        # their values, so the row refresh carries them.
        self._m.refresh_ticks.inc()
        dirty = sorted(s.dirty | set(self._slot_updates))
        self._slot_updates.clear()
        s.dirty.clear()
        self._m.refresh_rows.inc(len(dirty))
        n, k = len(dirty), len(acks)
        dcap, ecap = self._bucket(n), self._bucket(k)
        self._last_event_rows, self._last_event_cap = k, ecap
        # the rows and the acks are packed straight into the plan's pinned
        # buffer; padding rows point one past the end (dropped by the
        # scatter), padding acks are invalid
        plan = self._refresh_plan_for(self._dev)
        v = plan.views(dcap, ecap)
        v.idx[:n] = dirty
        v.idx[n:] = s.capacity
        rows = v.idx[:n]
        for name in q.DeviceState._fields:  # the mirror's names
            getattr(s, name).take(rows, axis=0, out=getattr(v, name)[:n])
        if k:
            v.events[:, :k] = np.fromiter(
                itertools.chain.from_iterable(acks), np.int32,
                4 * k).reshape(k, 4).T
        v.valid[:k] = True
        v.valid[k:] = False
        # one prepared call: the packed bytes up, one launch, the [4, G]
        # outputs (masks + commit values) down, never the [G, P] state
        out = plan.run(dcap, ecap, now, self.leadership_timeout_ms)
        return self._collect_changed(out[0], out[1] != 0, out[2] != 0,
                                     out[3] != 0)

    def _collect_changed(self, new_commit_np, commit_changed_np, timeouts_np,
                         stale_np) -> list[tuple[int, str, int]]:
        s = self.state
        changed: list[tuple[int, str, int]] = []
        for slot in np.nonzero(commit_changed_np)[0]:
            i = int(slot)
            if i in s.active:
                v = int(new_commit_np[i])
                # The inline ack path usually advanced the mirror (and fired
                # the listener) before this tick; the device event is then a
                # duplicate and must not re-fire.  Fire only when the device
                # is genuinely ahead (e.g. a dirty-row refresh carried state
                # the inline path never saw).
                if v > int(s.commit_index[i]):
                    s.commit_index[i] = v
                    changed.append((i, "commit", v))
        for slot in np.nonzero(timeouts_np)[0]:
            i = int(slot)
            # the kernel disarmed the deadline on device; mirror that here
            # (direct write, NOT mark_dirty: host and device already agree)
            if i in s.active:
                s.election_deadline_ms[i] = NO_DEADLINE
                changed.append((i, "timeout", 0))
        for slot in np.nonzero(stale_np)[0]:
            i = int(slot)
            if i in s.active:
                changed.append((i, "stale", 0))
        return changed
