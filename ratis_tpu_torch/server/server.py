"""RaftServer: the multi-Raft host (one process, many groups, one endpoint).

Capability parity with the reference RaftServerProxy
(ratis-server/.../impl/RaftServerProxy.java:81): a map of
groupId -> Division behind a single transport endpoint, group add/remove
(groupManagementAsync:490), request routing (getImpl:376), and lifecycle.
The reference's per-division thread fleet is replaced by the shared
QuorumEngine tick loop.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Optional

from ratis_tpu_torch.conf.keys import RaftConfigKeys, RaftServerConfigKeys
from ratis_tpu_torch.engine.engine import QuorumEngine
from ratis_tpu_torch.protocol.exceptions import (AlreadyExistsException,
                                           GroupMismatchException,
                                           RaftException)
from ratis_tpu_torch.protocol.group import RaftGroup
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.raftrpc import (AppendEntriesRequest, AppendEnvelope,
                                        AppendEnvelopeReply,
                                        InstallSnapshotRequest,
                                        ReadIndexRequest, RequestVoteRequest,
                                        StartLeaderElectionRequest)
from ratis_tpu_torch.protocol.requests import (DEFERRED_REPLY, RaftClientReply,
                                         RaftClientRequest)
from ratis_tpu_torch.protocol.termindex import TermIndex
from ratis_tpu_torch.server.division import Division
from ratis_tpu_torch.server.statemachine import StateMachine
from ratis_tpu_torch.trace.tracer import (STAGE_ACK_INTAKE,
                                          STAGE_FOLLOWER_APPEND, TRACER)
from ratis_tpu_torch.transport.base import ServerTransport, TransportFactory
from ratis_tpu_torch.util.lifecycle import LifeCycle, LifeCycleState

LOG = logging.getLogger(__name__)

# StateMachine registry: groupId -> StateMachine instance
StateMachineRegistry = Callable[[RaftGroupId], StateMachine]


class HeartbeatScheduler:
    """ONE periodic task per server sweeping every leader division's
    appenders (replaces a heartbeat-timer task per (division, follower) —
    2G standing tasks was the multi-raft scaling wall).  Each sweep wakes
    the appender fill paths, runs slowness detection, and sends any due
    heartbeats.  With coalescing enabled the sweep collects one COMPACT
    bulk item per due appender and ships one BulkHeartbeat RPC per
    destination server (see protocol.raftrpc.BulkHeartbeat — the per-item
    cost is a few dict lookups, not a full AppendEntries build+handle);
    without it, each appender sends its own unary AppendEntries heartbeat
    (the reference's cost shape)."""

    def __init__(self, server: "RaftServer", interval_s: float,
                 shard: Optional[int] = None, service=None):
        self.server = server
        self.interval_s = interval_s
        # loop sharding: shard i's scheduler runs ON shard i's loop and
        # sweeps ONLY divisions pinned there (appender/leader state is
        # loop-affine).  None = the single-loop sweep over every division.
        self.shard = shard
        self.service = service  # BulkHeartbeatService (defaults to server's)
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._sweep_seq = 0
        # array mode (raft.tpu.upkeep.enabled): this shard's UpkeepPlane;
        # None keeps the legacy per-division walk below bit-for-bit
        self.plane = None

    def start(self) -> None:
        self._running = True
        if self.service is None:
            self.service = self.server.heartbeats
        self.plane = self.server.upkeep_plane_for(self.shard or 0)
        name = (f"heartbeats-{self.server.peer_id}" if self.shard is None
                else f"heartbeats-{self.server.peer_id}-s{self.shard}")
        self._task = asyncio.create_task(self._run(), name=name)
        self._task.add_done_callback(self._on_exit)

    def _on_exit(self, task: asyncio.Task) -> None:
        """Belt-and-braces: if the sweep task ever dies while the server is
        running (a bug the try/except in _run should make impossible),
        restart it instead of silently losing every heartbeat forever."""
        if not self._running or task.cancelled():
            return
        LOG.error("heartbeat sweep task for %s exited unexpectedly "
                  "(%s); restarting", self.server.peer_id, task.exception())
        self.start()

    async def close(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        import time as _time
        while self._running:
            await asyncio.sleep(self.interval_s)
            now = _time.monotonic()
            self._sweep_seq += 1
            if self.plane is not None:
                await self._sweep_plane(now)
                continue
            coalesce = self.server.heartbeat_coalescing
            # destination -> ([bulk items], [appenders], aligned)
            bulk: dict[RaftPeerId, tuple[list, list]] = {}
            sweep = 0
            for i, div in enumerate(list(self.server.divisions.values())):
                if self.shard is not None \
                        and self.server.shard_of_group(div.group_id) \
                        != self.shard:
                    continue  # another shard's scheduler owns this division
                # One division's failure must never kill the single
                # server-wide heartbeat task — that silently collapses every
                # leadership on the server with no recovery path.
                try:
                    if not div.is_leader() or div.leader_ctx is None:
                        continue
                    if (self._sweep_seq + i) % 4 == 0:
                        # priority-yield scan is O(followers) python; its
                        # urgency is seconds, so a quarter-rate phase-spread
                        # scan keeps the sweep cheap at thousands of leaders
                        div.check_yield_to_higher_priority()
                    hib = (div.hibernate_sweep(now) if coalesce
                           else "awake")
                    if hib == "asleep":
                        continue  # hibernated: the group costs nothing
                    for appender in list(div.leader_ctx.appenders.values()):
                        sweep += 1
                        if coalesce:
                            item = appender.heartbeat_item(
                                now, hibernate=(hib == "request"))
                            if item is not None:
                                b = bulk.setdefault(
                                    appender.follower.peer_id, ([], []))
                                b[0].append(item)
                                b[1].append(appender)
                        else:
                            appender.on_heartbeat_sweep(now)
                        if sweep % 1024 == 0:
                            # Yield so the sweep never stalls the loop for
                            # one giant synchronous burst — but COARSELY: on
                            # a saturated loop every yield waits out the
                            # whole ready backlog, and at 40960 items a
                            # per-256 cadence stretched the sweep past the
                            # election timeout (followers of healthy
                            # leaders heard 16s+ of silence and deposed
                            # them).  1024 items ≈ tens of ms per stretch.
                            await asyncio.sleep(0)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    LOG.exception("heartbeat sweep failed for %s",
                                  div.member_id)
            for to, (items, appenders) in bulk.items():
                self.service.submit(to, items, appenders)

    async def _sweep_plane(self, now: float) -> None:
        """Array-mode sweep: ONE vectorized due-scan over the shard's
        packed deadlines, then the SAME per-division body as the legacy
        walk — but only for the due slots.  Non-leader and asleep groups
        hold +inf deadlines and cost nothing here."""
        from ratis_tpu_torch.ops.upkeep import (CH_CACHE, CH_HEARTBEAT,
                                          CH_HIBERNATE, CH_WATCH, CH_WINDOW)
        plane = self.plane
        resync = self.server.upkeep_resync_sweeps
        if resync and self._sweep_seq % resync == 0:
            self._plane_resync(now)
        timer = plane._timer
        ctx = timer.time() if timer is not None else None
        if ctx is not None:
            ctx.__enter__()
        try:
            slots, mask = plane.sweep(now)
            coalesce = self.server.heartbeat_coalescing
            bulk: dict[RaftPeerId, tuple[list, list]] = {}
            sweep = 0
            for j in range(len(slots)):
                slot = int(slots[j])
                div = plane.division_at(slot)
                if div is None:
                    continue
                gen = div.upkeep_gen
                try:
                    if mask[j, CH_WATCH]:
                        plane.clear(slot, gen, CH_WATCH)
                        div._update_watch_frontiers()
                    if mask[j, CH_CACHE]:
                        plane.set_deadline(slot, gen, CH_CACHE,
                                           div.sweep_caches(now))
                    if mask[j, CH_WINDOW]:
                        plane.set_deadline(slot, gen, CH_WINDOW,
                                           div.sweep_client_windows_due())
                    if mask[j, CH_HEARTBEAT] or mask[j, CH_HIBERNATE]:
                        sweep = await self._heartbeat_division(
                            div, slot, now, coalesce, bulk, sweep)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    LOG.exception("upkeep sweep failed for %s",
                                  div.member_id)
            for to, (items, appenders) in bulk.items():
                self.service.submit(to, items, appenders)
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)

    async def _heartbeat_division(self, div, slot: int, now: float,
                                  coalesce: bool, bulk: dict,
                                  sweep: int) -> int:
        """Identical body to one legacy-walk iteration, plus the
        post-dispatch re-arm (``Division.upkeep_rearm_heartbeat``)."""
        if not div.is_leader() or div.leader_ctx is None:
            div.upkeep_rearm_heartbeat(now)  # clears the leader channels
            return sweep
        if (self._sweep_seq + slot) % 4 == 0:
            # same quarter-rate phase spread as the legacy walk (slot is
            # as stable an offset as the enumeration index was)
            div.check_yield_to_higher_priority()
        hib = div.hibernate_sweep(now) if coalesce else "awake"
        if hib != "asleep":
            for appender in list(div.leader_ctx.appenders.values()):
                sweep += 1
                if coalesce:
                    item = appender.heartbeat_item(
                        now, hibernate=(hib == "request"))
                    if item is not None:
                        b = bulk.setdefault(
                            appender.follower.peer_id, ([], []))
                        b[0].append(item)
                        b[1].append(appender)
                else:
                    appender.on_heartbeat_sweep(now)
                if sweep % 1024 == 0:
                    # same coarse yield discipline as the legacy walk
                    await asyncio.sleep(0)
        div.upkeep_rearm_heartbeat(now)
        return sweep

    def _plane_resync(self, now: float) -> None:
        """Low-rate O(G) backstop against a missed re-arm hook: re-derive
        every registered division's deadlines from current state.  At the
        default 64-sweep cadence (~5s) the amortized cost is negligible;
        the hooks alone are believed sufficient — this bounds the blast
        radius of being wrong to one resync period."""
        plane = self.plane
        for div in plane._divisions:  # hot-loop-gate: allowlisted resync
            if div is None:
                continue
            div.upkeep_rearm_heartbeat(now)
            div.upkeep_arm_cache(now)
            div.upkeep_arm_window()


class BulkHeartbeatService:
    """Sends one BulkHeartbeat per destination server per sweep and routes
    the aligned per-item replies back to their appenders.  A failed send is
    simply dropped — the next sweep retries, and persistent failure
    surfaces through leadership staleness (no acks) exactly like a dead
    unary heartbeat channel would."""

    # One BulkHeartbeat RPC carries at most this many group items: a
    # 10k-item bulk is O(all co-hosted groups) handling time inside ONE
    # rpc deadline — measured at 5-peer x 10240 groups, the whole bulk
    # blew the rpc timeout, every ack was lost at once, and the staleness
    # sweep deposed thousands of healthy leaders.  Chunks fail (and
    # retry) independently.
    MAX_ITEMS_PER_RPC = 2048

    def __init__(self, server: "RaftServer"):
        self.server = server
        self.metrics = {"batches": 0, "heartbeats": 0}
        self._pending: set[asyncio.Task] = set()

    def submit(self, to: RaftPeerId, items: list, appenders: list) -> None:
        n = self.MAX_ITEMS_PER_RPC
        for i in range(0, len(items), n):
            t = asyncio.create_task(
                self._send(to, items[i:i + n], appenders[i:i + n]))
            self._pending.add(t)
            t.add_done_callback(self._pending.discard)

    async def _send(self, to: RaftPeerId, items: list, appenders: list) -> None:
        from ratis_tpu_torch.protocol.raftrpc import BulkHeartbeat
        self.metrics["batches"] += 1
        self.metrics["heartbeats"] += len(items)
        try:
            reply = await self.server.send_server_rpc(
                to, BulkHeartbeat(self.server.peer_id, to, tuple(items)))
        except asyncio.CancelledError:
            raise
        except Exception:
            # No send-clock rollback needed: the sweep period equals the
            # heartbeat interval and the due check is 0.9x interval, so a
            # failed item re-qualifies at the very next sweep anyway — the
            # failure costs at most one sweep period, never a silent extra
            # interval (unary mode routes the same failure through
            # on_send_error for its backoff semantics).
            return
        if len(reply.items) != len(items):
            LOG.warning("%s: bulk heartbeat reply misaligned from %s",
                        self.server.peer_id, to)
            return  # items re-qualify next sweep (see send-failure note)
        # packed ack intake (sweep mode): the whole bulk's heartbeat acks
        # enter the engine as one on_ack_batch instead of one scalar
        # on_ack (and one intake-lock round-trip) per item
        ack_rows = ([] if getattr(self.server, "replication_sweep", False)
                    else None)
        # leader.ack_intake: the bulk reply's acks landing
        unit = (TRACER.open_unit(STAGE_ACK_INTAKE) if TRACER.enabled
                else None)
        try:
            for appender, item in zip(appenders, reply.items):
                try:
                    await appender.on_bulk_reply(*item, ack_sink=ack_rows)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    LOG.exception("%s bulk heartbeat reply dispatch failed",
                                  self.server.peer_id)
            if ack_rows:
                self.server.engine.on_ack_batch(ack_rows)
        finally:
            if unit is not None:
                TRACER.close_unit(unit, len(items))

    async def close(self) -> None:
        for task in list(self._pending):
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._pending.clear()


class _LaneGap(Exception):
    """A buffered frame's lane gap never filled (its predecessor frame was
    lost): reject the frame with a rewind hint instead of processing it."""


class _LaneIntake:
    """Follower-side state of ONE sequenced append lane (RaftServer lane
    intake): frames process strictly in sequence — ``next_process`` only
    advances when a frame's processing COMPLETES, so a group's items in
    frame k+1 can never reach its division before frame k's (the ordering
    the sender's busy latch used to provide).  Out-of-order arrivals park
    on per-seq futures.  The ``busy`` flag is an OWNERSHIP token: a
    completing frame hands it directly to its parked successor
    (``pass_on`` wakes the future with busy left True), so the lane is
    never observably idle between back-to-back frames — which is also
    what keeps the gap timer honest: a genuine sequence gap (the frame we
    need next never arrived while the lane is idle) is detected by a
    one-shot timer and rejects every parked frame with a rewind hint."""

    # how long a parked frame waits for a missing predecessor before the
    # lane rejects it (a merely-slow predecessor never trips this — the
    # timer only fires when the needed frame never ARRIVED)
    GAP_WAIT_S = 1.0

    __slots__ = ("next_process", "next_arrival", "busy", "waiting",
                 "gap_timer", "last_used")

    def __init__(self, first_seq: int):
        # adopt the first observed sequence: a receiver restart (or lane
        # eviction) must not reject a healthy lane forever
        self.next_process = first_seq
        self.next_arrival = first_seq
        self.busy = False
        self.waiting: dict[int, asyncio.Future] = {}
        self.gap_timer = None
        self.last_used = 0.0

    @property
    def gapped(self) -> bool:
        """Frames are parked but the one we need next never arrived."""
        return (not self.busy and bool(self.waiting)
                and self.next_process not in self.waiting)

    def arm_gap_timer(self, loop: asyncio.AbstractEventLoop) -> None:
        if self.gap_timer is None and self.gapped:
            self.gap_timer = loop.call_later(self.GAP_WAIT_S,
                                             self._on_gap_timer)

    def _on_gap_timer(self) -> None:
        self.gap_timer = None
        if not self.gapped:
            return
        for fut in self.waiting.values():
            if not fut.done():
                fut.set_exception(_LaneGap())
        self.waiting.clear()

    def pass_on(self, loop: asyncio.AbstractEventLoop) -> None:
        """Release lane ownership: hand it to the parked ``next_process``
        frame (busy stays True across the transfer), or mark the lane
        idle and (re-)arm gap detection if later frames wait on a hole."""
        fut = self.waiting.pop(self.next_process, None)
        if fut is not None and not fut.done():
            fut.set_result(None)  # ownership transferred
        else:
            self.busy = False
            self.arm_gap_timer(loop)

    def close(self) -> None:
        if self.gap_timer is not None:
            self.gap_timer.cancel()
            self.gap_timer = None
        for fut in self.waiting.values():
            if not fut.done():
                fut.set_exception(_LaneGap())
        self.waiting.clear()


class RaftServer:
    def __init__(self, peer_id: RaftPeerId, address: str,
                 state_machine_registry: StateMachineRegistry,
                 properties, transport_factory: TransportFactory,
                 group: Optional[RaftGroup] = None,
                 log_factory: Optional[Callable] = None):
        self.peer_id = peer_id
        self.address = address
        self.properties = properties
        # Host-path tracing (ratis_tpu_torch.trace): enables the process-wide
        # tracer when raft.tpu.trace.enabled is set; a no-op otherwise.
        from ratis_tpu_torch.trace import configure_from_properties
        configure_from_properties(properties)
        self._sm_registry = state_machine_registry
        self._initial_group = group
        self._log_factory = log_factory
        self._transport_factory = transport_factory
        self.life_cycle = LifeCycle(f"server-{peer_id}")
        self.divisions: dict[RaftGroupId, Division] = {}
        # Shared log plane (raft.tpu.log.shared): one interleaved store per
        # loop shard, created on first use, refcounted by its divisions.
        self._shared_log_stores: dict[int, object] = {}
        # Loop sharding (raft.tpu.server.loop-shards): N worker event loops
        # with every Division hash-pinned to one; None (shards=1, the
        # default) keeps the single-loop runtime with zero indirection.
        self.loop_shards = RaftServerConfigKeys.loop_shards(properties)
        self.shards = None
        if self.loop_shards > 1:
            from ratis_tpu_torch.server.shards import LoopShardPool
            self.shards = LoopShardPool(f"{peer_id}", self.loop_shards)
        # Transaction contexts between append and apply
        # (reference TransactionManager, ratis-server/.../impl/).
        self.transactions: dict = {}

        p = properties
        mesh = None
        device = RaftServerConfigKeys.Engine.device(p)
        mesh_n = RaftServerConfigKeys.Engine.mesh_devices(p)
        if mesh_n > 0:
            # Mesh deployment: the resident engine state in n contiguous
            # slices of the group axis (ratis_tpu_torch.parallel.mesh) on
            # the engine's device; the fast tick ships slice-routed event
            # planes (kernel K5) and the row-local quorum math needs no
            # exchange between slices.
            from ratis_tpu_torch.parallel import make_group_mesh
            mesh = make_group_mesh(mesh_n, device=device)
        self.engine = QuorumEngine(
            max_groups=RaftServerConfigKeys.Engine.max_groups(p),
            max_peers=RaftServerConfigKeys.Engine.max_peers(p),
            tick_interval_s=RaftServerConfigKeys.Engine.tick_interval(p).seconds,
            scalar_fallback_threshold=p.get_int(
                RaftServerConfigKeys.Engine.SCALAR_FALLBACK_THRESHOLD_KEY,
                RaftServerConfigKeys.Engine.SCALAR_FALLBACK_THRESHOLD_DEFAULT),
            leadership_timeout_ms=int(
                RaftServerConfigKeys.Rpc.timeout_max(p).to_ms() * 2),
            mesh=mesh,
            profile_dir=RaftServerConfigKeys.Engine.profile_dir(p) or None,
            name=str(peer_id),
            device=device)
        # lag & health ledger thresholds (raft.tpu.lag.*); the ledger
        # itself is part of the engine
        self.engine.ledger.lag_threshold = RaftServerConfigKeys.Lag.threshold(p)
        self.engine.ledger.up_window_ms = int(
            RaftServerConfigKeys.Lag.up_window(p).to_ms())
        self.lag_top_groups = RaftServerConfigKeys.Lag.top_groups(p)
        self.pause_monitor = None  # started in start() when enabled
        # Observability plane (raft.tpu.metrics.http-port /
        # raft.tpu.watchdog.*): the per-server introspection endpoint and
        # the stall watchdog, both created in start().  With the port key
        # unset no listener socket is ever opened.
        self.metrics_http = None
        self.watchdog = None
        # Continuous telemetry (raft.tpu.telemetry.*): the background
        # time-series sampler + flight recorder, created in start() only
        # when enabled — off is zero-cost, identical paths.
        self.telemetry = None
        self.flight = None
        # Placement controller (raft.tpu.placement.enabled): the opt-in
        # telemetry-driven rebalancing loop, created in start() — unset
        # keeps every request/read path bit-identical to a build without
        # the subsystem.
        self.placement = None
        from ratis_tpu_torch.conf.reconfiguration import ReconfigurationManager
        # live property reconfiguration (divisions register their knobs)
        self.reconfiguration = ReconfigurationManager(properties)
        self.heartbeats = BulkHeartbeatService(self)
        self.heartbeat_coalescing = \
            RaftServerConfigKeys.Heartbeat.coalescing_enabled(p)
        # Data-path fan-out: one PeerSender per destination server drains
        # every group's append batches (ratis_tpu_torch.server.replication).
        # The sweep discipline (raft.tpu.replication.*) batches the whole
        # replication plane: cross-group append sweeps per (destination,
        # loop-shard), packed ack intake (engine.on_ack_batch), and the
        # commit fan-out collapse; sweep=0 keeps the per-request paths.
        from ratis_tpu_torch.server.replication import ReplicationScheduler
        appender_keys = RaftServerConfigKeys.Log.Appender
        repl_keys = RaftServerConfigKeys.Replication
        self.replication_sweep = repl_keys.sweep(p)
        self.reply_fanout = (self.replication_sweep
                             and repl_keys.reply_fanout(p))
        self.stream_shards = repl_keys.stream_shards(p)
        self.replication = ReplicationScheduler(
            self,
            coalescing=appender_keys.coalescing_enabled(p),
            inflight_cap=appender_keys.envelope_inflight(p),
            envelope_byte_limit=appender_keys.envelope_byte_limit(p),
            sweep=self.replication_sweep,
            window_depth=repl_keys.window_depth(p))
        # Follower-side sequenced lane intake
        # (raft.tpu.replication.window-depth > 1 senders): lane id ->
        # _LaneIntake processing that lane's frames strictly in sequence.
        # Bounded: dead lanes (sender restarts/re-cuts) age out by LRU.
        self._lanes: dict = {}
        self.reorder_buffer = repl_keys.reorder_buffer(p)
        self.lane_metrics = {"ooo_buffered": 0, "lane_rejects": 0,
                             "lane_frames": 0}
        # cross-frame per-group order chains (sequenced frames only):
        # group id -> the tail frame's completion future, each entry only
        # ever touched from the group's owning loop
        self._group_chains: dict = {}
        # scheduling-hops-per-commit: the fan-out collapse as a standing
        # measured artifact (metrics/hops.py; per-site gauges + the
        # hops-per-commit ratio on this server's registry)
        from ratis_tpu_torch.metrics import hops as hops_mod
        from ratis_tpu_torch.metrics.registry import (MetricRegistries,
                                                MetricRegistryInfo, labeled)
        self._plane_info = MetricRegistryInfo(
            prefix=str(peer_id), application="ratis", component="server",
            name="replication_plane")
        plane = MetricRegistries.global_registries().create(self._plane_info)
        for site in hops_mod.SCHEDULING_SITES:
            plane.gauge(labeled("schedulingHops", site=site),
                        lambda s=site: hops_mod.snapshot()[s])
        plane.gauge("replyHopsPerCommit", self.reply_hops_per_commit)
        # Window state (round 9): sender-side rewind/lane counters +
        # follower-side lane-intake counters, plus per-destination
        # frames-in-flight / occupancy gauges registered as destinations
        # appear (peers are few even when groups are many).
        rm = self.replication.metrics
        plane.gauge("windowDepth",
                    lambda: self.replication.window_depth)
        plane.gauge("windowRewinds",
                    lambda: rm.get("windowed_rewinds", 0))
        plane.gauge("windowLaneResets", lambda: rm.get("lane_resets", 0))
        plane.gauge("windowLaneRejects", lambda: rm.get("lane_rejects", 0))
        plane.gauge("laneOutOfOrderBuffered",
                    lambda: self.lane_metrics["ooo_buffered"])
        plane.gauge("laneIntakeRejects",
                    lambda: self.lane_metrics["lane_rejects"])

        def _register_window_gauges(dest) -> None:
            plane.gauge(labeled("windowFramesInFlight", dest=str(dest)),
                        lambda d=dest: self.replication.frames_in_flight(d))
            plane.gauge(labeled("windowOccupancy", dest=str(dest)),
                        lambda d=dest: self.replication.window_occupancy(d))

        self.replication.on_destination = _register_window_gauges
        # Serving plane (ratis_tpu_torch.server.serving): intake admission
        # control + the batched readIndex scheduler, raft.tpu.serving.*.
        from ratis_tpu_torch.server.serving import ServingPlane
        self.serving = ServingPlane(self)
        # readIndex steering table (server/read.py): always constructed
        # (an empty table is a free set() check in the sweep); only the
        # placement actuator ever populates it.
        from ratis_tpu_torch.server.read import ReadSteering
        self.read_steering = ReadSteering()
        # Vectorized upkeep plane (raft.tpu.upkeep.*): per-loop-shard
        # packed deadline arrays replace the per-group sweep walk.  Unset
        # keeps self.upkeep empty and every caller on the legacy paths.
        self.upkeep: list = []
        self.upkeep_resync_sweeps = RaftServerConfigKeys.Upkeep \
            .resync_sweeps(p)
        self._upkeep_info = None
        if RaftServerConfigKeys.Upkeep.enabled(p):
            from ratis_tpu_torch.server.upkeep import create_planes
            self.upkeep = create_planes(self)
            self._upkeep_info = MetricRegistryInfo(
                prefix=str(peer_id), application="ratis",
                component="server", name="upkeep_plane")
            ureg = MetricRegistries.global_registries().create(
                self._upkeep_info)
            sweep_timer = ureg.timer("upkeepSweepCost")
            idle_skips = ureg.counter("upkeepIdleSkips")
            for pl in self.upkeep:
                pl._timer = sweep_timer
                pl._idle_counter = idle_skips
            ureg.gauge("upkeepDueGroups",
                       lambda: sum(pl.last_due for pl in self.upkeep))
            ureg.gauge("upkeepRegisteredSlots",
                       lambda: sum(pl.registered for pl in self.upkeep))
        # single source of truth for the heartbeat cadence (LeaderContext
        # and the sweep must agree, or heartbeat gaps silently grow)
        self.heartbeat_interval_s = \
            RaftServerConfigKeys.Rpc.timeout_min(p).seconds / 2
        self.heartbeat_scheduler = HeartbeatScheduler(
            self, self.heartbeat_interval_s)
        # sharded mode: one (scheduler, bulk service) pair per shard, each
        # living on its shard's loop (built in start(); the unsharded
        # fields above stay exactly the single-loop runtime)
        self._hb_shards: list[HeartbeatScheduler] = []
        # peer id -> network address, fed from every conf the server sees
        # (division conf syncs, staging, group adds); the resolver transports
        # dial by (reference PeerProxyMap's address source).
        self.peer_addresses: dict[RaftPeerId, str] = {}
        if group is not None:
            for peer in group.peers:
                if peer.address:
                    self.peer_addresses[peer.id] = peer.address
        self.transport: ServerTransport = transport_factory.new_server_transport(
            peer_id, address, self._handle_server_rpc,
            self._handle_client_request, properties,
            peer_resolver=self.resolve_peer_address)

        # DataStream bulk path (reference DataStreamServerImpl; served on the
        # peer's dedicated datastream address when one is configured).  Also
        # created lazily by _add_division for groups that arrive via
        # group_add after startup.
        self.datastream = None
        self._datastream_started = False
        self._gc_disciplined = False
        self._gc_task: Optional[asyncio.Task] = None
        if group is not None:
            self._maybe_create_datastream(group)

    # ------------------------------------------------------------- lifecycle

    def _storage_root(self) -> Optional[str]:
        """Durable mode unless raft.server.log.use.memory is set.  The peer id
        becomes a path component so multiple peers sharing one machine (or the
        default dir) never collide on locks or boot-scan-adopt each other's
        group state."""
        if RaftServerConfigKeys.Log.use_memory(self.properties):
            return None
        dirs = RaftServerConfigKeys.storage_dirs(self.properties)
        if not dirs:
            return None
        return f"{dirs[0]}/{self.peer_id}"

    async def start(self) -> None:
        self.life_cycle.transition(LifeCycleState.STARTING)
        if self.shards is not None:
            # before anything that places a division: boot-scan recovery and
            # the initial group below pin divisions to shard loops
            self.shards.start()
        await self.engine.start()
        from ratis_tpu_torch.conf.keys import RaftServerConfigKeys as _K
        if _K.Gc.discipline(self.properties):
            # Heap discipline (util.gcdiscipline): tuned thresholds now, one
            # deliberate collect+freeze once the group set settles — instead
            # of the collector's own 52s-at-10k-groups pause mid-consensus.
            from ratis_tpu_torch.util import gcdiscipline
            gcdiscipline.enable()
            self._gc_disciplined = True
            self._gc_task = asyncio.create_task(
                self._gc_janitor(
                    _K.Gc.freeze_idle(self.properties).seconds,
                    _K.Gc.refreeze_interval(self.properties).seconds),
                name=f"gc-janitor-{self.peer_id}")
        if _K.PauseMonitor.enabled(self.properties):
            from ratis_tpu_torch.server.pause_monitor import PauseMonitor
            self.pause_monitor = PauseMonitor(self)
            self.pause_monitor.start()
        if _K.Watchdog.enabled(self.properties):
            from ratis_tpu_torch.server.watchdog import StallWatchdog
            self.watchdog = StallWatchdog(self)
            self.watchdog.start()
        json_routes = {"/health": self.health_info,
                       "/divisions": self.divisions_info,
                       "/events": self.watchdog_events,
                       "/lag": self.lag_info}
        if _K.Telemetry.enabled(self.properties):
            from ratis_tpu_torch.metrics.flight import (FlightRecorder,
                                                  install_sigterm_dump)
            from ratis_tpu_torch.metrics.timeseries import TelemetrySampler
            self.telemetry = TelemetrySampler(self)
            self.telemetry.start()
            flight_dir = _K.Telemetry.flight_dir(self.properties)
            self.flight = FlightRecorder(self, self.telemetry,
                                         dump_dir=flight_dir)
            if self.watchdog is not None:
                # organic degradation -> one debounced flight dump
                self.watchdog.on_event = self.flight.on_watchdog_event
            if flight_dir:
                install_sigterm_dump(self.flight)
            json_routes["/timeseries"] = self.telemetry.timeseries_info
            json_routes["/hotgroups"] = self.telemetry.hotgroups_info
            json_routes["/flightrecorder"] = \
                self.flight.flightrecorder_info
        if _K.Placement.enabled(self.properties):
            from ratis_tpu_torch.placement import PlacementController
            self.placement = PlacementController(self)
            self.placement.start()
            json_routes["/placement"] = self.placement.placement_info
        http_port = _K.Metrics.http_port(self.properties)
        if http_port is not None:
            from ratis_tpu_torch.metrics.prometheus import MetricsHttpServer
            self.metrics_http = MetricsHttpServer(
                port=http_port, json_routes=json_routes)
            await self.metrics_http.start()
        if self.shards is None:
            self.heartbeat_scheduler.start()
        else:
            # one sweep per shard, each ON its shard's loop over only its
            # own divisions (appender state is loop-affine), each with its
            # own bulk service so reply dispatch stays on-shard
            for i in range(self.shards.n):
                svc = BulkHeartbeatService(self)
                sched = HeartbeatScheduler(self, self.heartbeat_interval_s,
                                           shard=i, service=svc)
                self._hb_shards.append(sched)
                self.shards.call_soon(i, sched.start)
        # Boot scan: recover every group found on disk
        # (reference RaftServerProxy.initGroups:257-288).
        root = self._storage_root()
        if root is not None:
            from ratis_tpu_torch.server.storage import (RaftStorageDirectory,
                                                  scan_group_dirs)
            from ratis_tpu_torch.server.config import RaftConfiguration
            for gid in scan_group_dirs(root):
                if gid in self.divisions:
                    continue
                sd = RaftStorageDirectory(root, gid)
                conf_entry = sd.load_conf_entry()
                if conf_entry is None:
                    LOG.warning("%s: storage for %s has no conf; skipping",
                                self.peer_id, gid)
                    continue
                conf = RaftConfiguration.from_entry(conf_entry)
                group = RaftGroup.value_of(gid, conf.all_peers())
                await self._add_division(group)
        if self._initial_group is not None \
                and self._initial_group.group_id not in self.divisions:
            await self._add_division(self._initial_group)
        await self.transport.start()
        if self.datastream is not None and not self._datastream_started:
            await self.datastream.start()
            self._datastream_started = True
        self.life_cycle.transition(LifeCycleState.RUNNING)

    async def close(self) -> None:
        if not self.life_cycle.compare_and_transition(
                LifeCycleState.RUNNING, LifeCycleState.CLOSING):
            if not self.life_cycle.compare_and_transition(
                    LifeCycleState.NEW, LifeCycleState.CLOSING):
                return
        if self.metrics_http is not None:
            await self.metrics_http.close()
            self.metrics_http = None
        # the placement loop goes down before the watchdog: an in-flight
        # actuation still journals its aborted pair on cancellation
        if self.placement is not None:
            await self.placement.close()
            self.placement = None
        if self.telemetry is not None:
            if self.flight is not None:
                from ratis_tpu_torch.metrics.flight import uninstall_sigterm_dump
                uninstall_sigterm_dump(self.flight)
                self.flight = None
            await self.telemetry.close()
            self.telemetry = None
        if self.watchdog is not None:
            await self.watchdog.close()
            self.watchdog = None
        if self.pause_monitor is not None:
            await self.pause_monitor.close()
            self.pause_monitor = None
        if self._gc_task is not None:
            self._gc_task.cancel()
            try:
                await self._gc_task
            except asyncio.CancelledError:
                pass
            self._gc_task = None
        if self._gc_disciplined:
            from ratis_tpu_torch.util import gcdiscipline
            gcdiscipline.disable()
            self._gc_disciplined = False
        if self.shards is None:
            await self.heartbeat_scheduler.close()
        else:
            for sched in self._hb_shards:
                await self.shards.run_on(sched.shard, sched.close())
        await self.transport.close()
        if self.datastream is not None:
            await self.datastream.close()
        for div in list(self.divisions.values()):
            # whole-server shutdown (StateMachine.notifyServerShutdown,
            # StateMachine.java:277; group_remove notifies per-group instead)
            try:
                await div.state_machine.notify_server_shutdown(
                    div.role_info(), True)
            except Exception:
                LOG.exception("%s notify_server_shutdown raised",
                              div.member_id)
            await self._run_on_division_loop(div.group_id, div.close())
        self.divisions.clear()
        # after divisions: a live leader appender could otherwise submit a
        # heartbeat that recreates a flusher task in a closed coalescer
        await self.heartbeats.close()
        for sched in self._hb_shards:
            if sched.service is not None:
                await self.shards.run_on(sched.shard, sched.service.close())
        self._hb_shards.clear()
        await self.replication.close()
        for st in self._lanes.values():
            st.close()  # cancel gap timers, release any parked frames
        self._lanes.clear()
        from ratis_tpu_torch.metrics.registry import MetricRegistries
        MetricRegistries.global_registries().remove(self._plane_info)
        if self._upkeep_info is not None:
            MetricRegistries.global_registries().remove(self._upkeep_info)
            self._upkeep_info = None
        self.upkeep = []
        self.serving.close()
        await self.engine.close()
        if self.shards is not None:
            await self.shards.close()
        self.life_cycle.transition(LifeCycleState.CLOSED)

    async def _gc_janitor(self, freeze_idle_s: float,
                          refreeze_s: float = 0.0) -> None:
        """Waits for the group set to settle, then seals the heap (ONE
        deliberate collect+freeze) so the collector never walks the
        division fleet again; re-seals after later add/remove bursts, and
        — when ``raft.tpu.gc.refreeze-interval`` is set — on a steady
        cadence, moving load-accreted live objects (log entries) out of
        every future young-gen walk."""
        if freeze_idle_s <= 0 and refreeze_s <= 0:
            return
        from ratis_tpu_torch.util import gcdiscipline
        # poll fast enough for the FASTEST configured cadence, or a
        # sub-interval refreeze would silently quantize to the default poll
        # the early return above guarantees at least one cadence is set
        cadences = [c / 2 for c in (freeze_idle_s, refreeze_s) if c > 0]
        poll = max(min(*cadences, 5.0), 0.05)
        while True:
            await asyncio.sleep(poll)
            due = (freeze_idle_s > 0
                   and gcdiscipline.seal_due(freeze_idle_s)) or \
                  (refreeze_s > 0
                   and gcdiscipline.refreeze_due(refreeze_s))
            if due:
                # inline on purpose: gc.collect holds the GIL throughout, so
                # a worker thread would stall the loop just the same — and
                # the whole point is ONE scheduled pause at a quiet moment
                took = gcdiscipline.seal()
                if took > 1.0:
                    LOG.warning("%s: heap seal paused ~%.1fs (deliberate, "
                                "post-bring-up)", self.peer_id, took)

    def seal_heap(self) -> float:
        """Imperative form of the janitor's seal, for operators/harnesses
        that know bring-up just finished and prefer to take the one
        deliberate pause NOW (the bench does).  No-op unless the server
        runs with raft.tpu.gc.discipline: sealing without the discipline's
        close-time thaw would freeze the division fleet permanently."""
        if not self._gc_disciplined:
            LOG.warning("%s: seal_heap ignored — raft.tpu.gc.discipline "
                        "is off (nothing would ever unfreeze the heap)",
                        self.peer_id)
            return 0.0
        from ratis_tpu_torch.util import gcdiscipline
        return gcdiscipline.seal()

    # -------------------------------------------------------- group mgmt

    def _maybe_create_datastream(self, group: RaftGroup) -> None:
        if self.datastream is not None:
            return
        me = group.get_peer(self.peer_id)
        if me is not None and me.datastream_address:
            from ratis_tpu_torch.server.datastream import DataStreamManagement
            self.datastream = DataStreamManagement(self,
                                                   me.datastream_address)

    async def _add_division(self, group: RaftGroup) -> Division:
        if group.group_id in self.divisions:
            raise AlreadyExistsException(f"{self.peer_id} already hosts {group.group_id}")
        # a group arriving after startup (group_add) may be the first to
        # advertise a datastream address for this peer
        self._maybe_create_datastream(group)
        if self.datastream is not None and not self._datastream_started \
                and self.life_cycle.get_current_state() == LifeCycleState.RUNNING:
            await self.datastream.start()
            self._datastream_started = True
        sm = self._sm_registry(group.group_id)
        storage = None
        log = None
        root = self._storage_root()
        if self._log_factory is not None:
            if root is not None:
                # A durable server with a volatile injected log would persist
                # term/vote while losing acked entries on restart — a
                # committed-data-loss hazard.  Refuse the combination.
                raise ValueError(
                    "log_factory cannot be combined with durable storage; "
                    "set raft.server.log.use.memory=true")
            log = self._log_factory(self, group)
        elif root is not None:
            from ratis_tpu_torch.server.log.segmented import LogWorker, SegmentedRaftLog
            from ratis_tpu_torch.server.storage import RaftStorageDirectory
            storage = RaftStorageDirectory(root, group.group_id)
            storage.format()
            storage.lock()
            if RaftServerConfigKeys.TpuLog.shared(self.properties):
                from ratis_tpu_torch.server.log.shared import SharedGroupLog
                store = self._shared_log_store(root,
                                               self.shard_of_group(
                                                   group.group_id))
                log = SharedGroupLog(
                    f"log-{self.peer_id}-{group.group_id}",
                    group.group_id.to_bytes(), store)
            else:
                log = SegmentedRaftLog(
                    f"log-{self.peer_id}-{group.group_id}", storage.current,
                    worker=LogWorker.shared(f"{self.peer_id}:{root}"),
                    segment_size_max=RaftServerConfigKeys.Log
                    .segment_size_max(self.properties),
                    cache_segments_max=RaftServerConfigKeys.Log
                    .segment_cache_num_max(self.properties))
        div = Division(self, group, sm, log=log, storage=storage)
        self.divisions[group.group_id] = div
        if self._gc_disciplined:
            from ratis_tpu_torch.util import gcdiscipline
            gcdiscipline.note_mutation()
        try:
            # sharded: the division LIVES on its pinned loop from the first
            # task it spawns (apply loop, election machinery, windows)
            await self._run_on_division_loop(group.group_id, div.start())
        except Exception:
            self.divisions.pop(group.group_id, None)
            try:
                await self._run_on_division_loop(group.group_id, div.close())
            except Exception:
                LOG.exception("%s: cleanup after failed start of %s",
                              self.peer_id, group.group_id)
            raise
        return div

    async def group_add(self, group: RaftGroup) -> Division:
        return await self._add_division(group)

    async def group_remove(self, group_id: RaftGroupId,
                           delete_directory: bool = False) -> None:
        div = self.divisions.pop(group_id, None)
        if div is None:
            raise GroupMismatchException(f"{self.peer_id} does not host {group_id}")
        if self._gc_disciplined:
            from ratis_tpu_torch.util import gcdiscipline
            gcdiscipline.note_mutation()
        await div.state_machine.notify_group_remove()
        storage = div.storage
        await self._run_on_division_loop(group_id, div.close())
        if delete_directory and storage is not None:
            import shutil
            await asyncio.to_thread(
                shutil.rmtree, storage.root, ignore_errors=True)

    async def bootstrap_division(self, group_id: RaftGroupId) -> None:
        """Appointed-leader bootstrap on the division's own loop (harness/
        operator entry point; Division.bootstrap_as_leader is loop-affine
        like every other division method)."""
        div = self.get_division(group_id)
        await self._run_on_division_loop(group_id, div.bootstrap_as_leader())

    def get_division(self, group_id: RaftGroupId) -> Division:
        div = self.divisions.get(group_id)
        if div is None:
            raise GroupMismatchException(
                f"{self.peer_id} does not serve {group_id}; groups: "
                f"{[str(g) for g in self.divisions]}")
        return div

    def group_ids(self) -> list[RaftGroupId]:
        return list(self.divisions)

    # ------------------------------------------------------------- routing

    def _shared_log_store(self, root: str, shard: int):
        """Get-or-create the shard's interleaved log store.  Each shard
        gets its OWN LogWorker: worker futures are created on the
        submitter's loop, and a shard's divisions all live on one loop, so
        per-shard workers keep every future loop-affine (the per-group
        store's single per-device worker would cross loops here)."""
        store = self._shared_log_stores.get(shard)
        if store is None:
            from ratis_tpu_torch.server.log.segmented import LogWorker
            from ratis_tpu_torch.server.log.shared import (SharedLogStore,
                                                     shard_dir)
            store = SharedLogStore(
                shard_dir(root, shard),
                LogWorker.shared(f"{self.peer_id}:{root}:shard{shard}"),
                segment_size_max=RaftServerConfigKeys.TpuLog
                .shared_segment_size_max(self.properties),
                compaction_dead_ratio=RaftServerConfigKeys.TpuLog
                .compaction_dead_ratio(self.properties),
                name=f"sharedlog-{self.peer_id}-shard{shard}",
                on_final_release=lambda s=shard:
                self._shared_log_stores.pop(s, None))
            self._shared_log_stores[shard] = store
        return store

    def shard_of_group(self, group_id: RaftGroupId) -> int:
        """Loop-shard index owning ``group_id``'s division (0 unsharded)."""
        if self.shards is None:
            return 0
        return self.shards.shard_of(group_id.to_bytes())

    def slice_of_group(self, group_id: RaftGroupId) -> int:
        """Mesh slice owning ``group_id``'s engine rows (0 without a
        mesh).  Same crc32 hash as :meth:`shard_of_group`, so whenever
        ``mesh-devices`` divides ``loop-shards`` one device slice is fed
        by a stable subset of loop shards (one slice = one shard-set)."""
        return self.engine.slice_of(group_id.to_bytes())

    def upkeep_plane_for(self, shard: int):
        """The loop shard's UpkeepPlane, or None when array mode is off
        (raft.tpu.upkeep.enabled unset) — callers fall back to the legacy
        per-group paths."""
        if not self.upkeep:
            return None
        return self.upkeep[shard]

    def shard_queue_depth(self, group_id: RaftGroupId) -> int:
        """Ready-callback backlog of the loop owning ``group_id``'s
        division (-1 unknown) — the queueing signal the /divisions
        endpoint surfaces per division."""
        from ratis_tpu_torch.server.shards import loop_ready_depth
        if self.shards is not None:
            return self.shards.queue_depth(self.shard_of_group(group_id))
        try:
            return loop_ready_depth(asyncio.get_running_loop())
        except RuntimeError:
            return -1

    # -------------------------------------------- observability endpoints

    def health_info(self) -> dict:
        """GET /health: liveness + engine tick freshness.  The engine tick
        is the server's heartbeat-of-heartbeats — a stale tick means every
        hosted group's election/commit math is stalled."""
        import os
        import time as _time
        last = self.engine.last_tick_monotonic
        age = (None if last is None
               else round(_time.monotonic() - last, 3))
        # fresh = the tick loop ran within a generous multiple of its
        # cadence (the loop sleeps at most tick_interval between passes;
        # 50x tolerates load, a floor of 2s tolerates tiny intervals)
        fresh_bound = max(2.0, 50 * self.engine.tick_interval_s)
        state = self.life_cycle.get_current_state().name
        ok = (state == "RUNNING" and age is not None and age < fresh_bound)
        return {
            "status": "ok" if ok else "degraded",
            "peer": str(self.peer_id),
            "address": self.address,
            "pid": os.getpid(),
            "lifecycle": state,
            "divisions": len(self.divisions),
            "loopShards": self.loop_shards,
            "engine": {
                "ticks": self.engine.metrics["ticks"],
                "lastTickAgeS": age,
                "freshBoundS": fresh_bound,
                "groupsLive": len(self.engine.state.active),
                "groupsCapacity": self.engine.state.capacity,
                "meshSlices": self.engine.state.n_slices,
            },
            "watchdogEvents": (self.watchdog.event_count()
                               if self.watchdog is not None else 0),
            "serving": {
                "admissionEnabled": self.serving.admission.enabled,
                "shedTotal": self.serving.admission.shed_total,
                "pendingCount": sum(self.serving.admission.pending_count),
                "pendingBytes": sum(self.serving.admission.pending_bytes),
            },
            "chaos": self.chaos_info(),
        }

    def chaos_info(self) -> dict:
        """Active injected faults (the /health ``chaos`` block): link
        faults touching this peer from the process-wide chaos table, plus
        any registered code-injection points.  All-empty on a production
        server (the table is only consulted with raft.tpu.chaos.enabled,
        and nothing registers injections outside a campaign)."""
        from ratis_tpu_torch.chaos.link import link_faults
        from ratis_tpu_torch.util import injection as _inj
        me = str(self.peer_id)
        links = [f for f in link_faults().active()
                 if f["src"] in (me, None) or f["dst"] in (me, None)]
        points = [p for p in (_inj.APPEND_TRANSACTION, _inj.LOG_SYNC,
                              _inj.RUN_LOG_WORKER, _inj.REQUEST_VOTE,
                              _inj.APPEND_ENTRIES, _inj.INSTALL_SNAPSHOT)
                  if _inj.is_registered(p)]
        return {"activeLinkFaults": links, "activeInjections": points}

    def divisions_info(self, query=None):
        """GET /divisions: per-division introspection (role, term,
        commit/applied, follower lag, cache sizes, shard placement).
        ``?rollup=1`` returns the cheap per-server rollup instead —
        leadership count, total pending, shard occupancy vector — the
        O(servers) payload the placement frontends aggregate without
        shipping (or parsing) every division's full introspection."""
        if query and query.get("rollup", [None])[0]:
            n_shards = self.shards.n if self.shards is not None else 1
            shard_counts = [0] * n_shards
            leading = pending = hibernating = 0
            for div in list(self.divisions.values()):
                shard_counts[self.shard_of_group(div.group_id)
                             % n_shards] += 1
                if div.hibernating:
                    hibernating += 1
                if div.is_leader() and div.leader_ctx is not None:
                    leading += 1
                    pending += len(div.leader_ctx.pending)
            import os
            return {"peer": str(self.peer_id), "pid": os.getpid(),
                    "divisions": len(self.divisions),
                    "leading": leading, "pendingTotal": pending,
                    "hibernating": hibernating, "shards": shard_counts}
        return [div.introspect()
                for div in list(self.divisions.values())]

    def lag_info(self, query=None) -> dict:
        """GET /lag: the lag & health ledger — per-peer link/health
        rollups with log2 lag histograms, plus the top-k laggard groups
        (``?n=<k>`` overrides raft.tpu.lag.top-groups).  One fused engine
        pass + one device fetch, O(peers + k) python."""
        import os

        import numpy as np
        n = self.lag_top_groups
        if query:
            try:
                n = int(query.get("n", [None])[0])
            except (TypeError, ValueError):
                pass
        ledger = self.engine.ledger
        s = ledger.sample()
        peers = []
        for i, name in enumerate(s.peer_names):
            links = int(s.peer_links[i])
            if links == 0:
                continue
            up = int(s.peer_up[i])
            active = int(s.peer_active[i])
            laggy_active = int(s.peer_laggy_active[i])
            # health score: healthy share of the links that matter —
            # 1.0 = every active link inside the lag threshold; down
            # links count against the score like laggy ones
            down = links - up
            bad = laggy_active + down
            score = round(1.0 - bad / max(1, active + down), 4)
            hist = {int(b): int(c)
                    for b, c in enumerate(s.hist[i]) if c}
            peers.append({
                "peer": name, "links": links, "up": up, "down": down,
                "laggy": int(s.peer_laggy[i]), "active": active,
                "laggyActive": laggy_active,
                "maxLag": max(0, int(s.peer_max_lag[i])),
                "score": score, "hist": hist,
            })
        groups = []
        order = np.argsort(-s.worst_lag, kind="stable")
        for slot in order[:max(0, n)]:
            lag = int(s.worst_lag[slot])
            if lag <= 0:
                break  # sorted: nothing laggy past here
            listener = self.engine._listeners.get(int(slot))
            if listener is None:
                continue
            gid = listener.group_id
            peer_idx = int(s.worst_peer[slot])
            groups.append({
                "group": str(gid), "lag": lag,
                "peer": (s.peer_names[peer_idx]
                         if 0 <= peer_idx < len(s.peer_names) else "?"),
                "commit": int(s.commit[slot]),
                "gap": int(s.gap[slot]),
                "shard": self.shard_of_group(gid),
            })
        return {
            "peer": str(self.peer_id),
            "pid": os.getpid(),
            "now_ms": s.now_ms,
            "lagThreshold": ledger.lag_threshold,
            "upWindowMs": ledger.up_window_ms,
            "leading": s.leading,
            "gapTotal": s.gap_total,
            "fetchMs": s.fetch_ms,
            "peers": peers,
            "groups": groups,
        }

    def watchdog_events(self, query=None) -> dict:
        """GET /events: the stall watchdog's bounded event journal.
        ``?since=<seq>`` serves only records newer than that monotonic
        seq id — the flight recorder and ``shell top`` poll
        incrementally instead of re-deduping the whole ring."""
        if self.watchdog is None:
            return {"enabled": False, "seq": -1, "events": []}
        since = None
        if query:
            try:
                since = int(query.get("since", [None])[0])
            except (TypeError, ValueError):
                since = None
        return {"enabled": True,
                "count": self.watchdog.event_count(),
                "seq": self.watchdog.last_seq,
                "events": self.watchdog.events(since)}

    async def _run_on_division_loop(self, group_id: RaftGroupId, coro):
        """Await ``coro`` on the loop owning ``group_id``'s division; a
        plain await when unsharded or already on the owning loop."""
        if self.shards is None:
            return await coro
        return await self.shards.run_on(self.shard_of_group(group_id), coro)

    async def _handle_server_rpc(self, msg):
        from ratis_tpu_torch.protocol.raftrpc import BulkHeartbeat
        if isinstance(msg, AppendEnvelope):
            return await self._handle_append_envelope(msg)
        if isinstance(msg, BulkHeartbeat):
            return await self._handle_bulk_heartbeat(msg)
        if self.shards is not None:
            # division state is loop-affine: handle on the owning shard
            # (exceptions — e.g. GroupMismatch — propagate back through the
            # wrapped future unchanged)
            return await self.shards.run_on(
                self.shard_of_group(msg.header.group_id),
                self._handle_division_rpc(msg))
        return await self._handle_division_rpc(msg)

    async def _handle_division_rpc(self, msg):
        div = self.get_division(msg.header.group_id)
        if isinstance(msg, AppendEntriesRequest):
            return await div.handle_append_entries(msg)
        if isinstance(msg, RequestVoteRequest):
            return await div.handle_request_vote(msg)
        if isinstance(msg, InstallSnapshotRequest):
            return await div.handle_install_snapshot(msg)
        if isinstance(msg, ReadIndexRequest):
            return await div.handle_read_index(msg)
        if isinstance(msg, StartLeaderElectionRequest):
            return await div.handle_start_leader_election(msg)
        raise RaftException(f"unknown server rpc {type(msg).__name__}")

    # bounded lane table: dead lanes (sender restarts / lane re-cuts) are
    # LRU-evicted; live lanes (parked or processing frames) are never
    # evicted mid-flight
    _LANE_TABLE_MAX = 512
    # hard per-lane cap on IN-ORDER frames queued behind a busy
    # predecessor (memory bound; matches the sender-side lane-slot
    # ceiling, so a healthy sender never hits it)
    _LANE_QUEUE_MAX = 64

    async def _handle_append_envelope(self, env: AppendEnvelope
                                      ) -> AppendEnvelopeReply:
        """Follower intake of a multi-group append frame.  Unsequenced
        frames (seq < 0 — depth-1 senders, the legacy protocol) apply
        immediately; sequenced lane frames are sequence-checked first and
        process strictly in lane order (out-of-order arrivals briefly
        buffered, gaps rejected with a rewind hint) — the receiver half of
        the append-window pipeline."""
        if env.seq < 0:
            return await self._apply_append_envelope(env)
        return await self._handle_sequenced_envelope(env)

    async def _handle_sequenced_envelope(self, env: AppendEnvelope
                                         ) -> AppendEnvelopeReply:
        from ratis_tpu_torch.protocol.raftrpc import ENV_OUT_OF_SEQUENCE
        loop = asyncio.get_running_loop()
        # lane ids are unique per sender lifetime; the requestor id keys
        # co-hosted processes apart even across pid reuse
        requestor = (env.items[0].header.requestor_id if env.items
                     else None)
        key = (requestor, env.lane)
        st = self._lanes.get(key)
        if st is None:
            st = _LaneIntake(env.seq)
            self._lanes[key] = st
            if len(self._lanes) > self._LANE_TABLE_MAX:
                idle = [(s.last_used, k) for k, s in self._lanes.items()
                        if k != key and not s.busy and not s.waiting]
                if idle:
                    victim = self._lanes.pop(min(idle)[1], None)
                    if victim is not None:
                        victim.close()
        st.last_used = loop.time()

        def reject() -> AppendEnvelopeReply:
            self.lane_metrics["lane_rejects"] += 1
            return AppendEnvelopeReply((), status=ENV_OUT_OF_SEQUENCE,
                                       hint=st.next_process)

        if env.seq < st.next_process or env.seq in st.waiting \
                or (st.busy and env.seq == st.next_process):
            return reject()  # duplicate / stale frame: never re-process
        if env.seq > st.next_arrival:
            self.lane_metrics["ooo_buffered"] += 1  # genuine reorder
        st.next_arrival = max(st.next_arrival, env.seq + 1)
        if st.busy or env.seq != st.next_process:
            # park until our turn.  IN-ORDER frames queued behind a busy
            # predecessor are ordinary pipelining (bounded only by the
            # hard lane-queue cap — the sender's slot window keeps this
            # small); frames parked past a sequence HOLE (arrived
            # unprocessed frames don't account for every seq below us)
            # are genuine reorders, bounded by the reorder buffer, and a
            # hole that never fills trips the lane's gap timer and
            # rejects every parked frame
            arrived = len(st.waiting) + (1 if st.busy else 0)
            hole = arrived < env.seq - st.next_process
            limit = (self.reorder_buffer if hole
                     else self._LANE_QUEUE_MAX)
            if len(st.waiting) >= limit:
                return reject()
            fut = loop.create_future()
            st.waiting[env.seq] = fut
            st.arm_gap_timer(loop)
            try:
                # a normal wake IS the ownership hand-off (busy stays
                # True across the transfer — see _LaneIntake.pass_on)
                await fut
            except _LaneGap:
                return reject()
            except asyncio.CancelledError:
                if st.waiting.get(env.seq) is fut:
                    st.waiting.pop(env.seq, None)
                elif fut.done() and not fut.cancelled():
                    # ownership had just been handed to us: pass it on so
                    # the lane is not wedged by our cancellation
                    st.pass_on(loop)
                raise
        else:
            st.busy = True
        self.lane_metrics["lane_frames"] += 1
        try:
            # ADMISSION is the synchronous part: the frame's group runs
            # are created (and their per-group order chains registered)
            # before the lane admits the next frame — so cross-frame
            # per-group FIFO is fixed here, and frames then PROCESS
            # concurrently (distinct groups never wait on each other's
            # frames; the legacy envelope concurrency, kept)
            pending = self._start_append_envelope(env)
        finally:
            st.next_process = env.seq + 1
            st.last_used = loop.time()
            st.pass_on(loop)
        return await pending

    async def _apply_append_envelope(self, env: AppendEnvelope
                                     ) -> AppendEnvelopeReply:
        return await self._start_append_envelope(env)

    def _start_append_envelope(self, env: AppendEnvelope):
        """Sweep intake: fan the frame out to its divisions; returns the
        awaitable producing the frame's batched ack reply.  Groups are
        independent, so distinct groups are handled concurrently; one
        group's items are handled sequentially in envelope order, and —
        for sequenced frames, whose groups MAY span consecutive frames —
        a per-group completion chain orders frame k+1's run for a group
        after frame k's (registered synchronously in admission order, on
        the group's owning loop).  A group this server doesn't host
        yields None — a per-group error, not an envelope failure.  In
        sweep mode every item's engine flush update is collected and
        enters the engine as ONE batched intake after the whole frame has
        appended (one intake-lock round-trip per frame instead of one per
        item).  Traced, this admission (after any lane park) is one
        ``follower.append`` unit (tag = items); the group runs are tasks
        of their own, which may park on the log, and hold no unit."""
        if not TRACER.enabled:
            return self._admit_append_envelope(env)
        unit = TRACER.open_unit(STAGE_FOLLOWER_APPEND)
        try:
            return self._admit_append_envelope(env)
        finally:
            TRACER.close_unit(unit, len(env.items))

    def _admit_append_envelope(self, env: AppendEnvelope):
        items = env.items
        chained = env.seq >= 0
        results: list = [None] * len(items)
        # per-item flush rows (index-disjoint, so cross-shard writes are
        # safe); batched into one engine intake below
        flush_rows: Optional[list] = ([None] * len(items)
                                      if self.replication_sweep else None)
        by_group: dict = {}
        for i, req in enumerate(items):
            by_group.setdefault(req.header.group_id, []).append(i)

        def register_chain(gid):
            """Per-group cross-frame order link; called synchronously on
            the group's owning loop, in frame admission order."""
            if not chained:
                return None, None
            prev = self._group_chains.get(gid)
            fut = asyncio.get_running_loop().create_future()
            self._group_chains[gid] = fut
            return prev, fut

        async def run_group(gid, idxs, prev, fut):
            try:
                if prev is not None:
                    try:
                        await prev  # frame k's run for this group
                    except Exception:
                        pass
                for i in idxs:
                    try:
                        div = self.get_division(
                            items[i].header.group_id)
                        if flush_rows is None:
                            results[i] = await div.handle_append_entries(
                                items[i])
                        else:
                            rows: list = []
                            flush_rows[i] = rows
                            results[i] = await div.handle_append_entries(
                                items[i], flush_sink=rows)
                    except Exception:
                        results[i] = None
            finally:
                if fut is not None:
                    if not fut.done():
                        fut.set_result(None)
                    if self._group_chains.get(gid) is fut:
                        del self._group_chains[gid]

        if self.shards is None:
            # chains registered NOW (synchronously, in admission order);
            # gather creates the group tasks in the same breath
            aw = asyncio.gather(
                *(run_group(gid, ix, *register_chain(gid))
                  for gid, ix in by_group.items()))
        else:
            # sharded: each group's ordered run executes on its owning
            # loop; groups on one shard still run concurrently there
            # (gather inside the shard hop), shards run in parallel.  The
            # flat results list is index-disjoint across groups, so
            # cross-thread writes are safe.  Chain registration happens
            # as the shard coroutine's FIRST synchronous step: shard
            # submissions preserve admission order per loop
            # (run_coroutine_threadsafe is FIFO), so registration order
            # equals admission order there too.
            by_shard: dict[int, list] = {}
            for gid, idxs in by_group.items():
                by_shard.setdefault(self.shard_of_group(gid),
                                    []).append((gid, idxs))

            async def run_shard(group_runs):
                await asyncio.gather(
                    *(run_group(gid, ix, *register_chain(gid))
                      for gid, ix in group_runs))

            aw = asyncio.gather(*(self.shards.run_on(k, run_shard(v))
                                  for k, v in by_shard.items()))

        async def finish() -> AppendEnvelopeReply:
            await aw
            if flush_rows is not None:
                rows = [r for sub in flush_rows if sub for r in sub]
                if rows:
                    self.engine.on_flush_batch(rows)
            return AppendEnvelopeReply(tuple(results))

        return finish()

    async def _handle_bulk_heartbeat(self, msg):
        """Follower side of the compact multi-group heartbeat: one small
        per-division happy-path step per item (leadership recognition +
        deadline reset + log-matching-gated commit advance).  Items whose
        division append lock is free run inline (the happy path never
        suspends, so the sweep stays a tight loop); items contending with an
        in-flight append are skipped with BULK_HB_BUSY so ONE division's
        slow flush never head-of-line-blocks heartbeat delivery for later
        divisions, nor the envelope's reply (and with it every co-hosted
        group's ack freshness at the leader).  The skipped division's
        election deadline is safe: the very append holding its lock resets
        it on completion, and the leader retries next sweep.  Groups this
        server doesn't host reply UNKNOWN_GROUP."""
        from ratis_tpu_torch.protocol.ids import RaftGroupId
        from ratis_tpu_torch.protocol.raftrpc import (BULK_HB_BUSY,
                                                BULK_HB_UNKNOWN_GROUP,
                                                BulkHeartbeatReply)
        src = msg.requestor_id
        items = msg.items
        miss = (BULK_HB_UNKNOWN_GROUP, -1, -1, -1, -1)
        busy = (BULK_HB_BUSY, -1, -1, -1, -1)
        results: list = [miss] * len(items)

        async def run_items(idxs) -> None:
            done = 0
            for n in idxs:
                item = items[n]
                gid_bytes, term, commit, commit_term = item[:4]
                hibernate = len(item) > 4 and bool(item[4])
                div = self.divisions.get(RaftGroupId.value_of(gid_bytes))
                if div is None:
                    pass  # results[n] stays UNKNOWN_GROUP
                elif div.append_lock_locked():
                    results[n] = busy
                else:
                    try:
                        results[n] = await div.on_bulk_heartbeat(
                            src, term, commit, commit_term,
                            hibernate=hibernate)
                    except Exception:
                        LOG.exception("%s bulk heartbeat item failed",
                                      self.peer_id)
                done += 1
                if done % 1024 == 0:
                    # coarse yield cadence, same rationale as the sweep's:
                    # on a loaded loop each yield waits out the ready
                    # backlog, and heartbeat DELIVERY latency is an
                    # election-liveness input
                    await asyncio.sleep(0)

        if self.shards is None:
            await run_items(range(len(items)))
        else:
            # item handling is loop-affine (division append locks/deadline
            # state): split the bulk by owning shard, handle shard slices
            # in parallel, keep per-item reply alignment via the shared
            # index-disjoint results list
            by_shard: dict[int, list[int]] = {}
            for n, item in enumerate(items):
                gid = RaftGroupId.value_of(item[0])
                by_shard.setdefault(self.shard_of_group(gid), []).append(n)
            await asyncio.gather(*(self.shards.run_on(k, run_items(v))
                                   for k, v in by_shard.items()))
        return BulkHeartbeatReply(tuple(results))

    async def _handle_client_request(self, request: RaftClientRequest
                                     ) -> RaftClientReply:
        from ratis_tpu_torch.protocol.requests import RequestType
        from ratis_tpu_torch.trace.tracer import INGRESS_NS, STAGE_ROUTE, TRACER
        trace_t0 = 0
        if TRACER.enabled and request.trace_id:
            # route starts at transport ingress when the transport stamped
            # it (captures the ingress->handler scheduling hop), else here
            trace_t0 = INGRESS_NS.get() or TRACER.now()
            INGRESS_NS.set(0)  # single-use: never bleed into a later call
        t = request.type.type
        if t == RequestType.GROUP_MANAGEMENT:
            return await self._group_management(request)
        if t == RequestType.GROUP_LIST:
            from ratis_tpu_torch.protocol.admin import encode_group_list
            from ratis_tpu_torch.protocol.message import Message
            return RaftClientReply.success_reply(
                request, message=Message(encode_group_list(self.group_ids())))
        try:
            div = self.get_division(request.group_id)
        except GroupMismatchException as e:
            return RaftClientReply.failure_reply(request, e)
        # Admission control (serving plane): a shard over its pending
        # budget sheds here with a typed overload reply — the request
        # never hops to the saturated division loop.
        shed, ticket = self.serving.admission.try_admit(request)
        if shed is not None:
            return shed
        wrapped_sink = False
        if ticket is not None:
            from ratis_tpu_torch.protocol.requests import (attach_reply_sink,
                                                     reply_sink_of)
            sink = reply_sink_of(request)
            if sink is not None:
                # deferred replies bypass the handler return: the budget
                # is held until the waterline fan-out delivers through
                # the transport sink
                def _release_sink(reply, _sink=sink, _t=ticket):
                    _t.release()
                    _sink(reply)
                attach_reply_sink(request, _release_sink)
                wrapped_sink = True
        if trace_t0:
            TRACER.record(request.trace_id, STAGE_ROUTE, trace_t0,
                          TRACER.now())
        deferred = False
        try:
            try:
                # sharded: the division's whole submit path (windows, append,
                # quorum wait, apply wait) runs on its pinned loop
                reply = await self._run_on_division_loop(
                    request.group_id, div.submit_client_request(request))
            except RaftException as e:
                return RaftClientReply.failure_reply(request, e)
            except Exception as e:  # never leak raw errors to the wire
                LOG.exception("%s request failed", self.peer_id)
                return RaftClientReply.failure_reply(
                    request, RaftException(str(e)))
            if reply is DEFERRED_REPLY:
                # deferred-reply fast path: the waterline fan-out delivers the
                # real reply through the request's transport sink at commit
                # (the respond span is recorded there, not via mark_egress)
                deferred = True
                return reply
            if trace_t0:
                # the transport pops this to close the respond span (handler
                # done -> reply serialized/handed back)
                TRACER.mark_egress(request.trace_id)
            return reply
        finally:
            if ticket is not None and not (deferred and wrapped_sink):
                ticket.release()

    async def submit_data_stream_request(self, request: RaftClientRequest
                                         ) -> RaftClientReply:
        """Primary-side raft submit of a completed DataStream
        (DataStreamManagement.java:139-193: on CLOSE the primary drives the
        header request through the ordinary consensus path).  The primary
        may not be the leader — forward like any client request would be."""
        try:
            div = self.get_division(request.group_id)
            reply = await self._run_on_division_loop(
                request.group_id, div.submit_client_request(request))
        except RaftException as e:
            return RaftClientReply.failure_reply(request, e)
        nle = reply.get_not_leader_exception()
        if nle is not None and nle.suggested_leader is not None:
            peer = nle.suggested_leader
            address = peer.get_client_address() or \
                self.resolve_peer_address(peer.id)
            if address:
                try:
                    forward = self._transport_factory.new_client_transport(
                        self.properties)
                    try:
                        return await forward.send_request(address, request)
                    finally:
                        await forward.close()
                except Exception as e:
                    return RaftClientReply.failure_reply(
                        request, RaftException(f"forward to leader: {e}"))
        return reply

    async def _group_management(self, request: RaftClientRequest
                                ) -> RaftClientReply:
        """GroupManagementApi server side (RaftServerProxy
        groupManagementAsync:490 / groupAddAsync:509 / groupRemoveAsync:540)."""
        from ratis_tpu_torch.protocol.admin import (GroupManagementArguments,
                                              GroupManagementOp)
        try:
            args = GroupManagementArguments.from_payload(request.message.content)
        except Exception as e:
            return RaftClientReply.failure_reply(
                request, RaftException(f"bad groupManagement payload: {e}"))
        try:
            if args.op == GroupManagementOp.ADD:
                if args.group is None:
                    raise RaftException("group add without a group")
                await self.group_add(args.group)
            elif args.op == GroupManagementOp.REMOVE:
                if args.group_id is None:
                    raise RaftException("group remove without a group id")
                await self.group_remove(args.group_id, args.delete_directory)
            else:
                raise RaftException(f"unknown group op {args.op}")
        except RaftException as e:
            return RaftClientReply.failure_reply(request, e)
        except Exception as e:
            LOG.exception("%s group management failed", self.peer_id)
            return RaftClientReply.failure_reply(request, RaftException(str(e)))
        return RaftClientReply.success_reply(request)

    def reply_hops_per_commit(self) -> float:
        """Reply-plane scheduling hops per commit advance — the fan-out
        collapse's standing metric.  Hops are PROCESS-wide (co-hosted
        servers share the counters, like the tracer); the commit
        denominator is this server's engine, so in a one-server-per-
        process deployment the ratio is exact and in an in-process test
        cluster it is a per-server upper bound (the bench divides by the
        cluster-wide commit sum instead)."""
        from ratis_tpu_torch.metrics import hops as hops_mod
        commits = max(1, self.engine.metrics["commit_advances"])
        return round(hops_mod.reply_plane_hops() / commits, 4)

    def resolve_peer_address(self, peer_id: RaftPeerId) -> Optional[str]:
        return self.peer_addresses.get(peer_id)

    def learn_peer_addresses(self, peers) -> None:
        for p in peers:
            if p.address:
                self.peer_addresses[p.id] = p.address

    async def send_server_rpc(self, to: RaftPeerId, msg):
        return await self.transport.send_server_rpc(to, msg)

    def __str__(self) -> str:
        return f"RaftServer({self.peer_id}@{self.address}, {len(self.divisions)} groups)"
