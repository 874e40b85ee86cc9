"""Division: one group member — role machine, RPC handlers, apply loop.

Capability parity with the reference RaftServerImpl
(ratis-server/.../impl/RaftServerImpl.java:155): role transitions
(changeToFollower:587 / changeToLeader:635 / changeToCandidate:706), the
client write path (submitClientRequestAsync:937 -> appendTransaction:820),
reads (readAsync:1058, staleReadAsync:1024), the follower side
(requestVote:1420, appendEntriesAsync:1489 with the inconsistency check
:1661), apply (applyLogToStateMachine:1850 via StateMachineUpdater), and
leader-election wiring.

Structural difference by design: no per-division threads.  Election timeout
detection and commit advancement live in the server-wide QuorumEngine; the
division implements the EngineListener callbacks.  Only transient activities
(an in-flight election, per-follower appenders while leader, the apply loop)
are asyncio tasks.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Optional

import numpy as np

from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
from ratis_tpu_torch.engine.state import (ROLE_CANDIDATE, ROLE_FOLLOWER,
                                    ROLE_LEADER, ROLE_LISTENER)
from ratis_tpu_torch.protocol.exceptions import (LeaderNotReadyException,
                                           LeaderSteppingDownException,
                                           NotLeaderException, RaftException,
                                           StaleReadException,
                                           StateMachineException,
                                           StreamException)
from ratis_tpu_torch.protocol.group import RaftGroup, RaftGroupMemberId
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.logentry import (LogEntry, LogEntryKind,
                                         make_transaction_entry)
from ratis_tpu_torch.protocol.message import Message
from ratis_tpu_torch.protocol.peer import RaftPeer, RaftPeerRole
from ratis_tpu_torch.protocol.raftrpc import (AppendEntriesReply,
                                        AppendEntriesRequest, AppendResult,
                                        RaftRpcHeader, RequestVoteReply,
                                        RequestVoteRequest)
from ratis_tpu_torch.metrics.hops import hop
from ratis_tpu_torch.ops.upkeep import (CH_CACHE, CH_HEARTBEAT, CH_HIBERNATE,
                                  CH_WINDOW)
from ratis_tpu_torch.protocol.requests import (DEFERRED_REPLY, RaftClientReply,
                                         RaftClientRequest, RequestType,
                                         reply_sink_of)
from ratis_tpu_torch.protocol.termindex import INVALID_LOG_INDEX, TermIndex
from ratis_tpu_torch.server.config import RaftConfiguration
from ratis_tpu_torch.server.election import LeaderElection
from ratis_tpu_torch.server.leader import FollowerInfo, LeaderContext
from ratis_tpu_torch.server.state import ServerState
from ratis_tpu_torch.server.statemachine import StateMachine, TransactionContext
from ratis_tpu_torch.trace.tracer import (STAGE_APPEND, STAGE_APPLY,
                                          STAGE_APPLY_WAIT, STAGE_FANOUT,
                                          STAGE_QUORUM, STAGE_REPLICATE,
                                          STAGE_REPLY, STAGE_SEND_WAIT,
                                          STAGE_TXN, TRACER)
from ratis_tpu_torch.util import injection

LOG = logging.getLogger(__name__)


class Division:
    def __init__(self, server, group: RaftGroup, state_machine: StateMachine,
                 log=None, storage=None):
        self.server = server
        self.group_id: RaftGroupId = group.group_id
        self.member_id = RaftGroupMemberId(server.peer_id, group.group_id)
        self.storage = storage  # RaftStorageDirectory | None
        metadata_io = None
        if storage is not None:
            from ratis_tpu_torch.server.storage import FileMetadataIO
            metadata_io = FileMetadataIO(storage)
        self.state = ServerState(self.member_id, group, log=log,
                                 metadata_io=metadata_io)
        self.state_machine = state_machine
        state_machine.member_id = self.member_id
        # Per-entry SM notification is only dispatched when the app actually
        # overrides it — a no-op coroutine per applied entry is real cost at
        # thousands of groups (StateMachine.notifyTermIndexUpdated analog).
        self._sm_wants_term_index = (
            type(state_machine).notify_term_index_updated
            is not StateMachine.notify_term_index_updated)

        me = group.get_peer(server.peer_id)
        self.role: RaftPeerRole = (RaftPeerRole.LISTENER
                                   if me is not None and me.is_listener()
                                   else RaftPeerRole.FOLLOWER)
        self.leader_ctx: Optional[LeaderContext] = None
        self.election: Optional[LeaderElection] = None
        self._election_task: Optional[asyncio.Task] = None

        p = server.properties
        self._timeout_min_s = RaftServerConfigKeys.Rpc.timeout_min(p).seconds
        self._timeout_max_s = RaftServerConfigKeys.Rpc.timeout_max(p).seconds
        self.pre_vote_enabled = RaftServerConfigKeys.LeaderElection.pre_vote(p)

        from ratis_tpu_torch.server.read import (AppliedIndexWaiters, LeaseState,
                                           WriteIndexCache)
        from ratis_tpu_torch.server.retrycache import RetryCache
        from ratis_tpu_torch.server.snapshot import SnapshotInstaller, SnapshotSender
        from ratis_tpu_torch.server.watch import WatchRequests
        self.retry_cache = RetryCache(
            RaftServerConfigKeys.RetryCache.expiry_time(p).seconds)
        self.watch_requests = WatchRequests(
            RaftServerConfigKeys.Watch.timeout(p).seconds,
            RaftServerConfigKeys.Watch.element_limit(p))
        self.applied_waiters = AppliedIndexWaiters()
        self.write_index_cache = WriteIndexCache(
            p.get_time_duration(
                RaftServerConfigKeys.Read.READ_AFTER_WRITE_CONSISTENT_TIMEOUT_KEY,
                RaftServerConfigKeys.Read
                .READ_AFTER_WRITE_CONSISTENT_TIMEOUT_DEFAULT).seconds)
        self.read_option = RaftServerConfigKeys.Read.option(p)
        self.read_timeout_s = RaftServerConfigKeys.Read.timeout(p).seconds
        self.lease = LeaseState(
            RaftServerConfigKeys.Read.leader_lease_enabled(p),
            RaftServerConfigKeys.Read.leader_lease_timeout_ratio(p),
            RaftServerConfigKeys.Rpc.timeout_min(p).to_ms())
        from ratis_tpu_torch.server.messagestream import MessageStreamRequests
        self.message_stream_requests = MessageStreamRequests(
            RaftServerConfigKeys.Write.byte_limit(p))
        self.snapshot_installer = SnapshotInstaller(self)
        self.snapshot_sender = SnapshotSender(
            self,
            chunk_size=p.get_size(
                RaftServerConfigKeys.Log.Appender.SNAPSHOT_CHUNK_SIZE_MAX_KEY,
                RaftServerConfigKeys.Log.Appender.SNAPSHOT_CHUNK_SIZE_MAX_DEFAULT),
            install_enabled=RaftServerConfigKeys.Log.Appender
            .install_snapshot_enabled(p))
        self._snapshot_auto = RaftServerConfigKeys.Snapshot.auto_trigger_enabled(p)
        self._snapshot_threshold = \
            RaftServerConfigKeys.Snapshot.auto_trigger_threshold(p)
        self._snapshot_retention = \
            RaftServerConfigKeys.Snapshot.retention_file_num(p)
        self._last_snapshot_index = -1
        self._taking_snapshot = False
        self._confirm_inflight: Optional[asyncio.Task] = None
        self._last_cache_sweep = 0.0

        # engine wiring
        self.engine_slot: int = -1
        self.peer_slots: dict[RaftPeerId, int] = {}
        self.max_peers: int = server.engine.state.max_peers

        # upkeep plane (raft.tpu.upkeep.enabled): this division's slot in
        # its loop shard's packed deadline array (server/upkeep.py).  None
        # = legacy per-group paths, bit-for-bit.
        self._upkeep = None
        self.upkeep_slot: int = -1
        self.upkeep_gen: int = -1

        # apply loop
        self._applied_index = -1
        self._apply_wake = asyncio.Event()
        self._apply_task: Optional[asyncio.Task] = None
        self._running = False
        self._rng = random.Random(hash((str(self.member_id),)) & 0xFFFFFFFF)
        self._last_heard_leader_s = 0.0
        # Pipelined leaders keep several AppendEntries in flight; transports
        # deliver per-link FIFO, and this lock keeps *processing* in arrival
        # order too (the reference gets this from its serial gRPC stream,
        # GrpcServerProtocolService appendEntries stream observer).
        self._append_lock = asyncio.Lock()
        self._slowness_timeout_s = \
            RaftServerConfigKeys.Rpc.slowness_timeout(p).seconds
        # Idle-group quiescence (RaftServerConfigKeys.Hibernate; TiKV's
        # hibernate-regions pattern): leader-side sleep bookkeeping.
        self._hibernate_enabled = RaftServerConfigKeys.Hibernate.enabled(p)
        self._hibernate_after = RaftServerConfigKeys.Hibernate.after_sweeps(p)
        self._hibernate_backstop_s = \
            RaftServerConfigKeys.Hibernate.backstop(p).seconds
        self._hibernating = False
        self._quiet_sweeps = 0
        # leader side: monotonic time of the last slow-tick heartbeat sent
        # while asleep (refreshes follower backstop deadlines)
        self._last_hib_slow_tick = 0.0
        # follower side: the armed election deadline is the hibernate
        # BACKSTOP (long), not a normal timeout — client-contact nudges key
        # off this, and any real leader contact clears it
        self._hibernated_follower = False
        # follower-side wake nudge: first client contact on a disarmed
        # timer only RECORDS the moment (the client's retry to the still-
        # alive leader wakes the group properly); a second contact after a
        # full election timeout of continued leader silence re-arms
        self._wake_nudge_s = 0.0
        # staleness grace after wake: the silence was requested, so the
        # leader must get a full leadership-timeout of resumed heartbeats
        # before checkLeadership may judge it again
        self._wake_grace_until = 0.0
        self._election_timeout_min_s = \
            RaftServerConfigKeys.Rpc.timeout_min(p).seconds
        self._slowness_notified: dict[RaftPeerId, float] = {}
        # Fire-and-forget notification tasks: the loop holds only weak refs,
        # so keep strong ones until completion or GC may drop them unrun.
        self._bg_tasks: set[asyncio.Task] = set()
        self._no_leader_timeout_s = \
            RaftServerConfigKeys.Notification.no_leader_timeout(p).seconds
        self._last_no_leader_notify_s = 0.0
        self._started_at_s = 0.0
        self._last_yield_attempt_s = 0.0
        # per-client ordered-async reorder windows (leader only; see
        # _write_ordered)
        self._client_windows: dict = {}
        # Host-path tracing: log index -> [trace_id, append-done ns,
        # first-hand-off ns, commit-seen ns] for sampled writes in flight
        # between append and apply (the PeerSender stamps the hand-off,
        # on_commit_advance_now the commit; 0 until then); _apply_one
        # pops each to close the replicate span and its three waits and
        # open the apply span, then parks (trace_id, apply-done ns) in
        # _trace_applied for the write handler to close the reply span
        # when its future resumes.
        self._trace_pending: dict[int, list[int]] = {}
        self._trace_applied: dict[int, tuple[int, int]] = {}
        # Commit fan-out collapse (raft.tpu.replication.reply-fanout):
        # the apply loop resolves the batch's client waiters through ONE
        # waterline fan-out pass, and sink-carrying requests take the
        # deferred-reply path (reply delivered straight into the
        # transport's per-connection batcher, no per-request wakeup chain)
        self._reply_fanout = bool(getattr(server, "reply_fanout", False))
        # peer -> last known commit index (reference CommitInfoCache,
        # RaftServerImpl commitInfoCache): fed by our own commit advances,
        # follower reply piggybacks (leader) and leader request piggybacks
        # (follower); surfaced on every client reply.
        self._commit_info: dict[RaftPeerId, int] = {}
        # memoized (own_commit, infos, wire_form); None = stale
        self._ci_cache = None

        # admin state
        self.pending_reconf = None  # Optional[admin.PendingReconf]
        self.stepping_down = False  # transfer-leadership in progress
        self._election_paused = False

        # metrics (reference RaftServerMetricsImpl / LeaderElectionMetrics /
        # StateMachineMetrics; catalog in ratis-docs metrics.md)
        from ratis_tpu_torch.metrics import (LeaderElectionMetrics,
                                       RaftServerMetrics, StateMachineMetrics)
        self.metrics = RaftServerMetrics(self.member_id)
        self.election_metrics = LeaderElectionMetrics(self.member_id)
        self.sm_metrics = StateMachineMetrics(self.member_id)
        self.sm_metrics.add_applied_index_gauge(lambda: self._applied_index)
        self.metrics.add_commit_info_gauge(
            lambda: {"commitIndex": self.state.log.get_last_committed_index(),
                     "appliedIndex": self._applied_index})
        self.metrics.add_queue_gauge(
            lambda: len(self.leader_ctx.pending) if self.leader_ctx else 0)

    # ------------------------------------------------------------------ util

    def is_leader(self) -> bool:
        return self.role == RaftPeerRole.LEADER

    def is_follower(self) -> bool:
        return self.role == RaftPeerRole.FOLLOWER

    def is_candidate(self) -> bool:
        return self.role == RaftPeerRole.CANDIDATE

    def is_listener(self) -> bool:
        return self.role == RaftPeerRole.LISTENER

    @property
    def applied_index(self) -> int:
        return self._applied_index

    def set_applied_index(self, index: int) -> None:
        """Jump the applied frontier (snapshot install/restore)."""
        self._applied_index = max(self._applied_index, index)
        self.applied_waiters.advance(self._applied_index)
        self._engine_set_applied()

    def random_election_timeout_s(self) -> float:
        return self._rng.uniform(self._timeout_min_s, self._timeout_max_s)

    def get_leader_peer(self) -> Optional[RaftPeer]:
        # NB: a non-leader's hint can never name SELF — abdication without
        # a successor clears leader_id in change_to_follower (a stale
        # self-suggestion pins retrying clients in a self-referral loop).
        lid = self.state.leader_id
        if lid is None:
            return None
        return self.state.configuration.get_peer(lid)

    def introspect(self) -> dict:
        """Structured per-division introspection (the ``/divisions``
        endpoint and the stall watchdog both read this): role, term,
        commit/applied frontier, per-follower replication lag, cache and
        queue sizes, and loop-shard placement.  Pure reads over state the
        division already maintains — safe from the endpoint's connection
        handler on any loop, never awaits."""
        log = self.state.log
        commit = int(log.get_last_committed_index())
        out = {
            "group": str(self.group_id),
            "role": self.role.name,
            "term": int(self.state.current_term),
            "leader": (str(self.state.leader_id)
                       if self.state.leader_id is not None else None),
            "commitIndex": commit,
            "lastApplied": int(self._applied_index),
            "flushIndex": int(log.flush_index),
            "retryCacheSize": len(self.retry_cache),
            "pendingRequests": (len(self.leader_ctx.pending)
                                if self.leader_ctx is not None else 0),
            "hibernating": bool(self._hibernating),
            "loopShard": self.server.shard_of_group(self.group_id),
            "meshSlice": self.server.slice_of_group(self.group_id),
            "shardQueueDepth":
                self.server.shard_queue_depth(self.group_id),
        }
        if self.leader_ctx is not None:
            now = time.monotonic()
            out["followers"] = {
                str(pid): {
                    "matchIndex": int(f.match_index),
                    "nextIndex": int(f.next_index),
                    "lag": max(0, commit - int(f.match_index)),
                    "lastRpcElapsedS": round(
                        now - f.last_rpc_response_s, 3),
                }
                for pid, f in list(self.leader_ctx.followers.items())}
        return out

    # -------------------------------------------------------- engine wiring

    def attach_engine(self) -> None:
        engine = self.server.engine
        # slice-aware slot pin: the group's rows land inside the mesh
        # slice its crc32 hash owns, so its packed events route to the
        # device that holds them (no-op without a mesh: one slice)
        self.engine_slot = engine.attach(
            self, engine.slice_of(self.group_id.to_bytes()))
        self._assign_peer_slots()
        self._sync_conf_to_engine()
        self._engine_set_applied()
        engine.state.role[self.engine_slot] = (
            ROLE_LISTENER if self.is_listener() else ROLE_FOLLOWER)
        if not self.is_listener():
            self.reset_election_deadline()

    def detach_engine(self) -> None:
        if self.engine_slot >= 0:
            self.server.engine.detach(self.engine_slot)
            self.engine_slot = -1

    def _assign_peer_slots(self) -> None:
        """Stable peer->column mapping for the [G, P] arrays.  Existing
        assignments survive conf changes; new peers take free columns;
        columns of long-gone peers are recycled under membership churn."""
        def _take_free() -> int:
            used = set(self.peer_slots.values())
            for i in range(self.max_peers):
                if i not in used:
                    return i
            self._free_stale_slots()
            used = set(self.peer_slots.values())
            for i in range(self.max_peers):
                if i not in used:
                    return i
            raise RaftException(
                f"{self.member_id}: peer-slot columns exhausted "
                f"({self.max_peers}); raise raft.tpu.engine.max-peers")

        for peer in sorted(self.state.configuration.all_peers(),
                           key=lambda p: p.id.id):
            if peer.id not in self.peer_slots:
                self.peer_slots[peer.id] = _take_free()
        if self.member_id.peer_id not in self.peer_slots:
            self.peer_slots[self.member_id.peer_id] = _take_free()

    def _free_stale_slots(self) -> None:
        """Recycle columns of peers in neither conf nor the follower set."""
        keep = {p.id for p in self.state.configuration.all_peers()}
        keep.add(self.member_id.peer_id)
        if self.leader_ctx is not None:
            keep |= set(self.leader_ctx.followers)
        st = self.server.engine.state
        for pid in list(self.peer_slots):
            if pid not in keep:
                col = self.peer_slots.pop(pid)
                if self.engine_slot >= 0:
                    st.match_index[self.engine_slot, col] = -1
                    st.last_ack_ms[self.engine_slot, col] = 0
                    st.priority[self.engine_slot, col] = 0
                    st.peer_index[self.engine_slot, col] = -1
                    st.mark_dirty(self.engine_slot)

    def _sync_conf_to_engine(self) -> None:
        import numpy as np
        conf = self.state.configuration
        self.server.learn_peer_addresses(conf.all_peers())
        n = self.max_peers
        cur = np.zeros(n, bool)
        old = np.zeros(n, bool)
        prio = np.zeros(n, np.int32)
        for p in conf.conf.peers:
            s = self.peer_slots.get(p.id)
            if s is not None:
                cur[s] = True
                prio[s] = p.priority
        if conf.old_conf is not None:
            for p in conf.old_conf.peers:
                s = self.peer_slots.get(p.id)
                if s is not None:
                    old[s] = True
                    prio[s] = p.priority
        me = self.peer_slots[self.member_id.peer_id]
        my_peer = conf.get_peer(self.member_id.peer_id)
        engine = self.server.engine
        # dense peer ids for the lag ledger's per-peer aggregation
        pidx = np.full(n, -1, np.int32)
        for pid, s in self.peer_slots.items():
            pidx[s] = engine.ledger.peer_for(pid)
        engine.state.peer_index[self.engine_slot] = pidx
        engine.state.set_conf(
            self.engine_slot, me, cur, old, prio,
            my_peer.priority if my_peer is not None else 0)

    def _engine_set_applied(self) -> None:
        """Mirror the applied frontier into the lag ledger's [G] array
        (batch-level: once per apply sweep, not per entry)."""
        if self.engine_slot >= 0:
            self.server.engine.state.applied_index[self.engine_slot] = \
                self._applied_index

    def _engine_set_pending(self, n: int) -> None:
        """Mirror the leader pending-queue depth for the ledger/sampler
        (called by PendingRequests on add/pop/drain)."""
        if self.engine_slot >= 0:
            self.server.engine.state.pending_count[self.engine_slot] = n

    def reset_election_deadline(self) -> None:
        self._wake_nudge_s = 0.0
        self._hibernated_follower = False
        if self.engine_slot < 0 or self.is_listener():
            return
        engine = self.server.engine
        deadline = engine.clock.now_ms() + int(self.random_election_timeout_s() * 1000)
        # high-rate path (every append/heartbeat received re-arms): packed
        # update, not a dirty-row refresh
        engine.on_deadline(self.engine_slot, deadline)

    def _engine_set_role(self, role_code: int) -> None:
        if self.engine_slot >= 0:
            self.server.engine.state.role[self.engine_slot] = role_code
            self.server.engine.state.mark_dirty(self.engine_slot)

    def _engine_update_flush(self, sink: Optional[list] = None) -> None:
        if self.engine_slot >= 0:
            if sink is not None:
                # envelope sweep intake: the caller feeds the whole
                # frame's rows to QuorumEngine.on_flush_batch at once
                sink.append((self.engine_slot, self.state.log.flush_index))
                return
            # high-rate path (every append flushes): packed update
            self.server.engine.on_flush(self.engine_slot,
                                        self.state.log.flush_index)

    # ---------------------------------------------------------- lifecycle

    # ------------------------------------------------- live reconfiguration

    def _reconfigurable_keys(self) -> list[str]:
        K = RaftServerConfigKeys
        return [K.Rpc.SLOWNESS_TIMEOUT_KEY,
                K.Notification.NO_LEADER_TIMEOUT_KEY,
                K.Snapshot.AUTO_TRIGGER_ENABLED_KEY,
                K.Snapshot.AUTO_TRIGGER_THRESHOLD_KEY,
                K.Snapshot.RETENTION_FILE_NUM_KEY,
                K.Read.TIMEOUT_KEY]

    async def _apply_reconfiguration(self, key: str, value) -> None:
        """Re-read a runtime-tunable knob from properties (the value was
        already stored by ReconfigurationManager)."""
        p = self.server.properties
        K = RaftServerConfigKeys
        if key == K.Rpc.SLOWNESS_TIMEOUT_KEY:
            self._slowness_timeout_s = K.Rpc.slowness_timeout(p).seconds
        elif key == K.Notification.NO_LEADER_TIMEOUT_KEY:
            self._no_leader_timeout_s = \
                K.Notification.no_leader_timeout(p).seconds
        elif key == K.Snapshot.AUTO_TRIGGER_ENABLED_KEY:
            self._snapshot_auto = K.Snapshot.auto_trigger_enabled(p)
        elif key == K.Snapshot.AUTO_TRIGGER_THRESHOLD_KEY:
            self._snapshot_threshold = K.Snapshot.auto_trigger_threshold(p)
        elif key == K.Snapshot.RETENTION_FILE_NUM_KEY:
            self._snapshot_retention = K.Snapshot.retention_file_num(p)
        elif key == K.Read.TIMEOUT_KEY:
            self.read_timeout_s = K.Read.timeout(p).seconds

    async def start(self) -> None:
        self._running = True
        self._started_at_s = asyncio.get_running_loop().time()
        for key in self._reconfigurable_keys():
            self.server.reconfiguration.register(
                key, self._apply_reconfiguration)
        snapshot_index = -1
        if self.storage is not None:
            # RECOVER path (reference ServerState.initialize:134): reload
            # (term, votedFor), init the SM (restores its latest snapshot),
            # then open the segmented log above the snapshot.
            term, voted_for = self.storage.load_metadata()
            self.state.current_term = term
            self.state.voted_for = voted_for
            conf_entry = self.storage.load_conf_entry()
            if conf_entry is not None:
                self.state.apply_log_entry_configuration(conf_entry)
            else:
                # First boot: record the bootstrap conf so a restart with an
                # empty log still knows the group membership.
                boot = self.state.configuration.to_entry(0, -1)
                await asyncio.to_thread(self.storage.persist_conf_entry, boot)
            await self.state_machine.initialize(
                self.server, self.group_id, self.storage.root)
            snap = self.state_machine.get_latest_snapshot()
            if snap is not None:
                snapshot_index = snap.index
                self._applied_index = snap.index
                self._engine_set_applied()
        else:
            await self.state_machine.initialize(self.server, self.group_id, None)
            snap = None
        await self.state.log.open(snapshot_index)
        if snap is not None and self.state.log.get_last_entry_term_index() is None:
            # Snapshot exists but the log was purged/empty: restart the log
            # just above the snapshot (cf. ServerState.java:153 replay start).
            self.state.log.set_snapshot_boundary(snap.term_index)
        # replay durable conf entries into the configuration history
        log = self.state.log
        for i in range(log.start_index, log.next_index):
            e = log.get(i)
            if e is not None and e.is_config():
                self.state.apply_log_entry_configuration(e)
        self.attach_engine()
        if self.server.upkeep:
            # register on the owning shard's plane (this coroutine already
            # runs on the division's pinned loop, same loop as the plane's
            # sweep — single-threaded by construction)
            self._upkeep = self.server.upkeep_plane_for(
                self.server.shard_of_group(self.group_id))
            self.upkeep_slot, self.upkeep_gen = self._upkeep.register(self)
        # Decoupled-flush observers: the worker's fsync completion advances
        # flush_index -> feed the engine's commit kernel; a failed write is a
        # log failure (StateMachine.notifyLogFailed).
        log.set_flush_callbacks(self._on_log_flush, self._on_log_failed)
        self._apply_task = asyncio.create_task(
            self._apply_loop(), name=f"applier-{self.member_id}")

    def _on_log_flush(self, flush_index: int) -> None:
        self._engine_update_flush()

    def _spawn_bg(self, coro) -> None:
        t = asyncio.ensure_future(coro)
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)

    def _on_log_failed(self, exc: Exception) -> None:
        if not self._running:
            return
        LOG.error("%s log write failed: %s", self.member_id, exc)
        self._spawn_bg(self._handle_log_failure(exc))

    async def _handle_log_failure(self, exc: Exception) -> None:
        """A broken log cannot back leadership: notify the SM and step down
        (reference EventApi.notifyLogFailed, StateMachine.java:214; the
        reference shuts the division down via the log worker's error path)."""
        try:
            await self.state_machine.notify_log_failed(exc, None)
        except Exception:
            LOG.exception("%s notify_log_failed raised", self.member_id)
        if self.is_leader():
            await self.change_to_follower(self.state.current_term, None,
                                          reason=f"log failed: {exc}")

    async def close(self) -> None:
        self._running = False
        if self._upkeep is not None:
            # generation bump: outstanding (slot, gen) handles — and any
            # deadline already armed — can no longer fire into a future
            # tenant of this slot
            self._upkeep.unregister(self.upkeep_slot, self.upkeep_gen)
            self._upkeep = None
        self.server.reconfiguration.unregister_all(
            self._reconfigurable_keys(), self._apply_reconfiguration)
        if self.election is not None:
            self.election.stop()
        if self._election_task is not None:
            self._election_task.cancel()
        self._drain_client_windows(
            RaftException(f"{self.member_id} is closing"))
        for t in list(self._bg_tasks):
            t.cancel()
        self._bg_tasks.clear()
        if self.leader_ctx is not None:
            await self.leader_ctx.stop()
            self.leader_ctx = None
        if self._apply_task is not None:
            self._apply_task.cancel()
            try:
                await self._apply_task
            except asyncio.CancelledError:
                pass
        self.detach_engine()
        try:
            await self.state.log.close()
            await self.state_machine.close()
        finally:
            self.metrics.unregister()
            self.election_metrics.unregister()
            self.sm_metrics.unregister()
            if self.storage is not None:
                self.storage.unlock()

    # -------------------------------------------------- EngineListener API

    async def on_election_timeout(self) -> None:
        if not self._running or not self.is_follower():
            return
        if self._election_paused \
                or self.state.log.failed \
                or not self.state.configuration.contains_voting(
                    self.member_id.peer_id):
            # A dead log cannot back leadership (the reference terminates the
            # server on log failure): never campaign with one.
            self.reset_election_deadline()
            return
        self.election_metrics.timeout_count.inc()
        self._check_extended_no_leader()
        await self.change_to_candidate()

    def _check_extended_no_leader(self) -> None:
        """Reference RaftServerImpl.checkExtendedNoLeader (via
        StateMachine.notifyExtendedNoLeader, StateMachine.java:255): at each
        election timeout, if no leader has been heard for
        Notification.no_leader_timeout, tell the state machine — at most
        once per timeout period."""
        if self._no_leader_timeout_s <= 0:
            return
        now = asyncio.get_running_loop().time()
        base = max(self._last_heard_leader_s, self._started_at_s)
        if now - base < self._no_leader_timeout_s:
            return
        if now - self._last_no_leader_notify_s < self._no_leader_timeout_s:
            return
        self._last_no_leader_notify_s = now
        self._spawn_bg(self.state_machine.notify_extended_no_leader(
            self.role_info()))

    # ------------------------------------------------ idle-group hibernation

    def _quiescent(self) -> bool:
        """Nothing for this leader's group to say: no pending work and every
        voting follower fully synced with nothing in flight."""
        ctx = self.leader_ctx
        if ctx is None or ctx.pending.requests() \
                or self.watch_requests.pending_count() > 0:
            return False
        log = self.state.log
        last = log.next_index - 1
        if log.get_last_committed_index() != last:
            return False
        conf = self.state.configuration
        for f in ctx.followers.values():
            if not conf.contains_voting(f.peer_id):
                continue
            if f.match_index != last or f.snapshot_in_progress:
                return False
        return True

    def hibernate_sweep(self, now: float) -> str:
        """Called by the server heartbeat sweep per interval (leader +
        coalescing only).  Returns:
        - "awake":   heartbeat normally
        - "request": heartbeat with the hibernate flag (ask followers to
                     disarm their election timers)
        - "asleep":  fully hibernated — contribute NO items this sweep
        """
        if not self._hibernate_enabled or not self.is_leader() \
                or self.leader_ctx is None:
            return "awake"
        if self._hibernating:
            # Dead-leader backstop slow tick: one hibernate-flagged
            # heartbeat per backstop/4 refreshes the followers' (long)
            # backstop deadlines; if this leader dies, the refreshes stop
            # and the group becomes electable again within ~backstop.
            if self._hibernate_backstop_s > 0 and \
                    now - self._last_hib_slow_tick \
                    >= self._hibernate_backstop_s / 4:
                self._last_hib_slow_tick = now
                # The slow tick MUST actually send: heartbeat_item's
                # confirmed-contact gate (0.9*hb fresh-reply / 0.45*hb
                # send-cap) would otherwise suppress it whenever backstop
                # < ~4x the heartbeat interval — the tick counted as sent
                # here while followers heard nothing, and their backstop
                # deadlines expired in a perfectly healthy sleeping group
                # (ADVICE r5).  _last_send_s == 0.0 is the explicit
                # force-due marker heartbeat_item honors.
                for a in self.leader_ctx.appenders.values():
                    a._last_send_s = 0.0
                return "request"
            return "asleep"
        if not self._quiescent():
            self._quiet_sweeps = 0
            return "awake"
        self._quiet_sweeps += 1
        if self._quiet_sweeps < self._hibernate_after:
            return "awake"
        ctx = self.leader_ctx
        conf = self.state.configuration
        voting = [a for a in ctx.appenders.values()
                  if conf.contains_voting(a.follower.peer_id)]
        # An empty voting-appender set (all remaining followers are
        # listeners) is trivially acked — parking in "request" forever
        # would hibernate-flag non-voting followers every sweep with no
        # path to "asleep".
        if all(a.hibernate_acked for a in voting):
            self._hibernating = True
            self._last_hib_slow_tick = now
            LOG.info("%s hibernated (idle %d sweeps)", self.member_id,
                     self._quiet_sweeps)
            return "asleep"
        return "request"

    def wake_from_hibernation(self, reason: str = "") -> None:
        """Any contact (client request, admin op, new entry) wakes the
        group: resume heartbeats and refresh the staleness clock so the
        leader is not instantly declared stale for the silence it was
        ASKED to keep."""
        if not self._hibernating and self._quiet_sweeps == 0:
            return
        was_asleep = self._hibernating
        self._hibernating = False
        self._quiet_sweeps = 0
        # NO fabricated acks: last_ack_ms stays honest (a deposed leader
        # must NOT regain a valid lease from its own wake; see
        # _lease_valid) — the grace window alone suppresses the staleness
        # verdict until resumed heartbeats have had a full timeout to
        # produce REAL acks.
        self._wake_grace_until = (
            asyncio.get_running_loop().time()
            + self.server.engine.leadership_timeout_ms / 1000.0)
        if self.leader_ctx is not None:
            import time as _time
            now_s = _time.monotonic()
            for a in self.leader_ctx.appenders.values():
                a.hibernate_acked = False
                a._last_send_s = 0.0  # next sweep heartbeats immediately
                # slowness bookkeeping must not count the requested silence
                a.follower.last_rpc_response_s = now_s
        if was_asleep:
            LOG.info("%s woke from hibernation (%s)", self.member_id,
                     reason)
        # array mode: the wake moved the true heartbeat due-time to NOW
        # (the force-due marker above); the packed slot must hear it or
        # the plane would sleep out the asleep-era backstop deadline
        self.upkeep_touch_heartbeat()

    @property
    def hibernating(self) -> bool:
        """Engine-visible: suppress per-sweep stale dispatch while asleep
        (the staleness output is level-triggered; a sleeping leader's
        frozen acks would otherwise re-fire it every sweep)."""
        return self._hibernating

    # --------------------------------------------------------- upkeep plane

    def upkeep_touch_heartbeat(self) -> None:
        """Arm CH_HEARTBEAT to fire at the very next sweep.  Called from
        every event that moves the true heartbeat due-time earlier —
        leadership start, hibernation wake, appender added — so the packed
        deadline can only ever be conservative-EARLY (the dispatch re-runs
        the real due gate, so early costs one declined call, never a
        behavior change)."""
        u = self._upkeep
        if u is not None:
            u.set_deadline(self.upkeep_slot, self.upkeep_gen,
                           CH_HEARTBEAT, 0.0)
            u.clear(self.upkeep_slot, self.upkeep_gen, CH_HIBERNATE)

    def next_heartbeat_due(self, now: float) -> float:
        """Min over appenders of the confirmed-contact due-time.  An
        appender-less leader (single-peer group) stays on the sweep
        cadence so hibernation quiescence counting still advances.  With
        heartbeat coalescing OFF the legacy sweep calls every appender's
        ``on_heartbeat_sweep`` each interval as the fill-retry waker, so
        the slot stays due every sweep to preserve that cadence."""
        ctx = self.leader_ctx
        if not self.is_leader() or ctx is None:
            return float("inf")
        if not self.server.heartbeat_coalescing or not ctx.appenders:
            return now if not self.server.heartbeat_coalescing \
                else now + self.server.heartbeat_interval_s
        return min(a.next_due(now) for a in ctx.appenders.values())

    def upkeep_rearm_heartbeat(self, now: float) -> None:
        """Post-dispatch re-arm of the leader channels from current state:
        awake leaders arm CH_HEARTBEAT, asleep ones arm the CH_HIBERNATE
        backstop clock instead (the slot is then touched a handful of
        times per minute, not every sweep), non-leaders hold +inf."""
        u = self._upkeep
        if u is None:
            return
        slot, gen = self.upkeep_slot, self.upkeep_gen
        if not self.is_leader() or self.leader_ctx is None:
            u.clear(slot, gen, CH_HEARTBEAT)
            u.clear(slot, gen, CH_HIBERNATE)
        elif self._hibernating:
            u.clear(slot, gen, CH_HEARTBEAT)
            if self._hibernate_backstop_s > 0:
                u.set_deadline(slot, gen, CH_HIBERNATE,
                               self._last_hib_slow_tick
                               + self._hibernate_backstop_s / 4)
            else:
                # backstop 0 = round-4 full disarm: the group costs
                # nothing until contact wakes it
                u.clear(slot, gen, CH_HIBERNATE)
        else:
            u.clear(slot, gen, CH_HIBERNATE)
            u.set_deadline(slot, gen, CH_HEARTBEAT,
                           self.next_heartbeat_due(now))

    def upkeep_arm_cache(self, now: float) -> None:
        """Arm the CH_CACHE expiry waterline when entries exist and the
        channel is unarmed (write/apply paths; O(1) while armed — the
        oldest-entry scan only runs on the empty->non-empty transition)."""
        u = self._upkeep
        if u is None or u.is_armed(self.upkeep_slot, self.upkeep_gen,
                                   CH_CACHE):
            return
        when = min(self.retry_cache.next_expiry_s(),
                   self.write_index_cache.next_expiry_s())
        if when != float("inf"):
            u.set_deadline(self.upkeep_slot, self.upkeep_gen, CH_CACHE, when)

    def sweep_caches(self, now: float) -> float:
        """CH_CACHE dispatch: run both expiry sweeps (identical bodies to
        the legacy apply-loop slow tick) and return the new waterline —
        +inf once both caches drain, so an idle division disarms."""
        self.retry_cache.sweep()
        self.write_index_cache.sweep(now)
        return min(self.retry_cache.next_expiry_s(),
                   self.write_index_cache.next_expiry_s())

    def upkeep_arm_window(self) -> None:
        """Arm CH_WINDOW once the reorder-window census crosses the sweep
        threshold (the legacy per-write sweep is a no-op below it)."""
        u = self._upkeep
        if u is None or len(self._client_windows) <= 256 \
                or u.is_armed(self.upkeep_slot, self.upkeep_gen, CH_WINDOW):
            return
        u.set_deadline(self.upkeep_slot, self.upkeep_gen, CH_WINDOW,
                       asyncio.get_running_loop().time() + 30.0)

    def sweep_client_windows_due(self) -> float:
        """CH_WINDOW dispatch: same expiry policy as the legacy per-write
        ``_sweep_client_windows``; next due-time, +inf when the census is
        back under the threshold (re-armed by the next window creation)."""
        self._sweep_client_windows(force=True)
        if len(self._client_windows) > 256:
            return asyncio.get_running_loop().time() + 30.0
        return float("inf")

    def on_commit_advance_now(self, new_commit: int) -> None:
        """Engine advanced this group's commit (leader only).  Synchronous
        on purpose: the engine calls this INLINE from the ack intake path
        (QuorumEngine.on_ack) so a commit never waits for the tick task to
        win a turn on a loaded event loop; the body must stay await-free."""
        if not self.is_leader():
            return
        if self._trace_pending:
            self._trace_stamp(0, new_commit, 3)
        self.state.log.update_commit_index(new_commit,
                                           self.state.current_term, True)
        self._apply_wake.set()
        self._update_watch_frontiers()

    def _trace_stamp(self, lo: int, hi: int, field: int) -> None:
        """Stamp now into ``field`` (2: handed to the transport, 3: commit
        seen) of every traced write whose index is in [lo, hi] and not yet
        stamped there (a commit covers every index up to it)."""
        now = TRACER.now()
        for index, rec in self._trace_pending.items():
            if lo <= index <= hi and not rec[field]:
                rec[field] = now

    async def on_commit_advance(self, new_commit: int) -> None:
        self.on_commit_advance_now(new_commit)

    async def on_leadership_stale(self) -> None:
        if self._hibernating:
            # silence was requested (followers' timers are disarmed too);
            # staleness detection resumes at wake
            return
        if asyncio.get_running_loop().time() < self._wake_grace_until:
            return  # just woke: give resumed heartbeats a full window
        if self.is_leader():
            await self.change_to_follower(
                self.state.current_term, None,
                reason="no majority ack within leadership timeout")

    # ----------------------------------------------------- role transitions

    async def change_to_candidate(self, force: bool = False) -> None:
        assert self.is_follower()
        self.role = RaftPeerRole.CANDIDATE
        self._engine_set_role(ROLE_CANDIDATE)
        self.election = LeaderElection(self, force=force)
        if force:
            # Leadership-transfer target (dissertation §3.10 TimeoutNow):
            # own the higher term IMMEDIATELY — the in-memory bump happens
            # before any await — so the old leader's in-flight heartbeats
            # (still at the old term) are rejected instead of demoting this
            # candidacy before its vote requests ever go out.  The old
            # leader steps down when it sees the higher term in replies.
            await self.state.init_election_term()
            self.election.term_pre_initialized = True

        async def _run_and_rearm():
            try:
                await self.election.run()
            except asyncio.CancelledError:
                raise
            except Exception:
                LOG.exception("%s election failed", self.member_id)
            finally:
                if self.is_candidate():
                    # election did not conclude in leadership: back to follower
                    self.role = RaftPeerRole.FOLLOWER
                    self._engine_set_role(ROLE_FOLLOWER)
                    self.reset_election_deadline()

        self._election_task = asyncio.create_task(
            _run_and_rearm(), name=f"election-{self.member_id}")

    async def bootstrap_as_leader(self) -> None:
        """Deployment-mode APPOINTED-LEADER bootstrap: install leadership
        directly — term 1, self-vote persisted, startup conf entry,
        appenders — with NO vote round.  For fresh groups only; the
        followers adopt the term from the first heartbeat/append exactly as
        they would after a won election.

        Contract (operator-owned, like the reference's startup-role /
        priority machinery that legitimizes operator-chosen initial
        leaders, LeaderElection.java:80, RaftPeer startup roles): appoint
        EXACTLY ONE peer per group, at group creation, before any traffic.
        Two appointees would be two same-term leaders — the vote round
        this skips is what normally forbids that.  Guarded to fresh state
        so it can never fire on a group with history.

        Why it exists: mass bring-up (the 10k-group multi-raft shape) pays
        O(groups x peers) vote RPCs and election machinery for an outcome
        the deployment already chose; measured at 5-peer x 10240 groups
        this was the dominant bring-up cost."""
        if not self.is_follower() or self.state.current_term != 0 \
                or self.state.leader_id is not None \
                or self.state.log.get_last_entry_term_index() is not None:
            raise RaftException(
                f"{self.member_id}: appointed bootstrap requires a fresh "
                f"group (follower at term 0 with an empty log)")
        if not self.state.configuration.contains_voting(
                self.member_id.peer_id):
            raise RaftException(
                f"{self.member_id}: appointed bootstrap of a non-voting "
                f"member")
        # Deterministic appointee: the fresh-state guard above is peer-
        # LOCAL, so without this check two appointees on the same fresh
        # group would both pass it and become two term-1 leaders whose
        # conflicting index-1 entries can each gather acks (ADVICE r5).
        # Deriving the one legitimate appointee from the configuration
        # itself (highest priority, ties broken by lowest peer id) makes a
        # double appointment fail CLOSED on every peer but one, with no
        # coordination or persisted marker needed.
        appointee = self.bootstrap_appointee()
        if appointee != self.member_id.peer_id:
            raise RaftException(
                f"{self.member_id}: not the bootstrap appointee — this "
                f"configuration appoints {appointee} (highest priority, "
                f"lowest peer id); appointing anyone else risks two "
                f"term-1 leaders on the same group")
        await self.state.init_election_term()
        self.role = RaftPeerRole.CANDIDATE
        self._engine_set_role(ROLE_CANDIDATE)
        await self.change_to_leader()

    def bootstrap_appointee(self) -> RaftPeerId:
        """The one peer this configuration allows to bootstrap_as_leader:
        the voting peer with the highest priority, ties broken by lowest
        peer id — deterministic from the conf every peer shares."""
        voting = self.state.configuration.voting_peers()
        if not voting:
            raise RaftException(
                f"{self.member_id}: configuration has no voting peers")
        return min(voting, key=lambda p: (-p.priority, p.id.id)).id

    async def change_to_leader(self) -> None:
        assert self.is_candidate()
        self.role = RaftPeerRole.LEADER
        self.election_metrics.on_new_leader_elected()
        self.state.set_leader(self.member_id.peer_id)
        self._engine_set_role(ROLE_LEADER)
        st = self.server.engine.state
        st.election_deadline_ms[self.engine_slot] = np.iinfo(np.int32).max
        now = self.server.engine.clock.now_ms()
        st.last_ack_ms[self.engine_slot, :] = now
        st.match_index[self.engine_slot, :] = -1
        st.mark_dirty(self.engine_slot)

        self.watch_requests.reset_frontiers()
        self.leader_ctx = LeaderContext(self)
        # Append the startup placeholder entry carrying the current conf
        # (reference appends a conf/StartupLogEntry on election,
        # LeaderStateImpl.java:293): commits of earlier-term entries are
        # gated on this index (Raft §5.4.2).
        conf = self.state.configuration
        index = self.state.log.next_index
        entry = conf.to_entry(self.state.current_term, index)
        ctx = self.leader_ctx
        ctx.startup_index = index
        st.first_leader_index[self.engine_slot] = index
        st.mark_dirty(self.engine_slot)
        try:
            await self.state.log.append_entry(entry)
        except Exception as e:
            # Log died between the vote and the startup append: abdicate
            # immediately instead of lingering as a heartbeat-less leader.
            LOG.error("%s startup entry append failed: %s", self.member_id, e)
            await self.change_to_follower(self.state.current_term, None,
                                          reason=f"startup append failed: {e}")
            return
        if self.leader_ctx is not ctx or not self.is_leader():
            # Deposed DURING the startup append (a higher-term append or
            # vote landed in the await window and change_to_follower
            # already unwound leader_ctx — an election-storm interleaving
            # the chaos campaign hits at the 1024-group shape): the new
            # role owns the division now; starting appenders for the dead
            # context would crash (or leak a ghost leadership).
            LOG.info("%s deposed during startup append; staying %s",
                     self.member_id, self.role.name)
            return
        self.state.apply_log_entry_configuration(entry)
        self._engine_update_flush()
        self.leader_ctx.start_appenders()
        # array mode: fresh leadership is due immediately (covers the
        # appender-less single-peer case start_appenders' per-appender
        # touch cannot)
        self.upkeep_touch_heartbeat()
        LOG.info("%s became LEADER at term %d", self.member_id,
                 self.state.current_term)

    async def change_to_follower(self, term: int, leader_id: Optional[RaftPeerId],
                                 reason: str = "") -> None:
        old_role = self.role
        if self.is_listener():
            await self.state.update_current_term(term)
            if leader_id is not None:
                self.state.set_leader(leader_id)
            return
        self.role = RaftPeerRole.FOLLOWER
        self._engine_set_role(ROLE_FOLLOWER)
        await self.state.update_current_term(term)
        if leader_id is not None:
            changed = self.state.set_leader(leader_id)
            if changed:
                await self.state_machine.notify_leader_changed(
                    self.member_id, leader_id)
        self._hibernating = False
        self._quiet_sweeps = 0
        if self._upkeep is not None:
            # non-leaders hold +inf on the leader channels — this is where
            # the vectorized sweep's savings come from
            self._upkeep.clear(self.upkeep_slot, self.upkeep_gen,
                               CH_HEARTBEAT)
            self._upkeep.clear(self.upkeep_slot, self.upkeep_gen,
                               CH_HIBERNATE)
        if old_role == RaftPeerRole.LEADER and leader_id is None:
            # Abdication without a known successor: the stale hint still
            # names SELF, and every leader_id consumer (NotLeader
            # suggestions, readIndex forwarding, GroupInfo) would keep
            # reporting this non-leader as the leader — clients retrying
            # the suggestion would loop on this node forever.  We genuinely
            # don't know the leader: clear it.
            self.state.set_leader(None)
        if old_role == RaftPeerRole.LEADER and self.leader_ctx is not None:
            self.message_stream_requests.clear()
            self._trace_pending.clear()  # entries may truncate; never apply
            self._trace_applied.clear()
            ctx = self.leader_ctx
            self.leader_ctx = None
            nle = NotLeaderException(self.member_id, self.get_leader_peer(),
                                     self.state.configuration.all_peers())
            await ctx.stop(nle)
            self.watch_requests.drain(nle)
            self._drain_client_windows(nle)
            LOG.info("%s stepped down (%s)", self.member_id, reason)
        if old_role == RaftPeerRole.CANDIDATE and self.election is not None:
            self.election.stop()
        if self.pending_reconf is not None \
                and not self.pending_reconf.future.done():
            self.pending_reconf.future.set_exception(
                NotLeaderException(self.member_id, self.get_leader_peer(),
                                   self.state.configuration.all_peers()))
        self.reset_election_deadline()

    # ------------------------------------------------------- follower RPCs

    async def handle_request_vote(self, req: RequestVoteRequest) -> RequestVoteReply:
        await injection.execute(injection.REQUEST_VOTE, self.member_id,
                                req.header.requestor_id)
        state = self.state
        header = RaftRpcHeader(self.member_id.peer_id, req.header.requestor_id,
                               self.group_id)
        my_last = state.log.get_last_entry_term_index() or TermIndex.INITIAL_VALUE

        def reply(granted: bool, term: int) -> RequestVoteReply:
            return RequestVoteReply(header, term, granted, last_entry=my_last)

        candidate = req.header.requestor_id
        # Listener never votes (quorum exclusion).
        if self.is_listener():
            return reply(False, state.current_term)

        if req.candidate_term < state.current_term:
            return reply(False, state.current_term)

        # Leader stickiness: deny if we recently heard from a live leader
        # (reference VoteContext lease check) — applies to both phases.
        loop_now = asyncio.get_running_loop().time()
        has_live_leader = (state.leader_id is not None
                           and state.leader_id != candidate
                           and (loop_now - self._last_heard_leader_s)
                           < self._timeout_min_s)
        if has_live_leader and not req.force:
            return reply(False, state.current_term)

        if req.pre_vote:
            # no term/vote changes; just report whether we WOULD vote
            ok = state.is_log_up_to_date(req.candidate_last_entry)
            return reply(ok, state.current_term)

        if req.candidate_term > state.current_term:
            await self.change_to_follower(req.candidate_term, None,
                                          reason="higher term in vote request")

        granted = False
        if (state.voted_for is None or state.voted_for == candidate) \
                and state.is_log_up_to_date(req.candidate_last_entry):
            await state.grant_vote(candidate)
            self.reset_election_deadline()
            granted = True
        return reply(granted, state.current_term)

    def append_lock_locked(self) -> bool:
        """Whether an append/bulk-heartbeat is currently holding this
        division's serialization lock (used by the server's bulk-heartbeat
        receiver to defer contended items off its sequential sweep)."""
        return self._append_lock.locked()

    async def handle_append_entries(self, req: AppendEntriesRequest,
                                    flush_sink: Optional[list] = None
                                    ) -> AppendEntriesReply:
        """``flush_sink`` (envelope sweep intake): collect this append's
        engine flush update as a packed ``(slot, flush_index)`` row instead
        of a scalar ``on_flush`` call — the server feeds the whole frame's
        rows to ``QuorumEngine.on_flush_batch`` in one pass."""
        with self.metrics.follower_append_timer.time():
            async with self._append_lock:
                return await self._handle_append_entries_impl(req,
                                                              flush_sink)

    async def _handle_append_entries_impl(self, req: AppendEntriesRequest,
                                          flush_sink: Optional[list] = None
                                          ) -> AppendEntriesReply:
        await injection.execute(injection.APPEND_ENTRIES, self.member_id,
                                req.header.requestor_id)
        state = self.state
        log = state.log
        header = RaftRpcHeader(self.member_id.peer_id, req.header.requestor_id,
                               self.group_id)

        def reply(result: AppendResult, next_index: int) -> AppendEntriesReply:
            return AppendEntriesReply(
                header, state.current_term, result, next_index,
                log.get_last_committed_index(), log.flush_index,
                is_heartbeat=req.is_heartbeat())

        if req.leader_term < state.current_term:
            return reply(AppendResult.NOT_LEADER, log.next_index)

        # Recognize the leader: higher-or-equal term append wins.
        if req.leader_term > state.current_term or not self.is_follower() \
                or state.leader_id != req.header.requestor_id:
            await self.change_to_follower(req.leader_term,
                                          req.header.requestor_id,
                                          reason="append from leader")
        self._last_heard_leader_s = asyncio.get_running_loop().time()
        self.reset_election_deadline()
        for pid, idx in req.commit_infos:
            self.update_commit_info(RaftPeerId.value_of(pid), idx)

        # Inconsistency check (checkInconsistentAppendEntries:1661).
        if req.previous is not None:
            ti = log.get_term_index(req.previous.index)
            if ti is None and self._snapshot_matches(req.previous):
                ti = req.previous
            if ti is None or ti.term != req.previous.term:
                hint = min(log.next_index, req.previous.index)
                return reply(AppendResult.INCONSISTENCY, max(hint, log.start_index))

        if req.entries:
            old_next = log.next_index
            await log.append_entries_follower(req.entries)
            if log.next_index < old_next:
                state.truncate_configurations(log.next_index)
            for e in req.entries:
                if e.is_config():
                    state.apply_log_entry_configuration(e)
                    self.on_configuration_changed()
            self._engine_update_flush(flush_sink)

        # Follower commit: only up to the frontier THIS request verified
        # against the leader's log (Raft §5.3: min(leaderCommit, index of
        # last new entry); the prev check transitively verifies everything
        # at or below prev).  Capping at flush_index alone is unsafe: it can
        # cover a stale uncommitted tail from an old term that a heartbeat
        # never examined — committing it would commit an entry the current
        # leader is about to truncate away (found by the chaos suite as a
        # follower wedged on 'conflict at committed index').
        covered = (req.entries[-1].index if req.entries
                   else (req.previous.index if req.previous is not None
                         else -1))
        commit = min(req.leader_commit, covered, log.flush_index)
        if log.update_commit_index(commit, state.current_term, False):
            self._apply_wake.set()

        return reply(AppendResult.SUCCESS, log.next_index)

    async def on_bulk_heartbeat(self, leader_id: RaftPeerId, term: int,
                                leader_commit: int, commit_term: int,
                                hibernate: bool = False
                                ) -> tuple[int, int, int, int, int]:
        """One compact heartbeat item (protocol.raftrpc.BulkHeartbeat): the
        idle happy path of handle_append_entries without request building —
        leadership recognition, election-deadline reset, and commit advance
        gated on the Log Matching property (our entry at leader_commit must
        carry commit_term; identical (term, index) implies an identical
        prefix, so committing up to it is exactly as safe as the prev-check
        path).  Anything this cannot verify is left to the full
        AppendEntries probe the leader falls back to.

        Runs under the same _append_lock that serializes
        handle_append_entries: append_entries_follower awaits mid-scan
        (truncate/flush), and a heartbeat from a new-term leader landing in
        that window could change_to_follower and advance the commit index
        over entries the resumed (now stale-leader) append then truncates —
        destroying committed state.  The lock is uncontended on the idle
        happy path this fast-path serves."""
        async with self._append_lock:
            return await self._on_bulk_heartbeat_locked(
                leader_id, term, leader_commit, commit_term, hibernate)

    async def _on_bulk_heartbeat_locked(self, leader_id: RaftPeerId,
                                        term: int, leader_commit: int,
                                        commit_term: int,
                                        hibernate: bool = False
                                        ) -> tuple[int, int, int, int, int]:
        from ratis_tpu_torch.protocol.raftrpc import (BULK_HB_HIBERNATED,
                                                BULK_HB_NOT_LEADER,
                                                BULK_HB_OK)
        state = self.state
        log = state.log
        if term < state.current_term:
            return (BULK_HB_NOT_LEADER, state.current_term, log.next_index,
                    log.get_last_committed_index(), log.flush_index)
        if term > state.current_term or not self.is_follower() \
                or state.leader_id != leader_id:
            await self.change_to_follower(term, leader_id,
                                          reason="bulk heartbeat from leader")
        self._last_heard_leader_s = asyncio.get_running_loop().time()
        self.reset_election_deadline()
        if commit_term > 0 and leader_commit > log.get_last_committed_index():
            ti = log.get_term_index(leader_commit)
            if ti is not None and ti.term == commit_term:
                commit = min(leader_commit, log.flush_index)
                if log.update_commit_index(commit, state.current_term, False):
                    self._apply_wake.set()
        if hibernate:
            # Idle-group quiescence: the leader asks to stop heartbeating.
            # Accept only when fully synced with the leader's commit
            # frontier — the item carries real commit info, so a lagging
            # follower catches up right here and accepts on a later sweep;
            # otherwise the armed timer makes the leader keep heartbeating.
            # Accepting arms the long BACKSTOP deadline (not a full disarm):
            # the sleeping leader's slow tick keeps refreshing it, so a dead
            # leader is detected within ~backstop even with zero client
            # traffic (backstop=0 restores the full disarm).
            if log.get_last_committed_index() >= leader_commit \
                    and log.flush_index >= leader_commit \
                    and self.engine_slot >= 0:
                from ratis_tpu_torch.engine.state import NO_DEADLINE
                if self._hibernate_backstop_s > 0:
                    # clamp: the engine's deadline array is int32 ms, and a
                    # "30d" backstop must degrade to the sentinel (full
                    # disarm), not overflow the store
                    deadline = min(
                        self.server.engine.clock.now_ms() + int(
                            (self._hibernate_backstop_s
                             + self.random_election_timeout_s()) * 1000),
                        NO_DEADLINE)
                else:
                    deadline = NO_DEADLINE
                self.server.engine.on_deadline(self.engine_slot, deadline)
                self._hibernated_follower = True
                return (BULK_HB_HIBERNATED, state.current_term,
                        log.next_index, log.get_last_committed_index(),
                        log.flush_index)
        return (BULK_HB_OK, state.current_term, log.next_index,
                log.get_last_committed_index(), log.flush_index)

    async def handle_install_snapshot(self, req):
        """Follower side of snapshot install: chunked file mode or
        notification mode (SnapshotInstallationHandler.java:60)."""
        from ratis_tpu_torch.protocol.raftrpc import (InstallSnapshotReply,
                                                InstallSnapshotResult)
        await injection.execute(injection.INSTALL_SNAPSHOT, self.member_id,
                                req.header.requestor_id)
        header = RaftRpcHeader(self.member_id.peer_id, req.header.requestor_id,
                               self.group_id)
        state = self.state

        def reply(result, snapshot_index: int = -1):
            return InstallSnapshotReply(header, state.current_term, result,
                                        req.request_index, snapshot_index)

        if req.leader_term < state.current_term:
            return reply(InstallSnapshotResult.NOT_LEADER)
        if req.leader_term > state.current_term or not self.is_follower():
            await self.change_to_follower(req.leader_term,
                                          req.header.requestor_id,
                                          reason="install snapshot from leader")
        self._last_heard_leader_s = asyncio.get_running_loop().time()
        self.reset_election_deadline()

        if req.is_notification():
            # App-managed state transfer (StateMachine.java:293).
            installed = await self.state_machine \
                .notify_install_snapshot_from_leader(
                    None, req.notification_first_available)
            if installed is not None:
                self.state.log.set_snapshot_boundary(installed)
                self.set_applied_index(installed.index)
                return reply(InstallSnapshotResult.SNAPSHOT_INSTALLED,
                             installed.index)
            snap = self.state_machine.get_latest_snapshot()
            if snap is not None and req.notification_first_available is not None \
                    and snap.index + 1 >= req.notification_first_available.index:
                return reply(InstallSnapshotResult.ALREADY_INSTALLED, snap.index)
            return reply(InstallSnapshotResult.IN_PROGRESS)

        try:
            result = await self.snapshot_installer.receive(req)
        except RaftException as e:
            LOG.warning("%s snapshot install failed: %s", self.member_id, e)
            return reply(InstallSnapshotResult.SNAPSHOT_UNAVAILABLE)
        idx = (req.snapshot_term_index.index
               if req.snapshot_term_index is not None else -1)
        return reply(result, idx if result == InstallSnapshotResult.SUCCESS else -1)

    async def handle_read_index(self, req):
        """Leader side of follower-served linearizable reads: confirm
        leadership, return commitIndex (readIndexAsync in the reference)."""
        from ratis_tpu_torch.protocol.raftrpc import ReadIndexReply
        header = RaftRpcHeader(self.member_id.peer_id, req.header.requestor_id,
                               self.group_id)
        if not self.is_leader() or self.leader_ctx is None \
                or self._applied_index < self.leader_ctx.startup_index:
            return ReadIndexReply(header, False)  # not (ready as) leader
        try:
            read_index = await self._leader_read_index()
        except RaftException:
            return ReadIndexReply(header, False)
        return ReadIndexReply(header, True, read_index)

    async def handle_start_leader_election(self, req):
        """Transfer-leadership target: start an immediate (forced) election
        (reference RaftServerImpl.startLeaderElection:1735)."""
        from ratis_tpu_torch.protocol.raftrpc import StartLeaderElectionReply
        header = RaftRpcHeader(self.member_id.peer_id, req.header.requestor_id,
                               self.group_id)
        my_last = self.state.log.get_last_entry_term_index() \
            or TermIndex.INITIAL_VALUE
        if not self.is_follower() or my_last < req.leader_last_entry:
            return StartLeaderElectionReply(header, False)
        await self.change_to_candidate(force=True)
        return StartLeaderElectionReply(header, True)

    def _snapshot_matches(self, ti: TermIndex) -> bool:
        snap = self.state_machine.get_latest_snapshot()
        return snap is not None and snap.term_index == ti

    def snapshot_covers(self, index: int) -> bool:
        snap = self.state_machine.get_latest_snapshot()
        return snap is not None and snap.index >= index

    def snapshot_term_index(self, index: int) -> Optional[TermIndex]:
        snap = self.state_machine.get_latest_snapshot()
        if snap is not None and snap.index == index:
            return snap.term_index
        return None

    async def try_install_snapshot(self, follower: FollowerInfo) -> bool:
        """Follower is behind the purged log: ship the snapshot
        (GrpcLogAppender.installSnapshot:764 / notify:805 decision)."""
        if follower.snapshot_in_progress:
            return False
        follower.snapshot_in_progress = True
        try:
            return await self.snapshot_sender.send_to(follower)
        except Exception:
            LOG.exception("%s snapshot install to %s failed", self.member_id,
                          follower.peer_id)
            return False
        finally:
            follower.snapshot_in_progress = False

    # ------------------------------------------------------------ snapshots

    async def take_snapshot_async(self) -> int:
        """Take a snapshot now and purge the covered log
        (StateMachineUpdater.takeSnapshot:286 + purge:80); also serves the
        client-triggered path (SnapshotManagementRequestHandler)."""
        if self._taking_snapshot:
            return self._last_snapshot_index
        self._taking_snapshot = True
        try:
            with self.sm_metrics.snapshot_timer.time():
                index = await self.state_machine.take_snapshot()
            if index < 0:
                return index
            self._last_snapshot_index = index
            if self._snapshot_retention > 0:
                self.state_machine.get_state_machine_storage() \
                    .clean_old_snapshots(self._snapshot_retention)
            await self.state.log.purge(index)
            return index
        finally:
            self._taking_snapshot = False

    def _should_auto_snapshot(self) -> bool:
        return (self._snapshot_auto
                and self._applied_index - max(self._last_snapshot_index, 0)
                >= self._snapshot_threshold)

    # ------------------------------------------------------- watch frontiers

    def _update_watch_frontiers(self, force: bool = False) -> None:
        """Recompute the four replication-level frontiers
        (LeaderStateImpl.commitIndexChanged:579 + watchRequests.update:986)."""
        if not self.is_leader() or self.leader_ctx is None:
            return
        if not force and self.watch_requests.pending_count() == 0:
            return  # runs on every follower ack; skip the math when idle
        log = self.state.log
        commit = log.get_last_committed_index()
        match_all = [log.flush_index]
        commit_all = [commit]
        commit_voting = [commit]
        conf = self.state.configuration
        for f in self.leader_ctx.followers.values():
            match_all.append(f.match_index)
            commit_all.append(f.commit_index)
            if conf.contains_voting(f.peer_id):
                commit_voting.append(f.commit_index)
        majority_committed = sorted(commit_voting)[(len(commit_voting) - 1) // 2]
        self.watch_requests.update_all_levels(
            majority_commit=commit,
            all_match=min(match_all),
            majority_committed=majority_committed,
            all_committed=min(commit_all))

    # --------------------------------------------------------- leader acks

    def on_follower_ack(self, follower: FollowerInfo,
                        ack_sink: Optional[list] = None) -> None:
        slot = self.peer_slots.get(follower.peer_id)
        if slot is not None and self.engine_slot >= 0:
            if ack_sink is not None:
                # packed intake (sweep mode): the caller feeds the whole
                # reply frame's rows to QuorumEngine.on_ack_batch at once
                ack_sink.append((self.engine_slot, slot,
                                 follower.match_index))
            else:
                self.server.engine.on_ack(self.engine_slot, slot,
                                          follower.match_index)
        if self._upkeep is not None:
            # fold per-ack frontier math into one pass at the next sweep
            # (commit-level watches stay prompt via on_commit_advance_now);
            # same idle gate as _update_watch_frontiers — with no pending
            # watch the numpy mark itself is hot-ack-path overhead
            if self.watch_requests.pending_count():
                self._upkeep.mark_watch_dirty(self.upkeep_slot,
                                              self.upkeep_gen)
        else:
            self._update_watch_frontiers()

    def on_follower_match_regressed(self, follower: FollowerInfo) -> None:
        """A follower provably lost acked entries (volatile-log restart):
        write the lowered match through to the engine mirror so quorum math
        no longer counts the lost entries."""
        slot = self.peer_slots.get(follower.peer_id)
        if slot is not None and self.engine_slot >= 0:
            self.server.engine.regress_match(self.engine_slot, slot,
                                             follower.match_index)

    def check_yield_to_higher_priority(self) -> None:
        """Auto-yield (reference LeaderStateImpl.checkPeersForYieldingLeader
        :1058, run at the checkLeadership cadence): a leader whose current
        conf contains a strictly higher-priority, fully caught-up voting
        peer fires a forced election on it — how setConfiguration priority
        changes move leadership without an explicit transfer."""
        if not self.is_leader() or self.leader_ctx is None \
                or self.stepping_down or self.pending_reconf is not None:
            return
        conf = self.state.configuration
        if conf.is_transitional():
            return
        now = asyncio.get_running_loop().time()
        if now - self._last_yield_attempt_s < self._timeout_min_s:
            return  # give the previous forced election a round to land
        last = self.state.log.next_index - 1
        target = None
        # any caught-up AND LIVE peer above our priority qualifies (highest
        # first) — a crashed top-priority peer must not block yielding to
        # the next one, matching the reference's chooseUpToDateFollower
        # over ALL higher-priority appenders.  Liveness = a reply within
        # one election timeout (an idle log keeps match_index satisfied
        # forever, so match alone can't prove the peer is up).
        live_after = time.monotonic() - self._timeout_max_s
        for p in self.higher_priority_peers():
            f = self.leader_ctx.followers.get(p.id)
            if f is not None and f.match_index >= last \
                    and f.last_rpc_response_s >= live_after:
                target = p
                break
        if target is None:
            return  # none caught up yet; appenders keep catching them up
        self._last_yield_attempt_s = now
        LOG.info("%s yielding leadership to higher-priority %s",
                 self.member_id, target.id)
        self._spawn_bg(self._send_start_leader_election(target.id))

    def higher_priority_peers(self) -> list:
        """Voting peers with priority strictly above ours, highest first
        (shared by auto-yield and the explicit no-target transfer)."""
        conf = self.state.configuration
        me = conf.get_peer(self.member_id.peer_id)
        if me is None:
            return []
        return sorted((p for p in conf.voting_peers()
                       if p.id != me.id and p.priority > me.priority),
                      key=lambda p: -p.priority)

    async def _send_start_leader_election(self, target_id: RaftPeerId) -> None:
        from ratis_tpu_torch.protocol.raftrpc import StartLeaderElectionRequest
        hdr = RaftRpcHeader(self.member_id.peer_id, target_id, self.group_id)
        last_ti = self.state.log.get_last_entry_term_index()
        try:
            await self.server.send_server_rpc(
                target_id, StartLeaderElectionRequest(hdr, last_ti))
        except Exception as e:
            LOG.warning("%s startLeaderElection to %s failed: %s",
                        self.member_id, target_id, e)

    def check_follower_slowness(self, follower: FollowerInfo) -> None:
        """Leader-side slow-follower detection (reference
        RaftServerImpl.checkSlowness via LogAppenderBase + StateMachine
        .notifyFollowerSlowness, StateMachine.java:247): if a follower has
        not responded for Rpc.slowness_timeout, tell the state machine —
        at most once per timeout period per follower."""
        if self._slowness_timeout_s <= 0 or follower.snapshot_in_progress:
            # A follower taking a (possibly long) snapshot install is busy,
            # not slow; its chunk replies refresh last_rpc_response_s anyway.
            return
        now = time.monotonic()
        elapsed = now - follower.last_rpc_response_s
        if elapsed < self._slowness_timeout_s:
            self._slowness_notified.pop(follower.peer_id, None)
            return
        last = self._slowness_notified.get(follower.peer_id, 0.0)
        if now - last < self._slowness_timeout_s:
            return
        self._slowness_notified[follower.peer_id] = now
        peer = self.state.configuration.get_peer(follower.peer_id)
        self._spawn_bg(self.state_machine.notify_follower_slowness(
            self.role_info(), peer))

    def role_info(self):
        """A RoleInfoProto analog handed to StateMachine notifications
        (reference RoleInfoProto, Raft.proto:537)."""
        return {
            "peer_id": str(self.member_id.peer_id),
            "group_id": str(self.group_id),
            "role": self.role.name,
            "term": self.state.current_term,
            "leader_id": (str(self.state.leader_id)
                          if self.state.leader_id is not None else None),
        }

    def on_follower_heartbeat_ack(self, follower: FollowerInfo,
                                  ack_sink: Optional[list] = None) -> None:
        slot = self.peer_slots.get(follower.peer_id)
        if slot is not None and self.engine_slot >= 0:
            # routed as an ack event (match=-1 never regresses the scatter-
            # max) so the device-resident copy sees it without a row refresh
            if ack_sink is not None:
                ack_sink.append((self.engine_slot, slot, -1))
            else:
                self.server.engine.on_ack(self.engine_slot, slot, -1)
        # Heartbeat replies piggyback follower commitIndex: the *_COMMITTED
        # watch frontiers advance on them even with no new matches.
        if self._upkeep is not None:
            if self.watch_requests.pending_count():
                self._upkeep.mark_watch_dirty(self.upkeep_slot,
                                              self.upkeep_gen)
        else:
            self._update_watch_frontiers()

    # ------------------------------------------------- configuration change

    def on_configuration_changed(self) -> None:
        """Re-sync slots/masks/appenders after the effective conf changed
        (leader append, follower append, truncate rollback)."""
        self._assign_peer_slots()
        self._sync_conf_to_engine()
        self._ci_cache = None  # membership changed: rebuild commit infos
        # Listener promoted to voting member: voting rights begin as soon as
        # the conf entry is in the log (Raft uses a conf once appended);
        # demotion waits for commit (see _on_conf_entry_applied).
        if self.is_listener() and self.state.configuration.contains_voting(
                self.member_id.peer_id):
            self.role = RaftPeerRole.FOLLOWER
            self._engine_set_role(ROLE_FOLLOWER)
            self.reset_election_deadline()
        if self.is_leader() and self.leader_ctx is not None:
            ctx = self.leader_ctx
            next_index = self.state.log.next_index
            wanted = {p.id for p in self.state.configuration.all_peers()
                      if p.id != self.member_id.peer_id}
            for pid in wanted:
                if pid not in ctx.followers:
                    ctx.add_follower(pid, next_index)
            for pid in list(ctx.followers):
                if pid not in wanted:
                    # keep staged (pre-conf) followers; drop removed members
                    if self.pending_reconf is None:
                        asyncio.ensure_future(ctx.remove_follower(pid))

    def add_peer_for_staging(self, peer: RaftPeer) -> None:
        """Bootstrap a brand-new member before it enters the conf
        (LeaderStateImpl BootStrapProgress / addSenders for staging)."""
        assert self.leader_ctx is not None
        self.server.learn_peer_addresses([peer])
        self.leader_ctx.add_follower(peer.id, self.state.log.next_index)

    async def remove_staged_peer(self, peer_id: RaftPeerId) -> None:
        if self.leader_ctx is not None \
                and self.state.configuration.get_peer(peer_id) is None:
            await self.leader_ctx.remove_follower(peer_id)

    async def _on_conf_entry_applied(self, entry: LogEntry) -> None:
        """Leader-side joint-consensus progression: applied JOINT entry ->
        append the stable conf; applied STABLE entry -> complete the pending
        setConfiguration and step down if we were removed
        (reference LeaderStateImpl.updateConfiguration + replyPending)."""
        applied_conf = RaftConfiguration.from_entry(entry)
        state = self.state
        if self.is_leader() and self.leader_ctx is not None:
            if applied_conf.is_transitional():
                cur = state.configuration
                if cur.is_transitional() and cur.log_index == entry.index:
                    log = state.log
                    index = log.next_index
                    stable = RaftConfiguration(applied_conf.conf, None, index)
                    if self.pending_reconf is not None:
                        self.pending_reconf.final_index = index
                    stable_entry = stable.to_entry(state.current_term, index)
                    await log.append_entry(stable_entry)
                    state.apply_log_entry_configuration(stable_entry)
                    self.on_configuration_changed()
                    self._engine_update_flush()
                    self.leader_ctx.notify_appenders()
                return
            # stable conf applied while leading
            if self.pending_reconf is not None \
                    and entry.index == self.pending_reconf.final_index \
                    and not self.pending_reconf.future.done():
                self.pending_reconf.future.set_result(entry.index)
            # drop appenders of members that left (unless a reconf is still
            # staging new peers, whose appenders predate their conf entry)
            if self.pending_reconf is None \
                    or self.pending_reconf.joint_index >= 0:
                wanted = {p.id for p in state.configuration.all_peers()}
                for pid in list(self.leader_ctx.followers):
                    if pid not in wanted:
                        await self.leader_ctx.remove_follower(pid)
        if applied_conf.is_transitional():
            return
        # Role reconciliation against the committed stable conf (every role):
        # a member demoted from the voting set — or removed outright — drops
        # leadership/candidacy only once the conf is committed (Raft §6:
        # a removed leader steps down after C_new is committed).
        me = self.member_id.peer_id
        voting = applied_conf.contains_voting(me)
        in_conf = applied_conf.get_peer(me) is not None
        if not voting and not self.is_listener():
            if self.is_leader() or self.is_candidate():
                await self.change_to_follower(
                    state.current_term, None,
                    reason="no longer a voting member")
            if in_conf:
                # demoted to listener: replicate, never vote or campaign
                self.role = RaftPeerRole.LISTENER
                self._engine_set_role(ROLE_LISTENER)
                if self.engine_slot >= 0:
                    from ratis_tpu_torch.engine.state import NO_DEADLINE
                    self.server.engine.state.election_deadline_ms[
                        self.engine_slot] = NO_DEADLINE
                    self.server.engine.state.mark_dirty(self.engine_slot)

    # ------------------------------------------------------- client path

    def update_commit_info(self, peer_id: RaftPeerId, commit: int) -> None:
        if commit > self._commit_info.get(peer_id, -1):
            self._commit_info[peer_id] = commit
            self._ci_cache = None

    def get_commit_infos(self) -> tuple:
        """Cluster-wide commit picture for client replies
        (reference CommitInfoProto list on RaftClientReply).  Memoized:
        every AppendEntries build and client reply reads this, so rebuilding
        per call would tax the hot replication path."""
        own = self.state.log.get_last_committed_index()
        cache = self._ci_cache
        if cache is not None and cache[0] == own:
            return cache[1]
        from ratis_tpu_torch.protocol.requests import CommitInfo
        self.update_commit_info(self.member_id.peer_id, own)
        known = {p.id for p in self.state.configuration.all_peers()}
        infos = tuple(CommitInfo(pid, idx)
                      for pid, idx in sorted(self._commit_info.items(),
                                             key=lambda kv: kv[0].id)
                      if pid in known)
        wire = tuple((str(c.server), c.commit_index) for c in infos)
        self._ci_cache = (own, infos, wire)
        return infos

    def get_commit_infos_wire(self) -> tuple:
        """(peer_id_str, commit) tuples for the AppendEntries piggyback."""
        self.get_commit_infos()
        return self._ci_cache[2]

    async def submit_client_request(self, req: RaftClientRequest) -> RaftClientReply:
        self.metrics.num_requests.inc()
        if self._hibernating or self._quiet_sweeps:
            self.wake_from_hibernation("client request")
        elif not self.is_leader() and self.engine_slot >= 0:
            # A hibernated group's follower contacted by a client: if the
            # leader is alive, the client's retry TO the leader wakes the
            # group (heartbeats resume and re-arm us), so the FIRST contact
            # only records a nudge.  Only a second contact after a full
            # election timeout of continued silence re-arms the timer —
            # that is the dead-leader case, and the group must become
            # electable again.  Re-arming eagerly would let every client
            # probe of a healthy sleeping group trigger an election.
            if self._hibernated_follower and self.is_follower():
                now = asyncio.get_running_loop().time()
                if self._wake_nudge_s and (now - self._wake_nudge_s
                                           > self._election_timeout_min_s):
                    self._wake_nudge_s = 0.0
                    self.reset_election_deadline()
                elif not self._wake_nudge_s:
                    self._wake_nudge_s = now
        if req.replied_call_ids:
            # piggybacked retry-cache GC (RaftClientImpl.RepliedCallIds)
            self.retry_cache.evict_replied(req.client_id.to_bytes(),
                                           req.replied_call_ids)
        reply = await self._submit_client_request_impl(req)
        if reply is DEFERRED_REPLY:
            # deferred-reply fast path: the fan-out callback attaches the
            # commit infos and hands the real reply to the transport sink
            return reply
        if reply is not None and not reply.commit_infos:
            import dataclasses
            reply = dataclasses.replace(reply,
                                        commit_infos=self.get_commit_infos())
        return reply

    async def _submit_client_request_impl(self, req: RaftClientRequest
                                          ) -> RaftClientReply:
        t = req.type.type
        if t == RequestType.WRITE:
            if req.slider_seq_num >= 0:
                return await self._write_ordered(req)
            return await self._write_async(req)
        if t == RequestType.READ:
            return await self._read_async(req)
        if t == RequestType.STALE_READ:
            return await self._stale_read_async(req)
        if t == RequestType.WATCH:
            return await self._watch_async(req)
        if t == RequestType.MESSAGE_STREAM:
            return await self._message_stream_async(req)
        if t == RequestType.DATA_STREAM:
            # the submit of a completed DataStream rides the write path; the
            # streamed bytes are linked at apply (DataStreamManagement)
            return await self._write_async(req)
        if t == RequestType.SET_CONFIGURATION:
            from ratis_tpu_torch.server import admin
            return await admin.set_configuration(self, req)
        if t == RequestType.TRANSFER_LEADERSHIP:
            from ratis_tpu_torch.server import admin
            return await admin.transfer_leadership(self, req)
        if t == RequestType.SNAPSHOT_MANAGEMENT:
            return await self._snapshot_mgmt_async(req)
        if t == RequestType.LEADER_ELECTION_MANAGEMENT:
            return await self._election_mgmt_async(req)
        if t == RequestType.GROUP_INFO:
            return self._group_info(req)
        return RaftClientReply.failure_reply(
            req, RaftException(f"unsupported request type {t.name}"))

    def _check_leader(self, req: RaftClientRequest) -> Optional[RaftClientReply]:
        if not self.is_leader() or self.leader_ctx is None:
            return RaftClientReply.failure_reply(
                req, NotLeaderException(self.member_id, self.get_leader_peer(),
                                        self.state.configuration.all_peers()))
        if self.stepping_down:
            return RaftClientReply.failure_reply(
                req, LeaderSteppingDownException(
                    f"{self.member_id} is stepping down (leadership transfer)"))
        if not self.leader_ctx.leader_ready.done():
            # Leader until the startup entry commits: retryable not-ready.
            if self._applied_index < self.leader_ctx.startup_index:
                return RaftClientReply.failure_reply(
                    req, LeaderNotReadyException(self.member_id))
        return None

    async def _write_ordered(self, req: RaftClientRequest) -> RaftClientReply:
        """Ordered-async server side (reference
        GrpcClientProtocolService.java:151 + SlidingWindow.Server): requests
        from one client are released to the log-append path strictly in
        seqNum order; the window advances as soon as a request is APPENDED
        (not committed), so ordering costs no pipelining."""
        err = self._check_leader(req)
        if err is not None:
            return err  # fast-fail: only a live leader parks requests
        cid = req.client_id.to_bytes()
        win = self._client_windows.get(cid)
        if win is None:
            from ratis_tpu_torch.util.sliding_window import SlidingWindowServer
            win = SlidingWindowServer(self._ordered_submit,
                                      name=str(req.client_id),
                                      on_drop=self._on_window_drop)
            self._client_windows[cid] = win
        win.last_used = asyncio.get_running_loop().time()
        if self._upkeep is None:
            self._sweep_client_windows()
        else:
            # array mode: no per-write census walk — the plane's CH_WINDOW
            # deadline sweeps once the census crosses the threshold
            self.upkeep_arm_window()
        fut = asyncio.get_running_loop().create_future()
        accepted = await win.receive(req.slider_seq_num, req.slider_first,
                                     (req, fut))
        if not accepted:
            # duplicate of an already-released seq: the retry cache answers
            # it (same call_id as the original execution)
            return await self._write_async(req)
        return await fut

    def _sweep_client_windows(self, force: bool = False) -> None:
        """Idle-window GC: the reference ties window lifetime to the client
        stream; with per-request transports we expire instead."""
        if not force and len(self._client_windows) <= 256:
            return
        now = asyncio.get_running_loop().time()
        for cid, win in list(self._client_windows.items()):
            if win.pending_count() == 0 \
                    and now - getattr(win, "last_used", 0.0) > 120.0:
                del self._client_windows[cid]

    async def _ordered_submit(self, item) -> None:
        """SlidingWindowServer process callback: run the write, but return
        (releasing the next seqNum) as soon as this request has been
        appended to the log — commit/apply completes the reply later."""
        req, fut = item
        submitted = asyncio.get_running_loop().create_future()

        def on_submitted() -> None:
            if not submitted.done():
                submitted.set_result(None)

        async def run() -> None:
            try:
                reply = await self._write_async(req, on_submitted=on_submitted)
                if not fut.done():
                    if reply is not DEFERRED_REPLY:
                        # legacy chain hop #2: this resolution wakes the
                        # parked _write_ordered handler (deferred replies
                        # resolve the handler at APPEND time — off the
                        # commit latency path, so not a commit->reply hop)
                        hop("reply_window")
                    fut.set_result(reply)
            except asyncio.CancelledError:
                # division closing: unblock the handler awaiting fut
                if not fut.done():
                    fut.cancel()
                raise
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
            finally:
                on_submitted()

        self._spawn_bg(run())
        await submitted

    def _on_window_drop(self, item) -> None:
        """A window rebase discarded a parked request whose seq can never be
        released (its client already moved on): resolve the reply future so
        the handler coroutine doesn't leak."""
        req, fut = item
        if not fut.done():
            fut.set_result(RaftClientReply.failure_reply(
                req, RaftException(
                    "superseded: ordered window rebased past this seqNum")))

    def _drain_client_windows(self, exception: Exception) -> None:
        """Step-down/close: fail requests still parked in reorder windows."""
        for win in self._client_windows.values():
            for req, fut in win.drain_parked():
                if not fut.done():
                    fut.set_result(
                        RaftClientReply.failure_reply(req, exception))
        self._client_windows.clear()

    async def _write_async(self, req: RaftClientRequest,
                           on_submitted=None) -> RaftClientReply:
        err = self._check_leader(req)
        if err is not None:
            return err
        # Retry-cache dedupe (RaftServerImpl.submitClientRequestAsync:937):
        # a retried (clientId, callId) — including after failover — waits on
        # the original attempt's reply instead of re-executing.  Loop until we
        # either own a fresh entry or return a completed one: when a failed
        # attempt cancels its entry, exactly ONE concurrent retry wins the
        # replacement entry and re-executes.
        while True:
            cache_entry, is_new = self.retry_cache.get_or_create(
                req.client_id.to_bytes(), req.call_id)
            if is_new:
                self.metrics.retry_cache_miss.inc()
                break
            self.metrics.retry_cache_hit.inc()
            if on_submitted is not None:
                on_submitted()  # the original attempt already appended it
            try:
                return await asyncio.shield(cache_entry.future)
            except asyncio.CancelledError:
                if not cache_entry.future.cancelled():
                    raise  # our caller was cancelled, not the entry

        deliver = None
        sink = reply_sink_of(req) if self._reply_fanout else None
        if sink is not None:
            # Deferred-reply fast path: the tail of this method (cache
            # completion, write-index cache, commit-info piggyback) runs
            # as ONE synchronous callback from the waterline fan-out, and
            # the reply lands in the transport's per-connection batcher —
            # no per-request future-resume chain between commit and wire.
            def deliver(reply, *, _entry=cache_entry, _req=req,
                        _sink=sink):
                import dataclasses  # local like the other reply-path uses
                try:
                    if reply.success:
                        _entry.complete(reply)
                        self.write_index_cache.put(
                            _req.client_id.to_bytes(), reply.log_index)
                    else:
                        self.metrics.num_failed.inc()
                        _entry.fail()  # let a retry re-execute
                    if not reply.commit_infos:
                        reply = dataclasses.replace(
                            reply, commit_infos=self.get_commit_infos())
                    _sink(reply)
                except Exception:
                    LOG.exception("%s deferred reply delivery failed",
                                  self.member_id)
        with self.metrics.write_timer.time():
            try:
                reply = await self._write_impl(req, on_submitted, deliver)
            except asyncio.CancelledError:
                cache_entry.fail()
                raise
            except Exception as e:
                # e.g. RaftLogIOException from a latched-dead log: the cache
                # entry must resolve or every retry of this call_id hangs on
                # its future forever.
                cache_entry.fail()
                self.metrics.num_failed.inc()
                exc = e if isinstance(e, RaftException) \
                    else RaftException(str(e))
                return RaftClientReply.failure_reply(req, exc)
        if reply is DEFERRED_REPLY:
            return reply  # the registered callback owns the tail above
        if not reply.success:
            self.metrics.num_failed.inc()
        if reply.success:
            cache_entry.complete(reply)
            self.write_index_cache.put(req.client_id.to_bytes(),
                                       reply.log_index)
        else:
            cache_entry.fail()  # let a retry re-execute
        return reply

    async def _write_impl(self, req: RaftClientRequest,
                          on_submitted=None, deliver=None) -> RaftClientReply:
        await injection.execute(injection.APPEND_TRANSACTION, self.member_id,
                                req.client_id)
        tid = req.trace_id if TRACER.enabled else 0
        t0 = TRACER.now() if tid else 0
        try:
            trx = await self.state_machine.start_transaction(req)
        except Exception as e:
            return RaftClientReply.failure_reply(
                req, StateMachineException(str(e), cause=e))
        if trx.exception is not None:
            return RaftClientReply.failure_reply(
                req, StateMachineException(str(trx.exception),
                                           cause=trx.exception))
        trx = await self.state_machine.pre_append_transaction(trx)
        if tid:
            TRACER.record(tid, STAGE_TXN, t0, TRACER.now())
        if not self.is_leader() or self.leader_ctx is None:
            # stepped down while the state machine ran: answer NotLeader,
            # which the client retries at the new leader (the leader
            # context is gone, so this write cannot be appended here)
            return RaftClientReply.failure_reply(
                req, NotLeaderException(self.member_id, self.get_leader_peer(),
                                        self.state.configuration.all_peers()))

        log = self.state.log
        index = log.next_index
        entry = make_transaction_entry(self.state.current_term, index,
                                       req.client_id, req.call_id,
                                       trx.log_data or b"",
                                       sm_data=trx.sm_data,
                                       is_datastream=(req.type.type
                                                      == RequestType.DATA_STREAM))
        trx.log_entry = entry
        self.server.transactions[(self.group_id, index)] = trx
        try:
            pending = self.leader_ctx.pending.add(index, req)
        except RaftException as e:
            return RaftClientReply.failure_reply(req, e)
        # Decoupled append (VERDICT r1 item 5): return after the in-memory
        # append; the fsync overlaps the follower RPCs the appenders start
        # right below, and the flush callback advances the engine's
        # flush_index (the leader's self-slot commit input) when it lands.
        if tid:
            t0 = TRACER.now()
        await log.append_entry(entry, wait_flush=False)
        if tid:
            now = TRACER.now()
            TRACER.record(tid, STAGE_APPEND, t0, now)
            self._trace_pending[index] = [tid, now, 0, 0]
        self._engine_update_flush()
        self.leader_ctx.notify_appenders()
        if on_submitted is not None:
            on_submitted()  # appended: the ordered window may release the next
        if deliver is not None:
            # Deferred completion: the waterline fan-out invokes the
            # callback synchronously at commit — this coroutine is done.
            # No awaits sit between the pending registration above and
            # here, so the apply loop cannot have raced the registration.
            def _delivered(reply, *, _idx=index, _tid=tid):
                if _tid:
                    done = self._trace_applied.pop(_idx, None)
                    if done is not None:
                        # apply done -> fan-out delivery: the reply span
                        # is now the (batched) fan-out cost, not a task
                        # resume
                        TRACER.record(_tid, STAGE_REPLY, done[1],
                                      TRACER.now())
                deliver(reply)
            pending.deliver_to(_delivered)
            return DEFERRED_REPLY
        reply = await pending.future
        if tid:
            done = self._trace_applied.pop(index, None)
            if done is not None:
                # apply done -> this coroutine resumed: the reply span is
                # pure future-resolution + event-loop scheduling cost
                TRACER.record(tid, STAGE_REPLY, done[1], TRACER.now())
        return reply

    async def _read_async(self, req: RaftClientRequest) -> RaftClientReply:
        with self.metrics.read_timer.time():
            return await self._read_async_impl(req)

    async def _read_async_impl(self, req: RaftClientRequest) -> RaftClientReply:
        from ratis_tpu_torch.protocol.exceptions import ReadException, ReadIndexException
        linearizable = (self.read_option ==
                        RaftServerConfigKeys.Read.Option.LINEARIZABLE
                        and not req.type.read_nonlinearizable)

        # Read-after-write consistency (reference WriteIndexCache): wait for
        # this client's last write to be applied locally first.
        if req.type.read_after_write_consistent:
            widx = self.write_index_cache.get(req.client_id.to_bytes())
            if widx >= 0:
                try:
                    await self.applied_waiters.wait_applied(
                        widx, self.read_timeout_s)
                except asyncio.TimeoutError:
                    return RaftClientReply.failure_reply(
                        req, ReadException(
                            f"read-after-write: write index {widx} not applied "
                            f"within {self.read_timeout_s}s"))

        if not linearizable:
            err = self._check_leader(req)
            if err is not None:
                return err
            return await self._query(req)

        # Linearizable (Raft §6.4): get a readIndex, wait until applied.
        try:
            if self.is_leader():
                # Leader-ready gate: a fresh leader's commitIndex may lag
                # acknowledged writes until its own-term startup entry
                # commits; serving readIndex before that breaks
                # linearizability.
                err = self._check_leader(req)
                if err is not None:
                    return err
                read_index = await self._leader_read_index()
            else:
                read_index = await self._follower_read_index(req)
            await self.applied_waiters.wait_applied(read_index,
                                                    self.read_timeout_s)
        except RaftException as e:
            return RaftClientReply.failure_reply(req, e)
        except asyncio.TimeoutError:
            return RaftClientReply.failure_reply(
                req, ReadIndexException("read index wait timed out"))
        return await self._query(req)

    async def _query(self, req: RaftClientRequest) -> RaftClientReply:
        try:
            result = await self.state_machine.query(req.message)
        except Exception as e:
            return RaftClientReply.failure_reply(
                req, StateMachineException(str(e), cause=e))
        return RaftClientReply.success_reply(req, message=result,
                                             log_index=self._applied_index)

    async def _leader_read_index(self) -> int:
        """readIndex = commitIndex, after confirming we are still the leader
        (ReadIndexHeartbeats.java:40); the heartbeat round is skipped while
        the lease is valid (LeaderLease.java:36)."""
        from ratis_tpu_torch.protocol.exceptions import ReadIndexException
        if self.leader_ctx is None:
            raise ReadIndexException("not leader")
        read_index = self.state.log.get_last_committed_index()
        if self.lease.enabled and self._lease_valid():
            return read_index
        # Batched confirmation (serving plane): every group with pending
        # reads on this shard shares one zero-entry envelope sweep per
        # destination instead of a per-group heartbeat round.
        serving = getattr(self.server, "serving", None)
        scheduler = getattr(serving, "read_batch", None)
        if scheduler is not None:
            await asyncio.shield(scheduler.confirm(self))
            return read_index
        # Share one in-flight confirmation round among concurrent reads
        # (reference ReadIndexHeartbeats.AppendEntriesListeners:126).
        if self._confirm_inflight is None or self._confirm_inflight.done():
            self._confirm_inflight = asyncio.create_task(
                self._confirm_leadership())
        await asyncio.shield(self._confirm_inflight)
        return read_index

    def _lease_valid(self) -> bool:
        from ratis_tpu_torch.ops import reference as ref
        st = self.server.engine.state
        slot = self.engine_slot
        if slot < 0:
            return False
        expiry = ref.lease_expiry(
            st.last_ack_ms[slot].tolist(), int(st.self_slot[slot]),
            st.conf_cur[slot].tolist(), st.conf_old[slot].tolist(),
            int(self.lease.lease_ms))
        return self.server.engine.clock.now_ms() < expiry

    async def _confirm_leadership(self) -> None:
        """One empty-append round; a majority of acks proves leadership
        (ReadIndexHeartbeats' AppendEntriesListeners:126)."""
        from ratis_tpu_torch.protocol.exceptions import ReadIndexException
        conf = self.state.configuration
        others = [p for p in conf.voting_peers()
                  if p.id != self.member_id.peer_id]
        if not others:
            return
        need = len(conf.voting_peers()) // 2 + 1 - 1  # minus self
        log = self.state.log
        prev = log.get_last_entry_term_index()

        async def _hb(peer):
            req = AppendEntriesRequest(
                RaftRpcHeader(self.member_id.peer_id, peer.id, self.group_id),
                self.state.current_term, prev, (),
                log.get_last_committed_index())
            reply = await self.server.send_server_rpc(peer.id, req)
            return reply.result == AppendResult.SUCCESS \
                or reply.result == AppendResult.INCONSISTENCY

        tasks = [asyncio.create_task(_hb(p)) for p in others]
        acks = 0
        try:
            for fut in asyncio.as_completed(tasks, timeout=self.read_timeout_s):
                try:
                    if await fut:
                        acks += 1
                except Exception:
                    continue
                if acks >= need:
                    return
        except asyncio.TimeoutError:
            pass
        finally:
            for t in tasks:
                t.cancel()
        if acks < need:
            raise ReadIndexException(
                f"leadership not confirmed: {acks}/{need} acks")

    async def _follower_read_index(self, req: RaftClientRequest) -> int:
        """Follower-served linearizable read: ask the leader for a readIndex
        (reference readIndexAsync, RaftServerAsynchronousProtocol)."""
        from ratis_tpu_torch.protocol.exceptions import ReadIndexException
        from ratis_tpu_torch.protocol.raftrpc import ReadIndexRequest
        leader = self.state.leader_id
        if leader is None:
            raise NotLeaderException(self.member_id, None,
                                     self.state.configuration.all_peers())
        rreq = ReadIndexRequest(RaftRpcHeader(self.member_id.peer_id, leader,
                                              self.group_id))
        reply = await self.server.send_server_rpc(leader, rreq)
        if not reply.ok:
            raise ReadIndexException(f"leader {leader} rejected readIndex")
        return reply.read_index

    async def _watch_async(self, req: RaftClientRequest) -> RaftClientReply:
        """Watch an index for a replication level (WatchRequests.java:42)."""
        err = self._check_leader(req)
        if err is not None:
            return err
        # refresh stored frontiers first: the ack-path updates skip while no
        # watches are pending, so they may be stale at registration
        self._update_watch_frontiers(force=True)
        try:
            with self.metrics.watch_timer.time():
                frontier = await self.watch_requests.watch(
                    req.type.watch_index, req.type.watch_replication,
                    req.call_id)
        except RaftException as e:
            return RaftClientReply.failure_reply(req, e)
        return RaftClientReply.success_reply(req, log_index=frontier)

    async def _message_stream_async(self, req: RaftClientRequest) -> RaftClientReply:
        """MessageStream sub-request accumulation
        (RaftServerImpl.messageStreamAsync:1111 + MessageStreamRequests)."""
        err = self._check_leader(req)
        if err is not None:
            return err
        try:
            if not req.type.end_of_request:
                self.message_stream_requests.stream_async(req)
                return RaftClientReply.success_reply(req)
            write_req = \
                self.message_stream_requests.stream_end_of_request_async(req)
        except RaftException as e:
            return RaftClientReply.failure_reply(req, e)
        if write_req is self.message_stream_requests.RETIRED:
            # re-sent end-of-request: the assembled write already ran (or is
            # still replicating); only the retry cache may answer —
            # re-executing with just the final chunk would corrupt the
            # payload.  Await an in-flight original like _write_async does.
            entry = self.retry_cache.get(req.client_id.to_bytes(),
                                         req.call_id)
            if entry is not None and not entry.future.cancelled():
                try:
                    return await asyncio.shield(entry.future)
                except asyncio.CancelledError:
                    if not entry.future.cancelled():
                        raise  # our caller was cancelled, not the entry
            return RaftClientReply.failure_reply(req, StreamException(
                f"stream {req.type.stream_id}: already assembled but the "
                "reply is no longer cached; restart the stream"))
        return await self._write_async(write_req)

    async def _stale_read_async(self, req: RaftClientRequest) -> RaftClientReply:
        min_index = req.type.stale_read_min_index
        if self._applied_index < min_index:
            return RaftClientReply.failure_reply(
                req, StaleReadException(
                    f"applied index {self._applied_index} < requested {min_index}"))
        try:
            result = await self.state_machine.query_stale(req.message, min_index)
        except Exception as e:
            return RaftClientReply.failure_reply(
                req, StateMachineException(str(e), cause=e))
        return RaftClientReply.success_reply(req, message=result,
                                             log_index=self._applied_index)

    # ----------------------------------------------------------- admin ops

    async def _snapshot_mgmt_async(self, req: RaftClientRequest
                                   ) -> RaftClientReply:
        """Client-triggered snapshot create
        (SnapshotManagementRequestHandler): skip when the latest snapshot is
        within the creation gap of the applied index."""
        from ratis_tpu_torch.protocol.admin import SnapshotManagementArguments
        try:
            args = SnapshotManagementArguments.from_payload(req.message.content)
        except Exception as e:
            return RaftClientReply.failure_reply(
                req, RaftException(f"bad snapshotManagement payload: {e}"))
        gap = args.creation_gap
        if gap <= 0:
            gap = self.server.properties.get_int(
                RaftServerConfigKeys.Snapshot.CREATION_GAP_KEY,
                RaftServerConfigKeys.Snapshot.CREATION_GAP_DEFAULT)
        snap = self.state_machine.get_latest_snapshot()
        if snap is not None and self._applied_index - snap.index < gap:
            return RaftClientReply.success_reply(req, log_index=snap.index)
        try:
            index = await self.take_snapshot_async()
        except Exception as e:
            return RaftClientReply.failure_reply(
                req, StateMachineException(str(e), cause=e))
        return RaftClientReply.success_reply(req, log_index=index)

    async def _election_mgmt_async(self, req: RaftClientRequest
                                   ) -> RaftClientReply:
        """Pause/resume this server's candidacy
        (LeaderElectionManagementRequest; RaftServerImpl
        leaderElectionManagementAsync:1285)."""
        from ratis_tpu_torch.protocol.admin import (LeaderElectionManagementArguments,
                                              LeaderElectionManagementOp)
        try:
            args = LeaderElectionManagementArguments.from_payload(
                req.message.content)
        except Exception as e:
            return RaftClientReply.failure_reply(
                req, RaftException(f"bad leaderElectionManagement payload: {e}"))
        if args.op == LeaderElectionManagementOp.PAUSE:
            self._election_paused = True
        else:
            self._election_paused = False
            self.reset_election_deadline()
        return RaftClientReply.success_reply(req)

    def _group_info(self, req: RaftClientRequest) -> RaftClientReply:
        """GroupInfoRequest (reference GroupInfoReply + RoleInfoProto:537)."""
        from ratis_tpu_torch.protocol.admin import GroupInfoReplyData
        conf = self.state.configuration
        data = GroupInfoReplyData(
            group=RaftGroup.value_of(self.group_id, conf.all_peers()),
            role=self.role.name,
            term=self.state.current_term,
            leader_id=str(self.state.leader_id)
            if self.state.leader_id is not None else None,
            commit_index=self.state.log.get_last_committed_index(),
            applied_index=self._applied_index,
            is_leader_ready=(self.leader_ctx is not None
                             and self.leader_ctx.leader_ready.done()))
        return RaftClientReply.success_reply(
            req, message=Message(data.to_payload()),
            log_index=self._applied_index)

    # ----------------------------------------------------------- apply loop

    async def _apply_loop(self) -> None:
        """StateMachineUpdater (reference StateMachineUpdater.java:60): waits
        for the commit index to advance, applies entries in order, completes
        pending client futures."""
        sm = self.state_machine
        while self._running:
            log = self.state.log
            # clear BEFORE the commit check: a wake landing between check
            # and clear would otherwise be lost, and this wait has no
            # timeout (a poll timer per division is real churn at thousands
            # of co-hosted groups)
            self._apply_wake.clear()
            if self._applied_index >= log.get_last_committed_index():
                await self._apply_wake.wait()
            committed = log.get_last_committed_index()
            # Waterline reply fan-out (raft.tpu.replication.reply-fanout):
            # the batch's client waiters are resolved in ONE pass after the
            # applied frontier reaches the waterline, instead of one
            # per-entry wakeup chain each (bounded: an oversized backlog
            # flushes every 64 entries so first replies never wait out a
            # huge catch-up batch).
            batch: Optional[list] = [] if self._reply_fanout else None
            while self._applied_index < committed:
                index = self._applied_index + 1
                entry = log.get(index)
                if entry is None:
                    # purged or not yet local (snapshot install in
                    # progress): back off instead of spinning on the gap
                    if batch:
                        self._flush_reply_batch(batch)
                        batch = []
                    await asyncio.sleep(0.05)
                    break
                await self._apply_one(entry, batch)
                self._applied_index = index
                sm.update_last_applied_term_index(entry.term, entry.index)
                if batch is not None and len(batch) >= 64:
                    self._flush_reply_batch(batch)
                    batch = []
            if batch:
                self._flush_reply_batch(batch)
            self._engine_set_applied()
            self.applied_waiters.advance(self._applied_index)
            log.evict_cache(self._applied_index)
            if self.is_leader() and self.leader_ctx is not None \
                    and not self.leader_ctx.leader_ready.done() \
                    and self._applied_index >= self.leader_ctx.startup_index >= 0:
                self.leader_ctx.leader_ready.set_result(True)
                await sm.notify_leader_ready()
            if self._should_auto_snapshot():
                try:
                    await self.take_snapshot_async()
                except Exception:
                    LOG.exception("%s auto snapshot failed", self.member_id)
            # Sweep expired retry-cache entries on an interval, not per batch.
            import time as _time
            now = _time.monotonic()
            if self._upkeep is not None:
                # array mode: no per-division interval clock — the shared
                # CH_CACHE waterline fires the sweep; this is just the O(1)
                # arm check after a batch may have created the first entry
                self.upkeep_arm_cache(now)
            elif now - self._last_cache_sweep > self.retry_cache.expiry_s / 4:
                self._last_cache_sweep = now
                self.retry_cache.sweep()
                # same cadence for the write-index cache: the lazy get()
                # path never evicts ids that stop querying
                self.write_index_cache.sweep(now)

    def _flush_reply_batch(self, batch: list) -> None:
        """One waterline fan-out pass: resolve every client waiter the
        applied batch completed.  Sink-carrying requests deliver straight
        into their transport's per-connection reply batcher (synchronous
        callback, no task resume); legacy waiters get their futures
        resolved here — either way the whole batch is one scheduled unit,
        not one wakeup chain per request (hops metric site
        ``reply_batch``; span ``server.fanout``)."""
        hop("reply_batch")
        unit = TRACER.open_unit(STAGE_FANOUT) if TRACER.enabled else None
        for pending, exception, message, index in batch:
            try:
                if exception is not None:
                    pending.fail(exception)
                else:
                    pending.set_reply(RaftClientReply.success_reply(
                        pending.request, message=message or Message.EMPTY,
                        log_index=index))
            except Exception:
                LOG.exception("%s reply fan-out failed", self.member_id)
        if unit is not None:
            TRACER.close_unit(unit, len(batch))

    async def _apply_one(self, entry: LogEntry,
                         reply_batch: Optional[list] = None) -> None:
        sm = self.state_machine
        reply_message: Optional[Message] = None
        exception: Optional[Exception] = None
        trace = (self._trace_pending.pop(entry.index, None)
                 if self._trace_pending else None)
        if trace is not None:
            # close the replicate span (append done -> apply starts) and
            # its three waits, which tile it: to the first hand-off to the
            # transport, to the commit, to here (a stamp never taken, or
            # out of order, leaves its wait empty); open the apply span
            t_apply0 = TRACER.now()
            tid, t_append, t_sent, t_commit = trace
            TRACER.record(tid, STAGE_REPLICATE, t_append, t_apply0)
            t_sent = min(max(t_sent, t_append), t_apply0)
            t_commit = min(max(t_commit or t_apply0, t_sent), t_apply0)
            TRACER.record(tid, STAGE_SEND_WAIT, t_append, t_sent)
            TRACER.record(tid, STAGE_QUORUM, t_sent, t_commit)
            TRACER.record(tid, STAGE_APPLY_WAIT, t_commit, t_apply0)
        if entry.kind == LogEntryKind.STATE_MACHINE:
            trx = self.server.transactions.pop((self.group_id, entry.index), None)
            if trx is None or trx.log_entry is None \
                    or trx.log_entry.term_index() != entry.term_index():
                trx = TransactionContext(log_entry=entry)
            # DataStream link (StateMachine.DataApi.link, §3.5): tie the
            # bytes this peer streamed to the committed entry before apply.
            # A replica that holds no local stream for a DATA_STREAM entry
            # (crashed between stream CLOSE and apply, or outside the routing
            # table) still gets data_link(None, entry) so the StateMachine can
            # detect the miss and fetch/repair — the reference passes a null
            # stream for exactly this case.
            if entry.smlog is not None:
                link = None
                if self.server.datastream is not None:
                    link = self.server.datastream.take_link(
                        entry.smlog.client_id, entry.smlog.call_id)
                if link is not None or entry.smlog.is_datastream:
                    try:
                        await sm.data_link(
                            link.local if link is not None else None, entry)
                    except Exception:
                        LOG.exception("%s data_link failed", self.member_id)
            try:
                # applyTransactionSerial runs strictly in log order ahead of
                # applyTransaction (StateMachine.java:565: the serial hook
                # for state machines that parallelize the main apply); the
                # updater daemon here is itself serial, so the pair runs
                # back-to-back per entry in index order.
                trx = await sm.apply_transaction_serial(trx)
                reply_message = await sm.apply_transaction(trx)
                self.sm_metrics.applied_count.inc()
            except Exception as e:
                exception = StateMachineException(str(e), cause=e)
            # Populate the retry cache on EVERY role at apply time so a
            # request retried against the post-failover leader is deduped
            # (reference RetryCacheImpl failover-safe dedupe).
            if entry.smlog is not None and exception is None:
                cache_entry = self.retry_cache.get_or_create_on_apply(
                    entry.smlog.client_id, entry.smlog.call_id)
                from ratis_tpu_torch.protocol.ids import ClientId
                cache_entry.complete(RaftClientReply(
                    ClientId.value_of(entry.smlog.client_id),
                    self.member_id.peer_id, self.group_id,
                    entry.smlog.call_id, True,
                    message=reply_message or Message.EMPTY,
                    log_index=entry.index))
        elif entry.kind == LogEntryKind.CONFIGURATION:
            if self.storage is not None:
                await asyncio.to_thread(self.storage.persist_conf_entry, entry)
            await sm.notify_configuration_changed(
                entry.term, entry.index, self.state.configuration)
            await self._on_conf_entry_applied(entry)
        if self._sm_wants_term_index:
            await sm.notify_term_index_updated(entry.term, entry.index)
        if trace is not None:
            now = TRACER.now()
            TRACER.record(trace[0], STAGE_APPLY, t_apply0, now)
            self._trace_applied[entry.index] = (trace[0], now)

        if self.is_leader() and self.leader_ctx is not None:
            pending = self.leader_ctx.pending.pop(entry.index)
            if pending is not None:
                if reply_batch is not None:
                    # waterline fan-out: the apply loop resolves the whole
                    # batch in one pass (see _flush_reply_batch)
                    reply_batch.append((pending, exception, reply_message,
                                        entry.index))
                elif exception is not None:
                    pending.fail(exception)
                else:
                    pending.set_reply(RaftClientReply.success_reply(
                        pending.request, message=reply_message or Message.EMPTY,
                        log_index=entry.index))
