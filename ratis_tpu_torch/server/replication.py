"""Server-level replication fan-out: one sender per destination server.

The reference runs one LogAppender daemon per (group, follower), each with
its own long-lived stream (ratis-grpc/.../server/GrpcLogAppender.java:70,
343-381) — O(groups) threads and O(groups) RPC streams toward every peer.
That cost shape is exactly what caps the multi-raft axis at thousands of
co-hosted groups.

This module keeps the per-follower window/epoch state machine
(ratis_tpu_torch.server.leader.LogAppender) but replaces the send fabric: ONE
PeerSender task per destination server drains every marked appender's
window fills into a single :class:`AppendEnvelope` RPC per flush (data-path
coalescing), or into a concurrent burst of unary RPCs when coalescing is
disabled (the reference's per-group cost shape, kept as the benchmark
baseline mode).

Ordering: per-group FIFO holds end to end because (a) a group contributes
items to a bounded window of consecutive in-flight frames
(``raft.tpu.replication.window-depth``; depth 1 degenerates to the
one-envelope-at-a-time busy latch), (b) envelopes carry items in collect
order and sequenced frames carry monotonically numbered (lane, seq) pairs,
and (c) the receiver (RaftServer._handle_append_envelope) processes a
lane's frames strictly in sequence and one group's items sequentially in
envelope order.  With depth > 1 the round trip is PIPELINED: the next
frame is cut from the speculatively-advanced next-index while earlier
frames are still in flight, so a commit no longer pays a full RTT of dead
time per group (reference: GrpcLogAppender.java:343-381's per-follower
sliding window, here batched across groups).  Reordering across those
guarantees (e.g. unary mode over a reordering transport) at worst costs a
spurious INCONSISTENCY + windowed rewind — never safety, because match
only advances from request-capped SUCCESS confirmations.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
from typing import NamedTuple, Optional

from ratis_tpu_torch.metrics.hops import hop
from ratis_tpu_torch.protocol.exceptions import TimeoutIOException
from ratis_tpu_torch.protocol.ids import RaftPeerId
from ratis_tpu_torch.protocol.raftrpc import (ENV_OK, AppendEntriesRequest,
                                        AppendEnvelope, AppendResult)
from ratis_tpu_torch.trace.tracer import STAGE_ACK_INTAKE, TRACER

LOG = logging.getLogger(__name__)

# Lane ids are unique per PeerSender LIFETIME (a restarted/recreated sender
# never reuses its predecessor's sequence space at the receiver) and across
# co-hosted processes dialing the same peer under one requestor id after a
# restart (the pid component).
_LANE_IDS = itertools.count(1)
_LANE_BASE = (os.getpid() & 0x7FFFF) << 32


def _new_lane_id() -> int:
    return _LANE_BASE | next(_LANE_IDS)


class _LoopSweep:
    """Per-(event-loop) sweep state: the senders marked due on that loop
    and whether a drain pass is already scheduled.  Only ever touched from
    its own loop's thread."""

    __slots__ = ("due", "armed")

    def __init__(self) -> None:
        self.due: dict["PeerSender", None] = {}
        self.armed = False


def _trace_handoff(items) -> None:
    """replicate.send_wait ends here: stamp the hand-off to the transport
    on every traced write these items carry that no earlier envelope (to
    another follower) carried."""
    for it in items:
        div = it.appender.division
        entries = it.request.entries
        if div._trace_pending and entries:
            div._trace_stamp(entries[0].index, entries[-1].index, 2)


class OutItem(NamedTuple):
    """One collected AppendEntries send: who to notify and with which epoch
    the reply must be matched (stale-epoch replies are dropped by the
    appender, mirroring GrpcLogAppender's resetClient semantics)."""

    appender: object  # leader.LogAppender
    request: AppendEntriesRequest
    epoch: int
    pipelined: bool


class PeerSender:
    """Drains every co-hosted group's pending append batches toward ONE
    destination server.

    A flush collects from all marked appenders (round-robin in mark order,
    bounded by the envelope byte budget) and ships one envelope; up to
    ``inflight_cap`` envelopes may be in flight so one slow envelope never
    head-of-line-blocks other groups' batches.  With
    ``raft.tpu.replication.window-depth`` > 1 (sweep mode + coalescing)
    frames are SEQUENCED on a per-sender lane and a group may ride up to
    depth consecutive in-flight frames — per-group FIFO is enforced by the
    receiver's in-sequence lane intake instead of the busy latch.  Depth 1
    keeps the latch exactly: a group's entries are never split across two
    racing envelopes and frames go out unsequenced (the legacy wire
    shape).
    """

    def __init__(self, server, to: RaftPeerId, *, coalescing: bool,
                 inflight_cap: int, envelope_byte_limit: int,
                 metrics: Optional[dict] = None, sweep: bool = False,
                 scheduler: "Optional[ReplicationScheduler]" = None,
                 window_depth: int = 1):
        self.server = server
        self.to = to
        self.coalescing = coalescing
        self.envelope_byte_limit = envelope_byte_limit
        self.inflight_cap = max(1, inflight_cap)
        # Per-group frame window: only meaningful on the sequenced frame
        # path — sweep + coalescing.  Legacy (sweep=0) and unary modes pin
        # the effective depth at 1 so their paths stay bit-exact.
        self.window_depth = max(1, window_depth)
        self.sequenced = coalescing and sweep and self.window_depth > 1
        self.group_window = self.window_depth if self.sequenced else 1
        if self.sequenced:
            # The lane must hold enough envelope slots for the per-group
            # window to actually fill: with the slot cap at the legacy 4,
            # the depth knob never engages (measured: slots pinned full,
            # occupancy 1.0, zero throughput delta across depths — the
            # envelope window was the binding pipeline, docs/perf.md
            # round 9).  Depth 1 keeps the exact legacy cap.
            self.inflight_cap = min(64,
                                    self.inflight_cap * self.window_depth)
        # lane identity + next frame sequence (sequenced mode): reset to a
        # FRESH lane on any sequenced send failure or receiver reject, so
        # the receiver never waits out a gap that will not fill
        self._lane = _new_lane_id()
        self._seq = 0
        self._frames_out = 0  # envelopes currently in flight (all modes)
        self.metrics = metrics if metrics is not None else {
            "envelopes": 0, "items": 0, "rewinds": 0,
            "windowed_rewinds": 0, "lane_rejects": 0, "lane_resets": 0,
            "win_hwm": 0, "seq_frames": 0}
        self._dirty: dict[object, None] = {}  # insertion-ordered appender set
        self.refs: set = set()  # registered appenders (scheduler-managed)
        # the loop this sender (and every appender feeding it) lives on:
        # with loop sharding there is one sender per (destination, shard),
        # and the scheduler's close() must unwind it on this loop
        self.loop = asyncio.get_running_loop()
        # Sweep mode (raft.tpu.replication.sweep): NO standing flush-loop
        # task — marks register this sender with the scheduler's per-loop
        # sweep, and one scheduled drain pass collects across every due
        # sender on the loop.  sweep=0 keeps the per-sender wake-event
        # flush loop exactly as before.
        self.sweep = sweep
        self.scheduler = scheduler
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        if sweep:
            self._slots = None
            self._slots_free = self.inflight_cap
        else:
            self._slots = asyncio.Semaphore(self.inflight_cap)
            self._slots_free = 0
        self._running = True
        self._inflight_tasks: set[asyncio.Task] = set()
        if not sweep:
            self._task = asyncio.create_task(
                self._run(), name=f"sender-{server.peer_id}->{to}")

    # -- intake ---------------------------------------------------------------

    def mark(self, appender) -> None:
        """Register an appender as having (potential) work toward this
        destination and wake the flush loop (legacy) or arm the loop's
        cross-group sweep pass (sweep mode)."""
        self._dirty[appender] = None
        if self.sweep:
            if self._running:
                self.scheduler.arm_sweep(self)
        else:
            if not self._wake.is_set():
                hop("sender_wake")
            self._wake.set()

    def unmark(self, appender) -> None:
        self._dirty.pop(appender, None)

    # -- sequenced lane bookkeeping -------------------------------------------

    @property
    def frames_in_flight(self) -> int:
        """Envelopes currently awaiting their reply (window-state gauge)."""
        return self._frames_out

    def _next_frame(self) -> tuple[int, int]:
        """(lane, seq) for the envelope being dispatched — assigned in
        collect order on this sender's loop, so lane sequence == intended
        send order; also tracks the in-flight frame count and its
        high-water mark (the bench's window-occupancy artifact)."""
        self._frames_out += 1
        m = self.metrics
        if self._frames_out > m.get("win_hwm", 0):
            m["win_hwm"] = self._frames_out
        if not self.sequenced:
            return 0, -1
        m["seq_frames"] = m.get("seq_frames", 0) + 1
        seq = self._seq
        self._seq += 1
        return self._lane, seq

    def _reset_lane(self) -> None:
        """A sequenced frame failed to reach (or was refused by) the
        receiver: its lane now has a hole that will never fill, so every
        later frame of the lane would be rejected.  Re-cut on a FRESH lane
        — the receiver starts a new in-sequence intake at seq 0 and the
        dead lane's state ages out of its bounded table."""
        if self.sequenced:
            self._lane = _new_lane_id()
            self._seq = 0
            self.metrics["lane_resets"] = \
                self.metrics.get("lane_resets", 0) + 1

    # -- sweep mode: scheduler-driven drain pass ------------------------------

    def sweep_collect(self) -> None:
        """One drain pass over this sender's dirty appenders (called from
        the scheduler's per-loop sweep).  Collects multi-group envelopes
        until the dirty set or the in-flight slots run out; with the
        in-flight cap reached, the remaining dirty appenders keep their
        marks and the slot release re-arms the sweep."""
        server = self.server
        while self._running and self._dirty and self._slots_free > 0:
            items: list[OutItem] = []
            budget = self.envelope_byte_limit
            while self._dirty and budget > 0:
                a = next(iter(self._dirty))
                del self._dirty[a]
                try:
                    got = a.collect(items, budget)
                    budget -= got
                    if got and self.sequenced and a.has_backlog():
                        # the byte budget cut this group's fill short and
                        # its frame window still has room: keep it due so
                        # THIS drain pass cuts its next frame too (the
                        # pipelined fill; gated on progress, so a
                        # backoff/prefault collect can never spin)
                        self._dirty[a] = None
                except Exception:
                    LOG.exception("%s->%s collect failed for %s",
                                  server.peer_id, self.to, a)
            if not items:
                return
            self.metrics["envelopes"] += 1
            self.metrics["items"] += len(items)
            if self.coalescing:
                self._slots_free -= 1
                lane, seq = self._next_frame()
                t = asyncio.create_task(self._send(items, lane, seq))
                self._inflight_tasks.add(t)
                t.add_done_callback(self._inflight_tasks.discard)
            else:
                # reference cost shape, swept: the drain pass is shared but
                # each collected batch still ships as its own unary RPC
                # with per-reply window refill (see _run's unary branch)
                for it in items:
                    it.appender.envelope_done(remark=False)
                    t = asyncio.create_task(self._send_unary(it))
                    self._inflight_tasks.add(t)
                    t.add_done_callback(self._inflight_tasks.discard)

    def _release_slot(self) -> None:
        self._frames_out = max(0, self._frames_out - 1)
        if self.sweep:
            self._slots_free += 1
            if self._dirty and self._running:
                self.scheduler.arm_sweep(self)
        else:
            self._slots.release()

    # -- flush loop -----------------------------------------------------------

    async def _run(self) -> None:
        server = self.server
        while self._running:
            if not self._dirty:
                self._wake.clear()
                if not self._dirty:  # re-check: mark may race the clear
                    await self._wake.wait()
                # Micro-batch: let the in-progress scheduling burst (many
                # groups appending in the same loop pass) finish marking
                # before collecting, so the burst folds into one envelope
                # instead of a first tiny one + a big one.
                await asyncio.sleep(0)
                continue
            await self._slots.acquire()
            if not self._running:
                self._slots.release()
                return
            items: list[OutItem] = []
            budget = self.envelope_byte_limit
            while self._dirty and budget > 0:
                a = next(iter(self._dirty))
                del self._dirty[a]
                try:
                    budget -= a.collect(items, budget)
                except Exception:
                    LOG.exception("%s->%s collect failed for %s",
                                  server.peer_id, self.to, a)
            if not items:
                self._slots.release()
                continue
            self.metrics["envelopes"] += 1
            self.metrics["items"] += len(items)
            if self.coalescing:
                lane, seq = self._next_frame()
                t = asyncio.create_task(self._send(items, lane, seq))
                self._inflight_tasks.add(t)
                t.add_done_callback(self._inflight_tasks.discard)
            else:
                # Reference cost shape: one independent unary RPC task per
                # batch, window refilled per reply — NO flush barrier, so
                # this baseline mode keeps exactly the old per-appender
                # pipelining behavior (a slow RPC never stalls the rest of
                # the flush's items, and the benchmark's vs_baseline
                # compares against an unhandicapped per-group path).
                for it in items:
                    it.appender.envelope_done(remark=False)
                    t = asyncio.create_task(self._send_unary(it))
                    self._inflight_tasks.add(t)
                    t.add_done_callback(self._inflight_tasks.discard)
                self._slots.release()

    async def _send_unary(self, it: OutItem) -> None:
        """Baseline (coalescing-disabled) path: one RPC per collected batch,
        reply dispatched independently — the reference's per-(group,
        follower) send shape."""
        if TRACER.enabled:
            _trace_handoff((it,))
        try:
            reply = await self.server.send_server_rpc(self.to, it.request)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            it.appender.on_send_error(it, e)
            return
        try:
            await it.appender.on_send_reply(it, reply)
        except Exception:
            LOG.exception("%s->%s unary reply dispatch failed",
                          self.server.peer_id, self.to)
        finally:
            it.appender.notify()  # refill the window per reply
            if not self.sweep:
                self._wake.set()

    async def _send(self, items: list[OutItem], lane: int = 0,
                    seq: int = -1) -> None:
        server = self.server
        replies: list = []
        error: Optional[Exception] = None
        remark = True
        # Packed ack intake (sweep mode): every SUCCESS reply in this
        # envelope contributes one [slot, peer_slot, match] row here
        # instead of a scalar QuorumEngine.on_ack call, and the whole
        # frame batch enters the engine under ONE intake-lock round-trip.
        ack_rows: Optional[list] = [] if self.sweep else None
        unit = None
        # One outer try/finally owns the latch + slot: ANY exit (including
        # cancellation from a source other than close(), which used to skip
        # the slot release and wedge the sender after inflight_cap events)
        # releases the envelope slot and the appenders' busy latch.
        try:
            if TRACER.enabled:
                _trace_handoff(items)
            try:
                if seq >= 0:
                    # sequenced lane frame: even a single-item flush must
                    # ride the lane — the group may have another frame in
                    # flight, and only the receiver's in-sequence intake
                    # keeps the two ordered
                    env = AppendEnvelope(
                        tuple(it.request for it in items), lane, seq)
                    reply = await server.send_server_rpc(self.to, env)
                    if reply.status != ENV_OK:
                        # the receiver refused the frame unprocessed
                        # (sequence hole / stale duplicate): drop the
                        # lane's unacked frames, re-cut fresh
                        self.metrics["lane_rejects"] = \
                            self.metrics.get("lane_rejects", 0) + 1
                        if lane == self._lane:
                            self._reset_lane()
                        raise TimeoutIOException(
                            f"{self.to} refused lane frame seq={seq} "
                            f"(expects {reply.hint})")
                    replies = list(reply.items)
                    if len(replies) != len(items):
                        raise TimeoutIOException(
                            "envelope reply length mismatch")
                elif len(items) > 1:
                    env = AppendEnvelope(tuple(it.request for it in items))
                    reply = await server.send_server_rpc(self.to, env)
                    replies = list(reply.items)
                    if len(replies) != len(items):
                        raise TimeoutIOException(
                            "envelope reply length mismatch")
                else:
                    replies = [await server.send_server_rpc(
                        self.to, items[0].request)]
            except asyncio.CancelledError:
                remark = False
                raise
            except Exception as e:
                error = e
                if seq >= 0 and lane == self._lane:
                    # the frame may never have reached the receiver: later
                    # frames of this lane would stall on the hole — re-cut
                    self._reset_lane()
            # leader.ack_intake: the reply frame's acks landing (tag =
            # the items it answered)
            if TRACER.enabled:
                unit = TRACER.open_unit(STAGE_ACK_INTAKE)
            for i, it in enumerate(items):
                rep = error if error is not None else replies[i]
                try:
                    if isinstance(rep, asyncio.CancelledError):
                        continue
                    if rep is None:
                        rep = TimeoutIOException(
                            f"{self.to} failed this group's append")
                    if ack_rows and (isinstance(rep, Exception)
                                     or rep.result != AppendResult.SUCCESS):
                        # Ordering guard: a non-SUCCESS dispatch can
                        # REGRESS a follower's match (INCONSISTENCY after
                        # a volatile-log restart, via regress_match) — the
                        # rows buffered so far must enter the engine FIRST
                        # or the later batch apply would scatter-max a
                        # stale ack back over the regression.  Exactly the
                        # scalar path's interleaving, batched between
                        # anomalies (which are rare on the hot path).
                        server.engine.on_ack_batch(ack_rows)
                        ack_rows = []
                    if isinstance(rep, Exception):
                        it.appender.on_send_error(it, rep)
                    else:
                        await it.appender.on_send_reply(it, rep, ack_rows)
                except Exception:
                    LOG.exception("%s->%s reply dispatch failed",
                                  server.peer_id, self.to)
            if ack_rows:
                server.engine.on_ack_batch(ack_rows)
        finally:
            if unit is not None:
                TRACER.close_unit(unit, len(items))
            for a in {it.appender for it in items}:
                a.envelope_done(remark=remark)
            self._release_slot()
            if not self.sweep:
                self._wake.set()

    async def close(self) -> None:
        self._running = False
        self._wake.set()
        # close() can be reached from INSIDE one of this sender's own
        # inflight _send tasks (reply dispatch -> change_to_follower ->
        # appender.stop -> scheduler.release): never cancel-and-await the
        # task we are currently running in.
        cur = asyncio.current_task()
        tasks = [t for t in (self._task, *self._inflight_tasks)
                 if t is not None and t is not cur]
        self._inflight_tasks.clear()
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass


class ReplicationScheduler:
    """Owns one PeerSender per destination this server replicates toward
    (created lazily; peers are few even when groups are many)."""

    def __init__(self, server, *, coalescing: bool, inflight_cap: int,
                 envelope_byte_limit: int, sweep: bool = False,
                 window_depth: int = 1):
        self.server = server
        self.coalescing = coalescing
        self.inflight_cap = max(1, inflight_cap)
        self.envelope_byte_limit = envelope_byte_limit
        # Sequenced append-window pipelining
        # (raft.tpu.replication.window-depth): frames-per-group window on
        # every sender; 1 = the latched stop-and-wait-per-group protocol
        self.window_depth = max(1, window_depth)
        # hook: called once per NEW destination (server registers its
        # per-destination window gauges through this)
        self.on_destination = None
        self._known_dests: set[RaftPeerId] = set()
        # Cross-group append sweeps (raft.tpu.replication.sweep): marks
        # arm ONE drain pass per (loop, burst) that collects due
        # AppendEntries across every destination's dirty appenders on
        # that loop, replacing the per-sender wake->collect->schedule
        # flush-loop wakeups.  Off (0) = the per-request legacy path.
        self.sweep = sweep
        # loop key -> _LoopSweep; each entry is only touched from its own
        # loop's thread (marks and drain passes are loop-affine)
        self._sweeps: dict[int, _LoopSweep] = {}
        # keyed by (destination, calling loop): with loop sharding each
        # shard gets its own sender per destination — its flush task and
        # outbound connection live on the shard's loop, so one shard's
        # flush never queues behind another's (unsharded: one loop, one
        # sender per destination, exactly the old shape)
        self._senders: dict[tuple, PeerSender] = {}
        self._closed = False
        # shared across senders: folding evidence for tests/benchmarks;
        # "rewinds" counts INCONSISTENCY-triggered window resets (the
        # reorder churn the keyed-FIFO gRPC dispatch exists to prevent —
        # ADVICE r5; incremented by LogAppender._on_reply);
        # "windowed_rewinds" the subset taken while >1 frame of the group
        # was in flight (the pipelined rewind path); "lane_rejects" /
        # "lane_resets" the sequenced-lane recovery events; "win_hwm" the
        # frames-in-flight high-water mark across senders (bench window
        # occupancy = win_hwm / inflight_cap)
        self.metrics = {"envelopes": 0, "items": 0, "rewinds": 0,
                        "windowed_rewinds": 0, "lane_rejects": 0,
                        "lane_resets": 0, "win_hwm": 0, "seq_frames": 0}

    @staticmethod
    def codec_stats() -> dict:
        """Snapshot of the encode-once fast path's counters
        (protocol.raftrpc.FANOUT_STATS): how often the spliced append
        encoder ran, how often a fan-out suffix was reused, and whether
        anything fell back to the generic packer."""
        from ratis_tpu_torch.protocol.raftrpc import FANOUT_STATS
        return dict(FANOUT_STATS)

    @staticmethod
    def _loop_key() -> int:
        try:
            return id(asyncio.get_running_loop())
        except RuntimeError:
            return 0

    def sender_for(self, to: RaftPeerId) -> PeerSender:
        key = (to, self._loop_key())
        s = self._senders.get(key)
        if s is None:
            if self._closed:
                raise RuntimeError("replication scheduler closed")
            s = PeerSender(self.server, to, coalescing=self.coalescing,
                           inflight_cap=self.inflight_cap,
                           envelope_byte_limit=self.envelope_byte_limit,
                           metrics=self.metrics, sweep=self.sweep,
                           scheduler=self, window_depth=self.window_depth)
            self._senders[key] = s
            if to not in self._known_dests:
                self._known_dests.add(to)
                if self.on_destination is not None:
                    try:
                        self.on_destination(to)
                    except Exception:
                        LOG.exception("on_destination hook failed for %s",
                                      to)
        return s

    # -- window state (gauges / watchdog) -------------------------------------

    @property
    def lane_slots(self) -> int:
        """Envelope slots per (destination, loop-shard) lane — the
        configured inflight cap, scaled by window-depth on the sequenced
        path (matches PeerSender's own computation; the bench's
        window-occupancy denominator)."""
        if self.coalescing and self.sweep and self.window_depth > 1:
            return min(64, self.inflight_cap * self.window_depth)
        return self.inflight_cap

    def frames_in_flight(self, to: Optional[RaftPeerId] = None) -> int:
        """Envelopes in flight toward ``to`` (all destinations when None),
        summed across loop-shard senders."""
        return sum(s.frames_in_flight for (d, _), s in self._senders.items()
                   if to is None or d == to)

    def window_occupancy(self, to: Optional[RaftPeerId] = None) -> float:
        """frames-in-flight / envelope-slot capacity toward ``to``."""
        senders = [s for (d, _), s in self._senders.items()
                   if to is None or d == to]
        cap = sum(s.inflight_cap for s in senders)
        if not cap:
            return 0.0
        return round(sum(s.frames_in_flight for s in senders) / cap, 4)

    # -- sweep mode: one drain pass per (loop, burst) -------------------------

    def arm_sweep(self, sender: PeerSender) -> None:
        """Register ``sender`` as due and schedule at most ONE drain pass
        on its loop for the current scheduling burst.  All marks issued in
        the same event-loop pass — however many groups and destinations —
        fold into that single callback; call_soon runs it after the
        in-progress burst finishes marking, the same micro-batching the
        per-sender flush loop got from its post-wake ``sleep(0)``."""
        key = self._loop_key()
        st = self._sweeps.get(key)
        if st is None:
            st = self._sweeps[key] = _LoopSweep()
        st.due[sender] = None
        if not st.armed:
            st.armed = True
            hop("sender_wake")
            sender.loop.call_soon(self._sweep_pass, st)

    def _sweep_pass(self, st: _LoopSweep) -> None:
        st.armed = False
        due, st.due = st.due, {}
        for sender in due:
            try:
                sender.sweep_collect()
            except Exception:
                LOG.exception("replication sweep pass failed for %s",
                              sender.to)

    def acquire(self, to: RaftPeerId, appender) -> PeerSender:
        """sender_for + register ``appender`` as a user; pair with
        :meth:`release` so a sender (and its standing flush-loop task) is
        retired when its last appender goes away under membership churn."""
        s = self.sender_for(to)
        s.refs.add(appender)
        return s

    async def release(self, to: RaftPeerId, appender) -> None:
        # appenders acquire and release on their own (shard) loop, so the
        # loop key resolves to the same sender acquire() returned
        key = (to, self._loop_key())
        s = self._senders.get(key)
        if s is None:
            return
        s.refs.discard(appender)
        s.unmark(appender)
        if not s.refs:
            self._senders.pop(key, None)
            await s.close()

    async def close(self) -> None:
        self._closed = True
        senders = list(self._senders.values())
        self._senders.clear()
        try:
            current = asyncio.get_running_loop()
        except RuntimeError:
            current = None
        for s in senders:
            if s.loop is current:
                await s.close()
            elif s.loop.is_running():
                # shard-owned sender: unwind it on its own loop (its tasks
                # and wake event are loop-affine)
                try:
                    await asyncio.wrap_future(
                        asyncio.run_coroutine_threadsafe(s.close(), s.loop))
                except Exception:
                    LOG.exception("cross-loop sender close failed for %s",
                                  s.to)
            else:
                # owner loop already gone (test teardown): its tasks can
                # never resume — best-effort cancel, nothing to await
                s._running = False
                for t in (s._task, *s._inflight_tasks):
                    if t is not None:
                        t.cancel()
                s._inflight_tasks.clear()
