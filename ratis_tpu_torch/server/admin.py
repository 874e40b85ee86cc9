"""Server-side admin operations: membership change and leadership transfer.

Capability parity with the reference's reconfiguration pipeline
(RaftServerImpl.setConfigurationAsync:1322, LeaderStateImpl
startSetConfiguration/checkStaging:828/applyOldNewConf:586, joint consensus
per RaftConfigurationImpl) and TransferLeadership
(ratis-server/.../impl/TransferLeadership.java:47).

Flow of a setConfiguration on the leader:
1. validate (leader, no conf change in flight, mode precondition);
2. STAGE: brand-new peers get log appenders *before* entering the conf
   (BootStrapProgress); wait until each is within the staging catch-up gap
   of the leader's last index;
3. append the JOINT entry (new conf + old conf) — quorum checks now require
   majorities in BOTH confs (the engine gets two masks);
4. when the joint entry is APPLIED, the leader appends the stable new-conf
   entry (reference appends it on commit of the old-new entry);
5. when the stable entry is applied, the pending request completes; a leader
   that is not in the new conf steps down (reference yields leadership).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Optional

from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
from ratis_tpu_torch.protocol.admin import (SetConfigurationArguments,
                                      SetConfigurationMode,
                                      TransferLeadershipArguments)
from ratis_tpu_torch.protocol.exceptions import (LeaderSteppingDownException,
                                           RaftException,
                                           ReconfigurationInProgressException,
                                           TransferLeadershipException)
from ratis_tpu_torch.protocol.message import Message
from ratis_tpu_torch.protocol.peer import RaftPeer
from ratis_tpu_torch.protocol.requests import RaftClientReply, RaftClientRequest
from ratis_tpu_torch.server.config import PeerConfiguration, RaftConfiguration

LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class PendingReconf:
    """One in-flight setConfiguration (single-flight per group)."""

    joint_index: int = -1
    final_index: int = -1
    future: asyncio.Future = dataclasses.field(
        default_factory=lambda: asyncio.get_running_loop().create_future())

    def __post_init__(self):
        # The waiter may have timed out before a late failure is recorded;
        # retrieve the exception so the loop never logs it as unhandled.
        self.future.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None)


def _merge_new_conf(conf: RaftConfiguration,
                    args: SetConfigurationArguments
                    ) -> tuple[tuple[RaftPeer, ...], tuple[RaftPeer, ...]]:
    """Compute (voting, listeners) of the requested new conf per mode."""
    cur_v = {p.id: p for p in conf.conf.peers}
    cur_l = {p.id: p for p in conf.conf.listeners}
    if args.mode in (SetConfigurationMode.SET_UNCONDITIONALLY,
                     SetConfigurationMode.COMPARE_AND_SET):
        if args.mode == SetConfigurationMode.COMPARE_AND_SET:
            expected = {p.id for p in args.current_peers}
            if expected != set(cur_v):
                raise RaftException(
                    f"COMPARE_AND_SET precondition failed: current voting "
                    f"members {sorted(str(i) for i in cur_v)} != expected "
                    f"{sorted(str(i) for i in expected)}")
        return tuple(args.peers), tuple(args.listeners)
    if args.mode == SetConfigurationMode.ADD:
        for p in args.peers:
            cur_v[p.id] = p
            cur_l.pop(p.id, None)
        for p in args.listeners:
            cur_l[p.id] = p
            cur_v.pop(p.id, None)
        return tuple(cur_v.values()), tuple(cur_l.values())
    if args.mode == SetConfigurationMode.REMOVE:
        for p in (*args.peers, *args.listeners):
            cur_v.pop(p.id, None)
            cur_l.pop(p.id, None)
        return tuple(cur_v.values()), tuple(cur_l.values())
    raise RaftException(f"unknown mode {args.mode}")


def _same_membership(conf: RaftConfiguration, voting, listeners) -> bool:
    return (conf.is_stable()
            and set(conf.conf.peers) == set(voting)
            and set(conf.conf.listeners) == set(listeners))


async def set_configuration(div, req: RaftClientRequest) -> RaftClientReply:
    """The leader-side reconfiguration driver (see module docstring)."""
    err = div._check_leader(req)
    if err is not None:
        return err
    try:
        args = SetConfigurationArguments.from_payload(req.message.content)
    except Exception as e:
        return RaftClientReply.failure_reply(
            req, RaftException(f"bad setConfiguration payload: {e}"))

    state = div.state
    conf = state.configuration
    if div.pending_reconf is not None or conf.is_transitional():
        return RaftClientReply.failure_reply(
            req, ReconfigurationInProgressException(
                f"{div.member_id}: a configuration change is in progress"))
    try:
        voting, listeners = _merge_new_conf(conf, args)
    except RaftException as e:
        return RaftClientReply.failure_reply(req, e)
    if not voting:
        return RaftClientReply.failure_reply(
            req, RaftException("new configuration has no voting member"))
    if _same_membership(conf, voting, listeners):
        return RaftClientReply.success_reply(req, log_index=conf.log_index)

    pending = PendingReconf()
    div.pending_reconf = pending
    staged: list[RaftPeer] = []
    try:
        # -- stage brand-new members (BootStrapProgress) -------------------
        known = {p.id for p in conf.all_peers()}
        new_members = [p for p in (*voting, *listeners) if p.id not in known]
        for p in new_members:
            div.add_peer_for_staging(p)
            staged.append(p)
        if new_members:
            await _wait_caught_up(div, new_members, req.timeout_ms / 1000.0)

        if not div.is_leader() or div.leader_ctx is None:
            raise RaftException("lost leadership during staging")

        # -- append the joint entry ---------------------------------------
        log = state.log
        index = log.next_index
        joint = RaftConfiguration(
            PeerConfiguration(tuple(voting), tuple(listeners)),
            old_conf=conf.conf, log_index=index)
        pending.joint_index = index
        entry = joint.to_entry(state.current_term, index)
        await log.append_entry(entry)
        state.apply_log_entry_configuration(entry)
        div.on_configuration_changed()
        div._engine_update_flush()
        div.leader_ctx.notify_appenders()

        # -- wait for the stable entry to be applied (set by the apply-loop
        #    hook, Division._on_conf_entry_applied) ------------------------
        timeout_s = max(req.timeout_ms / 1000.0, 1.0)
        reply_index = await asyncio.wait_for(
            asyncio.shield(pending.future), timeout_s)
        return RaftClientReply.success_reply(req, log_index=reply_index)
    except asyncio.TimeoutError:
        return RaftClientReply.failure_reply(
            req, RaftException("setConfiguration timed out"))
    except RaftException as e:
        # failed before the joint entry: roll back staged appenders
        if pending.joint_index < 0:
            for p in staged:
                await div.remove_staged_peer(p.id)
        return RaftClientReply.failure_reply(req, e)
    finally:
        if div.pending_reconf is pending:
            div.pending_reconf = None


async def _wait_caught_up(div, peers: list[RaftPeer], timeout_s: float) -> None:
    """Staging gate: every new peer within the catch-up gap of the leader's
    last index (LeaderStateImpl.checkStaging:828)."""
    gap = div.server.properties.get_int(
        RaftServerConfigKeys.STAGING_CATCHUP_GAP_KEY,
        RaftServerConfigKeys.STAGING_CATCHUP_GAP_DEFAULT)
    deadline = asyncio.get_running_loop().time() + max(timeout_s, 1.0)
    while True:
        if not div.is_leader() or div.leader_ctx is None:
            raise RaftException("lost leadership during staging")
        last = div.state.log.next_index - 1
        ok = True
        for p in peers:
            f = div.leader_ctx.followers.get(p.id)
            if f is None or f.match_index < last - gap:
                ok = False
                break
        if ok:
            return
        if asyncio.get_running_loop().time() >= deadline:
            raise RaftException(
                f"staging timeout: new peers not caught up within {timeout_s}s")
        await asyncio.sleep(0.02)


async def transfer_leadership(div, req: RaftClientRequest) -> RaftClientReply:
    """Leader side of transfer: pick the target, wait for it to match our
    log, send StartLeaderElection, await the handover
    (TransferLeadership.java:47; Result types :84-97)."""
    err = div._check_leader(req)
    if err is not None:
        return err
    if div.hibernating:
        # a hibernated leader sends no heartbeats and its followers hold
        # no armed election timers — the handover below (catch-up wait +
        # StartLeaderElection) would stall against sleeping appenders, so
        # wake the group before transferring
        div.wake_from_hibernation("transfer-leadership")
    div.election_metrics.transfer_count.inc()
    try:
        args = TransferLeadershipArguments.from_payload(req.message.content)
    except Exception as e:
        return RaftClientReply.failure_reply(
            req, RaftException(f"bad transferLeadership payload: {e}"))

    state = div.state
    conf = state.configuration
    if args.new_leader:
        from ratis_tpu_torch.protocol.ids import RaftPeerId
        target_id = RaftPeerId.value_of(args.new_leader)
        target = conf.get_peer(target_id)
        if target is None or target.is_listener() \
                or not conf.contains_voting(target_id):
            return RaftClientReply.failure_reply(
                req, TransferLeadershipException(
                    f"{args.new_leader} is not a voting member of {conf}"))
    else:
        # No explicit target: yield to the highest-priority peer
        # (reference checkPeersForYieldingLeader:1058; the loop below waits
        # for it to catch up, unlike the auto-yield which requires it).
        candidates = div.higher_priority_peers()
        if not candidates:
            return RaftClientReply.failure_reply(
                req, TransferLeadershipException(
                    "no higher-priority peer to yield to"))
        target = candidates[0]
        target_id = target.id

    timeout_s = max(args.timeout_ms / 1000.0, 0.2)
    deadline = asyncio.get_running_loop().time() + timeout_s
    div.stepping_down = True
    try:
        # 1. wait for the target to be fully caught up (match == our last);
        # 2. fire the forced election on it (re-firing if it loses a round);
        # 3. succeed only once the TARGET is the known leader (reference
        #    TransferLeadership completes on the matching leader event).
        last_sent = -1.0
        while asyncio.get_running_loop().time() < deadline:
            if not div.is_leader():
                if div.state.leader_id == target_id:
                    return RaftClientReply.success_reply(req)
                await asyncio.sleep(0.02)  # some other peer won; keep waiting
                continue
            ctx = div.leader_ctx
            f = ctx.followers.get(target_id) if ctx is not None else None
            last = state.log.next_index - 1
            now = asyncio.get_running_loop().time()
            if f is not None and f.match_index >= last \
                    and now - last_sent > 0.3:
                last_sent = now
                await div._send_start_leader_election(target_id)
            await asyncio.sleep(0.02)
        return RaftClientReply.failure_reply(
            req, TransferLeadershipException(
                f"transfer to {target_id} timed out after {timeout_s}s "
                f"(leader now {div.state.leader_id})"))
    finally:
        div.stepping_down = False
