"""Batched quorum kernels: the consensus math of every group in one pass.

The PyTorch counterpart of ``ratis_tpu.ops.quorum`` — same functions, same
NamedTuples, same conventions (``[G, P]`` bool peer masks, int32 indices
and epoch-relative int32 millisecond times, total functions the caller
masks).  Each function on the engine's path has two bodies:

- a plain-torch version, the CPU path and the oracle the CUDA kernels are
  held against;
- a hand-written CUDA kernel for Hopper (``ops/kernels/*.cu``), launched
  by the public wrapper when its tensors are on a CUDA device:
  K1 ``engine_step_resident_fast``, K2 ``engine_step_resident``, K5
  ``engine_step_resident_fast_sliced`` (a mesh engine's fast tick), K6
  ``engine_step`` (all four in ``resident_step.cu``) and K3
  ``tally_votes`` (``tally_votes.cu``).

A wrapper takes the plain version only because its tensors lie on the
CPU; for CUDA tensors it launches the kernel or raises.

Where the JAX functions return new arrays from donated buffers, the
resident steps here update the ``DeviceState`` tensors IN PLACE and
return the same tensors in the result's ``state``.  The stateless tick
(``engine_step``) writes none of its inputs, as in JAX.

Scatter indices follow the JAX scatters' ``mode="drop"``: an index in
``[-n, -1]`` counts from the end of its own dimension (``n + idx``, as
numpy and XLA normalise it), and one outside ``[-n, n)`` is dropped (the
engine pads with index ``capacity``).  int32 differences that XLA wraps
are wrapped here explicitly.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ratis_tpu_torch.engine.roles import (ROLE_CANDIDATE, ROLE_FOLLOWER,  # noqa: F401
                                          ROLE_LEADER, ROLE_LISTENER,
                                          ROLE_UNUSED)
from ratis_tpu_torch.ops._build import INT, PTR, Kernel

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1
# the kernels keep a row's peer values in registers
MAX_KERNEL_PEERS = 16


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32: the wrapping int32 arithmetic of XLA."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def conf_size(mask: torch.Tensor) -> torch.Tensor:
    """[G, P] bool -> [G] int32 number of voting members."""
    return mask.sum(dim=-1, dtype=torch.int32)


def majority_count(mask: torch.Tensor) -> torch.Tensor:
    """[G, P] bool -> [G] votes needed for majority: floor(size/2) + 1."""
    return torch.div(conf_size(mask), 2, rounding_mode="floor") + 1


def majority_min(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per group, the greatest v such that a majority of members have
    value >= v: ascending-sorted member values at position (k-1)//2.
    Groups with an empty mask get INT32_MIN (never advances anything)."""
    masked = torch.where(mask, values, torch.full_like(values, INT32_MAX))
    sorted_asc = torch.sort(masked, dim=-1).values
    k = conf_size(mask)
    pos = torch.div(torch.clamp(k - 1, min=0), 2, rounding_mode="floor")
    maj = torch.gather(sorted_asc, -1, pos[:, None].long())[:, 0]
    return torch.where(k > 0, maj, torch.full_like(maj, INT32_MIN))


def combined_majority_min(values: torch.Tensor, conf_cur: torch.Tensor,
                          conf_old: torch.Tensor) -> torch.Tensor:
    """Joint-consensus combine: min over both confs when conf_old is
    active."""
    maj_cur = majority_min(values, conf_cur)
    in_joint = conf_old.any(dim=-1)
    maj_old = majority_min(values, conf_old)
    return torch.where(in_joint, torch.minimum(maj_cur, maj_old), maj_cur)


class CommitUpdate(NamedTuple):
    new_commit: torch.Tensor     # [G] advanced commit index
    changed: torch.Tensor        # [G] bool: commit advanced this step


def update_commit(match_index, self_mask, flush_index, conf_cur, conf_old,
                  commit_index, first_leader_index, is_leader
                  ) -> CommitUpdate:
    """Advance every group's commit index from follower matchIndexes: the
    leader's own slot counts its flush index, the majority-min over
    (current and old) confs is the candidate, and it takes effect only at
    or past the leader's first entry of its term."""
    eff = torch.where(self_mask, flush_index[:, None], match_index)
    candidate = combined_majority_min(eff, conf_cur, conf_old)
    ok = is_leader & (candidate > commit_index) & (
        candidate >= first_leader_index)
    return CommitUpdate(torch.where(ok, candidate, commit_index), ok)


class VoteTally(NamedTuple):
    passed: torch.Tensor             # [G] bool: strict mid-stream PASS
    passed_on_timeout: torch.Tensor  # [G] bool: PASS if the deadline fires now
    rejected: torch.Tensor           # [G] bool: reject majority or veto
    decided: torch.Tensor            # [G] bool: passed | rejected


def _has_majority(grants, mask):
    cnt = (grants & mask).sum(dim=-1, dtype=torch.int32)
    return cnt >= majority_count(mask)


def _majority_rejected(rejects, mask):
    # grant majority is impossible once ceil(size/2) members rejected
    cnt = (rejects & mask).sum(dim=-1, dtype=torch.int32)
    k = conf_size(mask)
    return (k > 0) & (cnt >= torch.div(k + 1, 2, rounding_mode="floor"))


def _tally_plain(grants, rejects, conf_cur, conf_old, priority,
                 self_priority) -> torch.Tensor:
    in_joint = conf_old.any(dim=-1)
    pass_cur = _has_majority(grants, conf_cur)
    pass_old = torch.where(in_joint, _has_majority(grants, conf_old),
                           torch.ones_like(in_joint))
    majority = pass_cur & pass_old
    union = conf_cur | conf_old
    higher = union & (priority > self_priority[:, None])
    veto = (rejects & higher).any(dim=-1)
    rej_any = _majority_rejected(rejects, conf_cur) | (
        in_joint & _majority_rejected(rejects, conf_old))
    rejected = veto | rej_any
    replied = grants | rejects
    hp_all_replied = (~higher | replied).all(dim=-1)
    passed = majority & hp_all_replied & ~rejected
    return torch.stack([passed, majority & ~rejected, rejected,
                        passed | rejected])


K3 = Kernel("tally_votes.cu", "k3_tally_votes",
            (PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT))


def tally_votes_packed(grants, rejects, conf_cur, conf_old, priority,
                       self_priority) -> torch.Tensor:
    """The tally as one bool [4, G] tensor (rows in VoteTally order), so
    the engine downloads it in one copy.  CPU tensors: plain torch; CUDA
    tensors: kernel K3."""
    dev = _device_of(grants, rejects, conf_cur, conf_old, priority,
                     self_priority)
    if dev.type == "cpu":
        return _tally_plain(grants, rejects, conf_cur, conf_old, priority,
                            self_priority)
    g, p = grants.shape
    for t in (grants, rejects, conf_cur, conf_old):
        _check(t, torch.bool, (g, p))
    _check(priority, torch.int32, (g, p))
    _check(self_priority, torch.int32, (g,))
    _check_peers(p)
    out = torch.empty((4, g), dtype=torch.bool, device=dev)
    K3(dev, grants.data_ptr(), rejects.data_ptr(), conf_cur.data_ptr(),
       conf_old.data_ptr(), priority.data_ptr(), self_priority.data_ptr(),
       out.data_ptr(), g, p)
    return out


def tally_votes(grants, rejects, conf_cur, conf_old, priority,
                self_priority) -> VoteTally:
    """Tally one election round for every group (LeaderElection
    waitForResults): REJECTED on a priority veto or a reject majority in
    either active conf; ``passed`` on a grant majority in the current conf
    (and the old one when joint) once every higher-priority member replied;
    ``passed_on_timeout`` without that wait.  The candidate's own grant is
    pre-set by the caller.  grants/rejects/confs: [G, P] bool; priority:
    [G, P] int32; self_priority: [G] int32."""
    return VoteTally(*tally_votes_packed(grants, rejects, conf_cur, conf_old,
                                         priority, self_priority))


def election_timeout(now_ms, next_deadline_ms, is_follower):
    """[G] bool: followers whose election deadline has passed."""
    return is_follower & (now_ms >= next_deadline_ms)


def check_leadership(last_ack_ms, self_mask, conf_cur, conf_old, now_ms,
                     timeout_ms, is_leader):
    """[G] bool step-down mask: leaders that have NOT heard from a quorum
    within the timeout.  The leader's own slot always counts as fresh;
    ``now - quorum_ack`` wraps in int32 as in XLA (an empty conf gives
    quorum_ack INT32_MIN)."""
    eff = torch.where(self_mask, torch.full_like(last_ack_ms, int(now_ms)),
                      last_ack_ms)
    quorum_ack = combined_majority_min(eff, conf_cur, conf_old)
    stale = wrap_i32(int(now_ms) - quorum_ack.long()) > int(timeout_ms)
    return is_leader & stale


def wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """An index in ``[-n, -1]`` counts from the end (``n + idx``), as XLA
    normalises scatter indices; anything else is returned as it is, and
    the caller drops what lies outside ``[0, n)``."""
    return torch.where(idx < 0, idx + n, idx)


def apply_ack_events(match_index, last_ack_ms, ev_group, ev_peer, ev_match,
                     ev_time_ms, ev_valid):
    """Scatter-max a packed batch of acks into ``match_index`` and
    ``last_ack_ms`` IN PLACE and return them.  Group and peer each wrap a
    negative index by their own extent; invalid slots and (group, peer)
    pairs still out of range write nothing."""
    g_n, p_n = match_index.shape
    ev_group, ev_peer = wrap_index(ev_group, g_n), wrap_index(ev_peer, p_n)
    keep = ev_valid & (ev_group >= 0) & (ev_group < g_n) & (ev_peer >= 0) \
        & (ev_peer < p_n)
    flat = (ev_group[keep].long() * p_n + ev_peer[keep].long())
    match_index.view(-1).scatter_reduce_(0, flat, ev_match[keep], "amax")
    last_ack_ms.view(-1).scatter_reduce_(0, flat, ev_time_ms[keep], "amax")
    return match_index, last_ack_ms


class EngineStep(NamedTuple):
    match_index: torch.Tensor     # [G, P] int32, a new tensor
    last_ack_ms: torch.Tensor     # [G, P] int32, a new tensor
    new_commit: torch.Tensor      # [G] int32
    commit_changed: torch.Tensor  # [G] bool
    timeouts: torch.Tensor        # [G] bool followers to become candidates
    stale: torch.Tensor           # [G] bool leaders that lost quorum contact


# the arrays of engine_step's signature, in order: name, dtype, shape
# ([G, P], [E] or [G]); the two trailing scalars, now_ms and
# leadership_timeout_ms, are ints
ENGINE_STEP_ARRAYS = (
    ("match_index", np.int32, "GP"), ("last_ack_ms", np.int32, "GP"),
    ("ev_group", np.int32, "E"), ("ev_peer", np.int32, "E"),
    ("ev_match", np.int32, "E"), ("ev_time_ms", np.int32, "E"),
    ("ev_valid", np.bool_, "E"), ("self_mask", np.bool_, "GP"),
    ("flush_index", np.int32, "G"), ("conf_cur", np.bool_, "GP"),
    ("conf_old", np.bool_, "GP"), ("commit_index", np.int32, "G"),
    ("first_leader_index", np.int32, "G"), ("role", np.int8, "G"),
    ("election_deadline_ms", np.int32, "G"))


def engine_step_args_from_numpy(args: Sequence, device) -> tuple:
    """The 17 arguments of ``engine_step`` (the JAX function's order, e.g.
    ``tools.bench._example_batch``) as fresh tensors on ``device`` with
    the JAX dtypes (int32, bool masks, int8 role; each checked), and the
    two trailing scalars ``now_ms`` and ``leadership_timeout_ms`` as
    Python ints: the kernel takes them by value, so no call waits on a
    device scalar."""
    args = list(args)
    if len(args) != len(ENGINE_STEP_ARRAYS) + 2:
        raise ValueError(f"expected {len(ENGINE_STEP_ARRAYS) + 2} "
                         f"arguments, got {len(args)}")
    out = _tensors_from_numpy([(n, dt) for n, dt, _ in ENGINE_STEP_ARRAYS],
                              args[:-2], device)
    return (*out, int(args[-2]), int(args[-1]))


def _engine_step_plain(match_index, last_ack_ms, ev_group, ev_peer, ev_match,
                       ev_time_ms, ev_valid, self_mask, flush_index, conf_cur,
                       conf_old, commit_index, first_leader_index, role,
                       election_deadline_ms, now_ms: int,
                       timeout_ms: int) -> EngineStep:
    match_index, last_ack_ms = apply_ack_events(
        match_index.clone(memory_format=torch.contiguous_format),
        last_ack_ms.clone(memory_format=torch.contiguous_format),
        ev_group, ev_peer, ev_match, ev_time_ms, ev_valid)
    is_leader = role == ROLE_LEADER
    cu = update_commit(match_index, self_mask, flush_index, conf_cur,
                       conf_old, commit_index, first_leader_index, is_leader)
    timeouts = election_timeout(now_ms, election_deadline_ms,
                                role == ROLE_FOLLOWER)
    stale = check_leadership(last_ack_ms, self_mask, conf_cur, conf_old,
                             now_ms, timeout_ms, is_leader)
    return EngineStep(match_index, last_ack_ms, cu.new_commit, cu.changed,
                      timeouts, stale)


K6 = Kernel("resident_step.cu", "k6_engine_step",
            (PTR,) * 15 + (INT, INT) + (PTR,) * 4 + (INT, INT, INT))


def engine_step(match_index, last_ack_ms, ev_group, ev_peer, ev_match,
                ev_time_ms, ev_valid, self_mask, flush_index, conf_cur,
                conf_old, commit_index, first_leader_index, role,
                election_deadline_ms, now_ms, leadership_timeout_ms
                ) -> EngineStep:
    """One stateless fused tick for every group (K6): scatter-max the ack
    batch into COPIES of ``match_index`` / ``last_ack_ms``, advance
    commits, fire election timeouts, find stale leaders.  No input is
    written.  Arrays as in ``ENGINE_STEP_ARRAYS``; ``now_ms`` and
    ``leadership_timeout_ms`` are host scalars (int, numpy int32).  CPU
    tensors: plain torch; CUDA tensors: the kernel."""
    arrays = (match_index, last_ack_ms, ev_group, ev_peer, ev_match,
              ev_time_ms, ev_valid, self_mask, flush_index, conf_cur,
              conf_old, commit_index, first_leader_index, role,
              election_deadline_ms)
    dev = _device_of(*arrays)
    now, timeout = int(now_ms), int(leadership_timeout_ms)
    if dev.type == "cpu":
        return _engine_step_plain(*arrays, now, timeout)
    g, p = match_index.shape
    _check_peers(p)
    e = ev_group.shape[0]
    shapes = {"GP": (g, p), "E": (e,), "G": (g,)}
    for (_, dt, shape), t in zip(ENGINE_STEP_ARRAYS, arrays):
        _check(t, _TORCH_DTYPE[dt], shapes[shape])
    match_out = torch.empty_like(match_index)
    ack_out = torch.empty_like(last_ack_ms)
    new_commit = torch.empty(g, dtype=torch.int32, device=dev)
    flags = torch.empty((3, g), dtype=torch.bool, device=dev)
    K6(dev, *(t.data_ptr() for t in arrays), now, timeout,
       match_out.data_ptr(), ack_out.data_ptr(), new_commit.data_ptr(),
       flags.data_ptr(), g, p, e)
    return EngineStep(match_out, ack_out, new_commit, *flags)


class DeviceState(NamedTuple):
    """The consensus state that lives on the engine's device between
    ticks.  The resident steps update these tensors in place; the host
    keeps a numpy mirror and uploads only changed rows and packed
    events per tick."""

    match_index: torch.Tensor          # [G, P] int32
    last_ack_ms: torch.Tensor          # [G, P] int32
    self_mask: torch.Tensor            # [G, P] bool
    conf_cur: torch.Tensor             # [G, P] bool
    conf_old: torch.Tensor             # [G, P] bool
    role: torch.Tensor                 # [G] int8
    flush_index: torch.Tensor          # [G] int32
    commit_index: torch.Tensor         # [G] int32
    first_leader_index: torch.Tensor   # [G] int32
    election_deadline_ms: torch.Tensor # [G] int32


_STATE_DTYPES = (np.int32, np.int32, np.bool_, np.bool_, np.bool_, np.int8,
                 np.int32, np.int32, np.int32, np.int32)


def device_state_from_numpy(arrays: Sequence[np.ndarray],
                            device) -> DeviceState:
    """Build a DeviceState of fresh tensors on ``device`` from the ten
    DeviceState fields as numpy arrays, in field order (a
    ``GroupBatchState`` mirror's arrays, or the fields of a JAX
    ``DeviceState`` fetched to the host).  Every dtype is kept and
    checked: int32, bool, int8."""
    arrays = list(arrays)
    if len(arrays) != len(DeviceState._fields):
        raise ValueError(f"expected {len(DeviceState._fields)} arrays, "
                         f"got {len(arrays)}")
    return DeviceState(*_tensors_from_numpy(
        zip(DeviceState._fields, _STATE_DTYPES), arrays, device))


def _tensors_from_numpy(fields, arrays, device) -> list[torch.Tensor]:
    """Fresh tensors on ``device`` from numpy arrays whose dtypes must be
    the ``(name, dtype)`` pairs of ``fields``."""
    out = []
    for (name, dt), a in zip(fields, arrays):
        a = np.asarray(a)
        if a.dtype != dt:
            raise TypeError(f"{name}: dtype {a.dtype}, expected "
                            f"{np.dtype(dt)}")
        out.append(torch.tensor(a, device=device))
    return out


def upload(arrays: Sequence[np.ndarray], device) -> list[torch.Tensor]:
    """Copy host arrays to ``device`` in ONE transfer: their bytes are
    packed (4-byte aligned) into one buffer, copied once, and returned as
    typed views of the copy, one per array, with the arrays' shapes and
    dtypes.  The per-tick uploads of the engine and the ledger go through
    here, so a tick pays one host-to-device copy, not one per array."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, off = [], 0
    for a in arrays:
        offs.append(off)
        off += -(-a.nbytes // 4) * 4
    buf = np.zeros(off, np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(buf).to(device)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


class ResidentStep(NamedTuple):
    state: DeviceState
    # int32 0/1 rows of one [4, G] output (new_commit, commit_changed,
    # timeouts, stale): read commit_changed/timeouts/stale with != 0
    new_commit: torch.Tensor      # [G] int32
    commit_changed: torch.Tensor  # [G] int32 0/1
    timeouts: torch.Tensor        # [G] int32 0/1
    stale: torch.Tensor           # [G] int32 0/1


class ResidentFastStep(NamedTuple):
    state: DeviceState
    # int32 [4, G]: new_commit; commit_changed/timeouts/stale as 0/1
    out: torch.Tensor


# "no value" sentinel for packed update columns
PACK_SENTINEL = INT32_MIN


def _row_pass_plain(st: DeviceState, now_ms: int,
                    timeout_ms: int) -> torch.Tensor:
    """The row math shared by K1 and K2 (update_commit, election_timeout,
    check_leadership); writes the new commit and the disarmed deadlines
    into ``st`` in place and returns the int32 [4, G] output."""
    is_leader = st.role == ROLE_LEADER
    cu = update_commit(st.match_index, st.self_mask, st.flush_index,
                       st.conf_cur, st.conf_old, st.commit_index,
                       st.first_leader_index, is_leader)
    timeouts = election_timeout(now_ms, st.election_deadline_ms,
                                st.role == ROLE_FOLLOWER)
    stale = check_leadership(st.last_ack_ms, st.self_mask, st.conf_cur,
                             st.conf_old, now_ms, timeout_ms, is_leader)
    st.commit_index.copy_(cu.new_commit)
    st.election_deadline_ms.masked_fill_(timeouts, INT32_MAX)
    return torch.stack([cu.new_commit, cu.changed.to(torch.int32),
                        timeouts.to(torch.int32), stale.to(torch.int32)])


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> None:
    idx = wrap_index(idx, dst.shape[0])
    keep = (idx >= 0) & (idx < dst.shape[0])
    dst[idx[keep].long()] = rows[keep]


K1 = Kernel("resident_step.cu", "k1_resident_fast",
            (PTR,) * 13 + (INT, INT, INT))
K2 = Kernel("resident_step.cu", "k2_resident",
            (PTR,) * 26 + (INT, INT, PTR, INT, INT, INT, INT))


def _resident_refresh_plain(state, rf_idx, rf, ev, now_ms, timeout_ms):
    for dst, rows in zip(state, rf):
        _scatter_rows(dst, rf_idx, rows)
    apply_ack_events(state.match_index, state.last_ack_ms, *ev)
    return _row_pass_plain(state, now_ms, timeout_ms)


def engine_step_resident(state: DeviceState, rf_idx, rf_match, rf_ack,
                         rf_self_mask, rf_conf_cur, rf_conf_old, rf_role,
                         rf_flush, rf_commit, rf_first_leader, rf_deadline,
                         ev_group, ev_peer, ev_match, ev_time_ms, ev_valid,
                         now_ms: int, leadership_timeout_ms: int
                         ) -> ResidentStep:
    """Device-resident refresh tick (K2): scatter the host's dirty rows
    into the state (``rf_idx`` entries outside ``[0, G)`` are padding and
    dropped), then scatter the acks, advance commits, fire timeouts and
    find stale leaders — the refresh lands first so an ack packed in the
    same tick lands on top of the refreshed row, as in the host mirror.
    Updates ``state`` in place."""
    rf = (rf_match, rf_ack, rf_self_mask, rf_conf_cur, rf_conf_old, rf_role,
          rf_flush, rf_commit, rf_first_leader, rf_deadline)
    ev = (ev_group, ev_peer, ev_match, ev_time_ms, ev_valid)
    dev = _device_of(*state, rf_idx, *rf, *ev)
    if dev.type == "cpu":
        out = _resident_refresh_plain(state, rf_idx, rf, ev, int(now_ms),
                                      int(leadership_timeout_ms))
        return ResidentStep(state, *out)
    g, p = _check_state(state)
    d = rf_idx.shape[0]
    _check(rf_idx, torch.int32, (d,))
    for t, like in zip(rf, state):
        _check(t, like.dtype, (d,) + tuple(like.shape[1:]))
    e = ev_group.shape[0]
    for t in ev[:4]:
        _check(t, torch.int32, (e,))
    _check(ev_valid, torch.bool, (e,))
    out = torch.empty((4, g), dtype=torch.int32, device=dev)
    K2(dev, *(t.data_ptr() for t in state), rf_idx.data_ptr(),
       *(t.data_ptr() for t in rf), *(t.data_ptr() for t in ev),
       int(now_ms), int(leadership_timeout_ms), out.data_ptr(), g, p, d, e)
    return ResidentStep(state, *out)


def _resident_fast_plain(state: DeviceState, ev_packed, meta):
    slot, ev_peer = ev_packed[0], ev_packed[1]
    ev_valid = ev_packed[4] != 0
    up_flush, up_deadline = ev_packed[5], ev_packed[6]
    cap = state.flush_index.shape[0]
    row = wrap_index(slot, cap)
    in_row = (row >= 0) & (row < cap)
    # slot updates first: a deadline re-armed in the same tick is seen by
    # the timeout check below
    f = in_row & (up_flush != PACK_SENTINEL)
    state.flush_index.scatter_reduce_(0, row[f].long(), up_flush[f], "amax")
    d = in_row & (up_deadline != PACK_SENTINEL)
    state.election_deadline_ms[row[d].long()] = up_deadline[d]
    apply_ack_events(state.match_index, state.last_ack_ms, slot, ev_peer,
                     ev_packed[2], ev_packed[3], ev_valid)
    return _row_pass_plain(state, int(meta[0]), int(meta[1]))


def engine_step_resident_fast(state: DeviceState, ev_packed: torch.Tensor,
                              meta: torch.Tensor) -> ResidentFastStep:
    """The steady-state tick (K1): two uploads and one download.

    ``ev_packed`` is int32 [7, E]; each column is an ack or a slot update:
    row 0 group slot, 1 peer slot (acks), 2 match index (acks), 3 ack time
    (acks), 4 ack valid 0/1, 5 new flush index (updates; PACK_SENTINEL
    otherwise), 6 new election deadline (updates; PACK_SENTINEL otherwise).
    ``meta`` is int32 [2]: (now_ms, leadership_timeout_ms).  ``out`` is
    int32 [4, G]: (new_commit, commit_changed, timeouts, stale).  Updates
    ``state`` in place."""
    dev = _device_of(*state, ev_packed, meta)
    if dev.type == "cpu":
        return ResidentFastStep(state,
                                _resident_fast_plain(state, ev_packed, meta))
    g, p = _check_state(state)
    e = ev_packed.shape[1] if ev_packed.dim() == 2 else -1
    _check(ev_packed, torch.int32, (7, e))
    _check(meta, torch.int32, (2,))
    out = torch.empty((4, g), dtype=torch.int32, device=dev)
    K1(dev, *(t.data_ptr() for t in state), ev_packed.data_ptr(),
       meta.data_ptr(), out.data_ptr(), g, p, e)
    return ResidentFastStep(state, out)


def _resident_fast_sliced_plain(state: DeviceState, ev_packed, meta):
    """K5's plain version: the plain fast tick on each slice's ``G / S``
    row view (views of the state, so the updates land in place), with the
    slice's own event plane.  Each slice wraps and drops its indices by its
    own extent, as each vmapped slice of the JAX function does."""
    n_slices = ev_packed.shape[1]
    rows = state.flush_index.shape[0] // n_slices
    return torch.cat([
        _resident_fast_plain(
            DeviceState(*(t[s * rows:(s + 1) * rows] for t in state)),
            ev_packed[:, s], meta)
        for s in range(n_slices)], dim=1)


K5 = Kernel("resident_step.cu", "k5_resident_fast_sliced",
            (PTR,) * 13 + (INT, INT, INT, INT))


def engine_step_resident_fast_sliced(state: DeviceState,
                                     ev_packed: torch.Tensor,
                                     meta: torch.Tensor) -> ResidentFastStep:
    """The steady-state tick of a mesh engine (K5): the group batch is S
    contiguous slices of ``G / S`` rows, and ``ev_packed`` is int32
    [7, S, E], one plane per slice, with the rows of
    :func:`engine_step_resident_fast` except that row 0 holds the
    SLICE-LOCAL row (global slot = slice * (G / S) + local row).  A local
    row wraps and drops by ``G / S`` (a row past the slice is dropped, not
    spilled into the next one; ``-1`` is the slice's last row), a peer by
    P.  With S == 1 it equals the flat fast tick.  ``meta`` is int32 [2];
    ``out`` is int32 [4, G].  Updates ``state`` in place."""
    dev = _device_of(*state, ev_packed, meta)
    if ev_packed.dim() != 3 or ev_packed.shape[0] != 7:
        raise ValueError(f"events of shape {tuple(ev_packed.shape)}, "
                         f"expected [7, S, E]")
    n_slices = ev_packed.shape[1]
    g = state.flush_index.shape[0]
    if n_slices < 1 or g % n_slices:
        raise ValueError(f"{n_slices} slices do not divide {g} group rows")
    if dev.type == "cpu":
        return ResidentFastStep(
            state, _resident_fast_sliced_plain(state, ev_packed, meta))
    g, p = _check_state(state)
    e = ev_packed.shape[2]
    _check(ev_packed, torch.int32, (7, n_slices, e))
    _check(meta, torch.int32, (2,))
    out = torch.empty((4, g), dtype=torch.int32, device=dev)
    K5(dev, *(t.data_ptr() for t in state), ev_packed.data_ptr(),
       meta.data_ptr(), out.data_ptr(), g, p, n_slices, e)
    return ResidentFastStep(state, out)


# -- wrapper checks -----------------------------------------------------------

def _device_of(*tensors: torch.Tensor) -> torch.device:
    """The one device all arguments share: CPU (plain version) or CUDA
    (kernel).  Mixed devices or any other device type raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"arguments on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device type {dev.type!r}")
    return dev


def _check(t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"shape {tuple(t.shape)}, kernel takes {shape}")
    if not t.is_contiguous():
        raise ValueError("kernel takes contiguous tensors")


def _check_peers(p: int) -> None:
    if not 0 < p <= MAX_KERNEL_PEERS:
        raise ValueError(f"{p} peer slots; the kernels take 1.."
                         f"{MAX_KERNEL_PEERS}")


_TORCH_DTYPE = {np.int32: torch.int32, np.bool_: torch.bool,
                np.int8: torch.int8}
_STATE_TORCH_DTYPES = tuple(_TORCH_DTYPE[d] for d in _STATE_DTYPES)


def _check_state(state: DeviceState) -> tuple[int, int]:
    g, p = state.match_index.shape
    _check_peers(p)
    for i, (t, dt) in enumerate(zip(state, _STATE_TORCH_DTYPES)):
        _check(t, dt, (g, p) if i < 5 else (g,))
    return g, p
