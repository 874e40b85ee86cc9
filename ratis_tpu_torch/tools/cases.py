"""Seeded numpy inputs for the kernels, edge cases included.

The same generators feed the CPU tests (JAX reference against the plain
torch versions) and ``chip_smoke.py`` (the CUDA kernels against the plain
versions on the card), so both hold the kernels to the same cases:

- resident state: leader/follower/candidate/listener/unused rows, joint
  confs, EMPTY confs (majority-min INT32_MIN; a leader with an empty conf
  takes the wrapping ``now - INT32_MIN`` branch of the staleness check),
  extreme indices for the ledger's wrapping differences;
- mesh fast-tick events: one ``[7, E]`` plane per slice with
  slice-local rows, rows past the slice and (``negative``) below its
  start, planes padded to a common width;
- fast-tick events: valid acks, invalid ack columns carrying sentinels,
  duplicate acks on one (group, peer), flush / deadline update columns,
  columns aimed at row ``capacity`` (dropped), sentinel padding; with
  ``negative``, also group and peer indices in ``[-n, -1]`` (they count
  from the end, as XLA's scatters normalise them) and below ``-n``
  (dropped);
- refresh: sorted unique dirty rows padded with index ``capacity`` (with
  ``negative``, some rows given as ``row - g``);
- the stateless tick (``engine_step``): the resident state's arrays with
  unpacked acks that mix valid, invalid (garbage values), duplicate,
  in-range negative and out-of-range (positive and negative) indices;
- K7: vote-reply batches (peers that already replied, a grant and a
  reject for one (group, peer) in one batch, invalid events, indices in
  ``[-n, -1]``, below ``-n`` and at or past ``n``), the hand-made edge
  batches of ``vote_event_edges``, replicated-index and lease inputs with
  joint, single-member and empty confs (and rows with no self bit or two:
  ``replicated_self_edges``), and lease timeouts that wrap
  (``LEASE_TIMEOUTS``);
- K3's public tally: ``tally_edges``, rows with priorities at INT32_MIN
  and INT32_MAX, empty current confs, joint rounds, every member or none
  replied;
- the engine's prepared calls: a fast tick, a refresh tick or a vote
  pass's rows packed into a ``FastPlan`` / ``RefreshPlan`` /
  ``TallyPlan`` as the engine packs them;
- a hibernated sparse fleet (``sleeping_state``, ``sleeping_events``,
  ``sleeping_refresh``): most rows asleep, their followers' deadlines
  60000-62000 ms ahead (the backstop plus a random election timeout) or
  at INT32_MAX, and updated so in the tick (the clamp to ``NO_DEADLINE``
  included), their leaders' acks stopped, and few acks;
- ledger: duplicate dense peer ids in a row, unmapped columns (-1), ids
  past the table width, argmax ties, and optionally one (peer, bucket)
  cell holding more than 2048 links.

Every array comes back with the engine's host-mirror dtypes.
"""

from __future__ import annotations

import numpy as np

from ratis_tpu_torch.ops import quorum as q

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max
SENT = INT32_MIN  # ops.quorum.PACK_SENTINEL


def _mask(rng, g: int, p: int, empty_frac: float) -> np.ndarray:
    k = rng.integers(1, p + 1, size=g)
    m = np.arange(p)[None, :] < k[:, None]
    m &= rng.random((g, p)) < 0.9
    m[rng.random(g) < empty_frac] = False
    return m


def _members(m: np.ndarray, members: int) -> np.ndarray:
    """``m`` with every row's current conf cut to exactly ``members`` slots
    (the first ones), as a group of that many peers fills them; None:
    ``m`` as drawn."""
    if members is None:
        return m
    m = np.zeros_like(m)
    m[:, :members] = True
    return m


def resident_state(rng, g: int, p: int, now: int = 100_000,
                   members: int = None) -> list:
    """The ten DeviceState fields (ops.quorum.DeviceState order); with
    ``members``, every row's current conf holds exactly that many peers
    (the draws are the same either way)."""
    role = rng.choice(np.array([0, 1, 2, 3, 4], np.int8), size=g,
                      p=[0.1, 0.35, 0.1, 0.4, 0.05])
    conf_cur = _members(_mask(rng, g, p, 0.05), members)
    joint = rng.random(g) < 0.2
    conf_old = _mask(rng, g, p, 0.0) & joint[:, None]
    self_slot = rng.integers(0, p, size=g)
    self_mask = np.zeros((g, p), bool)
    self_mask[np.arange(g), self_slot] = True
    match = rng.integers(-1, 2000, size=(g, p)).astype(np.int32)
    last_ack = rng.integers(now - 5000, now + 1, size=(g, p)).astype(np.int32)
    flush = rng.integers(-1, 2000, size=g).astype(np.int32)
    commit = rng.integers(-1, 1500, size=g).astype(np.int32)
    first = rng.integers(0, 1000, size=g).astype(np.int32)
    deadline = rng.integers(now - 500, now + 500, size=g).astype(np.int32)
    deadline[rng.random(g) < 0.2] = INT32_MAX
    # a few extreme rows: wrapping differences in the ledger
    ext = rng.random(g) < 0.02
    match[ext] = INT32_MIN
    commit[rng.random(g) < 0.01] = INT32_MAX
    return [match, last_ack, self_mask, conf_cur, conf_old, role, flush,
            commit, first, deadline]


def _negate(rng, idx: np.ndarray, n: int, frac: float) -> None:
    """In place: a ``frac`` of the indices become ``idx - n`` (the same
    slot, counted from the end), a tenth of those ``idx - 2n - 1`` (below
    ``-n``: dropped)."""
    neg = rng.random(idx.shape) < frac
    idx[neg] -= n
    below = neg & (rng.random(idx.shape) < 0.1)
    idx[below] -= n + 1


def fast_events(rng, g: int, p: int, e: int, now: int = 100_000,
                negative: bool = False) -> np.ndarray:
    """A fast-tick pack int32 [7, e]: about half ack columns (some
    invalid, some duplicated), a quarter update columns on unique slots
    (some aimed at row g and dropped), the rest sentinel padding.
    ``negative``: some ack and update indices negative (see module)."""
    ev = np.full((7, e), SENT, np.int32)
    ev[0] = 0
    ev[1] = 0
    ev[4] = 0
    n_ack = e // 2
    slots = rng.integers(0, g, size=n_ack)
    peers = rng.integers(0, p, size=n_ack)
    dup = rng.random(n_ack) < 0.2       # repeat an earlier (group, peer)
    src = rng.integers(0, max(1, n_ack), size=n_ack)
    slots[dup] = slots[src[dup]]
    peers[dup] = peers[src[dup]]
    ev[0, :n_ack] = slots
    ev[1, :n_ack] = peers
    ev[2, :n_ack] = rng.integers(-1, 2500, size=n_ack)
    ev[3, :n_ack] = rng.integers(now - 100, now + 1, size=n_ack)
    valid = rng.random(n_ack) < 0.9
    ev[4, :n_ack] = valid
    ev[2, :n_ack][~valid] = SENT
    ev[3, :n_ack][~valid] = SENT
    n_up = min(e // 4, g)
    up_slots = rng.permutation(g)[:n_up]
    up_slots[rng.random(n_up) < 0.05] = g      # capacity index: dropped
    cols = slice(n_ack, n_ack + n_up)
    ev[0, cols] = up_slots
    flush = rng.integers(-1, 2500, size=n_up).astype(np.int32)
    flush[rng.random(n_up) < 0.3] = SENT
    dl = rng.integers(now - 300, now + 300, size=n_up).astype(np.int32)
    dl[rng.random(n_up) < 0.3] = SENT
    ev[5, cols] = flush
    ev[6, cols] = dl
    if negative:
        _negate(rng, ev[0, :n_ack], g, 0.2)
        _negate(rng, ev[1, :n_ack], p, 0.2)
        # update slots stay unique once wrapped: row g (dropped) is kept
        up = ev[0, cols]
        real = up[up < g]
        _negate(rng, real, g, 0.2)
        up[up < g] = real
    return ev


def sliced_events(rng, g: int, p: int, s: int, e: int, now: int = 100_000,
                  negative: bool = False) -> np.ndarray:
    """A mesh engine's fast-tick pack int32 [7, s, e] over ``g`` rows in
    ``s`` slices, row 0 local to the slice: each slice's plane is
    ``fast_events`` over its ``g // s`` rows (update columns aimed at the
    slice's row ``g // s`` are dropped), cut to a random number of columns
    and padded (valid 0, update rows sentinel), as the engine pads every
    plane to the fullest slice's bucket; a twentieth of the ack rows moved
    past the slice (``row + g // s``: dropped, never spilled into the next
    slice).  ``negative``: local rows in ``[-g // s, -1]`` (the slice's own
    end) and below it (dropped), peers likewise."""
    rows = g // s
    ev = np.stack([fast_events(rng, rows, p, e, now, negative)
                   for _ in range(s)], axis=1)
    ack_rows = ev[0, :, :e // 2]
    past = (rng.random(ack_rows.shape) < 0.05) & (ack_rows >= 0)
    ack_rows[past] += rows
    for i in range(s):
        cut = int(rng.integers(0, e + 1))
        ev[:, i, cut:] = SENT
        ev[(0, 1, 4), i, cut:] = 0
    return ev


# raft.tpu.hibernate.backstop (60 s) plus a follower's random election
# timeout: how far ahead a hibernated follower arms its deadline
SLEEP_AHEAD_MS = (60_000, 62_000)


def _sleep_deadlines(rng, n: int, now: int) -> np.ndarray:
    """Deadlines a hibernated follower arms: ``now`` plus 60000-62000 ms,
    clamped to INT32_MAX as the division clamps them, a fifth at
    INT32_MAX (a full disarm)."""
    lo, hi = SLEEP_AHEAD_MS
    dl = np.minimum(now + rng.integers(lo, hi + 1, size=n, dtype=np.int64),
                    INT32_MAX).astype(np.int32)
    dl[rng.random(n) < 0.2] = INT32_MAX
    return dl


def sleeping_state(rng, g: int, p: int, now: int = 100_000,
                   members: int = None) -> list:
    """The ten DeviceState fields of a hibernated sparse fleet:
    ``resident_state``'s rows, nine in ten of them then asleep: a third
    leaders whose acks stopped 2-60 s ago (stale by the check; the engine
    skips a hibernating leader's verdict), the rest followers whose
    deadlines lie 60000-62000 ms ahead or at INT32_MAX; every asleep row
    caught up (match = flush = commit)."""
    st = resident_state(rng, g, p, now, members)
    match, last_ack, _, _, _, role, flush, commit, _, deadline = st
    asleep = np.nonzero(rng.random(g) < 0.9)[0]
    leads = rng.random(len(asleep)) < 1 / 3
    role[asleep] = np.where(leads, np.int8(3), np.int8(1))
    commit[asleep] = flush[asleep]
    match[asleep] = flush[asleep][:, None]
    last_ack[asleep[leads]] = now - rng.integers(
        2_000, 60_000, size=(int(leads.sum()), p)).astype(np.int32)
    deadline[asleep[leads]] = INT32_MAX
    deadline[asleep[~leads]] = _sleep_deadlines(rng, int((~leads).sum()),
                                                now)
    return st


def sleeping_events(rng, g: int, p: int, e: int,
                    now: int = 100_000) -> np.ndarray:
    """A fast-tick pack int32 [7, e] of a sleeping fleet: acks on a
    sixteenth of the columns (a few awake groups), deadline updates on a
    quarter (unique rows, each armed 60000-62000 ms ahead or at
    INT32_MAX, their flush a sentinel), the rest sentinel padding."""
    ev = np.full((7, e), SENT, np.int32)
    ev[(0, 1, 4), :] = 0
    n_ack = max(1, e // 16)
    ev[0, :n_ack] = rng.integers(0, g, size=n_ack)
    ev[1, :n_ack] = rng.integers(0, p, size=n_ack)
    ev[2, :n_ack] = rng.integers(-1, 2500, size=n_ack)
    ev[3, :n_ack] = rng.integers(now - 100, now + 1, size=n_ack)
    ev[4, :n_ack] = 1
    n_up = min(e // 4, g)
    cols = slice(n_ack, n_ack + n_up)
    ev[0, cols] = rng.permutation(g)[:n_up]
    ev[6, cols] = _sleep_deadlines(rng, n_up, now)
    return ev


def sleeping_refresh(rng, g: int, p: int, d: int, e: int,
                     now: int = 100_000) -> tuple[np.ndarray, list, list]:
    """``refresh``'s (rf_idx, rows, acks) for a sleeping fleet: the
    refreshed rows are ``sleeping_state``'s (groups falling asleep or
    waking), the acks ``sleeping_events``' few."""
    n = int(rng.integers(1, d + 1))
    rows = np.sort(rng.permutation(g)[:min(n, g)]).astype(np.int32)
    rf_idx = np.full(d, g, np.int32)
    rf_idx[:len(rows)] = rows
    rf = sleeping_state(rng, d, p, now)
    ev = sleeping_events(rng, g, p, e, now)
    ack_cols = ev[4] != 0
    acks = [np.where(ack_cols, ev[i], 0).astype(np.int32) for i in range(4)]
    return rf_idx, rf, [*acks, ack_cols.copy()]


HOT_ROWS = (40, 41, 42)


def hot_acks(rng, ev: np.ndarray, rows=HOT_ROWS) -> np.ndarray:
    """``ev`` (a fast pack, [7, E] or [7, S, E]) with each ack column
    aimed at one of ``rows`` (slice-local on a sliced pack): a few hot
    groups' backlog, so that one kernel tile lists more columns than one
    of its rounds holds.  In place; returned."""
    acks = ev[0, ..., :ev.shape[-1] // 2]
    acks[...] = rng.choice(np.asarray(rows, np.int32), size=acks.shape)
    return ev


def refresh(rng, g: int, p: int, d: int, e: int, now: int = 100_000,
            negative: bool = False) -> tuple[np.ndarray, list, list]:
    """(rf_idx [d], the ten refreshed-row arrays [d, ...], the five
    unpacked ack arrays [e]) for the refresh tick.  ``negative``: a fifth
    of the rows given as ``row - g`` (still unique once wrapped), and
    negative ack indices as in ``fast_events``."""
    n = int(rng.integers(1, d + 1))
    rows = np.sort(rng.permutation(g)[:min(n, g)]).astype(np.int32)
    rf_idx = np.full(d, g, np.int32)    # padding: one past the end
    rf_idx[:len(rows)] = rows
    if negative:
        neg = rng.random(len(rows)) < 0.2
        rf_idx[:len(rows)][neg] -= g
    rf = resident_state(rng, d, p, now)
    ev = fast_events(rng, g, p, e, now, negative)
    ack_cols = ev[4] != 0
    acks = [np.where(ack_cols, ev[0], 0).astype(np.int32),
            np.where(ack_cols, ev[1], 0).astype(np.int32),
            np.where(ack_cols, ev[2], 0).astype(np.int32),
            np.where(ack_cols, ev[3], 0).astype(np.int32),
            ack_cols.copy()]
    return rf_idx, rf, acks


def step_events(rng, g: int, p: int, e: int, now: int = 100_000) -> list:
    """The five unpacked ack arrays [e] of the stateless tick: group, peer,
    match, time, valid.  A tenth invalid (their values garbage: they must
    write nothing), a fifth duplicates of an earlier (group, peer), and
    group / peer indices in ``[-n, -1]``, below ``-n`` and at or past
    ``n``."""
    grp = rng.integers(0, g, size=e).astype(np.int32)
    peer = rng.integers(0, p, size=e).astype(np.int32)
    dup = rng.random(e) < 0.2
    src = rng.integers(0, max(1, e), size=e)
    grp[dup] = grp[src[dup]]
    peer[dup] = peer[src[dup]]
    _negate(rng, grp, g, 0.15)
    _negate(rng, peer, p, 0.15)
    past = rng.random(e) < 0.03
    grp[past] = g + rng.integers(0, 3, size=int(past.sum()))
    past = rng.random(e) < 0.03
    peer[past] = p + rng.integers(0, 3, size=int(past.sum()))
    match = rng.integers(-1, 2500, size=e).astype(np.int32)
    t = rng.integers(now - 100, now + 1, size=e).astype(np.int32)
    valid = rng.random(e) < 0.9
    match[~valid] = INT32_MAX
    t[~valid] = INT32_MAX
    return [grp, peer, match, t, valid]


def step_args(rng, g: int, p: int, e: int, now: int = 100_000,
              timeout: int = 300) -> list:
    """The 17 arguments of ``engine_step`` in its order: the resident
    state's arrays (joint and empty confs, a leader whose empty conf
    takes the wrapping ``now - INT32_MIN`` branch), ``step_events``, and
    ``now_ms`` / ``leadership_timeout_ms`` as numpy int32 scalars."""
    (match, last_ack, self_mask, conf_cur, conf_old, role, flush, commit,
     first, deadline) = resident_state(rng, g, p, now)
    return [match, last_ack, *step_events(rng, g, p, e, now), self_mask,
            flush, conf_cur, conf_old, commit, first, role, deadline,
            np.int32(now), np.int32(timeout)]


def tally_inputs(rng, g: int, p: int, members: int = None) -> list:
    """grants, rejects, conf_cur, conf_old, priority, self_priority; with
    ``members``, every current conf of exactly that many peers."""
    conf_cur = _members(_mask(rng, g, p, 0.05), members)
    conf_old = _mask(rng, g, p, 0.0) & (rng.random(g) < 0.2)[:, None]
    replied = rng.random((g, p)) < 0.6
    granted = rng.random((g, p)) < 0.7
    grants = replied & granted
    rejects = replied & ~granted
    priority = rng.integers(0, 3, size=(g, p)).astype(np.int32)
    self_priority = rng.integers(0, 3, size=g).astype(np.int32)
    return [grants, rejects, conf_cur, conf_old, priority, self_priority]


def tally_edges(rng, g: int, p: int) -> list:
    """``tally_inputs`` with most rows cut to an edge of the tally, each
    kind on about a seventh of the rows: priorities at INT32_MIN and
    INT32_MAX (the candidate's and the peers'), an empty conf_cur (alone,
    or beside a conf_old), a joint round, every member replied, none
    replied, every member granted."""
    grants, rejects, cur, old, prio, self_prio = tally_inputs(rng, g, p)
    kind = rng.integers(0, 7, size=g)
    extreme = np.array([INT32_MIN, INT32_MAX, 0, 1], np.int32)
    rows = kind == 0
    prio[rows] = rng.choice(extreme, size=(int(rows.sum()), p))
    self_prio[rows] = rng.choice(extreme, size=int(rows.sum()))
    cur[kind == 1] = False
    joint = kind == 2
    old[joint] = _mask(rng, int(joint.sum()), p, 0.0)
    members = cur | old
    granted = members & (rng.random((g, p)) < 0.6)
    every = kind == 3
    grants[every] = granted[every]
    rejects[every] = (members & ~granted)[every]
    none = kind == 4
    grants[none] = rejects[none] = False
    all_granted = kind == 5
    grants[all_granted] = members[all_granted]
    rejects[all_granted] = False
    return [grants, rejects, cur, old, prio, self_prio]


def ledger_inputs(rng, g: int, p: int, width: int, now: int = 100_000,
                  big_cell: bool = False,
                  members: int = None) -> tuple[list, tuple]:
    """(the eleven array args of ops.ledger.ledger_pass, (now_ms,
    lag_threshold, up_window_ms)).  ``big_cell`` makes every leader row's
    first three follower links point at peer 0, caught up (lag bucket 0):
    one histogram cell then counts > 2048 links once g > 700; ``members``
    as ``resident_state``'s."""
    st = resident_state(rng, g, p, now, members)
    match, last_ack, self_mask, conf_cur, conf_old, role = st[:6]
    commit = st[7]
    applied = (commit - rng.integers(0, 50, size=g)).astype(np.int32)
    peer_index = rng.integers(-1, width + 2, size=(g, p)).astype(np.int32)
    # duplicate ids within a row and argmax ties (two links, equal lag)
    dup = rng.random(g) < 0.3
    peer_index[dup, 1] = peer_index[dup, 0]
    tie = rng.random(g) < 0.3
    match[tie, 1] = match[tie, 0]
    if big_cell:
        role[:] = 3
        conf_cur[:, :4] = True
        self_mask[:] = False
        self_mask[:, 3] = True
        peer_index[:, :3] = 0
        match[:, :3] = commit[:, None]
    prev_commit = (commit - rng.integers(0, 20, size=g)).astype(np.int32)
    prev_valid = rng.random(g) < 0.8
    arrays = [role, match, commit, applied, conf_cur, conf_old, self_mask,
              last_ack, peer_index, prev_commit, prev_valid]
    return arrays, (now, 64, 3000)


# lease timeouts the K7c cases take: ordinary, zero, negative (the cap
# INT32_MAX - t wraps) and the int32 extremes
LEASE_TIMEOUTS = (1000, 0, -5, 150, INT32_MAX, INT32_MIN)


def vote_events(rng, g: int, p: int, e: int) -> list:
    """grants, rejects ([g, p] bool: about a third of the peers already
    replied) and the four event arrays [e] of ``apply_vote_events``:
    group, peer (int32), granted, valid (bool).  A fifth of the events
    repeat an earlier (group, peer), some with the opposite answer (both
    pass the gate in one batch); a tenth are invalid; group and peer
    indices in ``[-n, -1]``, below ``-n`` and at or past ``n``."""
    replied = rng.random((g, p)) < 0.3
    granted = rng.random((g, p)) < 0.6
    grants, rejects = replied & granted, replied & ~granted
    grp = rng.integers(0, g, size=e).astype(np.int32)
    peer = rng.integers(0, p, size=e).astype(np.int32)
    dup = rng.random(e) < 0.2
    src = rng.integers(0, max(1, e), size=e)
    grp[dup] = grp[src[dup]]
    peer[dup] = peer[src[dup]]
    _negate(rng, grp, g, 0.15)
    _negate(rng, peer, p, 0.15)
    past = rng.random(e) < 0.03
    grp[past] = g + rng.integers(0, 3, size=int(past.sum()))
    past = rng.random(e) < 0.03
    peer[past] = p + rng.integers(0, 3, size=int(past.sum()))
    ev_granted = rng.random(e) < 0.6
    ev_valid = rng.random(e) < 0.9
    return [grants, rejects, grp, peer, ev_granted, ev_valid]


def vote_event_edges(g: int, p: int) -> list:
    """One hand-made batch for ``apply_vote_events`` over empty masks
    (``g`` >= 2, ``p`` >= 3), one event per edge: a grant and then a
    reject for (1, 2) in the same batch (both masks set), a grant at
    group -1 (row g - 1), groups g, g + 1, -g - 1 and -2g (dropped), peer
    -1 (slot p - 1) and peer p (dropped), and an invalid event at (0, 0)
    (writes nothing)."""
    ev = [(1, 2, True, True), (1, 2, False, True), (-1, 0, True, True),
          (g, 0, True, True), (g + 1, 1, False, True),
          (-g - 1, 0, True, True), (-2 * g, 1, False, True),
          (0, -1, False, True), (0, p, True, True), (0, 0, True, False)]
    grp, peer, granted, valid = (np.array(c) for c in zip(*ev))
    return [np.zeros((g, p), bool), np.zeros((g, p), bool),
            grp.astype(np.int32), peer.astype(np.int32), granted, valid]


def _quorum_confs(rng, g: int, p: int) -> tuple:
    """(self_mask, conf_cur, conf_old) [g, p]: joint confs on a fifth of
    the rows, empty current confs on a twentieth (a few of those empty in
    both), single-member confs on a tenth (the leader's own slot alone)."""
    conf_cur = _mask(rng, g, p, 0.05)
    conf_old = _mask(rng, g, p, 0.0) & (rng.random(g) < 0.2)[:, None]
    conf_old[rng.random(g) < 0.02] = False
    conf_cur[rng.random(g) < 0.02] = False
    self_slot = rng.integers(0, p, size=g)
    self_mask = np.zeros((g, p), bool)
    self_mask[np.arange(g), self_slot] = True
    single = rng.random(g) < 0.1
    conf_cur[single] = self_mask[single]
    conf_old[single] = False
    return self_mask, conf_cur, conf_old


def replicated_inputs(rng, g: int, p: int) -> list:
    """match_index, self_mask, flush_index, conf_cur, conf_old for
    ``all_replicated_min``: extreme indices included (INT32_MIN matches,
    INT32_MAX flushes), empty unions on some rows."""
    self_mask, conf_cur, conf_old = _quorum_confs(rng, g, p)
    match = rng.integers(-1, 2000, size=(g, p)).astype(np.int32)
    match[rng.random((g, p)) < 0.01] = INT32_MIN
    flush = rng.integers(-1, 2000, size=g).astype(np.int32)
    flush[rng.random(g) < 0.01] = INT32_MAX
    return [match, self_mask, flush, conf_cur, conf_old]


def replicated_self_edges(rng, g: int, p: int) -> list:
    """``replicated_inputs`` with no self bit on a fifth of the rows and
    two on another fifth (where ``p`` > 1): each slot counts its own
    value, the flush index wherever its self bit is set."""
    arrays = replicated_inputs(rng, g, p)
    self_mask = arrays[1]
    kind = rng.integers(0, 5, size=g)
    self_mask[kind == 0] = False
    if p > 1:
        two = np.flatnonzero(kind == 1)
        self_mask[two, (np.argmax(self_mask[two], axis=1) + 1) % p] = True
    return arrays


def lease_inputs(rng, g: int, p: int, now: int = 100_000) -> list:
    """last_ack_ms, self_mask, conf_cur, conf_old for ``lease_expiry``
    (times around ``now``, a few near INT32_MAX so the sum wraps)."""
    self_mask, conf_cur, conf_old = _quorum_confs(rng, g, p)
    ack = rng.integers(now - 5000, now + 1, size=(g, p)).astype(np.int32)
    big = rng.random((g, p)) < 0.02
    ack[big] = INT32_MAX - rng.integers(0, 2000, size=int(big.sum()))
    return [ack, self_mask, conf_cur, conf_old]


def refresh_plan(state, rf_idx, rf, acks):
    """A ``RefreshPlan`` on ``state`` (a DeviceState) holding one refresh
    tick, ``refresh``'s arrays, packed into its views as the engine packs
    one: ``plan.run(len(rf_idx), len(acks[0]), ...)`` runs it."""
    d, e = len(rf_idx), len(acks[0])
    plan = q.RefreshPlan(state, d, e)
    v = plan.views(d, e)
    v.idx[:] = rf_idx
    for name, rows in zip(q.DeviceState._fields, rf):
        getattr(v, name)[:] = rows
    v.events[:] = np.stack(acks[:4])
    v.valid[:] = acks[4]
    return plan


def fast_plan(state, ev, sliced: bool = False):
    """A ``FastPlan`` on ``state`` (a DeviceState) holding one fast tick
    packed into its buffer as the engine packs one: ``fast_events``'
    [7, E] on a flat plan (K1), or with ``sliced`` ``sliced_events``'
    [7, S, E] on a plan over S slices (K5).  ``plan.run(E, now, timeout)``
    runs it."""
    ev = ev if sliced else ev[:, None]
    s, e = ev.shape[1:]
    plan = q.FastPlan(state, e, s if sliced else None)
    plan.events(e)[...] = ev
    return plan


def padded_rows(rows, cap: int, g: int) -> np.ndarray:
    """``rows`` then ``cap - len(rows)`` padding rows as the engine's vote
    pass leaves them: other groups' rows, packed by an earlier, larger
    pass (the engine never clears them; their tallies are dropped)."""
    return np.concatenate([rows, np.arange(cap - len(rows)) % g])


def tally_plan(arrays, rows, device, cap=None):
    """A ``TallyPlan`` on ``device`` holding the rows ``rows`` of
    ``tally_inputs``' arrays as the engine's vote pass packs them (mask
    bit words, priority rows), padded to ``cap`` rows (default: none)
    with the stale rows of ``padded_rows``: ``plan.run(cap)`` is the
    tally of ``padded_rows(rows, cap, G)``, its first ``len(rows)``
    columns the rows' own."""
    cap = len(rows) if cap is None else cap
    full = padded_rows(rows, cap, arrays[0].shape[0])
    plan = q.TallyPlan(arrays[0].shape[1], cap, device)
    v = plan.views(cap)
    arrays[4].take(full, axis=0, out=v.priority)
    arrays[5].take(full, out=v.self_priority)
    for words, mask in zip(v.masks, arrays[:4]):
        q.pack_mask_bits(mask.take(full, axis=0), words)
    return plan
