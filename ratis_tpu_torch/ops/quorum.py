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
  ``engine_step`` (all four in ``resident_step.cu``), K3
  ``tally_votes`` (``tally_votes.cu``), and K7a ``apply_vote_events``,
  K7b ``all_replicated_min`` and K7c ``lease_expiry``
  (``vote_lease.cu``; no path of the server calls K7, as none of the JAX
  package does).

A wrapper takes the plain version only because its tensors lie on the
CPU; for CUDA tensors it launches the kernel or raises.

The engine reaches K1, K2, K3 and K5 through prepared calls instead of
the wrappers: :class:`FastPlan` (the fast tick: K1, or K5 on a mesh
engine), :class:`RefreshPlan` (the refresh tick) and :class:`TallyPlan`
(the vote pass over the open rounds' rows) hold a pinned host buffer the
engine packs each tick into, its device copy and the output on both
sides, and ``run`` is one call into the kernel library (copy up, one
launch, copy down, synchronise).  On the CPU the same buffers feed the
plain versions.

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

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ratis_tpu_torch.engine.roles import (ROLE_CANDIDATE, ROLE_FOLLOWER,  # noqa: F401
                                          ROLE_LEADER, ROLE_LISTENER,
                                          ROLE_UNUSED)
from ratis_tpu_torch.ops._build import (I64, INT, PTR, Kernel, c_function,
                                        raise_on_error)

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


def _all_replicated_min_plain(match_index, self_mask, flush_index, conf_cur,
                              conf_old) -> torch.Tensor:
    eff = torch.where(self_mask, flush_index[:, None], match_index)
    union = conf_cur | conf_old
    m = torch.where(union, eff, torch.full_like(eff, INT32_MAX)).amin(dim=-1)
    return torch.where(union.any(dim=-1), m, torch.full_like(m, INT32_MIN))


K7b = Kernel("vote_lease.cu", "k7b_all_replicated_min",
             (PTR,) * 6 + (INT,) * 4)

# K7b, K7c and the public K3 run in rows of ROW_LANES lanes, 4 rows to a
# warp, in blocks of KERNEL_THREADS threads
ROW_LANES = 8
KERNEL_THREADS = 256


def lane_blocks(g: int) -> int:
    """The blocks of a launch in rows of ROW_LANES lanes over ``g`` rows
    (K7b, the public K3): every row in one, no block without a row."""
    return -(-g * ROW_LANES // KERNEL_THREADS)


@functools.lru_cache(maxsize=64)
def _replicated_specs(g: int, p: int) -> tuple:
    """(dtype, shape) of ``all_replicated_min``'s five arrays, in its
    order."""
    gp = torch.Size((g, p))
    return ((torch.int32, gp), (torch.bool, gp),
            (torch.int32, torch.Size((g,))), (torch.bool, gp),
            (torch.bool, gp))


def all_replicated_min(match_index, self_mask, flush_index, conf_cur,
                       conf_old) -> torch.Tensor:
    """[G] int32: per group, the least index replicated on ALL members of
    ``conf_cur | conf_old`` (watch levels ALL / ALL_COMMITTED), the
    leader's own slot counted at its flush index; INT32_MIN for an empty
    union.  match_index: [G, P] int32; masks: [G, P] bool; flush_index:
    [G] int32.  CPU tensors: plain torch; CUDA tensors: one launch of
    kernel K7b."""
    arrays = (match_index, self_mask, flush_index, conf_cur, conf_old)
    dev = match_index.device
    if dev.type != "cuda":
        _device_of(*arrays)  # mixed devices and other types raise
        return _all_replicated_min_plain(*arrays)
    g, p = match_index.shape
    _check_peers(p)
    _check_all(arrays, _replicated_specs(g, p), dev)
    out = torch.empty(g, dtype=torch.int32, device=dev)
    K7b(dev, *(t.data_ptr() for t in arrays), out.data_ptr(), g, p,
        lease_slots(p), lane_blocks(g))
    return out


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


# the public [G, P] tally (``tally`` in tally_votes.cu); no path of the
# server launches it: the engine's vote pass runs K3 below
K3_PUBLIC = Kernel("tally_votes.cu", "k3_tally_votes",
                   (PTR,) * 7 + (INT,) * 5)

# the public K3's two designs (``tally_votes.cu``): (a) rows of ROW_LANES
# lanes, as K7b; (b) tiles of TALLY_TILE rows staged in shared memory,
# one thread a row, from TALLY_TILE_FROM rows (``tally_tile``)
TALLY_TILE = 128
TALLY_TILE_FROM = 24_576


def tally_tile(g: int) -> int:
    """The public K3's design at ``g`` rows: 0 for rows of 8 lanes (a),
    TALLY_TILE for staged tiles (b) from TALLY_TILE_FROM rows.  On an H100
    (a) was the faster up to 10240 rows and (b) from 40960
    (``tools/fast_tick_timing.py``; PERF.md): (a) spreads a row's
    loads over 8 lanes, so its latency is short, but issues 8 threads a
    row; (b) issues one thread a row and 16-byte copies, so it moves the
    bytes of many rows with fewer instructions."""
    return TALLY_TILE if g >= TALLY_TILE_FROM else 0


def tally_blocks(g: int, tile: int) -> int:
    """The blocks of the public K3's launch at ``g`` rows by design
    ``tile`` (``tally_tile``): every row in one, no block without a row."""
    return lane_blocks(g) if tile == 0 else -(-g // tile)


@functools.lru_cache(maxsize=64)
def _tally_specs(g: int, p: int) -> tuple:
    """(dtype, shape) of ``tally_votes_packed``'s six arrays, in its
    order."""
    gp = torch.Size((g, p))
    return ((torch.bool, gp),) * 4 + ((torch.int32, gp),
                                      (torch.int32, torch.Size((g,))))


def tally_votes_packed(grants, rejects, conf_cur, conf_old, priority,
                       self_priority) -> torch.Tensor:
    """The tally as one bool [4, G] tensor (rows in VoteTally order), so
    the engine downloads it in one copy.  CPU tensors: plain torch; CUDA
    tensors: one launch of K3_PUBLIC by the design ``tally_tile`` picks."""
    arrays = (grants, rejects, conf_cur, conf_old, priority, self_priority)
    dev = grants.device
    if dev.type != "cuda":
        _device_of(*arrays)  # mixed devices and other types raise
        return _tally_plain(*arrays)
    g, p = grants.shape
    _check_peers(p)
    _check_all(arrays, _tally_specs(g, p), dev)
    out = torch.empty((4, g), dtype=torch.bool, device=dev)
    tile = tally_tile(g)
    K3_PUBLIC(dev, *(t.data_ptr() for t in arrays), out.data_ptr(), g, p,
              lease_slots(p), tile, tally_blocks(g, tile))
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


# bit p of a row's mask word is peer p (K3's row entry packs P <= 16 peers
# into one uint16)
_BIT_WEIGHTS = (1 << np.arange(MAX_KERNEL_PEERS)).astype(np.uint16)


def pack_mask_bits(rows: np.ndarray, out: np.ndarray) -> None:
    """bool [R, P] peer masks -> uint16 [R] bit words (bit p = peer p),
    written into ``out``."""
    np.dot(rows, _BIT_WEIGHTS[:rows.shape[1]], out=out)


def _tally_rows_plain(masks, priority, self_priority) -> torch.Tensor:
    """K3's row entry in plain torch: ``masks`` holds the bit words of R
    gathered rows ([4, R]: grants, rejects, conf_cur, conf_old; any
    integer dtype), ``priority`` int32 [R, P], ``self_priority`` int32
    [R]; returns bool [4, R] in VoteTally order."""
    p = priority.shape[1]
    bits = ((masks.to(torch.int32)[:, :, None]
             >> torch.arange(p, dtype=torch.int32, device=masks.device))
            & 1) != 0
    return _tally_plain(bits[0], bits[1], bits[2], bits[3], priority,
                        self_priority)


# K3, the tally the engine runs (``tally_rows`` in tally_votes.cu): on R
# gathered rows, the masks as bit words
K3 = Kernel("tally_votes.cu", "k3_tally_rows",
            (PTR, PTR, PTR, PTR, INT, INT))


def tally_rows(masks, priority, self_priority) -> torch.Tensor:
    """The vote tally of R gathered rows: ``masks`` uint16 [4, R] bit
    words (grants, rejects, conf_cur, conf_old; bit p = peer p),
    ``priority`` int32 [R, P], ``self_priority`` int32 [R]; returns bool
    [4, R] in VoteTally order.  CPU tensors: plain torch; CUDA tensors:
    kernel K3 (the engine's vote pass runs it through :class:`TallyPlan`)."""
    dev = _device_of(masks, priority, self_priority)
    if dev.type == "cpu":
        return _tally_rows_plain(masks, priority, self_priority)
    r, p = priority.shape
    _check(masks, torch.uint16, (4, r))
    _check(priority, torch.int32, (r, p))
    _check(self_priority, torch.int32, (r,))
    _check_peers(p)
    out = torch.empty((4, r), dtype=torch.bool, device=dev)
    K3(dev, masks.data_ptr(), priority.data_ptr(), self_priority.data_ptr(),
       out.data_ptr(), r, p)
    return out


def _layout_views(buf: np.ndarray, layout, shapes: dict) -> list:
    """Typed views of one packed byte buffer: the ``(name, dtype, shape
    code)`` sections of ``layout`` back to back, shapes from ``shapes``."""
    views, off = [], 0
    for _, dt, code in layout:
        shape = shapes[code]
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        views.append(buf[off:off + n].view(dt).reshape(shape))
        off += n
    return views


def layout_offsets(layout, shapes: dict) -> list[int]:
    """Each section's byte offset in a packed buffer, then the total."""
    out, off = [], 0
    for _, dt, code in layout:
        out.append(off)
        off += int(np.prod(shapes[code])) * np.dtype(dt).itemsize
    return out + [off]


def tick_offsets(layout, shapes: dict, sections: tuple):
    """The packed buffer's layout as a prepared call's C entry takes it:
    the byte offsets of ``sections`` (section names, in the entry's
    order), then the total, as an int64 array.  The layout is the host's
    alone; every section must sit at a multiple of its item size."""
    offs = layout_offsets(layout, shapes)
    where = {}
    for (name, dt, _), off in zip(layout, offs):
        if off % np.dtype(dt).itemsize:
            raise ValueError(f"section {name} at byte {off} is misaligned")
        where[name] = off
    return (I64 * (len(sections) + 1))(*(where[n] for n in sections),
                                         offs[-1])


# the vote pass's packed rows: int32 sections first, so each is aligned;
# ``k3_tick`` takes the sections' offsets in the order of _K3_TICK
TALLY_LAYOUT = (("priority", np.int32, "RP"),
                ("self_priority", np.int32, "R"),
                ("masks", np.uint16, "4R"))
_K3_TICK = ("masks", "priority", "self_priority")


def tally_shapes(r: int, p: int) -> dict:
    return {"RP": (r, p), "R": (r,), "4R": (4, r)}


class TallyViews(NamedTuple):
    priority: np.ndarray       # int32 [R, P]
    self_priority: np.ndarray  # int32 [R]
    masks: np.ndarray          # uint16 [4, R]: grants, rejects, cur, old


class TallyPlan:
    """K3's prepared call (the engine's vote pass): the tally of R
    gathered rows, not of all G.  Built once per engine capacity: a host
    buffer the caller packs the rows of the open rounds into (``views``;
    pinned on a card), its device copy, and bool [4, R] on both sides.
    ``run`` is ONE call into the kernel library (copy in, launch, copy
    out, synchronise).  On the CPU the same buffer feeds the plain
    version."""

    def __init__(self, peers: int, max_rows: int, device):
        _check_peers(peers)
        self.peers, self.max_rows = peers, max_rows
        self.device = torch.device(device)
        nbytes = layout_offsets(TALLY_LAYOUT,
                                tally_shapes(max_rows, peers))[-1]
        cuda = self.device.type == "cuda"
        self._host = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self._host_out = torch.zeros(4 * max_rows, dtype=torch.bool,
                                     pin_memory=cuda)
        self._out = self._host_out.numpy()
        self._views: dict[int, tuple] = {}
        self._plan = None
        if cuda:
            self._dev_in = torch.empty(nbytes, dtype=torch.uint8,
                                       device=self.device)
            self._dev_out = torch.empty(4 * max_rows, dtype=torch.bool,
                                        device=self.device)
            index = self._dev_in.device.index
            self._tick = c_function("tally_votes.cu", "k3_tick",
                                    (PTR, INT, PTR, PTR))
            self._plan_free = c_function("tally_votes.cu", "k3_plan_free",
                                         (PTR,), None)
            self._plan = c_function(
                "tally_votes.cu", "k3_plan_new", (PTR,) * 4 + (INT, INT),
                PTR)(self._host.data_ptr(), self._dev_in.data_ptr(),
                     self._dev_out.data_ptr(), self._host_out.data_ptr(),
                     peers, index)
            self._stream = torch.cuda.current_stream(index).cuda_stream

    def views(self, r: int) -> TallyViews:
        """The packed rows of a pass of ``r`` rows, as numpy views of the
        host buffer."""
        v = self._views.get(r)
        if v is None:
            if not 0 <= r <= self.max_rows:
                raise ValueError(f"{r} rows; the plan holds {self.max_rows}")
            shapes = tally_shapes(r, self.peers)
            v = self._views[r] = (
                TallyViews(*_layout_views(self._host.numpy(), TALLY_LAYOUT,
                                          shapes)),
                tick_offsets(TALLY_LAYOUT, shapes, _K3_TICK))
        return v[0]

    def run(self, r: int) -> np.ndarray:
        """Tally the ``r`` packed rows: bool [4, r] (VoteTally rows), a
        view of the plan's output buffer, valid until the next run."""
        v = self.views(r)
        out = self._out[:4 * r].reshape(4, r)
        if self._plan is not None:
            raise_on_error("tally_votes.cu", "k3_tick", self._tick(
                self._plan, r, self._views[r][1], self._stream))
            K3.launches += 1
        else:
            out[...] = tally_rows(*(torch.from_numpy(x) for x in (
                v.masks, v.priority, v.self_priority))).numpy()
        return out

    def __del__(self):
        if self._plan:
            self._plan_free(self._plan)
            self._plan = None


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


def _int32_scalar(x) -> int:
    """A host int32 scalar (int, numpy int32, 0-d tensor) as an int;
    raises outside the int32 range."""
    v = int(x)
    if not INT32_MIN <= v <= INT32_MAX:
        raise ValueError(f"{v} is not an int32")
    return v


def _lease_expiry_plain(last_ack_ms, self_mask, conf_cur, conf_old,
                        lease_timeout_ms: int) -> torch.Tensor:
    eff = torch.where(self_mask, torch.full_like(last_ack_ms, INT32_MAX),
                      last_ack_ms)
    quorum_ack = combined_majority_min(eff, conf_cur, conf_old)
    cap = wrap_i32(torch.tensor(INT32_MAX - lease_timeout_ms))
    return wrap_i32(torch.minimum(quorum_ack, cap).long() + lease_timeout_ms)


K7c = Kernel("vote_lease.cu", "k7c_lease_expiry",
             (PTR, PTR, PTR, PTR, INT, PTR, INT, INT, INT))


def lease_slots(p: int) -> int:
    """Peer slots each lane of a row of ROW_LANES lanes holds (K7b, K7c,
    the public K3): 1 for up to 8 peer slots, else 2."""
    return 1 if p <= 8 else 2


@functools.lru_cache(maxsize=64)
def _lease_specs(g: int, p: int) -> tuple:
    """(dtype, shape) of ``lease_expiry``'s four arrays, in its order."""
    gp = torch.Size((g, p))
    return ((torch.int32, gp),) + ((torch.bool, gp),) * 3


def lease_expiry(last_ack_ms, self_mask, conf_cur, conf_old,
                 lease_timeout_ms) -> torch.Tensor:
    """[G] int32 lease expiry: the time a majority (of both confs when
    joint) acked at or after, plus the lease timeout; the leader's own slot
    counts as INT32_MAX.  Saturating as in JAX:
    ``min(q, INT32_MAX - t) + t``, each int32 operation wrapping as XLA's
    does (a single-member conf gives INT32_MAX, an empty one INT32_MIN +
    t).  last_ack_ms: [G, P] int32; masks: [G, P] bool;
    ``lease_timeout_ms``: a host int32 scalar.  CPU tensors: plain torch;
    CUDA tensors: one launch of kernel K7c."""
    arrays = (last_ack_ms, self_mask, conf_cur, conf_old)
    timeout = _int32_scalar(lease_timeout_ms)
    dev = last_ack_ms.device
    if dev.type != "cuda":
        _device_of(*arrays)  # mixed devices and other types raise
        return _lease_expiry_plain(*arrays, timeout)
    g, p = last_ack_ms.shape
    _check_peers(p)
    _check_all(arrays, _lease_specs(g, p), dev)
    out = torch.empty(g, dtype=torch.int32, device=dev)
    K7c(dev, *(t.data_ptr() for t in arrays), timeout, out.data_ptr(), g, p,
        lease_slots(p))
    return out


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


def _apply_vote_events_plain(grants, rejects, ev_group, ev_peer, ev_granted,
                             ev_valid) -> tuple[torch.Tensor, torch.Tensor]:
    g_n, p_n = grants.shape
    grp, peer = wrap_index(ev_group, g_n), wrap_index(ev_peer, p_n)
    keep = ev_valid & (grp >= 0) & (grp < g_n) & (peer >= 0) & (peer < p_n)
    flat = grp[keep].long() * p_n + peer[keep].long()
    # the gate reads the INPUT masks: two events for one (group, peer) in
    # a batch both pass it
    fresh = ~(grants | rejects).reshape(-1)[flat]
    granted = ev_granted[keep]
    new_grants = grants.clone(memory_format=torch.contiguous_format)
    new_rejects = rejects.clone(memory_format=torch.contiguous_format)
    new_grants.view(-1)[flat[fresh & granted]] = True
    new_rejects.view(-1)[flat[fresh & ~granted]] = True
    return new_grants, new_rejects


K7a = Kernel("vote_lease.cu", "k7a_apply_vote_events",
             (PTR,) * 8 + (INT,) * 4)

# K7a's design (a): about VOTE_BLOCKS blocks, each owning a range of rows
# (a multiple of VOTE_ROW_ALIGN), every block scanning every event's group
# row, taken up to VOTE_ROWS_MAX_EVENTS events; design (b), one
# cooperative launch, above (``vote_rows``)
VOTE_BLOCKS = 256
VOTE_ROW_ALIGN = 16
VOTE_ROWS_MAX_EVENTS = 4096


def vote_block_rows(g: int) -> int:
    """The rows each block of K7a's design (a) owns at G rows: a multiple
    of 16 giving about VOTE_BLOCKS blocks."""
    per = -(-max(g, 1) // VOTE_BLOCKS)
    return -(-per // VOTE_ROW_ALIGN) * VOTE_ROW_ALIGN


def vote_rows(g: int, p: int, e: int) -> int:
    """The launch K7a takes at G rows, P peer slots and E events: design
    (a) with ``vote_block_rows(g)`` rows a block up to
    VOTE_ROWS_MAX_EVENTS events, or 0 for design (b), one cooperative
    launch, above.  Every block of (a) scans all E events, so E sets how
    long each takes; on an H100 (a) was the faster at every G timed up to
    4096 events and (b) from 8192 (``tools/fast_tick_timing.py``, PERF.md
    PR 8).  ``p`` does not change the choice."""
    return vote_block_rows(g) if e <= VOTE_ROWS_MAX_EVENTS else 0


@functools.lru_cache(maxsize=64)
def _vote_specs(g: int, p: int, e: int) -> tuple:
    """(dtype, shape) of ``apply_vote_events``' six arrays, in its order,
    and its one output buffer: the byte offset of the reject mask (the
    grant mask's G * P bytes rounded up to 16, so both start 16-byte
    aligned) and the buffer's size."""
    gp, ev = torch.Size((g, p)), torch.Size((e,))
    specs = ((torch.bool, gp), (torch.bool, gp), (torch.int32, ev),
             (torch.int32, ev), (torch.bool, ev), (torch.bool, ev))
    off = -(-g * p // 16) * 16
    return specs, off, off + g * p


def apply_vote_events(grants, rejects, ev_group, ev_peer, ev_granted,
                      ev_valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a packed batch of vote replies into NEW grant / reject
    masks (first reply wins: an event for a (group, peer) that already
    granted or rejected in ``grants | rejects`` is dropped).  The gate
    reads the inputs, so two events for one (group, peer) in one batch
    both pass it, as in JAX (the host packer dedupes a batch).  Group and
    peer each wrap a negative index by their own extent; invalid events
    and pairs out of range write nothing; no input is written.
    grants/rejects: [G, P] bool; ev_group/ev_peer: [E] int32;
    ev_granted/ev_valid: [E] bool.  CPU tensors: plain torch; CUDA
    tensors: one launch of kernel K7a, the two masks contiguous views of
    one new buffer."""
    arrays = (grants, rejects, ev_group, ev_peer, ev_granted, ev_valid)
    dev = grants.device
    if dev.type != "cuda":
        _device_of(*arrays)  # mixed devices and other types raise
        return _apply_vote_events_plain(*arrays)
    g, p = grants.shape
    _check_peers(p)
    e = ev_group.shape[0]
    specs, off, size = _vote_specs(g, p, e)
    _check_all(arrays, specs, dev)
    buf = torch.empty(size, dtype=torch.bool, device=dev)
    new_grants = buf.as_strided((g, p), (p, 1), 0)
    new_rejects = buf.as_strided((g, p), (p, 1), off)
    ptr = buf.data_ptr()
    K7a(dev, *(t.data_ptr() for t in arrays), ptr, ptr + off, g, p, e,
        vote_rows(g, p, e))
    return new_grants, new_rejects


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


@functools.lru_cache(maxsize=64)
def _step_specs(g: int, p: int, e: int) -> tuple:
    """(dtype, shape) of each of engine_step's 15 arrays, in its order,
    and the byte offsets of its outputs in one buffer: match and ack
    int32 [G, P], new_commit int32 [G], flags bool [3, G], then the
    total, rounded up to whole int32 words so that the buffer also reads
    as int32 for any G."""
    shapes = {"GP": torch.Size((g, p)), "E": torch.Size((e,)),
              "G": torch.Size((g,))}
    specs = tuple((_TORCH_DTYPE[dt], shapes[code])
                  for _, dt, code in ENGINE_STEP_ARRAYS)
    gp = g * p
    return specs, (0, 4 * gp, 8 * gp, 8 * gp + 4 * g,
                   (8 * gp + 7 * g + 3) // 4 * 4)


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
    tensors: plain torch; CUDA tensors: one launch of the kernel, its four
    outputs views of one buffer."""
    arrays = (match_index, last_ack_ms, ev_group, ev_peer, ev_match,
              ev_time_ms, ev_valid, self_mask, flush_index, conf_cur,
              conf_old, commit_index, first_leader_index, role,
              election_deadline_ms)
    now, timeout = int(now_ms), int(leadership_timeout_ms)
    dev = match_index.device
    if dev.type != "cuda":
        _device_of(*arrays)  # mixed devices and other types raise
        return _engine_step_plain(*arrays, now, timeout)
    g, p = match_index.shape
    _check_peers(p)
    e = ev_group.shape[0]
    specs, offs = _step_specs(g, p, e)
    _check_all(arrays, specs, dev)
    buf = torch.empty(offs[-1], dtype=torch.uint8, device=dev)
    words, bools = buf.view(torch.int32), buf.view(torch.bool)
    match_out = words.as_strided((g, p), (p, 1), 0)
    ack_out = words.as_strided((g, p), (p, 1), offs[1] // 4)
    new_commit = words.as_strided((g,), (1,), offs[2] // 4)
    K6(dev, *(t.data_ptr() for t in arrays), now, timeout,
       match_out.data_ptr(), ack_out.data_ptr(), new_commit.data_ptr(),
       buf.data_ptr() + offs[3], g, p, e)
    flags = offs[3]
    return EngineStep(match_out, ack_out, new_commit,
                      bools.as_strided((g,), (1,), flags),
                      bools.as_strided((g,), (1,), flags + g),
                      bools.as_strided((g,), (1,), flags + 2 * g))


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
    dtypes.  No route of the engine takes it any more (its ticks, vote
    pass and ledger samples pack into their plans' pinned buffers): it is
    the earlier route that ``chip_smoke.py`` and
    ``tools/fast_tick_timing.py`` time beside them."""
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
            (PTR,) * 13 + (INT, INT, INT, INT))
K2 = Kernel("resident_step.cu", "k2_resident",
            (PTR,) * 26 + (INT, INT, PTR, INT, INT, INT, INT, INT))


def tick_tile(g: int) -> int:
    """Rows per block of the tick kernel of K1, K2 and K5 for a batch of
    ``g`` rows (``tile_tick`` in resident_step.cu takes 32 or 128):
    every block scans all of a tick's row indices (refresh rows, ack and
    update columns), so above 16384 rows fewer, larger tiles win
    (measured on an H100 by chip_smoke.py's K1 and K2 tile rows)."""
    return 32 if g <= 16384 else 128


def _resident_refresh_plain(state, rf_idx, rf, ev, now_ms, timeout_ms):
    for dst, rows in zip(state, rf):
        _scatter_rows(dst, rf_idx, rows)
    apply_ack_events(state.match_index, state.last_ack_ms, *ev)
    return _row_pass_plain(state, now_ms, timeout_ms)


@functools.lru_cache(maxsize=256)
def _refresh_specs(g: int, p: int, d: int, e: int) -> tuple:
    """(dtype, shape) of each of engine_step_resident's 26 tensors, in
    its order."""
    def rows(n):
        return tuple((dt, torch.Size((n, p) if i < 5 else (n,)))
                     for i, dt in enumerate(_STATE_TORCH_DTYPES))
    col = torch.Size((e,))
    return (*rows(g), (torch.int32, torch.Size((d,))), *rows(d),
            *((torch.int32, col),) * 4, (torch.bool, col))


def engine_step_resident(state: DeviceState, rf_idx, rf_match, rf_ack,
                         rf_self_mask, rf_conf_cur, rf_conf_old, rf_role,
                         rf_flush, rf_commit, rf_first_leader, rf_deadline,
                         ev_group, ev_peer, ev_match, ev_time_ms, ev_valid,
                         now_ms: int, leadership_timeout_ms: int
                         ) -> ResidentStep:
    """Device-resident refresh tick (K2): scatter the host's dirty rows
    into the state (``rf_idx`` entries outside ``[0, G)`` are padding and
    dropped; the rows are unique once wrapped), then scatter the acks,
    advance commits, fire timeouts and find stale leaders — the refresh
    lands first so an ack packed in the same tick lands on top of the
    refreshed row, as in the host mirror.  Updates ``state`` in place.
    CUDA tensors: one launch of the kernel (the engine's ticks go through
    :class:`RefreshPlan` instead)."""
    rf = (rf_match, rf_ack, rf_self_mask, rf_conf_cur, rf_conf_old, rf_role,
          rf_flush, rf_commit, rf_first_leader, rf_deadline)
    ev = (ev_group, ev_peer, ev_match, ev_time_ms, ev_valid)
    tensors = (*state, rf_idx, *rf, *ev)
    dev = _device_of(*tensors)
    if dev.type == "cpu":
        out = _resident_refresh_plain(state, rf_idx, rf, ev, int(now_ms),
                                      int(leadership_timeout_ms))
        return ResidentStep(state, *out)
    g, p = state.match_index.shape
    _check_peers(p)
    d, e = rf_idx.shape[0], ev_group.shape[0]
    for t, (dt, shape) in zip(tensors, _refresh_specs(g, p, d, e)):
        if t.dtype != dt or t.shape != shape or not t.is_contiguous():
            _check(t, dt, shape)
    out = torch.empty((4, g), dtype=torch.int32, device=dev)
    K2(dev, *(t.data_ptr() for t in tensors), int(now_ms),
       int(leadership_timeout_ms), out.data_ptr(), g, p, d, e,
       tick_tile(g))
    return ResidentStep(state, *out)


# K2's packed tick: the refresh indices, the refreshed rows by DeviceState
# field, the ack columns [4, E] (group, peer, match, time) and their valid
# flags; int32 sections first, so each is aligned.  ``k2_tick`` takes the
# sections' offsets in the order of _K2_TICK
REFRESH_LAYOUT = (
    ("idx", np.int32, "D"), ("match_index", np.int32, "DP"),
    ("last_ack_ms", np.int32, "DP"), ("flush_index", np.int32, "D"),
    ("commit_index", np.int32, "D"), ("first_leader_index", np.int32, "D"),
    ("election_deadline_ms", np.int32, "D"), ("events", np.int32, "4E"),
    ("self_mask", np.bool_, "DP"), ("conf_cur", np.bool_, "DP"),
    ("conf_old", np.bool_, "DP"), ("role", np.int8, "D"),
    ("valid", np.bool_, "E"))
_K2_TICK = ("idx", "match_index", "last_ack_ms", "self_mask", "conf_cur",
            "conf_old", "role", "flush_index", "commit_index",
            "first_leader_index", "election_deadline_ms", "events", "valid")


def refresh_shapes(d: int, e: int, p: int) -> dict:
    return {"D": (d,), "DP": (d, p), "4E": (4, e), "E": (e,)}


class RefreshViews(NamedTuple):
    """A packed refresh tick: ``idx`` [D] and the refreshed rows' fields
    (DeviceState names), the acks as ``events`` [4, E] (group, peer,
    match, time) and ``valid`` [E]."""

    idx: np.ndarray
    match_index: np.ndarray
    last_ack_ms: np.ndarray
    flush_index: np.ndarray
    commit_index: np.ndarray
    first_leader_index: np.ndarray
    election_deadline_ms: np.ndarray
    events: np.ndarray
    self_mask: np.ndarray
    conf_cur: np.ndarray
    conf_old: np.ndarray
    role: np.ndarray
    valid: np.ndarray


class _StatePlan:
    """A prepared call on one resident state: a host buffer of ``nbytes``
    the caller packs each tick into (pinned on a card), its device copy,
    and out[4, G] on both sides (``out``, the host side).  On a card the C
    plan holds the state's ten arrays, the buffers and the tile size, so a
    tick is ONE call into the kernel library (the copy to the card, the
    launch, the copy of out back, the stream synchronised); the checks ran
    once, when the plan was built or bound.  ``bind`` points the plan at
    another state of the same shape (a re-upload) without reallocating."""

    _plan = None

    def __init__(self, state: DeviceState, nbytes: int):
        g, p = _check_state(state)
        self.capacity, self.peers = g, p
        self.device = state.match_index.device
        cuda = self.device.type == "cuda"
        self._host = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=cuda)
        self._host_out = torch.zeros((4, g), dtype=torch.int32,
                                     pin_memory=cuda)
        self.out = self._host_out.numpy()
        if cuda:
            self._dev_in = torch.empty(nbytes, dtype=torch.uint8,
                                       device=self.device)
            self._dev_out = torch.empty((4, g), dtype=torch.int32,
                                        device=self.device)
            self._plan_new = c_function("resident_step.cu", "tick_plan_new",
                                        (PTR,) * 14 + (INT,) * 4, PTR)
            self._plan_free = c_function("resident_step.cu",
                                         "tick_plan_free", (PTR,), None)
        self.bind(state)

    def tile(self) -> int:
        """Rows per block of the plan's kernel."""
        raise NotImplementedError

    def bind(self, state: DeviceState) -> None:
        """Point the plan at ``state`` (same shape and device)."""
        if tuple(state.match_index.shape) != (self.capacity, self.peers) \
                or state.match_index.device != self.device:
            raise ValueError(f"state {tuple(state.match_index.shape)} on "
                             f"{state.match_index.device}; the plan is for "
                             f"{(self.capacity, self.peers)} on "
                             f"{self.device}")
        _check_state(state)
        self.state = state
        if self.device.type == "cuda":
            plan = self._plan_new(
                *(t.data_ptr() for t in state), self._host.data_ptr(),
                self._dev_in.data_ptr(), self._dev_out.data_ptr(),
                self._host_out.data_ptr(), self.capacity, self.peers,
                self.tile(), self.device.index)
            self._free()
            self._plan = plan
            self._stream = torch.cuda.current_stream(
                self.device).cuda_stream

    def _free(self) -> None:
        if self._plan:
            self._plan_free(self._plan)
            self._plan = None

    def __del__(self):
        self._free()


class RefreshPlan(_StatePlan):
    """K2's prepared call on one resident state (the engine's refresh
    route), built once per state shape: the caller packs each tick's
    refresh rows and acks into ``views(d, e)`` and ``run`` is one call
    into the kernel library.  On the CPU the same buffer feeds the plain
    version, so the packing is exercised there too."""

    def __init__(self, state: DeviceState, max_rows: int, max_events: int):
        self.max_rows, self.max_events = max_rows, max_events
        self._views: dict[tuple, tuple] = {}
        p = state.match_index.shape[1]
        super().__init__(state, layout_offsets(REFRESH_LAYOUT, refresh_shapes(
            max_rows, max_events, p))[-1])
        if self._plan is not None:
            self._tick = c_function("resident_step.cu", "k2_tick",
                                    (PTR, INT, INT, INT, INT, PTR, PTR))

    def tile(self) -> int:
        return tick_tile(self.capacity)

    def views(self, d: int, e: int) -> RefreshViews:
        """The packed tick of ``d`` refresh rows and ``e`` ack columns, as
        numpy views of the host buffer."""
        v = self._views.get((d, e))
        if v is None:
            if not (0 <= d <= self.max_rows and 0 <= e <= self.max_events):
                raise ValueError(f"{d} rows, {e} acks; the plan holds "
                                 f"{self.max_rows}, {self.max_events}")
            shapes = refresh_shapes(d, e, self.peers)
            arrays = RefreshViews(*_layout_views(
                self._host.numpy(), REFRESH_LAYOUT, shapes))
            tensors = RefreshViews(*map(torch.from_numpy, arrays))
            v = self._views[(d, e)] = (
                arrays, tensors, tick_offsets(REFRESH_LAYOUT, shapes,
                                              _K2_TICK))
        return v[0]

    def run(self, d: int, e: int, now_ms: int, timeout_ms: int
            ) -> np.ndarray:
        """The refresh tick on the packed ``views(d, e)``: int32 [4, G]
        (new_commit, commit_changed, timeouts, stale), the plan's output
        buffer, valid until the next run.  Updates the state in place."""
        self.views(d, e)
        if self._plan is not None:
            raise_on_error("resident_step.cu", "k2_tick", self._tick(
                self._plan, d, e, now_ms, timeout_ms, self._views[(d, e)][2],
                self._stream))
            K2.launches += 1
        else:
            t = self._views[(d, e)][1]
            ev = t.events
            self.out[...] = _resident_refresh_plain(
                self.state, t.idx,
                tuple(getattr(t, f) for f in DeviceState._fields),
                (ev[0], ev[1], ev[2], ev[3], t.valid), now_ms,
                timeout_ms).numpy()
        return self.out


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
    """The steady-state tick (K1).

    ``ev_packed`` is int32 [7, E]; each column is an ack or a slot update:
    row 0 group slot, 1 peer slot (acks), 2 match index (acks), 3 ack time
    (acks), 4 ack valid 0/1, 5 new flush index (updates; PACK_SENTINEL
    otherwise), 6 new election deadline (updates; PACK_SENTINEL otherwise).
    ``meta`` is int32 [2]: (now_ms, leadership_timeout_ms).  ``out`` is
    int32 [4, G]: (new_commit, commit_changed, timeouts, stale).  Updates
    ``state`` in place.  CUDA tensors: one launch of the kernel (the
    engine's fast ticks go through :class:`FastPlan` instead)."""
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
       meta.data_ptr(), out.data_ptr(), g, p, e, tick_tile(g))
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
            (PTR,) * 13 + (INT,) * 5)


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
    ``out`` is int32 [4, G].  Updates ``state`` in place.  CUDA tensors:
    one launch of the kernel (a mesh engine's fast ticks go through
    :class:`FastPlan` instead)."""
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
       meta.data_ptr(), out.data_ptr(), g, p, n_slices, e, tick_tile(g))
    return ResidentFastStep(state, out)


# K1's and K5's packed tick: the seven rows of the fast pack (see
# engine_step_resident_fast), each int32 [S, E], back to back in row
# order, so the whole tick is also one [7, S, E] array (``events``).
# ``fast_tick`` takes the rows' offsets in this order
FAST_ROWS = ("slot", "peer", "match", "time", "valid", "flush", "deadline")
FAST_LAYOUT = tuple((name, np.int32, "SE") for name in FAST_ROWS)


def fast_shapes(s: int, e: int) -> dict:
    return {"SE": (s, e)}


class FastPlan(_StatePlan):
    """The fast tick's prepared call on one resident state (the engine's
    fast route): K1 on a flat state (``n_slices`` None), K5 over
    ``n_slices`` slices of a mesh engine's state.  Built once per state
    shape: the caller packs each tick's acks and slot updates into
    ``events(e)`` (int32 [7, S, E], plane s with rows local to slice s)
    and ``run(e, ...)`` is one call into the kernel library.  On the CPU
    the same buffer feeds the plain version, so the packing is exercised
    there too."""

    def __init__(self, state: DeviceState, max_events: int,
                 n_slices: "int | None" = None):
        s = 1 if n_slices is None else int(n_slices)
        g = state.match_index.shape[0]
        if s < 1 or g % s:
            raise ValueError(f"{s} slices do not divide {g} group rows")
        self.n_slices, self.sliced = s, n_slices is not None
        self.kernel = K5 if self.sliced else K1
        self.max_events = max_events
        self._events: dict[int, tuple] = {}
        super().__init__(state, layout_offsets(FAST_LAYOUT, fast_shapes(
            s, max_events))[-1])
        if self._plan is not None:
            self._tick = c_function("resident_step.cu", "fast_tick",
                                    (PTR, INT, INT, INT, INT, PTR, PTR))

    def tile(self) -> int:
        return tick_tile(self.capacity)

    def events(self, e: int) -> np.ndarray:
        """The packed tick of the plan's S planes of ``e`` columns, int32
        [7, S, E], a view of the host buffer."""
        v = self._events.get(e)
        if v is None:
            if not 0 <= e <= self.max_events:
                raise ValueError(f"{e} columns; the plan holds "
                                 f"{self.max_events}")
            shapes = fast_shapes(self.n_slices, e)
            n = layout_offsets(FAST_LAYOUT, shapes)[-1]
            arr = self._host.numpy()[:n].view(np.int32).reshape(
                7, self.n_slices, e)
            v = self._events[e] = (
                arr, torch.from_numpy(arr),
                tick_offsets(FAST_LAYOUT, shapes, FAST_ROWS))
        return v[0]

    def run(self, e: int, now_ms: int, timeout_ms: int) -> np.ndarray:
        """The fast tick on the packed ``events(e)``: int32 [4, G]
        (new_commit, commit_changed, timeouts, stale), the plan's output
        buffer, valid until the next run.  Updates the state in place."""
        self.events(e)
        _, ev, offsets = self._events[e]
        if self._plan is not None:
            raise_on_error("resident_step.cu", "fast_tick", self._tick(
                self._plan, self.n_slices, e, now_ms, timeout_ms, offsets,
                self._stream))
            self.kernel.launches += 1
        else:
            meta = torch.tensor([now_ms, timeout_ms], dtype=torch.int32)
            self.out[...] = (
                _resident_fast_sliced_plain(self.state, ev, meta)
                if self.sliced
                else _resident_fast_plain(self.state, ev[:, 0], meta)
            ).numpy()
        return self.out


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


def _check_all(arrays: Sequence[torch.Tensor], specs: tuple,
               dev: torch.device) -> None:
    """Every array against its (dtype, shape) in ``specs``, contiguous and
    on ``dev``, in one pass; the first that fails raises with its own
    message, prefixed with its position among ``arrays``."""
    card = dev.index
    for i, (t, (dt, shape)) in enumerate(zip(arrays, specs)):
        if t.dtype is not dt or t.shape != shape or not t.is_contiguous() \
                or t.get_device() != card:
            _device_of(*arrays)
            try:
                _check(t, dt, shape)
            except (TypeError, ValueError) as exc:
                raise type(exc)(f"argument {i}: {exc}") from None


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
