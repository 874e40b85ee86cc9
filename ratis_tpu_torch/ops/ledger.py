"""Fused lag & health ledger pass over the ``[G, P]`` group batch.

The PyTorch counterpart of ``ratis_tpu.ops.ledger``: one pass per
telemetry tick turns the engine's host-mirror arrays (match/commit/applied
indexes, conf masks, ack times, the dense ``peer_index`` map) into every
per-group and per-peer observability quantity, packed into ONE int32
vector so a sample costs one device-to-host copy.  ``ledger_pass`` runs the
plain-torch version for CPU tensors and the hand-written CUDA kernel K4
(``ops/kernels/ledger_pass.cu``, one launch) for CUDA tensors.

The engine's ledger reaches K4 through :class:`LedgerPlan` instead: a
pinned host buffer it writes the mirrors into, its device copy and the
packed output on both sides, so a sample is ONE call into the kernel
library (copy up, one launch, copy down, synchronise).  On the CPU the
same buffer feeds the plain version.

Counts are int32, never float: the JAX version's f32 einsum is exact on
the CPU, and a TF32 product on the card would not be.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ratis_tpu_torch.engine.roles import ROLE_LEADER, ROLE_UNUSED
from ratis_tpu_torch.ops._build import (INT, PTR, Kernel, c_function,
                                        raise_on_error)
from ratis_tpu_torch.ops.quorum import (_check, _check_peers, _device_of,
                                        _layout_views, layout_offsets,
                                        tick_offsets, wrap_i32)

# log2 lag histogram width: bucket 0 = caught up (lag 0), bucket i >= 1 =
# lag in [2^(i-1), 2^i) entries.  31 thresholds covers any int32 lag.
LAG_BUCKETS = 32

# packed-output section names, in order, with per-section width factors
# expressed over (g, num_peers); see pack_slices()
_SECTIONS = (("gap", "g"), ("delta", "g"), ("worst_lag", "g"),
             ("worst_peer", "g"), ("hist", "hist"), ("peer_links", "p"),
             ("peer_up", "p"), ("peer_laggy", "p"), ("peer_active", "p"),
             ("peer_laggy_active", "p"), ("peer_max_lag", "p"),
             ("scalars", "s"))


def pack_slices(g: int, num_peers: int) -> dict:
    """Slice of each section inside the packed int32 output vector."""
    widths = {"g": g, "hist": num_peers * LAG_BUCKETS, "p": num_peers,
              "s": 2}
    out, off = {}, 0
    for name, kind in _SECTIONS:
        w = widths[kind]
        out[name] = slice(off, off + w)
        off += w
    return out


def packed_size(g: int, num_peers: int) -> int:
    return 4 * g + n_counters(num_peers)


def n_counters(num_peers: int) -> int:
    """The packed vector's tail after the four [G] sections: the per-peer
    sections and the two scalars (K4 sums them over every row)."""
    return num_peers * (LAG_BUCKETS + 6) + 2


def lag_buckets(lag: torch.Tensor) -> torch.Tensor:
    """log2 bucket of a non-negative lag: exact integer compare-sum
    (bit_length), never a float log."""
    thresholds = torch.tensor([1 << i for i in range(LAG_BUCKETS - 1)],
                              dtype=torch.int32, device=lag.device)
    return (lag[..., None] >= thresholds).sum(dim=-1, dtype=torch.int32)


def _ledger_plain(role, match_index, commit_index, applied_index, conf_cur,
                  conf_old, self_mask, last_ack_ms, peer_index, prev_commit,
                  prev_valid, now_ms, lag_threshold, up_window_ms,
                  num_peers):
    active = role != ROLE_UNUSED
    is_leader = role == ROLE_LEADER
    member = (conf_cur | conf_old) & ~self_mask
    valid = member & is_leader[:, None] & (peer_index >= 0)
    lag = torch.where(valid, torch.clamp(wrap_i32(
        commit_index[:, None].long() - match_index.long()), min=0), 0)
    lag_or_none = torch.where(valid, lag, torch.full_like(lag, -1))
    # argmax taking the FIRST column on ties (torch.argmax does not
    # promise which): the lowest column index holding the row max
    row_max = lag_or_none.max(dim=1, keepdim=True).values
    cols = torch.arange(lag.shape[1], device=lag.device)
    worst_col = torch.where(lag_or_none == row_max, cols,
                            lag.shape[1]).min(dim=1).values
    worst_lag = row_max[:, 0]
    worst_peer = torch.where(
        worst_lag >= 0,
        torch.gather(peer_index, 1, worst_col[:, None])[:, 0],
        torch.full_like(worst_lag, -1))
    gap = torch.where(active, torch.clamp(wrap_i32(
        commit_index.long() - applied_index.long()), min=0), 0)
    delta = torch.where(is_leader & prev_valid, torch.clamp(wrap_i32(
        commit_index.long() - prev_commit.long()), min=0), 0)
    bucket = lag_buckets(lag)
    dev = lag.device
    onehot = valid[..., None] & (peer_index[..., None] == torch.arange(
        num_peers, dtype=torch.int32, device=dev))
    bucket_hot = bucket[..., None] == torch.arange(
        LAG_BUCKETS, dtype=torch.int32, device=dev)
    # integer histogram: per (peer, bucket) count of links
    hist = (onehot[..., :, None] & bucket_hot[..., None, :]).sum(
        dim=(0, 1), dtype=torch.int32).ravel()
    up = valid & (wrap_i32(int(now_ms) - last_ack_ms.long())
                  <= int(up_window_ms))
    laggy = valid & (lag >= int(lag_threshold))
    link_active = up & (delta > 0)[:, None]
    laggy_active = link_active & laggy

    def _per_peer(mask):
        return (onehot & mask[..., None]).sum(dim=(0, 1), dtype=torch.int32)

    peer_max_lag = torch.where(onehot, lag[..., None],
                               torch.full_like(onehot, -1, dtype=torch.int32)
                               ).amax(dim=(0, 1))
    scalars = torch.stack([is_leader.sum(dtype=torch.int32),
                           wrap_i32(gap.long().sum())])
    return torch.cat([
        gap, delta, worst_lag, worst_peer, hist, _per_peer(valid),
        _per_peer(up), _per_peer(laggy), _per_peer(link_active),
        _per_peer(laggy_active), peer_max_lag, scalars])


K4 = Kernel("ledger_pass.cu", "k4_ledger_pass",
            (PTR,) * 11 + (INT, INT, INT, PTR, INT, INT, INT))


def ledger_pass(role, match_index, commit_index, applied_index,
                conf_cur, conf_old, self_mask, last_ack_ms, peer_index,
                prev_commit, prev_valid, now_ms, lag_threshold,
                up_window_ms, *, num_peers: int) -> torch.Tensor:
    """The fused observability pass.  Array args keep the engine's
    host-mirror dtypes (role int8; masks and prev_valid bool; the rest
    int32); the scalars are Python ints; ``num_peers`` is the dense
    peer-table width.  Returns the packed int32 vector described by
    :func:`pack_slices`:

    - ``gap [G]``: commit - applied per active group.
    - ``delta [G]``: commit advance since the previous pass, leader rows
      with a valid baseline only.
    - ``worst_lag [G]`` / ``worst_peer [G]``: the laggiest follower link
      per leader row (the first column on ties), -1 where there is none.
    - ``hist [num_peers * LAG_BUCKETS]``: per-peer log2 lag histogram.
    - ``peer_* [num_peers]``: per-peer link counts across the groups this
      server leads (total, up, laggy, active, laggy_active) and max lag.
    - ``scalars [2]``: leader-row count, summed commit - applied gap.

    CUDA tensors: one launch of K4 (the engine's samples go through
    :class:`LedgerPlan` instead)."""
    arrays = (role, match_index, commit_index, applied_index, conf_cur,
              conf_old, self_mask, last_ack_ms, peer_index, prev_commit,
              prev_valid)
    dev = _device_of(*arrays)
    if dev.type == "cpu":
        return _ledger_plain(*arrays, now_ms, lag_threshold, up_window_ms,
                             num_peers)
    g, p = match_index.shape
    _check_peers(p)
    _check(role, torch.int8, (g,))
    for t in (commit_index, applied_index, prev_commit):
        _check(t, torch.int32, (g,))
    for t in (match_index, last_ack_ms, peer_index):
        _check(t, torch.int32, (g, p))
    for t in (conf_cur, conf_old, self_mask):
        _check(t, torch.bool, (g, p))
    _check(prev_valid, torch.bool, (g,))
    if num_peers <= 0:
        raise ValueError(f"num_peers {num_peers}: the table needs a column")
    out = torch.empty(packed_size(g, num_peers), dtype=torch.int32,
                      device=dev)
    K4(dev, *(t.data_ptr() for t in arrays), int(now_ms),
       int(lag_threshold), int(up_window_ms), out.data_ptr(), g, p,
       num_peers)
    return out


# A ledger sample's packed inputs: int32 sections first, so each is
# aligned.  ``k4_tick`` takes the sections' offsets in the order of
# LedgerViews (ledger_pass's argument order)
LEDGER_LAYOUT = (
    ("match_index", np.int32, "GP"), ("last_ack_ms", np.int32, "GP"),
    ("peer_index", np.int32, "GP"), ("commit_index", np.int32, "G"),
    ("applied_index", np.int32, "G"), ("prev_commit", np.int32, "G"),
    ("conf_cur", np.bool_, "GP"), ("conf_old", np.bool_, "GP"),
    ("self_mask", np.bool_, "GP"), ("role", np.int8, "G"),
    ("prev_valid", np.bool_, "G"))


def ledger_shapes(g: int, p: int) -> dict:
    return {"GP": (g, p), "G": (g,)}


class LedgerViews(NamedTuple):
    """The eleven inputs of a ledger sample, in ledger_pass's order."""

    role: np.ndarray           # int8 [G]
    match_index: np.ndarray    # int32 [G, P]
    commit_index: np.ndarray   # int32 [G]
    applied_index: np.ndarray  # int32 [G]
    conf_cur: np.ndarray       # bool [G, P]
    conf_old: np.ndarray       # bool [G, P]
    self_mask: np.ndarray      # bool [G, P]
    last_ack_ms: np.ndarray    # int32 [G, P]
    peer_index: np.ndarray     # int32 [G, P]
    prev_commit: np.ndarray    # int32 [G]
    prev_valid: np.ndarray     # bool [G]


class LedgerPlan:
    """K4's prepared call (the engine's ledger samples) for ``capacity``
    rows of ``peers`` slots, built once per capacity: a host buffer the
    caller writes the eleven inputs into (``views``; pinned on a card), its
    device copy and the packed output on both sides.  ``run(width, ...)``
    is ONE call into the kernel library (copy in, one launch, copy out,
    synchronise); the output, sized for a table of 8 at first, grows when
    a wider peer table asks for it.  On the CPU the same buffer feeds the
    plain version."""

    _plan = None

    def __init__(self, capacity: int, peers: int, device):
        self.capacity, self.peers = capacity, peers
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            _check_peers(peers)
        shapes = ledger_shapes(capacity, peers)
        nbytes = layout_offsets(LEDGER_LAYOUT, shapes)[-1]
        self._host = torch.zeros(nbytes, dtype=torch.uint8,
                                 pin_memory=self._cuda)
        views = dict(zip((name for name, _, _ in LEDGER_LAYOUT),
                         _layout_views(self._host.numpy(), LEDGER_LAYOUT,
                                       shapes)))
        self.views = LedgerViews(**{f: views[f] for f in LedgerViews._fields})
        self._tensors = LedgerViews(*map(torch.from_numpy, self.views))
        self._offsets = tick_offsets(LEDGER_LAYOUT, shapes,
                                     LedgerViews._fields)
        if self._cuda:
            self._dev_in = torch.empty(nbytes, dtype=torch.uint8,
                                       device=self.device)
            self.device = self._dev_in.device  # "cuda" names its index
            self._tick = c_function("ledger_pass.cu", "k4_tick",
                                    (PTR, INT, INT, INT, INT, PTR, PTR))
            self._plan_new = c_function("ledger_pass.cu", "k4_plan_new",
                                        (PTR,) * 4 + (INT,) * 4, PTR)
            self._plan_free = c_function("ledger_pass.cu", "k4_plan_free",
                                         (PTR,), None)
            self._stream = torch.cuda.current_stream(
                self.device).cuda_stream
        self.width = 0
        self._grow(8)

    def _grow(self, width: int) -> None:
        """Room for tables up to ``width`` peers wide."""
        n = packed_size(self.capacity, width)
        self._host_out = torch.zeros(n, dtype=torch.int32,
                                     pin_memory=self._cuda)
        self._out = self._host_out.numpy()
        if self._cuda:
            self._dev_out = torch.empty(n, dtype=torch.int32,
                                        device=self.device)
            plan = self._plan_new(
                self._host.data_ptr(), self._dev_in.data_ptr(),
                self._dev_out.data_ptr(), self._host_out.data_ptr(),
                self.capacity, self.peers, width, self.device.index)
            self._free()
            self._plan = plan
        self.width = width

    def run(self, width: int, now_ms: int, lag_threshold: int,
            up_window_ms: int) -> np.ndarray:
        """The ledger pass on the inputs in ``views`` with a peer table
        ``width`` wide: the packed int32 vector (:func:`pack_slices`), a
        view of the plan's output buffer, valid until the next run."""
        if width <= 0:
            raise ValueError(f"num_peers {width}: the table needs a column")
        if width > self.width:
            self._grow(width)
        out = self._out[:packed_size(self.capacity, width)]
        if self._cuda:
            if self._plan is None:
                raise RuntimeError("the ledger plan's C plan was freed")
            raise_on_error("ledger_pass.cu", "k4_tick", self._tick(
                self._plan, width, now_ms, lag_threshold, up_window_ms,
                self._offsets, self._stream))
            K4.launches += 1
        else:
            out[...] = _ledger_plain(*self._tensors, now_ms, lag_threshold,
                                     up_window_ms, width).numpy()
        return out

    def _free(self) -> None:
        if self._plan:
            self._plan_free(self._plan)
            self._plan = None

    def __del__(self):
        self._free()
