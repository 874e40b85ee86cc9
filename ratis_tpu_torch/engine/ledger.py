"""LagLedger: the quorum engine's lag & health ledger.

Host orchestration around :mod:`ratis_tpu_torch.ops.ledger`: every ``sample()``
writes the engine's authoritative host-mirror arrays (the same
``GroupBatchState`` the tick advances, so this works identically in
scalar-fallback and batched mode) into the pinned buffer of the ledger's
prepared call (``ops.ledger.LedgerPlan``), and one call into the kernel
library copies them to the engine's device, runs the fused pass (kernel
K4, one launch) and fetches ONE packed int32 vector.  Consumers — the
telemetry sampler's hot-group accounting, the watchdog's follower-lag and
grey-follower detectors, the ``GET /lag`` endpoint, the flight recorder —
read numpy views of that single transfer instead of walking the division
fleet in Python.

The ledger also owns the server-wide dense peer table: divisions intern
their peers' ids here (``peer_for``) and write the resulting dense ids
into ``GroupBatchState.peer_index``, which is what lets the kernel
aggregate one peer's health across every group it participates in with a
device-side scatter instead of a host-side group-by.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np

from ratis_tpu_torch.engine.roles import ROLE_LEADER
from ratis_tpu_torch.ops.ledger import LedgerPlan

LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class LedgerSample:
    """One fetched ledger pass: numpy views over the single packed
    transfer plus the host-mirror scalars consumers pair with it."""

    now_ms: int
    capacity: int
    peer_names: list
    commit: np.ndarray        # [G] engine commit at the pass
    pending: np.ndarray       # [G] mirrored leader pending-queue depths
    gen: np.ndarray           # [G] slot allocation generation
    leader_mask: np.ndarray   # [G] bool
    gap: np.ndarray           # [G] commit - applied
    delta: np.ndarray         # [G] commit advance since the last pass
    worst_lag: np.ndarray     # [G] laggiest follower link (-1 = none)
    worst_peer: np.ndarray    # [G] dense peer id of that link (-1 = none)
    hist: np.ndarray          # [num_peers, LAG_BUCKETS] log2 lag counts
    peer_links: np.ndarray    # [num_peers] follower links per peer
    peer_up: np.ndarray       # [num_peers] links acked within up-window
    peer_laggy: np.ndarray    # [num_peers] links >= lag_threshold behind
    peer_active: np.ndarray   # [num_peers] up links of advancing groups
    peer_laggy_active: np.ndarray  # [num_peers] laggy among active
    peer_max_lag: np.ndarray  # [num_peers] worst link lag (-1 = none)
    leading: int
    gap_total: int
    fetch_ms: float


class LagLedger:
    """Engine-attached; always constructed (a ledger nobody samples costs
    nothing).  ``lag_threshold`` / ``up_window_ms`` are plain attributes
    — the server seeds them from ``raft.tpu.lag.*`` and tests/chaos
    harnesses retune them live, exactly like the watchdog thresholds."""

    def __init__(self, engine, prefix: str):
        from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
        from ratis_tpu_torch.metrics.registry import (MetricRegistries,
                                                MetricRegistryInfo)
        self.engine = engine
        keys = RaftServerConfigKeys.Lag
        self.lag_threshold = keys.THRESHOLD_DEFAULT
        self.up_window_ms = int(keys.UP_WINDOW_DEFAULT.to_ms())
        self._peer_idx: dict[str, int] = {}
        self.peer_names: list[str] = []
        self._prev_commit = np.full(engine.state.capacity, -1, np.int32)
        self._prev_gen = np.full(engine.state.capacity, -1, np.int32)
        # the prepared call, built at the first sample and again when the
        # capacity changes (_sync_capacity)
        self._ledger_plan = None
        self.last_sample: Optional[LedgerSample] = None
        info = MetricRegistryInfo(prefix=prefix, application="ratis",
                                  component="engine", name="lag_ledger")
        self.registry = MetricRegistries.global_registries().create(info)
        r = self.registry
        self.samples = r.counter("ledgerSamples")
        # the mirrors into the plan + the one call (copy up, fused kernel,
        # the one device->host fetch), wall clock
        self.fetch_timer = r.timer("ledgerFetchCost")
        r.gauge("ledgerPeersTracked", lambda: len(self.peer_names))
        r.gauge("ledgerWorstLag",
                lambda: (int(self.last_sample.worst_lag.max())
                         if self.last_sample is not None else -1))
        r.gauge("ledgerGapTotal",
                lambda: (self.last_sample.gap_total
                         if self.last_sample is not None else 0))

    def unregister(self) -> None:
        from ratis_tpu_torch.metrics.registry import MetricRegistries
        MetricRegistries.global_registries().remove(self.registry.info)

    # ------------------------------------------------------- peer table

    def peer_for(self, peer_id) -> int:
        """Dense server-wide id for a peer (interned on first sight;
        peers are never forgotten — the table is bounded by the fleet)."""
        name = str(peer_id)
        idx = self._peer_idx.get(name)
        if idx is None:
            idx = len(self.peer_names)
            self._peer_idx[name] = idx
            self.peer_names.append(name)
        return idx

    def _table_width(self) -> int:
        """Static kernel width: next power of two >= the peer count (min
        8), so the table growing by one peer rarely costs a recompile."""
        n = max(8, len(self.peer_names))
        return 1 << (n - 1).bit_length()

    # --------------------------------------------------------- sampling

    def _sync_capacity(self, cap: int):
        """The prepared call for ``cap`` rows (remade when the capacity
        changed), the previous-pass baselines resized with it."""
        st = self.engine.state
        plan = self._ledger_plan
        if plan is None or plan.capacity != cap \
                or plan.peers != st.max_peers:
            # a mesh engine's slices are contiguous rows on the engine's
            # card: the flat pass reduces its per-peer sections over all
            plan = self._ledger_plan = LedgerPlan(cap, st.max_peers,
                                                  self.engine.device)
        if len(self._prev_commit) != cap:
            pc = np.full(cap, -1, np.int32)
            pg = np.full(cap, -1, np.int32)
            n = min(cap, len(self._prev_commit))
            pc[:n] = self._prev_commit[:n]
            pg[:n] = self._prev_gen[:n]
            self._prev_commit, self._prev_gen = pc, pg
        return plan

    def _run_pass(self, plan, width: int, now: int, commit: np.ndarray,
                  prev_commit: np.ndarray, prev_valid: np.ndarray
                  ) -> np.ndarray:
        """The mirrors into the plan's buffer, one call into the kernel
        library, and the packed result copied out of the plan's buffer
        (a sample keeps views of it; the next pass rewrites the buffer)."""
        st = self.engine.state
        v = plan.views
        np.copyto(v.role, st.role)
        np.copyto(v.match_index, st.match_index)
        np.copyto(v.commit_index, commit)
        np.copyto(v.applied_index, st.applied_index)
        np.copyto(v.conf_cur, st.conf_cur)
        np.copyto(v.conf_old, st.conf_old)
        np.copyto(v.self_mask, st.self_mask)
        np.copyto(v.last_ack_ms, st.last_ack_ms)
        np.copyto(v.peer_index, st.peer_index)
        np.copyto(v.prev_commit, prev_commit)
        np.copyto(v.prev_valid, prev_valid)
        return plan.run(width, now, self.lag_threshold,
                        self.up_window_ms).copy()

    def prewarm(self) -> None:
        """One pass through the prepared call (built here), recording no
        sample: the engine's prewarm launches K4 once before the server
        elects."""
        st = self.engine.state
        plan = self._sync_capacity(st.capacity)
        self._run_pass(plan, self._table_width(), self.engine.clock.now_ms(),
                       st.commit_index, st.commit_index,
                       st.role == ROLE_LEADER)

    def sample(self) -> LedgerSample:
        """One fused pass + one fetch, in one call of the prepared call.
        Same read discipline as the watchdog: plain reads of the host
        mirrors, tolerating concurrent mutation (a torn row is one sample
        of noise, never a tear)."""
        st = self.engine.state
        cap = st.capacity
        plan = self._sync_capacity(cap)
        names = list(self.peer_names)
        width = self._table_width()
        now = self.engine.clock.now_ms()
        commit = st.commit_index.copy()
        pending = st.pending_count.copy()
        gen = st.alloc_gen.copy()
        leader_mask = st.role == ROLE_LEADER
        prev_valid = self._prev_gen == gen
        from ratis_tpu_torch.ops.ledger import LAG_BUCKETS, pack_slices
        t0 = time.perf_counter()
        packed = self._run_pass(plan, width, now, commit, self._prev_commit,
                                prev_valid)
        elapsed_s = time.perf_counter() - t0
        self.fetch_timer.update(elapsed_s)
        self._prev_commit = commit
        self._prev_gen = np.where(leader_mask, gen, -1).astype(np.int32)
        sl = pack_slices(cap, width)
        scalars = packed[sl["scalars"]]
        s = LedgerSample(
            now_ms=now, capacity=cap, peer_names=names,
            commit=commit, pending=pending, gen=gen,
            leader_mask=leader_mask,
            gap=packed[sl["gap"]], delta=packed[sl["delta"]],
            worst_lag=packed[sl["worst_lag"]],
            worst_peer=packed[sl["worst_peer"]],
            hist=packed[sl["hist"]].reshape(width, LAG_BUCKETS),
            peer_links=packed[sl["peer_links"]],
            peer_up=packed[sl["peer_up"]],
            peer_laggy=packed[sl["peer_laggy"]],
            peer_active=packed[sl["peer_active"]],
            peer_laggy_active=packed[sl["peer_laggy_active"]],
            peer_max_lag=packed[sl["peer_max_lag"]],
            leading=int(scalars[0]), gap_total=int(scalars[1]),
            fetch_ms=round(elapsed_s * 1e3, 3))
        self.samples.inc()
        self.last_sample = s
        return s
