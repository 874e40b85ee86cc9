#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--groups 1024] [--writes 4] [--out FILE]

Phases, in order; any failure raises, exits non-zero and prints no
result line:

1. environment: the card's name and power limit (nvidia-smi), CUDA present,
   which msgpack the wire codec uses;
2. build: nvcc compiles the kernels from this checkout's sources;
3. kernel parity: K1-K6 against their plain-torch versions on the
   same CUDA inputs, several seeds with the edge cases of
   ``ratis_tpu_torch.tools.cases`` (negative indices included), K6 also
   on the bench's own batches at its three shapes, its inputs unchanged;
   K5 at 1, 2 and 8 slices with rows past and before the slice and padding
   columns, equal to K1 at one slice, and on the mesh100k rung's batch
   (also equal to K1 on the same acks unrouted); K7a-c (the vote-reply
   scatter, the all-members replicated index, the lease expiry) at G =
   1024 and 102400 with P = 8 and at P = 3, 5, 7 and 16, with the edge
   cases of ``cases.vote_event_edges`` and the wrapping lease timeouts;
   the bar is exact equality;
4. the main paths, each with its kernels' launch counts zeroed just
   before and read just after (each must be > 0; K5 must stay 0 on the
   paths without a mesh):
   a. simulated transport: 3 port servers x ``--groups`` groups on
      ``cuda`` with the batched properties, leaders by election,
      ``--writes`` INCREMENTs per group through the port's RaftClient,
      every counter read back from all three replicas (K1-K4);
   b. the bench's kernel rungs (``tools/bench.py``): the stateless tick
      at 10240 x 8 x 4096 and 102400 x 8 x 8192 (K6);
   c. the bench's headline e2e rung over real localhost TCP sockets:
      3 servers x 1024 groups, one warm-up write and 8 writes per group,
      every write acknowledged and every counter read back equal from all
      three replicas (K1-K4; the cluster is prewarmed before the counts
      are zeroed); a socket that cannot bind fails the run;
   d. the mesh path: 3 servers x 1024 groups with ``mesh-devices=8`` over
      the simulated transport, 4 INCREMENTs per group, every counter read
      back from all three replicas, 8 slices on every server (K5, K2, K3
      and K4 > 0; K1 must stay 0: a mesh engine's fast ticks are K5);
      then ``dryrun_multichip(8)`` and the bench's ``mesh_100k`` rung
      (K5 against the flat K1 at 102400 x 8 x 8192);
   e. ``durable_1024``, the bench's ``durable`` rung: 3 servers x 1024
      groups over localhost TCP on the server's default durable log
      (per-group segment files in a fresh temporary directory),
      ``ArithmeticStateMachine``, 1 + 8 writes per group at 128 in
      flight; every replica's variable map equal to the fold of the
      acknowledged writes, then a full restart from disk and the same
      check (K1-K4 > 0, K5 0); fsyncs per commit and the storage's
      filesystem are printed;
   f. ``shared_256``: the same on the shared log plane
      (``raft.tpu.log.shared``) at 3 x 256 groups;
   g. ``churn_1024``, the bench's ``churn`` rung: 3 x 1024 over the
      simulated transport, 8 writes per group while 64 leadership
      transfers run and 8 groups each go through a joint-consensus round;
      every write acknowledged and every counter read back in the final
      configuration (K1-K4 > 0, K5 0, and K1/K2 launched while the
      calling engine led a row with a non-empty ``conf_old`` more than 0
      times);
5. kernel parity again at every shape the main paths gave K1-K5, then
   timing: K1-K5 at their most common shape (K5 also at the mesh100k
   rung's), K6 at both rung shapes;
   CUDA events, warm-up, median of 60 calls (K1/K2/K5 each on the same
   fresh state), beside the plain version's time and the card's bound for
   the same work, and each one's device time per call from
   ``torch.profiler``; K7a-c at G = 1024, P = 8 (K7a with 2048 events;
   no path calls K7: every path's run checks that it launched 0 times,
   so phases 3 and 5 make all of its launches);
6. one JSON line of kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

It needs one CUDA card and nothing else of the machine but nvcc; it
builds into ``ratis_tpu_torch/_build/`` and starts no process that
outlives it.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

P = 8
NOW = 100_000
TIMEOUT_MS = 300
# the bench's headline e2e rung: 3 servers x 1024 groups over TCP, one
# warm-up write and then 8 measured writes per group
TCP_GROUPS = 1024
TCP_WRITES = 8
# H100 SXM published peaks: HBM bytes/s, and the INT32 rate (132 SMs x
# 64 INT32 lanes x 1.98 GHz, a multiply-add counted as two, as NVIDIA
# counts it), against which the kernels' integer ops count
HBM_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 33.5e12

KERNELS = (
    # name, wrapper attribute, source, the JAX function it replaces
    ("engine_step_resident_fast", "K1",
     "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:394"),
    ("engine_step_resident", "K2",
     "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:325"),
    ("tally_votes", "K3", "ratis_tpu_torch/ops/kernels/tally_votes.cu",
     "ratis_tpu/ops/quorum.py:144"),
    ("ledger_pass", "K4", "ratis_tpu_torch/ops/kernels/ledger_pass.cu",
     "ratis_tpu/ops/ledger.py:68"),
    ("engine_step_resident_fast_sliced", "K5",
     "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:465"),
    ("engine_step", "K6", "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:257"),
    ("apply_vote_events", "K7a", "ratis_tpu_torch/ops/kernels/vote_lease.cu",
     "ratis_tpu/ops/quorum.py:501"),
    ("all_replicated_min", "K7b",
     "ratis_tpu_torch/ops/kernels/vote_lease.cu",
     "ratis_tpu/ops/quorum.py:110"),
    ("lease_expiry", "K7c", "ratis_tpu_torch/ops/kernels/vote_lease.cu",
     "ratis_tpu/ops/quorum.py:208"),
)
# K7: no path of the server calls them (none of the JAX package does)
K7 = ("K7a", "K7b", "K7c")
K7_PEERS = (3, 5, 7, 16)
K7_VOTE_EDGES = ((4, 3), (2, 3), (16, 8), (8, 16), (1024, 8))
# the durable paths: 3 x 1024 per-group logs, 3 x 256 on the shared plane,
# 1 warm-up + 8 measured writes per group; the churn path: 3 x 1024
DURABLE_GROUPS = 1024
SHARED_GROUPS = 256
DURABLE_WRITES = 8
CHURN_GROUPS = 1024
CHURN_WRITES = 8
# K6: entry() and the bench's two kernel rungs (G, P, E)
K6_SHAPES = ((1024, 8, 256), (10_240, 8, 4096), (102_400, 8, 8192))
# the mesh path: 3 servers x 1024 groups in 8 slices, 4 writes per group.
# Capacity 2048, not the bench's bucket of 1024: divisions pin to their
# crc32 slice, which fills 8 slices of 128 rows unevenly, and a full slice
# refuses its group (the bench's 10240 rung has 16384 rows)
MESH_GROUPS = 1024
MESH_SLICES = 8
MESH_MAX_GROUPS = 2048
MESH_WRITES = 4


def log(*a) -> None:
    print(*a, flush=True)


def max_abs_err(got, want) -> int:
    err = 0
    for x, y in zip(got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def cuda(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


# -- phases 3 and 5: parity ----------------------------------------------------

def parity_k1(tq, cases, g, p, e, seed, negative=False):
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW)
    ev, meta = cuda([cases.fast_events(rng, g, p, e, NOW, negative),
                     np.array([NOW, TIMEOUT_MS], np.int32)])
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident_fast(a, ev, meta)
    want = tq._resident_fast_plain(b, ev, meta)
    return max_abs_err([k.out, *a], [want, *b])


def parity_k2(tq, cases, g, p, d, e, seed, negative=False):
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW)
    rf_idx, rf, acks = cases.refresh(rng, g, p, d, e, NOW, negative)
    rf_idx, *rf = cuda([rf_idx, *rf])
    acks = cuda(acks)
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident(a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS)
    want = tq._resident_refresh_plain(b, rf_idx, rf, acks, NOW, TIMEOUT_MS)
    return max_abs_err([torch.stack(k[1:]), *a], [want, *b])


def parity_k5(tq, cases, g, p, s, e, seed, negative=False):
    """K5 against its plain version; at one slice also against K1 on the
    same plane."""
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW)
    ev, meta = cuda([cases.sliced_events(rng, g, p, s, e, NOW, negative),
                     np.array([NOW, TIMEOUT_MS], np.int32)])
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident_fast_sliced(a, ev, meta)
    want = tq._resident_fast_sliced_plain(b, ev, meta)
    err = max_abs_err([k.out, *a], [want, *b])
    if s == 1:
        c = tq.device_state_from_numpy(st, "cuda")
        k1 = tq.engine_step_resident_fast(c, ev[:, 0].contiguous(), meta)
        err = max(err, max_abs_err([k.out, *a], [k1.out, *c]))
    return err


def parity_k5_rung(tq, bench):
    """K5 on the mesh100k rung's batch against its plain version, and
    against K1 on the same acks with global rows."""
    state, evs, evf, meta = bench.mesh100k_batch()
    ev_s, ev_f, mt = cuda([evs, evf, meta])
    a, b, c = (tq.device_state_from_numpy(state, "cuda") for _ in range(3))
    k = tq.engine_step_resident_fast_sliced(a, ev_s, mt)
    want = tq._resident_fast_sliced_plain(b, ev_s, mt)
    k1 = tq.engine_step_resident_fast(c, ev_f, mt)
    return max(max_abs_err([k.out, *a], [want, *b]),
               max_abs_err([k.out, *a], [k1.out, *c]))


def parity_k6(tq, args_np):
    """K6 against its plain version on the same card tensors; raises if
    the kernel wrote any of its inputs (it is functional, as in JAX)."""
    args = tq.engine_step_args_from_numpy(args_np, "cuda")
    before = [t.clone() for t in args[:15]]
    k = tq.engine_step(*args)
    want = tq._engine_step_plain(*args)
    torch.cuda.synchronize()
    for (name, _, _), x, y in zip(tq.ENGINE_STEP_ARRAYS, args, before):
        if not torch.equal(x, y):
            raise AssertionError(f"K6 wrote its input {name}")
    return max_abs_err(list(k), list(want))


def parity_k3(tq, cases, g, p, seed):
    args = cuda(cases.tally_inputs(np.random.default_rng(seed), g, p))
    return max_abs_err([tq.tally_votes_packed(*args)],
                       [tq._tally_plain(*args)])


def parity_k4(tl, cases, g, p, width, seed, big_cell=False):
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(seed), g, p,
                                          width, big_cell=big_cell)
    dev = cuda(arrays)
    return max_abs_err([tl.ledger_pass(*dev, *scalars, num_peers=width)],
                       [tl._ledger_plain(*dev, *scalars, width)])


def parity_k7a(tq, arrays):
    """K7a against its plain version; raises if the kernel wrote any of
    its inputs (it is functional, as in JAX)."""
    args = cuda(arrays)
    before = [t.clone() for t in args]
    got = tq.apply_vote_events(*args)
    want = tq._apply_vote_events_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip(args, before):
        if not torch.equal(x, y):
            raise AssertionError("K7a wrote one of its inputs")
    return max_abs_err(list(got), list(want))


def parity_k7b(tq, arrays):
    args = cuda(arrays)
    return max_abs_err([tq.all_replicated_min(*args)],
                       [tq._all_replicated_min_plain(*args)])


def parity_k7c(tq, arrays, timeout):
    args = cuda(arrays)
    return max_abs_err([tq.lease_expiry(*args, timeout)],
                       [tq._lease_expiry_plain(*args, timeout)])


def run_parity_k7(tq, cases, par) -> None:
    """K7a-c: seeded cases at G = 1024 and 102400 with P = 8, at P = 3,
    5, 7, 16 with G = 1024, the hand-made vote edges, every lease
    timeout of ``cases.LEASE_TIMEOUTS``."""
    shapes = [(1024, P), (102_400, P)] + [(1024, p) for p in K7_PEERS]
    for seed, (g, p) in enumerate(shapes):
        rng = np.random.default_rng(seed)
        for e in (g // 4, 2 * g):
            par.add("K7a", parity_k7a(tq, cases.vote_events(rng, g, p, e)))
        par.add("K7b", parity_k7b(tq, cases.replicated_inputs(rng, g, p)))
        lease = cases.lease_inputs(rng, g, p, NOW)
        for t in cases.LEASE_TIMEOUTS:
            par.add("K7c", parity_k7c(tq, lease, t))
    for g, p in K7_VOTE_EDGES:
        par.add("K7a", parity_k7a(tq, cases.vote_event_edges(g, p)))


class Parity:
    """The largest error and the number of cases, per kernel."""

    def __init__(self):
        self.errs = collections.defaultdict(int)
        self.n = collections.Counter()

    def add(self, key: str, err: int) -> None:
        self.errs[key] = max(self.errs[key], err)
        self.n[key] += 1

    def check(self, what: str) -> None:
        torch.cuda.synchronize()
        for k in sorted(self.n):
            log(f"parity ({what}): {k} {self.n[k]} cases, "
                f"max_abs_err {self.errs[k]}")
            if self.errs[k] != 0:
                raise AssertionError(f"{k} disagrees with its plain version: "
                                     f"max_abs_err {self.errs[k]}")


def run_parity(tq, tl, cases, bench, par: Parity) -> None:
    """Fixed shapes, before the main path: the edge cases at G up to
    102400 and E up to 16384."""
    for g in (1024, 10240, 102400):
        for e in (64, 1024, 16384):
            for seed in (0, 1):
                par.add("K1", parity_k1(tq, cases, g, P, e, seed))
            par.add("K1", parity_k1(tq, cases, g, P, e, 2, negative=True))
    for g in (1024, 10240):
        for d, e in ((64, 64), (1024, 1024), (64, 16384)):
            for seed in (0, 1):
                par.add("K2", parity_k2(tq, cases, g, P, d, e, seed))
            par.add("K2", parity_k2(tq, cases, g, P, d, e, 2, negative=True))
        for seed in (0, 1, 2):
            par.add("K3", parity_k3(tq, cases, g, P, seed))
        for width in (8, 16):
            for seed in (0, 1):
                par.add("K4", parity_k4(tl, cases, g, P, width, seed))
        par.add("K4", parity_k4(tl, cases, g, P, 8, 2, big_cell=True))
    for g in (2048, 10240):
        for s in (1, 2, MESH_SLICES):
            for e in (64, 2048):
                par.add("K5", parity_k5(tq, cases, g, P, s, e, 0))
                par.add("K5", parity_k5(tq, cases, g, P, s, e, 1,
                                        negative=True))
    par.add("K5", parity_k5_rung(tq, bench))
    for g, p, e in K6_SHAPES:
        for seed in (0, 1, 2):
            par.add("K6", parity_k6(tq, cases.step_args(
                np.random.default_rng(seed), g, p, e, NOW, TIMEOUT_MS)))
            par.add("K6", parity_k6(tq, bench._example_batch(g, p, e, seed)))
    run_parity_k7(tq, cases, par)
    par.check("fixed shapes")


def run_parity_observed(tq, tl, cases, main, shapes, par: Parity,
                        what: str) -> None:
    """Every shape a main path gave a kernel, after the main path."""
    g, p, w = main["capacity"], main["peers"], main["ledger_width"]
    for seed in (10, 11):
        for e in shapes["K1"]:
            par.add("K1", parity_k1(tq, cases, g, p, e, seed))
        for d, e in shapes["K2"]:
            par.add("K2", parity_k2(tq, cases, g, p, d, e, seed))
        for s, e in shapes["K5"]:
            par.add("K5", parity_k5(tq, cases, g, p, s, e, seed))
        par.add("K3", parity_k3(tq, cases, g, p, seed))
        par.add("K4", parity_k4(tl, cases, g, p, w, seed))
    par.check(f"{what} shapes")


# -- phase 4: the main path --------------------------------------------------

async def drive(cluster, writes: int) -> dict:
    try:
        t0 = time.monotonic()
        await cluster.start(timeout=600)
        bring_up = time.monotonic() - t0
        timeouts = cluster.election_timeouts()
        stats = await cluster.write_all(writes)
        timeouts = [timeouts, cluster.election_timeouts() - timeouts]
        counters = await cluster.read_counters(timeout=300)
        # the watchdog's ledger pass runs once a second on every server
        deadline = time.monotonic() + 30
        while any(s.engine.ledger.samples.count == 0
                  for s in cluster.servers):
            if time.monotonic() > deadline:
                raise AssertionError("no ledger sample on some server")
            await asyncio.sleep(0.1)
        for g in cluster.groups:
            want = stats["acked"][g.group_id]
            got = counters[g.group_id]
            if want != writes or got != [want] * len(cluster.servers):
                raise AssertionError(f"group {g.group_id}: acked {want}, "
                                     f"replica counters {got}")
        for s in cluster.servers:
            e = s.engine
            if e.device.type != "cuda" or not e._dev.match_index.is_cuda:
                raise AssertionError(f"{s.peer_id}: engine state not on "
                                     f"cuda")
            if e.metrics["batched_dispatches"] == 0:
                raise AssertionError(f"{s.peer_id}: no batched dispatch")
        return {"bring_up_s": bring_up, **{k: v for k, v in stats.items()
                                           if k != "acked"},
                "election_timeouts": timeouts,
                "dispatches": [s.engine.metrics["batched_dispatches"]
                               for s in cluster.servers],
                "ledger_samples": [s.engine.ledger.samples.count
                                   for s in cluster.servers]}
    finally:
        await cluster.close()


class ShapeRecorder:
    """Records the shapes the engine hands K1, K2 and K5 while active (the
    wrappers are swapped for counting ones and restored on exit)."""

    def __init__(self, tq):
        self.tq = tq
        self.shapes = {"K1": collections.Counter(),
                       "K2": collections.Counter(),
                       "K5": collections.Counter()}

    def __enter__(self):
        tq, shapes = self.tq, self.shapes
        self.fast, self.refresh, self.sliced = (
            tq.engine_step_resident_fast, tq.engine_step_resident,
            tq.engine_step_resident_fast_sliced)
        fast, refresh, sliced = self.fast, self.refresh, self.sliced

        def rec_fast(state, ev, meta):
            shapes["K1"][ev.shape[1]] += 1
            return fast(state, ev, meta)

        def rec_refresh(state, rf_idx, *rest):
            shapes["K2"][(rf_idx.shape[0], rest[10].shape[0])] += 1
            return refresh(state, rf_idx, *rest)

        def rec_sliced(state, ev, meta):
            shapes["K5"][(ev.shape[1], ev.shape[2])] += 1
            return sliced(state, ev, meta)

        tq.engine_step_resident_fast = rec_fast
        tq.engine_step_resident = rec_refresh
        tq.engine_step_resident_fast_sliced = rec_sliced
        return self

    def __exit__(self, *exc):
        self.tq.engine_step_resident_fast = self.fast
        self.tq.engine_step_resident = self.refresh
        self.tq.engine_step_resident_fast_sliced = self.sliced


def counted(kernels: dict, keys, drive, never=()):
    """Zero the launch counts of ``keys``, ``never`` and K7 just before
    ``drive()``, read them just after; every one of ``keys`` must be > 0,
    every one of ``never`` and of K7 (no path calls it) 0."""
    never = (*never, *K7)
    for k in (*keys, *never):
        kernels[k].launches = 0
    res = drive()
    launches = {k: kernels[k].launches for k in (*keys, *never)}
    for k in keys:
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on this path")
    for k in never:
        if launches[k] != 0:
            raise AssertionError(f"{k} launched {launches[k]} times on a "
                                 f"path that must not take it")
    return res, launches


def run_main_path(tq, kernels, groups: int, writes: int, rec):
    from ratis_tpu_torch.tools.cluster import Cluster
    cluster = Cluster(groups, device="cuda")
    cluster.prewarm()
    with rec:
        res, launches = counted(kernels, ("K1", "K2", "K3", "K4"),
                                lambda: asyncio.run(drive(cluster, writes)),
                                never=("K5",))
    res.update(engine_shape(cluster))
    return res, launches


def engine_shape(cluster) -> dict:
    e = cluster.servers[0].engine
    return {"capacity": e.state.capacity, "peers": e.state.max_peers,
            "ledger_width": e.ledger._table_width()}


def run_mesh_path(kernels, rec):
    """3 servers x 1024 groups, every engine in 8 slices: the fast ticks
    must all be K5."""
    from ratis_tpu_torch.conf import RaftServerConfigKeys
    from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties
    props = cluster_properties(MESH_GROUPS, 3, "cuda", "sim", MESH_SLICES)
    props.set(RaftServerConfigKeys.Engine.MAX_GROUPS_KEY,
              str(MESH_MAX_GROUPS))
    cluster = Cluster(MESH_GROUPS, device="cuda", properties=props)
    cluster.prewarm()
    with rec:
        res, launches = counted(
            kernels, ("K2", "K3", "K4", "K5"),
            lambda: asyncio.run(drive(cluster, MESH_WRITES)), never=("K1",))
    slices = [(s.engine.state.n_slices, s.engine.mesh.n_slices)
              for s in cluster.servers]
    if slices != [(MESH_SLICES, MESH_SLICES)] * 3:
        raise AssertionError(f"mesh path: slices {slices}")
    res["n_slices"] = [n for n, _ in slices]
    res.update(engine_shape(cluster))
    return res, launches


def run_mesh_rungs(kernels, bench):
    """``dryrun_multichip(8)`` (K6, then a mesh engine: K5 and K2) and the
    bench's ``mesh_100k`` rung (K5 and its control K1)."""
    return counted(kernels, ("K1", "K2", "K5", "K6"), lambda: {
        "dryrun_multichip": bench.dryrun_multichip(MESH_SLICES, "cuda"),
        "mesh_100k": bench.mesh_100k_rung("cuda")})


def run_kernel_rungs(kernels, bench):
    """The bench's kernel rungs on the card (K6)."""
    return counted(kernels, ("K6",), lambda: {
        "kernel": bench.kernel_rung("cuda"),
        "kernel_100k": bench.kernel_100k_rung("cuda")})


def run_tcp_path(kernels, bench, rec):
    """The bench's headline e2e rung: 3 servers over localhost TCP."""
    cluster = bench.e2e_cluster("cuda", TCP_GROUPS)
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.e2e_rung(cluster, TCP_WRITES)),
            never=("K5",))
    groups = TCP_GROUPS
    want = groups * (bench.WARMUP_WRITES + TCP_WRITES)
    if res["acked"] != want or res["replicas_read_back"] != groups * 3:
        raise AssertionError(f"TCP path: {res['acked']} of {want} writes "
                             f"acked, {res['replicas_read_back']} replicas "
                             f"read back")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"TCP path: engine on {res['engine_device']}")
    return res, launches


def run_durable_path(kernels, bench, groups: int, shared: bool):
    """The bench's durable rung (``shared``: on the shared log plane) in a
    fresh temporary directory: 3 servers x ``groups`` groups over TCP,
    ArithmeticStateMachine, every map held to the fold before and after a
    full restart from disk."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="ratis-smoke-durable-") as tmp:
        cluster = bench.durable_cluster("cuda", groups, tmp, shared)
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.durable_rung(cluster, DURABLE_WRITES)),
            never=("K5",))
    want = groups * (bench.WARMUP_WRITES + DURABLE_WRITES)
    if res["acked"] != want or res["replicas_read_back"] != [groups * 3] * 2:
        raise AssertionError(f"durable path: {res['acked']} of {want} "
                             f"writes acked, replicas read back "
                             f"{res['replicas_read_back']}")
    if not res["engine_device"].startswith("cuda") \
            or res["shared_log"] != shared:
        raise AssertionError(f"durable path: engine on "
                             f"{res['engine_device']}, shared log "
                             f"{res['shared_log']}")
    return res, launches


class JointRecorder:
    """While active, counts the K1 and K2 calls an engine made while its
    host mirror had a row it leads (role leader) with a non-empty
    ``conf_old`` (joint consensus: the only rows where the ``conf_old``
    branch decides a commit); the wrappers are swapped for counting ones
    and restored on exit."""

    def __init__(self, tq, cluster):
        from ratis_tpu_torch.engine.roles import ROLE_LEADER
        self.tq = tq
        self.cluster = cluster
        self.leader = ROLE_LEADER
        self.joint_calls = {"K1": 0, "K2": 0}
        # calls on a state no engine held (reported; expected 0)
        self.unmatched = 0

    def _leads_joint_row(self, state) -> bool:
        for s in self.cluster.servers:
            e = s.engine
            if e._dev is state:
                m = e.state
                return bool((m.conf_old.any(axis=1)
                             & (m.role == self.leader)).any())
        self.unmatched += 1
        return False

    def __enter__(self):
        tq = self.tq
        self.fast, self.refresh = (tq.engine_step_resident_fast,
                                   tq.engine_step_resident)
        fast, refresh = self.fast, self.refresh

        def rec_fast(state, *rest):
            self.joint_calls["K1"] += self._leads_joint_row(state)
            return fast(state, *rest)

        def rec_refresh(state, *rest):
            self.joint_calls["K2"] += self._leads_joint_row(state)
            return refresh(state, *rest)

        tq.engine_step_resident_fast = rec_fast
        tq.engine_step_resident = rec_refresh
        return self

    def __exit__(self, *exc):
        self.tq.engine_step_resident_fast = self.fast
        self.tq.engine_step_resident = self.refresh


def run_churn_path(tq, kernels, bench):
    """The bench's churn rung: leadership transfers and joint-consensus
    rounds under write load, over the simulated transport."""
    cluster = bench.churn_cluster("cuda", CHURN_GROUPS)
    with JointRecorder(tq, cluster) as rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.churn_rung(cluster, CHURN_WRITES)),
            never=("K5",))
    res["joint_calls"] = dict(rec.joint_calls)
    res["joint_unmatched_calls"] = rec.unmatched
    if res["transfers_ok"] + res["transfers_failed"] != bench.CHURN_TRANSFERS:
        raise AssertionError(f"churn path: {res['transfers_ok']} + "
                             f"{res['transfers_failed']} transfers counted "
                             f"of {bench.CHURN_TRANSFERS}")
    if res["commits"] != CHURN_GROUPS * CHURN_WRITES \
            or res["replicas_read_back"] != CHURN_GROUPS * 3 \
            or res["final_conf_sizes"] != [3]:
        raise AssertionError(f"churn path: {res['commits']} writes acked, "
                             f"{res['replicas_read_back']} replicas read "
                             f"back, conf sizes {res['final_conf_sizes']}")
    if rec.joint_calls["K1"] + rec.joint_calls["K2"] == 0:
        raise AssertionError("churn path: no K1/K2 launch while the engine "
                             "led a row in joint consensus")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"churn path: engine on {res['engine_device']}")
    return res, launches


# -- phase 5: timing ---------------------------------------------------------

def timed(fn, setup=None, n: int = 60, warm: int = 5) -> float:
    """Median CUDA-event time of ``fn``; ``setup`` runs before each call,
    outside the events."""
    for _ in range(warm):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if setup:
            setup()
            torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def state_bytes(g, p):
    # match, last_ack (int32), self/cur/old (bool), role (int8), 4 x int32
    return g * p * (4 + 4 + 3) + g * (1 + 16)


def written_bytes(before, after) -> int:
    """Bytes of the in-place state that one call changed: the least an
    in-place update must write."""
    return sum(int((x != y).sum()) * x.element_size()
               for x, y in zip(before, after))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_INT32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_inplace(tq, st, kernel, plain):
    """Kernel and plain times of an in-place step, each call on the same
    fresh state, and the state bytes one call changes."""
    fresh = tq.device_state_from_numpy(st, "cuda")
    a = tq.device_state_from_numpy(st, "cuda")

    def restore():
        for x, y in zip(a, fresh):
            x.copy_(y)

    ms = timed(lambda: kernel(a), restore)
    plain_ms = timed(lambda: plain(a), restore)
    restore()
    plain(a)
    return ms, plain_ms, written_bytes(fresh, a)


def k6_bytes(g: int, p: int, e: int) -> int:
    """K6's least traffic: each input read once (match and last_ack int32
    and three bool masks per link; four int32 and one bool per ack;
    flush, commit, first, deadline int32 and role int8 per row), each
    output written once (two [G, P] int32, new_commit int32 and three
    bools per row)."""
    return g * p * (8 + 3) + 17 * e + 17 * g + g * p * 8 + 7 * g


def device_us_per_call(fn, n: int = 20):
    """Device time per call of ``fn`` (every kernel and copy the profiler
    traced, summed), or None when the trace shows no device time."""
    from ratis_tpu_torch.tools.profile_main_path import _device_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(evt) for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA)
    return total / n if total > 0 else None


def k5_timing(tq, st, ev_np, out, key, device_us) -> None:
    """K5 on ``ev_np`` ([7, S, E]) over the state ``st``: each input read
    once (the state, the S x E event columns, meta), the state it changes
    and the [4, G] output written once."""
    g, p = st[0].shape
    _, s, e = ev_np.shape
    ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
    ms, plain, wrote = time_inplace(
        tq, st, lambda a: tq.engine_step_resident_fast_sliced(a, ev, meta),
        lambda a: tq._resident_fast_sliced_plain(a, ev, meta))
    nbytes = state_bytes(g, p) + 7 * s * e * 4 + 8 + wrote + 16 * g
    out[key] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * s * e),
                f"G={g} P={p} S={s} E={e}")
    a = tq.device_state_from_numpy(st, "cuda")
    device_us[key] = device_us_per_call(
        lambda: tq.engine_step_resident_fast_sliced(a, ev, meta))


def k7_timing(tq, cases, g: int, p: int, out, device_us) -> None:
    """K7a-c at the main paths' G and P (K7a with two replies per group):
    each input read once and each output written once (K7a: both [G, P]
    masks in and out, 10 bytes per event; K7b: the int32 and three bool
    [G, P] arrays and the flush index in, int32 [G] out; K7c: the int32
    and three bool [G, P] arrays in, int32 [G] out).  No PyTorch call
    computes any of the three alone, so there is no library time."""
    rng = np.random.default_rng(7)
    e = 2 * g
    votes = cuda(cases.vote_events(rng, g, p, e))
    repl = cuda(cases.replicated_inputs(rng, g, p))
    lease = cuda(cases.lease_inputs(rng, g, p, NOW))
    timeout = 1000
    work = (
        ("K7a", lambda: tq.apply_vote_events(*votes),
         lambda: tq._apply_vote_events_plain(*votes),
         4 * g * p + 10 * e, 10 * e, f"G={g} P={p} E={e}"),
        ("K7b", lambda: tq.all_replicated_min(*repl),
         lambda: tq._all_replicated_min_plain(*repl),
         7 * g * p + 8 * g, g * (3 * p + 4), f"G={g} P={p}"),
        ("K7c", lambda: tq.lease_expiry(*lease, timeout),
         lambda: tq._lease_expiry_plain(*lease, timeout),
         7 * g * p + 4 * g, g * (8 * p * p + 16), f"G={g} P={p}"))
    for key, kernel, plain, nbytes, ops, shape in work:
        ms = timed(kernel)
        plain_ms = timed(plain)
        out[key] = (ms, plain_ms, *bound(nbytes, ops), shape)
        device_us[key] = device_us_per_call(kernel)


def run_timing(tq, tl, cases, bench, main, shapes, mesh_main,
               mesh_shapes) -> dict:
    """K1-K4 at the main paths' most common shape, K5 at the mesh path's
    (key ``K5``) and on the mesh100k rung's batch (``K5_100k``), K6 at
    both kernel-rung shapes (key ``K6`` at 10240 groups, ``K6_100k`` at
    102400).  Bytes: every input read once (K2's refresh rows only where
    they are not padding), the state elements a call changes and the
    outputs written once.  Device time per call from ``torch.profiler``
    for every kernel (K1/K2 on a state of their own that the profiled
    calls keep updating: the same events again, so the same work)."""
    g, p, w = main["capacity"], main["peers"], main["ledger_width"]
    e1 = shapes["K1"].most_common(1)[0][0]
    d2, e2 = shapes["K2"].most_common(1)[0][0]
    rng = np.random.default_rng(99)
    st = cases.resident_state(rng, g, p, NOW)
    out = {}
    device_us = {}

    # K1
    ev, meta = cuda([cases.fast_events(rng, g, p, e1, NOW),
                     np.array([NOW, TIMEOUT_MS], np.int32)])
    ms, plain, wrote = time_inplace(
        tq, st, lambda s: tq.engine_step_resident_fast(s, ev, meta),
        lambda s: tq._resident_fast_plain(s, ev, meta))
    nbytes = state_bytes(g, p) + 28 * e1 + 8 + wrote + 16 * g
    out["K1"] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * e1),
                 f"G={g} P={p} E={e1}")
    a = tq.device_state_from_numpy(st, "cuda")
    device_us["K1"] = device_us_per_call(
        lambda: tq.engine_step_resident_fast(a, ev, meta))

    # K2
    rf_idx_np, rf, acks = cases.refresh(rng, g, p, d2, e2, NOW)
    d_real = int((rf_idx_np < g).sum())
    rf_idx, *rf = cuda([rf_idx_np, *rf])
    acks = cuda(acks)
    ms, plain, wrote = time_inplace(
        tq, st, lambda s: tq.engine_step_resident(s, rf_idx, *rf, *acks, NOW,
                                                  TIMEOUT_MS),
        lambda s: tq._resident_refresh_plain(s, rf_idx, rf, acks, NOW,
                                             TIMEOUT_MS))
    nbytes = (state_bytes(g, p) + 4 * d2 + state_bytes(d_real, p) + 17 * e2
              + wrote + 16 * g)
    out["K2"] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * e2
                                   + d_real * 12 * p),
                 f"G={g} P={p} D={d2} ({d_real} rows) E={e2}")
    a = tq.device_state_from_numpy(st, "cuda")
    device_us["K2"] = device_us_per_call(
        lambda: tq.engine_step_resident(a, rf_idx, *rf, *acks, NOW,
                                        TIMEOUT_MS))

    # K3: four bool and one int32 [G, P] inputs, int32 [G], bool [4, G] out
    args = cuda(cases.tally_inputs(rng, g, p))
    ms = timed(lambda: tq.tally_votes_packed(*args))
    plain = timed(lambda: tq._tally_plain(*args))
    out["K3"] = (ms, plain, *bound(g * p * 8 + 4 * g + 4 * g,
                                   g * (8 * p + 40)), f"G={g} P={p}")
    device_us["K3"] = device_us_per_call(
        lambda: tq.tally_votes_packed(*args))

    # K4: role (int8), commit, applied, prev_commit (int32), prev_valid
    # (bool) per row; match, last_ack, peer_index (int32) and three bool
    # masks per link; the packed int32 output
    arrays, scalars = cases.ledger_inputs(rng, g, p, w)
    dev = cuda(arrays)
    ms = timed(lambda: tl.ledger_pass(*dev, *scalars, num_peers=w))
    plain = timed(lambda: tl._ledger_plain(*dev, *scalars, w))
    nbytes = g * (1 + 3 * 4 + 1) + g * p * (3 * 4 + 3) \
        + 4 * tl.packed_size(g, w)
    out["K4"] = (ms, plain, *bound(nbytes, g * p * 45), f"G={g} P={p} W={w}")
    device_us["K4"] = device_us_per_call(
        lambda: tl.ledger_pass(*dev, *scalars, num_peers=w))

    # K5 at the mesh path's most common (S, E) and at the rung's batch
    s5, e5 = mesh_shapes["K5"].most_common(1)[0][0]
    g5 = mesh_main["capacity"]
    k5_timing(tq, cases.resident_state(rng, g5, p, NOW),
              cases.sliced_events(rng, g5, p, s5, e5, NOW), out, "K5",
              device_us)
    state, evs, _, _ = bench.mesh100k_batch()
    k5_timing(tq, state, evs, out, "K5_100k", device_us)

    # K6 on the bench's own batches, at the rungs' shapes; functional, so
    # every call sees the same inputs
    for key, (g6, p6, e6) in zip(("K6", "K6_100k"), K6_SHAPES[1:]):
        args = tq.engine_step_args_from_numpy(
            bench._example_batch(g6, p6, e6), "cuda")
        ms = timed(lambda: tq.engine_step(*args))
        plain = timed(lambda: tq._engine_step_plain(*args))
        out[key] = (ms, plain, *bound(k6_bytes(g6, p6, e6),
                                      g6 * (4 * p6 * p6 + 64) + 10 * e6),
                    f"G={g6} P={p6} E={e6}")
        device_us[key] = device_us_per_call(lambda: tq.engine_step(*args))

    k7_timing(tq, cases, g, p, out, device_us)
    for k, (ms, plain, b_ms, by, shape) in out.items():
        dev = (f", device {device_us[k]:.3f} us/call" if device_us.get(k)
               else "")
        log(f"timing: {k} [{shape}] kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, bound {b_ms:.6f} ms ({by}){dev}")
    return out, device_us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=1024)
    ap.add_argument("--writes", type=int, default=4)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    # 1. environment
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    import msgpack
    log(f"wire codec: msgpack {'.'.join(map(str, msgpack.version))}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from ratis_tpu_torch.ops import _build
    from ratis_tpu_torch.ops import ledger as tl
    from ratis_tpu_torch.ops import quorum as tq
    from ratis_tpu_torch.tools import bench, cases
    kernels = {"K1": tq.K1, "K2": tq.K2, "K3": tq.K3, "K4": tl.K4,
               "K5": tq.K5, "K6": tq.K6, "K7a": tq.K7a, "K7b": tq.K7b,
               "K7c": tq.K7c}

    # 2. build
    t0 = time.monotonic()
    _build.build_all()
    log(f"build: {time.monotonic() - t0:.2f} s wall; nvcc per source "
        + ", ".join(f"{s} {t:.2f} s" for s, t in _build.build_seconds.items()))
    for s, report in _build.build_reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {s}: {line.strip()}")

    # 3. parity at fixed shapes (K7's launches here and in phase 5 are its
    # only ones: no path calls it)
    par = Parity()
    k7_before = {k: kernels[k].launches for k in K7}
    run_parity(tq, tl, cases, bench, par)
    k7_launches = {k: {"parity": kernels[k].launches - k7_before[k]}
                   for k in K7}

    # 4a. the main path over the simulated transport
    rec = ShapeRecorder(tq)
    main_res, sim_launches = run_main_path(tq, kernels, args.groups,
                                           args.writes, rec)
    log(f"main path (sim): {card} | 3 servers x {args.groups} groups | "
        f"bring-up {main_res['bring_up_s']:.3f} s | "
        f"{main_res['commits']} writes acked, all replicas read back | "
        f"{main_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {main_res['p50_ms']:.2f} ms | p99 {main_res['p99_ms']:.2f} ms | "
        f"election timeouts (bring-up, writes) "
        f"{main_res['election_timeouts']}")
    log(f"main path (sim) launches: {sim_launches}")

    # 4b. the bench's kernel rungs
    rungs, rung_launches = run_kernel_rungs(kernels, bench)
    log(f"kernel rungs: {card} | 10240 x 8 x 4096: "
        f"{rungs['kernel']['group_updates_per_sec']:.1f} group updates/s, "
        f"{rungs['kernel']['vs_scalar_loop']:.2f} x the scalar loop | "
        f"102400 x 8 x 8192: "
        f"{rungs['kernel_100k']['group_updates_per_sec_100k']:.1f} group "
        f"updates/s | launches {rung_launches}")

    # 4c. the headline e2e rung over localhost TCP
    tcp_res, tcp_launches = run_tcp_path(kernels, bench, rec)
    log(f"main path (tcp): {card} | 3 servers x {TCP_GROUPS} groups | "
        f"bring-up {tcp_res['election_convergence_s']:.3f} s | "
        f"{tcp_res['acked']} writes acked, all replicas read back | "
        f"{tcp_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {tcp_res['p50_ms']:.2f} ms | p99 {tcp_res['p99_ms']:.2f} ms | "
        f"election timeouts (bring-up, warm-up, writes) "
        f"{tcp_res['election_timeouts']}")
    log(f"main path (tcp) launches: {tcp_launches}")
    shapes = rec.shapes
    log(f"K1 E {dict(shapes['K1'])}; K2 (D, E) {dict(shapes['K2'])}")

    # 4d. the mesh path, then dryrun_multichip and the mesh100k rung
    rec_mesh = ShapeRecorder(tq)
    mesh_res, mesh_launches = run_mesh_path(kernels, rec_mesh)
    log(f"main path (mesh): {card} | 3 servers x {MESH_GROUPS} groups in "
        f"{MESH_SLICES} slices, slices per server {mesh_res['n_slices']} | "
        f"bring-up {mesh_res['bring_up_s']:.3f} s | "
        f"{mesh_res['commits']} writes acked, all replicas read back | "
        f"{mesh_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {mesh_res['p50_ms']:.2f} ms | p99 {mesh_res['p99_ms']:.2f} ms "
        f"| election timeouts (bring-up, writes) "
        f"{mesh_res['election_timeouts']}")
    log(f"main path (mesh) launches: {mesh_launches}")
    log(f"mesh K5 (S, E) {dict(rec_mesh.shapes['K5'])}; K2 (D, E) "
        f"{dict(rec_mesh.shapes['K2'])}")
    mesh_rungs, mesh_rung_launches = run_mesh_rungs(kernels, bench)
    m = mesh_rungs["mesh_100k"]
    log(f"dryrun_multichip(8): {mesh_rungs['dryrun_multichip']}")
    log(f"mesh_100k: {card} | {m['groups']} groups in {m['devices']} "
        f"slices | {m['updates_per_s']:.1f} updates/s, "
        f"{m['per_slice_updates_per_s']:.1f} per slice | tick "
        f"{m['tick_ms']:.4f} ms, control (K1) {m['control_tick_ms']:.4f} "
        f"ms, efficiency {m['efficiency_frac']:.3f} | launches "
        f"{mesh_rung_launches}")

    # 4e/4f. the durable paths: per-group logs at 1024, the shared plane
    # at 256; 4g. leadership and configuration churn
    durable = {}
    for key, groups, shared in (("durable_1024", DURABLE_GROUPS, False),
                                ("shared_256", SHARED_GROUPS, True)):
        res, launches = run_durable_path(kernels, bench, groups, shared)
        durable[key] = (res, launches)
        log_kind = "shared log plane" if shared else "per-group segments"
        log(f"{key}: {card} | 3 servers x {groups} groups over TCP, "
            f"ArithmeticStateMachine, {log_kind} on {res['storage_fs']} | "
            f"bring-up "
            f"{res['election_convergence_s']:.3f} s | {res['acked']} writes "
            f"acked | {res['commits_per_sec']:.1f} commits/s | p50 "
            f"{res['p50_ms']:.2f} ms | p99 {res['p99_ms']:.2f} ms | "
            f"fsyncs {res['fsyncs']} ({res['fsyncs_per_commit']:.4f} per "
            f"commit) | election timeouts (bring-up, warm-up, writes) "
            f"{res['election_timeouts']} | restart to all leaders "
            f"{res['restart_s']:.3f} s ({res['restart_election_timeouts']} "
            f"election timeouts) | replicas equal to the fold before, after "
            f"restart {res['replicas_read_back']}")
        log(f"{key} launches: {launches}")
    churn_res, churn_launches = run_churn_path(tq, kernels, bench)
    log(f"churn_1024: {card} | 3 servers x {CHURN_GROUPS} groups (sim) | "
        f"bring-up {churn_res['election_convergence_s']:.3f} s | transfers "
        f"ok {churn_res['transfers_ok']} failed "
        f"{churn_res['transfers_failed']} "
        f"{churn_res.get('transfer_failures', [])} | joint rounds ok "
        f"{churn_res['joint_ok']} failed {churn_res['joint_failed']} | "
        f"{churn_res['commits']} writes acked, all replicas read back in "
        f"the final configuration | {churn_res['commits_per_sec']:.1f} "
        f"commits/s | p50 {churn_res['p50_ms']:.2f} ms | p99 "
        f"{churn_res['p99_ms']:.2f} ms | election timeouts (bring-up, "
        f"writes) {churn_res['election_timeouts']}")
    log(f"churn_1024 launches: {churn_launches}; K1/K2 launches while "
        f"the engine led a joint row: {churn_res['joint_calls']} "
        f"(unmatched calls "
        f"{churn_res['joint_unmatched_calls']})")

    # 5. parity at every shape the main paths gave a kernel, then timing
    run_parity_observed(tq, tl, cases, main_res, shapes, par, "main path")
    run_parity_observed(tq, tl, cases, mesh_res, rec_mesh.shapes, par,
                        "mesh path")
    k7_before = {k: kernels[k].launches for k in K7}
    timing, device_us = run_timing(tq, tl, cases, bench, main_res, shapes,
                                   mesh_res, rec_mesh.shapes)
    for k in K7:
        k7_launches[k]["timing"] = kernels[k].launches - k7_before[k]

    # 6. results
    # each kernel's counts as every path's run read them (K7's are all 0,
    # checked there); K7's comparison launches are listed beside them
    paths = {"sim": sim_launches, "kernel_rungs": rung_launches,
             "tcp": tcp_launches, "mesh": mesh_launches,
             "mesh_rungs": mesh_rung_launches,
             **{k: launches for k, (_, launches) in durable.items()},
             "churn_1024": churn_launches}
    by_path = {k: {p: n[k] for p, n in paths.items() if k in n}
               for k in kernels}
    rows = []
    for name, key, source, replaces in KERNELS:
        ms, plain, b_ms, by, shape = timing[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(by_path[key].values()),
                     "launches_by_path": {**by_path[key],
                                          **k7_launches.get(key, {})},
                     "max_abs_err": par.errs[key], "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "device_us": device_us.get(key)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "main_path": main_res,
                       "tcp_path": tcp_res, "kernel_rungs": rungs,
                       "mesh_path": mesh_res, "mesh_rungs": mesh_rungs,
                       "durable_paths": {k: r for k, (r, _) in
                                         durable.items()},
                       "churn_path": churn_res,
                       "seconds": time.monotonic() - t_start,
                       "shapes": {k: {str(s): n for s, n in v.items()}
                                  for k, v in shapes.items()},
                       "mesh_shapes": {k: {str(s): n for s, n in v.items()}
                                       for k, v in rec_mesh.shapes.items()},
                       "timing": {k: dict(zip(("ms", "plain_ms", "bound_ms",
                                               "bound_by", "shape"), v))
                                  for k, v in timing.items()},
                       "device_us": device_us,
                       "parity_cases": dict(par.n),
                       "kernels": rows}, f, indent=1, default=str)
    log(f"smoke: {time.monotonic() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
