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
   (also equal to K1 on the same acks unrouted); the redesigned K1 and K5
   (one launch each, the tile kernel of K2) at 3, 5, 8 and 16 peers, K1
   at G = 1 to 102400 and E = 64 and 16384, K5 at 1, 2 and 8 slices of G
   / S rows a multiple of the tile and not, every tile size, each case
   also through the engine's prepared call (``FastPlan``); the
   redesigned K2 (one
   launch) at 3, 5, 8 and 16 peers, G = 1 to 102400, every tile size,
   each case also through the engine's prepared call, and K3 (the row
   entry the engine runs) on gathered rows at every peer count, padded to
   the engine's bucket with stale rows, through the prepared call and on
   the packed tensors; K3's public [G, P] entry (``K3_public``) and K7a-c
   (the vote-reply scatter, the all-members replicated index, the lease
   expiry) at G = 1024 and 102400 with P = 8, at P = 3, 5, 7 and 16 (K7b
   and K3 public at 1024 and 102400 rows), and at G = 1001 and 1023, with
   the edge cases of ``cases.vote_event_edges``, every vote event on one
   row, the wrapping lease timeouts, K7b's rows of no self bit and of two
   and K3's ``cases.tally_edges`` (the redesigned K7a and K3 public
   through their launch rules and forced to each of their two designs);
   the redesigned K4 (one
   cooperative launch) at G = 1024, 1000 and 10240 with tables of 8, 16
   and 512 peers (512: the
   counters do not fit in shared memory and go straight to the output)
   and ``big_cell``, each case also through the engine's prepared call
   (``LedgerPlan``); the redesigned K6 (one launch) also at
   P = 3, 5, 7 and 16, and at G = 1001 and 1023 (no multiple of 4);
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
   on every served path (a, c-g) each ledger sample must make exactly one
   call into the kernel library, its prepared call's, and launch K4 once;
   Before the paths, one K2 call captured in a CUDA graph, which must
   hold exactly one node, the kernel ``tile_tick`` on K2's refresh
   events, and one K1 call and one K5 call, each one node, ``tile_tick``
   on the fast events; one K4 call and one K6 call, each one kernel node,
   and one call of K4's prepared call, its two copies around one kernel;
   one K7a call (by its rule and forced to each design), one K7c call,
   one K7b call and one call of K3's public entry (the last two also at
   102400 rows), each one kernel node; one call of K3's row entry, its
   nodes counted (every kernel's count is its ``nodes`` in the kernels
   line);
5. kernel parity again at every shape the main paths gave K1-K5 (K3 at
   every padded row count of the vote passes); the
   engine's own routes on one card engine of 1024 rows, host clock,
   median of 200: the refresh dispatch (K2's prepared call, D = E = 64)
   and its prepared call alone, the fast dispatch (K1's prepared call,
   64 acks), its prepared call alone and the earlier route (pack,
   ``upload``, the wrapper, ``.cpu()``) as the same-run control, the same
   three on a mesh engine of 8 slices (K5), the vote pass at R = 1, 64,
   1024 open rounds and its tally alone (K3's prepared call) beside the
   earlier tally of all G rows; one refresh tick, one fast tick and one
   vote pass must each make exactly one call into the kernel library, the
   refresh tick one K2 launch, a flat fast tick one K1 launch, a mesh
   fast tick one K5 launch and no K1; the ledger sample (K4's prepared
   call) on the flat and the mesh engine, its prepared call alone and the
   earlier route (``upload``, the wrapper, ``.cpu()``), a sample checked
   to be one library call and one K4 launch; then timing: K1-K5 at their most
   common shape
   (K3 at the vote passes' most common padded R, ``K3_public`` at G; K5
   also at the mesh100k rung's), K6 at both rung shapes; CUDA events, warm-up,
   median of 200 calls (K1/K2/K5 each on the same fresh state), beside
   the plain version's time and the card's bound for the same work, each
   one's device time per call from ``torch.profiler`` (on the card hosts
   the profiler sometimes drops the records of kernels launched from the
   kernel libraries, so these may read low or be missing) and from 20
   calls captured in a CUDA graph and replayed between CUDA events, and
   its host time per call issued back to back; K1 also with each tile
   size at G = 1024, 10240, 102400 and E = 64, 16384, and on the mesh100k
   rung's flat control (102400 x 8 x 8192); K7a-c at G = 1024, P = 8
   (K7a with 2048 events), K7a-c and ``K3_public`` again at G = 102400
   (``K7a_100k`` with 204800 events, ``K7b_100k``, ``K7c_100k``,
   ``K3_public_100k``; no path calls K7 or ``K3_public``:
   every path's
   run checks that they launched 0 times, so phases 3 and 5 make all of
   their launches); K2 also with each
   tile size at G = 1024, 10240, 102400 and (D, E) = (64, 64), (1024,
   16384); K1 and K2 once more, each call after the state restore, a
   synchronisation and a 1 ms idle gap, event ms beside the call's host
   ms;
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

from ratis_tpu_torch.tools.fast_tick_timing import (K6_SHAPES,
                                                     engine_padded, graph_us,
                                                     host_us,
                                                     ledger_earlier_route,
                                                     tally_design, timed,
                                                     timed_host, vote_design)

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
    ("tally_votes_public", "K3_public",
     "ratis_tpu_torch/ops/kernels/tally_votes.cu",
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
# kernels no path of the server launches: K7 (none of the JAX package's
# paths calls it) and K3's public [G, P] entry (the engine's vote pass
# runs K3's row entry); every path checks that they launched 0 times
K7 = ("K7a", "K7b", "K7c")
OFF_PATH = ("K3_public", *K7)
K7_PEERS = (3, 5, 7, 16)
K7_VOTE_EDGES = ((4, 3), (2, 3), (16, 8), (8, 16), (1024, 8))
# K7a and K7c also at rows that fill no multiple of 4
K7_ODD_ROWS = (1001, 1023)
# the redesigned K1, K2, K5 (one launch per tick of one tile kernel) and
# K3 (gathered rows): peers and tile sizes held against the plain
# versions (and the tiles timed)
K2_PEERS = (3, 5, 8, 16)
TILES = (32, 128)
REDESIGNED = {
    "K1": "redesigned: one launch per tick (row tiles in shared memory, the "
          "kernel of K2); the engine's fast tick is one prepared call",
    "K5": "redesigned: one launch per tick (row tiles in shared memory, each "
          "block scanning only its slices' planes); a mesh engine's fast "
          "tick is one prepared call",
    "K2": "redesigned: one launch per tick (row tiles in shared memory); the "
          "engine's refresh tick is one prepared call",
    "K3": "redesigned: the engine's vote pass tallies only the open rounds' "
          "rows, packed as bit words, in one prepared call",
    "K4": "redesigned: one cooperative launch (a lane per link, counters "
          "in shared memory, one grid sync); a ledger sample is one "
          "prepared call",
    "K6": "redesigned: one launch (each block lists the acks landing in "
          "its rows, then copies and runs them), its outputs views of one "
          "buffer",
    "K7a": "redesigned: one launch, no copy node (blocks owning rows copy "
           "them and land the events listed there, or one cooperative "
           "launch with one grid sync, by G, P, E), its masks views of one "
           "buffer",
    "K7c": "redesigned: one launch, each row's peer slots over 8 lanes "
           "(one or two a lane; ranks by shuffles, the majority member by "
           "a ballot)",
    "K7b": "redesigned: one launch, each row's peer slots over 8 lanes "
           "(one or two a lane, every load issued before any is used; the "
           "row's min by three shuffle steps, the empty union by a ballot)",
    "K3_public": "redesigned: one launch by one of two designs, by G: "
                 "rows of 8 lanes (five ballots give a row's bit words) "
                 "or tiles of 128 rows staged in shared memory, one thread "
                 "a row; the verdict shared with K3's row entry"}
# why no kernel has a library time: no one PyTorch call computes the same
# function (``library_ms`` null in the kernels line)
_TICK = ("none: no one PyTorch call scatter-maxes the acks and takes each "
         "row's majority-min, timeouts and staleness")
NO_LIBRARY = {
    "K1": _TICK, "K2": _TICK + " (after the refreshed rows)", "K5": _TICK,
    "K6": _TICK + " (into copies)",
    "K3": "none: no one PyTorch call tallies masked vote majorities with a "
          "priority veto",
    "K3_public": "none: as K3",
    "K4": "none: no one PyTorch call gives the per-row gap, delta and worst "
          "link with the per-peer histogram and rollups",
    "K7a": "none: no one PyTorch call scatters vote replies gated on the "
           "input masks",
    "K7b": "none: a masked min over the conf union is a where and an amin, "
           "two calls",
    "K7c": "none: no one PyTorch call takes the lease's majority-min with "
           "its wrapping expiry"}
# the durable paths: 3 x 1024 per-group logs, 3 x 256 on the shared plane,
# 1 warm-up + 8 measured writes per group; the churn path: 3 x 1024
DURABLE_GROUPS = 1024
SHARED_GROUPS = 256
DURABLE_WRITES = 8
CHURN_GROUPS = 1024
CHURN_WRITES = 8
# K6: the other peer counts it is held at (at the first two of
# K6_SHAPES, entry() and the bench's two kernel rungs)
K6_PEERS = (3, 5, 7, 16)
# K4: rows and table widths held against the plain version (W = 512: the
# counters do not fit in shared memory and go straight to the output)
K4_ROWS = (1024, 1000, 10_240)
K4_WIDTHS = (8, 16, 512)
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

def fast_plan_err(tq, cases, st, ev_np, sliced, k, a):
    """The engine's prepared call (``FastPlan``) on the tick ``ev_np``
    packed into its buffer, on a fresh copy of the state ``st``, against
    the public wrapper's result ``k`` and state ``a``."""
    c = tq.device_state_from_numpy(st, "cuda")
    pl = cases.fast_plan(c, ev_np, sliced)
    out = torch.from_numpy(pl.run(ev_np.shape[-1], NOW, TIMEOUT_MS).copy())
    return max_abs_err([out.cuda(), *c], [k.out, *a])


def parity_k1(tq, cases, g, p, e, seed, negative=False, plan=False,
              hot=False, engine_padding=False):
    """K1's public wrapper (one launch) against its plain version; with
    ``plan``, also the engine's prepared call on the same tick, against
    the wrapper; with ``hot``, every ack aimed at three rows of one tile
    (``cases.hot_acks``); with ``engine_padding``, padded as the engine
    pads (``fast_tick_timing.engine_padded``)."""
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW)
    ev_np = cases.fast_events(rng, g, p, e, NOW, negative)
    if hot:
        cases.hot_acks(rng, ev_np)
    if engine_padding:
        engine_padded(ev_np)
    ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident_fast(a, ev, meta)
    want = tq._resident_fast_plain(b, ev, meta)
    err = max_abs_err([k.out, *a], [want, *b])
    if plan:
        err = max(err, fast_plan_err(tq, cases, st, ev_np, False, k, a))
    return err


def parity_k2(tq, cases, g, p, d, e, seed, negative=False, plan=False):
    """K2's public wrapper (one launch) against its plain version; with
    ``plan``, also the engine's prepared call on the same tick packed into
    a plan's buffer, against the wrapper."""
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW)
    rf_idx_np, rf_np, acks_np = cases.refresh(rng, g, p, d, e, NOW, negative)
    rf_idx, *rf = cuda([rf_idx_np, *rf_np])
    acks = cuda(acks_np)
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident(a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS)
    want = tq._resident_refresh_plain(b, rf_idx, rf, acks, NOW, TIMEOUT_MS)
    err = max_abs_err([torch.stack(k[1:]), *a], [want, *b])
    if plan:
        c = tq.device_state_from_numpy(st, "cuda")
        pl = cases.refresh_plan(c, rf_idx_np, rf_np, acks_np)
        out = torch.from_numpy(pl.run(d, e, NOW, TIMEOUT_MS).copy()).cuda()
        err = max(err, max_abs_err([out, *c], [torch.stack(k[1:]), *a]))
    return err


def parity_k5(tq, cases, g, p, s, e, seed, negative=False, plan=False,
              hot=False, engine_padding=False):
    """K5 against its plain version; at one slice also against K1 on the
    same plane; with ``plan``, also the engine's prepared call on the same
    tick, against the wrapper; with ``hot``, every ack aimed at three rows
    of each slice (``cases.hot_acks``); with ``engine_padding``, padded as
    the engine pads (``fast_tick_timing.engine_padded``)."""
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW)
    ev_np = cases.sliced_events(rng, g, p, s, e, NOW, negative)
    if hot:
        cases.hot_acks(rng, ev_np)
    if engine_padding:
        engine_padded(ev_np)
    ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident_fast_sliced(a, ev, meta)
    want = tq._resident_fast_sliced_plain(b, ev, meta)
    err = max_abs_err([k.out, *a], [want, *b])
    if plan:
        err = max(err, fast_plan_err(tq, cases, st, ev_np, True, k, a))
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
    return parity_k3_public(tq, cases.tally_inputs(
        np.random.default_rng(seed), g, p))


def parity_k3_rows(tq, cases, g, p, r, cap, seed):
    """K3 (the row entry) on ``r`` gathered rows packed as the engine's
    vote pass packs them, padded to ``cap`` rows with stale rows: through
    the engine's prepared call and launched on the packed tensors, each
    against the plain tally of the same ``cap`` rows."""
    rng = np.random.default_rng(seed)
    arrays = cases.tally_inputs(rng, g, p)
    rows = np.sort(rng.permutation(g)[:r])
    plan = cases.tally_plan(arrays, rows, "cuda", cap)
    got = torch.from_numpy(plan.run(cap).copy()).cuda()
    v = plan.views(cap)
    k = tq.tally_rows(*cuda([v.masks, v.priority, v.self_priority]))
    full = cases.padded_rows(rows, cap, g)
    want = tq._tally_plain(*cuda([a[full] for a in arrays]))
    return max_abs_err([got, k], [want, want])


def parity_k4(tl, cases, g, p, width, seed, big_cell=False, plan=False):
    """K4's wrapper against its plain version on the same card tensors;
    with ``plan``, also the engine's prepared call on the same inputs
    written into its buffer (a plan built for a table of 8, so a wider
    one grows it)."""
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(seed), g, p,
                                          width, big_cell=big_cell)
    dev = cuda(arrays)
    want = tl._ledger_plain(*dev, *scalars, width)
    got = [tl.ledger_pass(*dev, *scalars, num_peers=width)]
    if plan:
        pl = tl.LedgerPlan(g, p, "cuda")
        for v, a in zip(pl.views, arrays):
            np.copyto(v, a)
        got.append(torch.from_numpy(pl.run(width, *scalars).copy()).cuda())
    return max_abs_err(got, [want] * len(got))


def parity_k7a(tq, arrays):
    """K7a against its plain version, through the wrapper's own launch and
    forced to each of its two designs (blocks owning rows; one
    cooperative launch); raises if the kernel wrote any of its inputs (it
    is functional, as in JAX)."""
    args = cuda(arrays)
    before = [t.clone() for t in args]
    want = tq._apply_vote_events_plain(*args)
    got = list(tq.apply_vote_events(*args))
    for rows in (tq.vote_block_rows(args[0].shape[0]), 0):
        with vote_design(tq, rows):
            got += tq.apply_vote_events(*args)
    torch.cuda.synchronize()
    for x, y in zip(args, before):
        if not torch.equal(x, y):
            raise AssertionError("K7a wrote one of its inputs")
    return max_abs_err(got, list(want) * 3)


def parity_k7b(tq, arrays):
    args = cuda(arrays)
    return max_abs_err([tq.all_replicated_min(*args)],
                       [tq._all_replicated_min_plain(*args)])


def parity_k3_public(tq, arrays):
    """K3's public tally against its plain version, through the wrapper's
    own launch and forced to each of its two designs (rows of 8 lanes;
    staged tiles)."""
    args = cuda(arrays)
    got = [tq.tally_votes_packed(*args)]
    for tile in (0, tq.TALLY_TILE):
        with tally_design(tq, tile):
            got.append(tq.tally_votes_packed(*args))
    return max_abs_err(got, [tq._tally_plain(*args)] * 3)


def parity_k7c(tq, arrays, timeout):
    args = cuda(arrays)
    return max_abs_err([tq.lease_expiry(*args, timeout)],
                       [tq._lease_expiry_plain(*args, timeout)])


def run_parity_k7(tq, cases, par) -> None:
    """K7a-c and K3's public tally: seeded cases at G = 1024 and 102400
    with P = 8, at P = 3, 5, 7, 16 with G = 1024 and 102400, at G = 1001
    and 1023, the hand-made vote edges, every event on one row (more than
    a block of K7a's design (a) lists), every lease timeout of
    ``cases.LEASE_TIMEOUTS``; K7b also with rows of no self bit and of
    two, K3 also on ``cases.tally_edges`` (extreme priorities, empty
    current confs, joint rounds, every member or none replied)."""
    shapes = [(1024, P), (102_400, P)] + [(1024, p) for p in K7_PEERS] \
        + [(g, p) for g in K7_ODD_ROWS for p in (3, P)]
    for seed, (g, p) in enumerate(shapes):
        rng = np.random.default_rng(seed)
        for e in (g // 4, 2 * g):
            par.add("K7a", parity_k7a(tq, cases.vote_events(rng, g, p, e)))
        par.add("K7b", parity_k7b(tq, cases.replicated_inputs(rng, g, p)))
        par.add("K7b", parity_k7b(tq, cases.replicated_self_edges(rng, g,
                                                                  p)))
        par.add("K3_public", parity_k3_public(tq, cases.tally_inputs(
            rng, g, p)))
        par.add("K3_public", parity_k3_public(tq, cases.tally_edges(rng, g,
                                                                    p)))
        lease = cases.lease_inputs(rng, g, p, NOW)
        for t in cases.LEASE_TIMEOUTS:
            par.add("K7c", parity_k7c(tq, lease, t))
    for seed, p in enumerate(K7_PEERS):  # the other peer counts at 100k
        rng = np.random.default_rng(100 + seed)
        par.add("K7b", parity_k7b(tq, cases.replicated_self_edges(
            rng, 102_400, p)))
        par.add("K3_public", parity_k3_public(tq, cases.tally_edges(
            rng, 102_400, p)))
    for g, p in K7_VOTE_EDGES:
        par.add("K7a", parity_k7a(tq, cases.vote_event_edges(g, p)))
    for g, e in ((1024, 2048), (102_400, 204_800)):
        hot = cases.vote_events(np.random.default_rng(e), g, P, e)
        hot[2][:] = 7  # every event on one row
        par.add("K7a", parity_k7a(tq, hot))


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
            par.add("K3_public", parity_k3(tq, cases, g, P, seed))
    run_parity_redesigned(tq, cases, par)
    run_parity_fast(tq, cases, par)
    for g in K4_ROWS:
        for width in K4_WIDTHS:
            for seed in (0, 1):
                par.add("K4", parity_k4(tl, cases, g, P, width, seed,
                                        plan=True))
        par.add("K4", parity_k4(tl, cases, g, P, 8, 2, big_cell=True,
                                plan=True))
    for p4 in (3, 5, 16):  # rows of 8 lanes, and of 16
        par.add("K4", parity_k4(tl, cases, 1024, p4, 16, p4, plan=True))
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
    for g, p6, e in K6_SHAPES[1:]:
        # every ack on one row: more than the row's block lists
        hot = cases.step_args(np.random.default_rng(g), g, p6, e, NOW,
                              TIMEOUT_MS)
        hot[2][:] = 7
        par.add("K6", parity_k6(tq, hot))
    for p6 in K6_PEERS:
        for g, _, e in K6_SHAPES[:2]:
            par.add("K6", parity_k6(tq, cases.step_args(
                np.random.default_rng(p6), g, p6, e, NOW, TIMEOUT_MS)))
            par.add("K6", parity_k6(tq, bench._example_batch(g, p6, e, p6)))
    for g in (1001, 1023):  # the outputs' one buffer ends mid-word
        par.add("K6", parity_k6(tq, cases.step_args(
            np.random.default_rng(g), g, P, 1024, NOW, TIMEOUT_MS)))
    run_parity_k7(tq, cases, par)
    par.check("fixed shapes")


def run_parity_redesigned(tq, cases, par) -> None:
    """The redesigned K2 and K3: K2 at P = 3, 5, 8, 16, G = 1,
    100, 1024, 10240 (G not a multiple of the tile), D and E from 64 to
    16384, negative and padding indices, each case also through the
    engine's prepared call; every tile size; K2 at G = 102400; K3's row
    entry at R = 1, 64, 1024 for every P, padded to the engine's bucket
    with stale rows."""
    for p in K2_PEERS:
        for g in (1, 100, 1024, 10240):
            for d, e in ((64, 64), (1024, 16384), (16384, 1024)):
                for negative in (False, True):
                    par.add("K2", parity_k2(tq, cases, g, p, d, e,
                                            p + g + d + negative, negative,
                                            plan=True))
        for r, cap in ((1, 64), (64, 64), (100, 256), (1024, 1024)):
            par.add("K3", parity_k3_rows(tq, cases, 2048, p, r, cap, p + r))
    tile = tq.tick_tile
    try:
        for t in TILES:
            tq.tick_tile = lambda g, t=t: t
            for g in (100, 1024, 10240):
                par.add("K2", parity_k2(tq, cases, g, P, 1024, 1024, g, True,
                                        plan=True))
    finally:
        tq.tick_tile = tile
    par.add("K2", parity_k2(tq, cases, 102_400, P, 1024, 16384, 5, True))


def run_parity_fast(tq, cases, par) -> None:
    """The redesigned K1 and K5 (one launch each), every case through the
    public wrapper and through the engine's prepared call: K1 at P = 3,
    5, 8, 16, G = 1, 100, 1024, 10240 and E = 64, 16384, negative,
    out-of-range and sentinel columns and duplicate acks included; K5 at
    S = 1, 2, 8 with slices of G / S rows a multiple of the tile (G =
    2048) and not (G = 264: a tile straddles slices), for every P; K1 and
    K5 at every tile size; K1 at G = 102400 with E = 16384; K1 and K5 with
    every ack aimed at three rows (a tile lists more columns than its list
    holds) and padded as the engine pads."""
    for p in K2_PEERS:
        for g in (1, 100, 1024, 10240):
            for e in (64, 16384):
                for negative in (False, True):
                    par.add("K1", parity_k1(tq, cases, g, p, e,
                                            p + g + e + negative, negative,
                                            plan=True))
        for g in (264, 2048):
            for s in (1, 2, MESH_SLICES):
                for negative in (False, True):
                    par.add("K5", parity_k5(tq, cases, g, p, s, 256,
                                            p + g + s + negative, negative,
                                            plan=True))
    tile = tq.tick_tile
    try:
        for t in TILES:
            tq.tick_tile = lambda g, t=t: t
            for g in (100, 1024, 10240):
                par.add("K1", parity_k1(tq, cases, g, P, 1024, g + t, True,
                                        plan=True))
            for g, s in ((264, 8), (2048, 2), (10240, 8)):
                par.add("K5", parity_k5(tq, cases, g, P, s, 1024, g + t,
                                        True, plan=True))
    finally:
        tq.tick_tile = tile
    par.add("K1", parity_k1(tq, cases, 102_400, P, 16384, 5, True,
                            plan=True))
    for e in (4096, 16384):
        for hot in (False, True):
            par.add("K1", parity_k1(tq, cases, 1024, P, e, e + hot, True,
                                    plan=True, hot=hot,
                                    engine_padding=True))
            par.add("K5", parity_k5(tq, cases, 2048, P, 2, e, e + hot, True,
                                    plan=True, hot=hot,
                                    engine_padding=True))
        par.add("K1", parity_k1(tq, cases, 1024, P, e, e, plan=True,
                                hot=True))
        par.add("K5", parity_k5(tq, cases, 2048, P, 2, e, e, plan=True,
                                hot=True))


def run_parity_observed(tq, tl, cases, main, shapes, par: Parity,
                        what: str) -> None:
    """Every shape a main path gave a kernel, after the main path (K3: at
    every padded row count R the vote passes ran, with a quarter and all
    of the rows real, the rest stale padding)."""
    g, p, w = main["capacity"], main["peers"], main["ledger_width"]
    for seed in (10, 11):
        for e in shapes["K1"]:
            par.add("K1", parity_k1(tq, cases, g, p, e, seed))
        for d, e in shapes["K2"]:
            par.add("K2", parity_k2(tq, cases, g, p, d, e, seed))
        for s, e in shapes["K5"]:
            par.add("K5", parity_k5(tq, cases, g, p, s, e, seed))
        for cap in shapes["K3"]:
            for r in (max(1, cap // 4), cap):
                par.add("K3", parity_k3_rows(tq, cases, max(g, cap), p, r,
                                             cap, seed))
        par.add("K4", parity_k4(tl, cases, g, p, w, seed, plan=True))
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
    """Records the shapes the engine hands K1 (E of the flat fast plan's
    runs), K2 (D, E of the refresh plan's runs), K3 (the rows R of the
    tally plan's runs, padding included) and K5 ((S, E) of the sliced fast
    plan's runs) while active (the plans' ``run`` are swapped for counting
    ones and restored on exit); and checks that every ledger sample taken
    meanwhile (the watchdogs', once a second on every server) made ONE
    call into the kernel library, its prepared call's ``k4_tick``, that
    launched K4 once (``LagLedger.sample`` and ``LedgerPlan.run`` swapped
    likewise): on exit it raises if a sample did not, or if none was
    taken."""

    def __init__(self, tq, tl):
        self.tq, self.tl = tq, tl
        self.shapes = {"K1": collections.Counter(),
                       "K2": collections.Counter(),
                       "K3": collections.Counter(),
                       "K5": collections.Counter()}
        # samples taken, and the (library calls, K4 launches) of those
        # that were not (1, 1)
        self.ledger_samples = 0
        self.ledger_faults = []
        self._ledger_calls = 0

    def __enter__(self):
        from ratis_tpu_torch.engine.ledger import LagLedger
        tq, tl, shapes = self.tq, self.tl, self.shapes
        self.fast, self.refresh, self.tally = (
            tq.FastPlan.run, tq.RefreshPlan.run, tq.TallyPlan.run)
        self.ledger_run, self.sample = tl.LedgerPlan.run, LagLedger.sample
        fast, refresh, tally = self.fast, self.refresh, self.tally
        ledger_run, sample = self.ledger_run, self.sample

        def rec_ledger_run(plan, *a):
            tick = plan._tick

            def counting(*b):
                self._ledger_calls += 1
                return tick(*b)
            plan._tick = counting
            try:
                return ledger_run(plan, *a)
            finally:
                plan._tick = tick

        def rec_sample(ledger):
            self._ledger_calls = 0
            n = tl.K4.launches
            res = sample(ledger)
            got = (self._ledger_calls, tl.K4.launches - n)
            self.ledger_samples += 1
            if got != (1, 1):
                self.ledger_faults.append(got)
            return res

        def rec_fast(plan, e, *rest):
            if plan.sliced:
                shapes["K5"][(plan.n_slices, e)] += 1
            else:
                shapes["K1"][e] += 1
            return fast(plan, e, *rest)

        def rec_refresh(plan, d, e, *rest):
            shapes["K2"][(d, e)] += 1
            return refresh(plan, d, e, *rest)

        def rec_tally(plan, r):
            shapes["K3"][r] += 1
            return tally(plan, r)

        tq.FastPlan.run = rec_fast
        tq.RefreshPlan.run = rec_refresh
        tq.TallyPlan.run = rec_tally
        tl.LedgerPlan.run = rec_ledger_run
        LagLedger.sample = rec_sample
        return self

    def __exit__(self, exc_type, *exc):
        from ratis_tpu_torch.engine.ledger import LagLedger
        self.tq.FastPlan.run = self.fast
        self.tq.RefreshPlan.run = self.refresh
        self.tq.TallyPlan.run = self.tally
        self.tl.LedgerPlan.run = self.ledger_run
        LagLedger.sample = self.sample
        if exc_type is None and (self.ledger_faults
                                 or self.ledger_samples == 0):
            raise AssertionError(
                f"ledger samples: {self.ledger_samples}, (library calls, "
                f"K4 launches) of those that were not one call and one "
                f"launch: {self.ledger_faults[:10]}")


def counted(kernels: dict, keys, drive, never=()):
    """Zero the launch counts of ``keys``, ``never`` and OFF_PATH just
    before ``drive()``, read them just after; every one of ``keys`` must
    be > 0, every one of ``never`` and of OFF_PATH (no path launches
    them) 0."""
    never = (*never, *OFF_PATH)
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


# -- phase 5: the engine's routes ------------------------------------------

ROUTE_GROUPS = 1024
ROUTE_ROWS = 64     # dirty rows and acks of a timed refresh / fast tick
ROUTE_ROUNDS = (1, 64, 1024)


class _Listener:
    async def on_commit_advance(self, c):
        pass

    async def on_election_timeout(self):
        pass

    async def on_leadership_stale(self):
        pass


def route_engine(tq, mesh: bool = False):
    """A card engine of ``ROUTE_GROUPS`` leader rows (3 of 8 peers), built
    and prewarmed as a server builds one, its state uploaded; with
    ``mesh``, in ``MESH_SLICES`` slices of ``MESH_MAX_GROUPS`` rows, the
    groups pinned round-robin to the slices (as the mesh path's engines
    are).  Returns the engine and its attached slots."""
    from ratis_tpu_torch.engine.engine import QuorumEngine
    from ratis_tpu_torch.engine.state import ROLE_LEADER
    from ratis_tpu_torch.parallel import make_group_mesh
    eng = QuorumEngine(
        max_groups=MESH_MAX_GROUPS if mesh else ROUTE_GROUPS, max_peers=P,
        scalar_fallback_threshold=0, use_device=True, device="cuda",
        mesh=make_group_mesh(MESH_SLICES, device="cuda") if mesh else None)
    cur = np.arange(P) < 3
    slots = []
    for i in range(ROUTE_GROUPS):
        slot = eng.attach(_Listener(), i % MESH_SLICES if mesh else -1)
        eng.state.set_conf(slot, 0, cur, np.zeros(P, bool),
                           np.zeros(P, np.int32), 0)
        eng.state.role[slot] = ROLE_LEADER
        slots.append(slot)
    eng.prewarm()
    eng._tick_batched([], eng.clock.now_ms())  # the full upload
    return eng, slots


def earlier_fast_dispatch(tq, eng, acks, now):
    """The fast dispatch by the engine's earlier route, the same-run
    control of the prepared call: the tick packed into a fresh array, it
    and meta uploaded in one pageable copy (``ops.quorum.upload``), the
    public wrapper (K1, or K5 on a mesh engine; eleven tensors checked,
    ``out`` allocated), a synchronising pageable copy of ``out`` down,
    the changed list."""
    sliced = eng.mesh is not None
    ev = (eng._pack_tick_sliced(acks, {}) if sliced
          else eng._pack_tick(acks, {})).copy()
    ev_t, meta_t = tq.upload(
        (ev, np.array([now, eng.leadership_timeout_ms], np.int32)), "cuda")
    step = (tq.engine_step_resident_fast_sliced if sliced
            else tq.engine_step_resident_fast)
    out = step(eng._dev, ev_t, meta_t).out.cpu().numpy()
    return eng._collect_changed(out[0], out[1] != 0, out[2] != 0,
                                out[3] != 0)


def fast_route_rows(tq, eng, acks, now, prefix: str) -> dict:
    """One engine's fast route: a fast tick must be ONE call into the
    kernel library that launches K1 once on a flat engine, K5 once (and
    K1 never) on a mesh engine, and nothing else; then host ms (median
    of 200) of the fast dispatch, of its prepared call alone and of the
    earlier route."""
    plan = eng._fast_plan
    sliced = eng.mesh is not None
    before = (tq.K1.launches, tq.K2.launches, tq.K5.launches)
    with CallCounter(plan) as calls:
        eng._tick_batched_pass(acks, now)
    got = tuple(k.launches - n for k, n in zip((tq.K1, tq.K2, tq.K5),
                                                before))
    want = (0, 0, 1) if sliced else (1, 0, 0)
    if calls.calls != 1 or got != want:
        raise AssertionError(f"{prefix} fast tick: {calls.calls} calls into "
                             f"the library, K1/K2/K5 +{got}, expected "
                             f"+{want}")
    e = eng._last_event_cap
    return {
        f"{prefix}fast_dispatch": {
            "ms": timed_host(lambda: eng._tick_batched_pass(acks, now)),
            "acks": len(acks), "slices": plan.n_slices, "columns": e,
            "library_calls": calls.calls,
            "launches": dict(zip(("K1", "K2", "K5"), got))},
        f"{prefix}fast_plan_run": {"ms": timed_host(
            lambda: plan.run(e, now, eng.leadership_timeout_ms))},
        f"{prefix}fast_dispatch_earlier_route": {"ms": timed_host(
            lambda: earlier_fast_dispatch(tq, eng, acks, now))}}


def ledger_route_rows(tq, tl, eng, prefix: str) -> dict:
    """One engine's ledger route (its rows leading 3 peers interned in the
    ledger's table): a sample must be ONE call into the kernel library,
    its prepared call's ``k4_tick``, that launches K4 once; then host ms
    (median of 200) of the whole sample, of its prepared call alone and of
    the earlier route (the eleven mirrors uploaded in one pageable copy by
    ``ops.quorum.upload``, the public wrapper, a synchronising pageable
    ``.cpu()``)."""
    ledger, st = eng.ledger, eng.state
    for i in range(3):
        st.peer_index[:, i] = ledger.peer_for(f"route-peer-{i}")
    ledger.sample()  # builds the prepared call
    plan = ledger._ledger_plan
    n = tl.K4.launches
    with CallCounter(plan) as calls:
        ledger.sample()
    got = tl.K4.launches - n
    if calls.calls != 1 or got != 1:
        raise AssertionError(f"{prefix}ledger sample: {calls.calls} calls "
                             f"into the library, K4 +{got}")
    width = ledger._table_width()
    now = eng.clock.now_ms()
    scalars = (now, ledger.lag_threshold, ledger.up_window_ms)
    mirrors = (st.role, st.match_index, st.commit_index, st.applied_index,
               st.conf_cur, st.conf_old, st.self_mask, st.last_ack_ms,
               st.peer_index, ledger._prev_commit,
               ledger._prev_gen == st.alloc_gen)
    return {
        f"{prefix}ledger_sample": {
            "ms": timed_host(ledger.sample), "rows": st.capacity,
            "width": width, "library_calls": calls.calls,
            "launches": {"K4": got}},
        f"{prefix}ledger_plan_run": {"ms": timed_host(
            lambda: plan.run(width, *scalars))},
        f"{prefix}ledger_earlier_route": {"ms": timed_host(
            lambda: ledger_earlier_route(tl, tq, mirrors, scalars, width))}}


class CallCounter:
    """Counts the calls into one C function of a plan (its ``_tick``)."""

    def __init__(self, plan):
        self.plan, self.fn, self.calls = plan, plan._tick, 0

    def __enter__(self):
        def counting(*a):
            self.calls += 1
            return self.fn(*a)
        self.plan._tick = counting
        return self

    def __exit__(self, *exc):
        self.plan._tick = self.fn


def run_route_timing(tq, log_card) -> dict:
    """Host time of the engine's own routes on one card engine: the
    refresh dispatch (K2's prepared call: pack, one C call, the changed
    list) at D = E = ROUTE_ROWS and its prepared call alone; the fast
    dispatch (K1's prepared call) with ROUTE_ROWS acks, its prepared call
    alone and the earlier route (pack, ``upload``, the wrapper, ``.cpu()``)
    as the same-run control; the same three on a mesh engine of 8 slices
    (K5); the vote pass at R = 1, 64, 1024 open rounds (the whole pass,
    and its tally alone: K3's prepared call on the open rounds' rows)
    beside the earlier tally (all G rows of six mirrors uploaded, the
    public K3, the download).  Checks that one refresh tick, one fast tick
    and one vote pass each make exactly ONE call into the kernel library
    (and launch K2, K1 or K5, K3 once, and no other of K1, K2, K5).  The
    refresh and fast ticks' device operations come from a profiler trace,
    the refresh tick's failed only on a trace that shows another kernel
    (on the card hosts a trace sometimes records nothing); the ticks
    synchronise, so they cannot be captured in a graph, but their kernels
    come from the C launchers of the wrappers', which phase 3 holds to one
    kernel in a graph."""
    from ratis_tpu_torch.ops import ledger as tl
    from ratis_tpu_torch.tools.profile_main_path import device_ops, is_copy
    eng, _ = route_engine(tq)
    s = eng.state
    rng = np.random.default_rng(17)
    now = eng.clock.now_ms()
    rows = [int(r) for r in rng.permutation(ROUTE_GROUPS)[:ROUTE_ROWS]]
    acks = [(int(g), int(rng.integers(0, 3)), int(rng.integers(0, 99)), now)
            for g in rng.integers(0, ROUTE_GROUPS, size=ROUTE_ROWS)]

    def dirty():
        s.dirty.update(rows)

    def refresh():
        eng._tick_batched_pass(acks, now)

    out = {}
    plan = eng._refresh_plan
    n1, n2 = tq.K1.launches, tq.K2.launches
    dirty()
    with CallCounter(plan) as calls:
        refresh()
    if calls.calls != 1 or tq.K2.launches != n2 + 1 \
            or tq.K1.launches != n1:
        raise AssertionError(f"refresh tick: {calls.calls} calls into the "
                             f"library, K2 +{tq.K2.launches - n2}, K1 "
                             f"+{tq.K1.launches - n1}")
    ops = device_ops(lambda: (dirty(), refresh()))
    kernels = [op for op in ops if not is_copy(op)]
    if ops and (len(kernels) != 1 or "tile_tick" not in kernels[0]
                or "RefreshEvents" not in kernels[0]):
        raise AssertionError(f"refresh tick put {ops} on the card")
    out["refresh_dispatch"] = {
        "ms": timed_host(refresh, dirty), "rows": ROUTE_ROWS,
        "acks": ROUTE_ROWS, "library_calls": calls.calls,
        "device_ops": ops or None}
    out["refresh_plan_run"] = {"ms": timed_host(
        lambda: plan.run(64, 64, now, eng.leadership_timeout_ms))}
    out.update(fast_route_rows(tq, eng, acks, now, ""))
    out.update(ledger_route_rows(tq, tl, eng, ""))
    out["fast_dispatch"]["device_ops"] = device_ops(
        lambda: eng._tick_batched_pass(acks, now)) or None
    mesh_eng, slots = route_engine(tq, mesh=True)
    mesh_now = mesh_eng.clock.now_ms()
    mesh_acks = [(int(g), int(rng.integers(0, 3)), int(rng.integers(0, 99)),
                  mesh_now) for g in rng.choice(slots, size=ROUTE_ROWS)]
    out.update(fast_route_rows(tq, mesh_eng, mesh_acks, mesh_now, "mesh_"))
    out.update(ledger_route_rows(tq, tl, mesh_eng, "mesh_"))

    async def votes():
        for r in ROUTE_ROUNDS:
            # only the self grant of 3 members: every round stays open
            for slot in range(r):
                eng.begin_vote_round(slot, now + 10 ** 6)
            n3 = tq.K3.launches
            with CallCounter(eng._tally_plan) as calls:
                if eng._vote_pass(now):
                    raise AssertionError("a timed vote round resolved")
            if calls.calls != 1 or tq.K3.launches != n3 + 1:
                raise AssertionError(f"vote pass: {calls.calls} calls into "
                                     f"the library, K3 "
                                     f"+{tq.K3.launches - n3}")
            slots = np.fromiter(eng._vote_rounds, np.int64, r)
            out[f"vote_pass_R{r}"] = {
                "ms": timed_host(lambda: eng._vote_pass(now)), "rounds": r,
                "library_calls": calls.calls}
            out[f"vote_tally_R{r}"] = {"ms": timed_host(
                lambda: eng._tally_rounds(slots)), "rounds": r}
            out[f"vote_all_rows_tally_R{r}"] = {"ms": timed_host(
                lambda: tq.tally_votes_packed(*tq.upload(
                    (s.vote_grants, s.vote_rejects, s.conf_cur, s.conf_old,
                     s.priority, s.self_priority), "cuda")).cpu().numpy())}
            for slot in range(r):
                eng.end_vote_round(slot)
    asyncio.run(votes())
    for k, v in out.items():
        log(f"route: {log_card} | {k}: host {v['ms']:.4f} ms (median)")
    return out


IDLE_GAP_S = 0.001


def k1_k2_split(tq, cases, main, n: int = 200) -> dict:
    """K1's and K2's wrappers at the main shape (E = D = 64), each call
    after the same state restore as ``timed``'s, a synchronisation and
    an idle gap of ``IDLE_GAP_S``, so the restore's copies are over and
    the card idles when the call starts: the median CUDA-event ms of the
    call (the events bracket the wrapper's host work too, since the
    stream waits for its launch) and the median host ms of the call, in
    the same loop.  Where the event ms follows the host ms, the wrapper's
    host work bounds the timed call, not the restore or the kernel."""
    g, p = main["capacity"], main["peers"]
    rng = np.random.default_rng(31)
    st = cases.resident_state(rng, g, p, NOW)
    ev, meta = cuda([cases.fast_events(rng, g, p, 64, NOW),
                     np.array([NOW, TIMEOUT_MS], np.int32)])
    rf_idx, rf, acks = cases.refresh(rng, g, p, 64, 64, NOW)
    rf_idx, *rf = cuda([rf_idx, *rf])
    acks = cuda(acks)
    fresh = tq.device_state_from_numpy(st, "cuda")
    a = tq.device_state_from_numpy(st, "cuda")
    calls = {"K1": lambda: tq.engine_step_resident_fast(a, ev, meta),
             "K2": lambda: tq.engine_step_resident(a, rf_idx, *rf, *acks,
                                                   NOW, TIMEOUT_MS)}
    out = {}
    for key, fn in calls.items():
        ev_ms, host_ms = [], []
        for i in range(n + 5):
            for x, y in zip(a, fresh):
                x.copy_(y)
            torch.cuda.synchronize()
            time.sleep(IDLE_GAP_S)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            e1.record()
            e1.synchronize()
            if i >= 5:
                ev_ms.append(e0.elapsed_time(e1))
                host_ms.append((t1 - t0) * 1e3)
        out[key] = {"event_ms": statistics.median(ev_ms),
                    "host_ms": statistics.median(host_ms)}
    log(f"K1/K2 after restore, sync and a {IDLE_GAP_S * 1e3:.0f} ms idle "
        f"gap: " + "; ".join(f"{k} event {v['event_ms']:.4f} ms, host "
                             f"{v['host_ms']:.4f} ms" for k, v in out.items()))
    return out


def k2_one_launch(tq, cases) -> list[str]:
    """One K2 public-wrapper call at the main shape, captured in a CUDA
    graph: the graph must hold exactly one node, the kernel
    ``tile_tick`` on K2's refresh events (the earlier design put three
    kernels).  Returns the
    nodes' first lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(23)
    st = cases.resident_state(rng, ROUTE_GROUPS, P, NOW)
    rf_idx, rf, acks = cases.refresh(rng, ROUTE_GROUPS, P, 64, 64, NOW)
    rf_idx, *rf = cuda([rf_idx, *rf])
    acks = cuda(acks)
    a = tq.device_state_from_numpy(st, "cuda")
    nodes = graph_nodes(lambda: tq.engine_step_resident(
        a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS))
    if len(nodes) != 1 or not is_kernel_node(nodes[0]) \
            or "tile_tick" not in nodes[0] \
            or "RefreshEvents" not in nodes[0]:
        raise AssertionError(f"one K2 call put {len(nodes)} graph nodes on "
                             f"the card: {nodes}")
    return [" ".join(n.split())[:160] for n in nodes]


def fast_one_launch(tq, cases) -> dict:
    """One K1 public-wrapper call (G = 1024, E = 64) and one K5 call (G =
    2048 in 8 slices, E = 64), each captured in a CUDA graph: each graph
    must hold exactly one node, the kernel ``tile_tick`` on the fast
    events (the earlier design put two kernels).  Returns each call's nodes' first lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(29)
    out = {}
    for key, g, sliced in (("K1", ROUTE_GROUPS, False),
                           ("K5", MESH_MAX_GROUPS, True)):
        st = cases.resident_state(rng, g, P, NOW)
        ev_np = (cases.sliced_events(rng, g, P, MESH_SLICES, 64, NOW)
                 if sliced else cases.fast_events(rng, g, P, 64, NOW))
        ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
        a = tq.device_state_from_numpy(st, "cuda")
        wrapper = (tq.engine_step_resident_fast_sliced if sliced
                   else tq.engine_step_resident_fast)
        nodes = graph_nodes(lambda: wrapper(a, ev, meta))
        if len(nodes) != 1 or not is_kernel_node(nodes[0]) \
                or "tile_tick" not in nodes[0] \
                or "FastEvents" not in nodes[0]:
            raise AssertionError(f"one {key} call put {len(nodes)} graph "
                                 f"nodes on the card: {nodes}")
        out[key] = [" ".join(n.split())[:160] for n in nodes]
    return out


def ledger_step_one_launch(tq, tl, cases, bench) -> dict:
    """One K4 wrapper call (G = 1024, W = 8) and one K6 call (the bench's
    entry batch), each captured in a CUDA graph, must each hold exactly
    one node, the kernel (the earlier designs put two kernels, and two
    copies and two kernels); one call of K4's prepared call (captured it
    does not synchronise) its copy in, the same one kernel and its copy
    out.  Returns each call's nodes' first lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(37),
                                          ROUTE_GROUPS, P, 8)
    dev = cuda(arrays)
    plan = tl.LedgerPlan(ROUTE_GROUPS, P, "cuda")
    for v, a in zip(plan.views, arrays):
        np.copyto(v, a)

    def plan_call():
        plan._stream = torch.cuda.current_stream().cuda_stream
        plan.run(8, *scalars)

    fn, args = bench.entry("cuda")
    out = {}
    for key, call, want, kernel in (
            ("K4", lambda: tl.ledger_pass(*dev, *scalars, num_peers=8),
             [True], tl.K4),
            ("K4_plan", plan_call, [False, True, False], tl.K4),
            ("K6", lambda: fn(*args), [True], tq.K6)):
        n = kernel.launches
        nodes = graph_nodes(call)
        # the warm-up call and the captured one; a node's label cuts the
        # kernel's mangled name short, so the launch count names it
        if [is_kernel_node(x) for x in nodes] != want \
                or kernel.launches != n + 2:
            raise AssertionError(f"one {key} call put {len(nodes)} graph "
                                 f"nodes on the card ({kernel.launches - n} "
                                 f"launches counted): {nodes}")
        out[key] = [" ".join(x.split())[:160] for x in nodes]
    return out


def other_one_launch(tq, cases) -> dict:
    """One call each of K3's row entry (``tally_rows`` at R = 64), K3's
    public entry (G = 1024, and 102400: ``K3_public_100k``; at 1024 also
    forced to each design: ``K3_public_lanes``, ``K3_public_tile``), K7a
    (1024 x 8 with 2048 events, by its rule and forced to each design:
    ``K7a_rows``, ``K7a_grid``), K7b (1024 x 8, and 102400:
    ``K7b_100k``) and K7c (1024 x 8), each captured in a CUDA graph: every
    call but K3's row entry must be one node, the kernel, and count two
    launches (the warm-up call and the captured; K7a's earlier design put
    two copies before its kernel).  Returns each call's nodes' first
    lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(41)
    g = ROUTE_GROUPS
    arrays = cases.tally_inputs(rng, g, P)
    v = cases.tally_plan(arrays, np.arange(0, g, 16), "cpu", 64).views(64)
    packed = cuda([v.masks, v.priority, v.self_priority])
    tally = cuda(arrays)
    votes = cuda(cases.vote_events(rng, g, P, 2 * g))
    repl = cuda(cases.replicated_inputs(rng, g, P))
    lease = cuda(cases.lease_inputs(rng, g, P, NOW))
    tally_100k = cuda(cases.tally_inputs(rng, 102_400, P))
    repl_100k = cuda(cases.replicated_inputs(rng, 102_400, P))

    def forced(rows):
        def call():
            with vote_design(tq, rows):
                tq.apply_vote_events(*votes)
        return call

    def tally_forced(tile, args):
        def call():
            with tally_design(tq, tile):
                tq.tally_votes_packed(*args)
        return call

    out = {}
    for key, call, kernel in (
            ("K3", lambda: tq.tally_rows(*packed), None),
            ("K3_public", lambda: tq.tally_votes_packed(*tally),
             tq.K3_PUBLIC),
            ("K3_public_100k", lambda: tq.tally_votes_packed(*tally_100k),
             tq.K3_PUBLIC),
            ("K3_public_lanes", tally_forced(0, tally), tq.K3_PUBLIC),
            ("K3_public_tile", tally_forced(tq.TALLY_TILE, tally),
             tq.K3_PUBLIC),
            ("K7a", lambda: tq.apply_vote_events(*votes), tq.K7a),
            ("K7a_rows", forced(tq.vote_block_rows(g)), tq.K7a),
            ("K7a_grid", forced(0), tq.K7a),
            ("K7b", lambda: tq.all_replicated_min(*repl), tq.K7b),
            ("K7b_100k", lambda: tq.all_replicated_min(*repl_100k), tq.K7b),
            ("K7c", lambda: tq.lease_expiry(*lease, 1000), tq.K7c)):
        n = kernel.launches if kernel else 0
        nodes = graph_nodes(call)
        if kernel and ([is_kernel_node(x) for x in nodes] != [True]
                       or kernel.launches != n + 2):
            raise AssertionError(f"one {key} call put {len(nodes)} graph "
                                 f"nodes on the card ({kernel.launches - n} "
                                 f"launches counted): {nodes}")
        out[key] = [" ".join(x.split())[:160] for x in nodes]
    return out


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


def run_durable_path(kernels, bench, groups: int, shared: bool, rec):
    """The bench's durable rung (``shared``: on the shared log plane) in a
    fresh temporary directory: 3 servers x ``groups`` groups over TCP,
    ArithmeticStateMachine, every map held to the fold before and after a
    full restart from disk."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="ratis-smoke-durable-") as tmp:
        cluster = bench.durable_cluster("cuda", groups, tmp, shared)
        with rec:
            res, launches = counted(
                kernels, ("K1", "K2", "K3", "K4"),
                lambda: asyncio.run(bench.durable_rung(cluster,
                                                       DURABLE_WRITES)),
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
    branch decides a commit); the plans' ``run`` are swapped for counting
    ones and restored on exit."""

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
        self.fast, self.refresh = tq.FastPlan.run, tq.RefreshPlan.run
        fast, refresh = self.fast, self.refresh

        def rec_fast(plan, *rest):
            self.joint_calls["K1"] += self._leads_joint_row(plan.state)
            return fast(plan, *rest)

        def rec_refresh(plan, *rest):
            self.joint_calls["K2"] += self._leads_joint_row(plan.state)
            return refresh(plan, *rest)

        tq.FastPlan.run = rec_fast
        tq.RefreshPlan.run = rec_refresh
        return self

    def __exit__(self, *exc):
        self.tq.FastPlan.run = self.fast
        self.tq.RefreshPlan.run = self.refresh


def run_churn_path(tq, kernels, bench, shapes):
    """The bench's churn rung: leadership transfers and joint-consensus
    rounds under write load, over the simulated transport."""
    cluster = bench.churn_cluster("cuda", CHURN_GROUPS)
    with shapes, JointRecorder(tq, cluster) as rec:
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


# host us per call of each timed wrapper, and its device us per call from
# a CUDA graph (keys as in device_us)
HOST_US: dict = {}
GRAPH_US: dict = {}


def per_call(key: str, fn):
    """Device us per call of ``fn`` from the profiler (returned), its host
    us per call (HOST_US[key]) and its device us per call from a CUDA
    graph (GRAPH_US[key])."""
    HOST_US[key] = host_us(fn)
    GRAPH_US[key] = graph_us_per_call(fn)
    return device_us_per_call(fn)


def graph_us_per_call(fn, n: int = 20):
    """Device us per call of ``fn`` from ``n`` calls in one CUDA graph
    (``fast_tick_timing.graph_us``); None, and a log line, where a call
    cannot be captured."""
    try:
        return graph_us(fn, n)
    except RuntimeError as exc:
        log(f"graph timing: not measured ({exc})")
        return None


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


def k2_timing(tq, cases, rng, g, p, d, e, out, key, device_us) -> None:
    """K2's public wrapper at one shape: each input read once (the state,
    the refresh indices and the rows that are not padding, 17 bytes per
    ack), the state bytes it changes and the int32 [4, G] output written
    once."""
    st = cases.resident_state(rng, g, p, NOW)
    rf_idx_np, rf, acks = cases.refresh(rng, g, p, d, e, NOW)
    d_real = int((rf_idx_np < g).sum())
    rf_idx, *rf = cuda([rf_idx_np, *rf])
    acks = cuda(acks)
    ms, plain, wrote = time_inplace(
        tq, st, lambda s: tq.engine_step_resident(s, rf_idx, *rf, *acks, NOW,
                                                  TIMEOUT_MS),
        lambda s: tq._resident_refresh_plain(s, rf_idx, rf, acks, NOW,
                                             TIMEOUT_MS))
    nbytes = (state_bytes(g, p) + 4 * d + state_bytes(d_real, p) + 17 * e
              + wrote + 16 * g)
    out[key] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * e
                                  + d_real * 12 * p),
                f"G={g} P={p} D={d} ({d_real} rows) E={e} "
                f"tile={tq.tick_tile(g)}")
    a = tq.device_state_from_numpy(st, "cuda")
    device_us[key] = per_call(key, lambda: tq.engine_step_resident(
        a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS))


def k2_extra_timing(tq, cases, rng, p, out, device_us) -> None:
    """K2 with each tile size at G = 1024, 10240 and 102400, at the main
    paths' most common (D, E) = (64, 64) and at the acks' cap (E = 16384,
    where every block scans 64 KB of ack rows)."""
    tile = tq.tick_tile
    try:
        for gx in (1024, 10_240, 102_400):
            for d, e in ((64, 64), (1024, 16384)):
                for t in TILES:
                    tq.tick_tile = lambda g, t=t: t
                    k2_timing(tq, cases, rng, gx, p, d, e, out,
                              f"K2_G{gx}_D{d}_E{e}_tile{t}", device_us)
    finally:
        tq.tick_tile = tile


def k1_timing(tq, st, ev_np, out, key, device_us) -> None:
    """K1 on ``ev_np`` ([7, E]) over the state ``st``: each input read
    once (the state, the E event columns, meta), the state it changes and
    the [4, G] output written once."""
    g, p = st[0].shape
    e = ev_np.shape[1]
    ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
    ms, plain, wrote = time_inplace(
        tq, st, lambda a: tq.engine_step_resident_fast(a, ev, meta),
        lambda a: tq._resident_fast_plain(a, ev, meta))
    nbytes = state_bytes(g, p) + 28 * e + 8 + wrote + 16 * g
    out[key] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * e),
                f"G={g} P={p} E={e} tile={tq.tick_tile(g)}")
    a = tq.device_state_from_numpy(st, "cuda")
    device_us[key] = per_call(
        key, lambda: tq.engine_step_resident_fast(a, ev, meta))


def k1_extra_timing(tq, cases, rng, p, out, device_us) -> None:
    """K1 with each tile size at G = 1024, 10240 and 102400, at the main
    paths' most common E = 64 and at the acks' cap (E = 16384, where
    every block scans 64 KB of slot rows); at 1024 rows also at the
    backlog buckets between (E = 1024, 4096)."""
    tile = tq.tick_tile
    try:
        for g in (1024, 10_240, 102_400):
            st = cases.resident_state(rng, g, p, NOW)
            for e in (64, 1024, 4096, 16384) if g == 1024 else (64, 16384):
                ev = cases.fast_events(rng, g, p, e, NOW)
                for t in TILES:
                    tq.tick_tile = lambda g, t=t: t
                    k1_timing(tq, st, ev, out, f"K1_G{g}_E{e}_tile{t}",
                              device_us)
    finally:
        tq.tick_tile = tile


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
                f"G={g} P={p} S={s} E={e} tile={tq.tick_tile(g)}")
    a = tq.device_state_from_numpy(st, "cuda")
    device_us[key] = per_call(
        key, lambda: tq.engine_step_resident_fast_sliced(a, ev, meta))


def k7_timing(tq, cases, g: int, p: int, out, device_us) -> None:
    """K7a-c at the main paths' G and P (K7a with two replies per group),
    and again at 102400 rows (``K7a_100k``, ``K7b_100k``, ``K7c_100k``):
    each input read once and each output written once (K7a: both [G, P]
    masks in and out, 10 bytes per event; K7b: the int32 and three bool
    [G, P] arrays and the flush index in, int32 [G] out; K7c: the int32
    and three bool [G, P] arrays in, int32 [G] out).  No PyTorch call
    computes any of the three alone, so there is no library time."""
    rng = np.random.default_rng(7)
    timeout = 1000
    work = []
    for key, rows in ((("K7a", "K7c", "K7b"), g),
                      (("K7a_100k", "K7c_100k", "K7b_100k"), 102_400)):
        e = 2 * rows
        votes = cuda(cases.vote_events(rng, rows, p, e))
        lease = cuda(cases.lease_inputs(rng, rows, p, NOW))
        repl = cuda(cases.replicated_inputs(rng, rows, p))
        work += [
            (key[2], lambda repl=repl: tq.all_replicated_min(*repl),
             lambda repl=repl: tq._all_replicated_min_plain(*repl),
             7 * rows * p + 8 * rows, rows * (3 * p + 4),
             f"G={rows} P={p}"),
            (key[0], lambda votes=votes: tq.apply_vote_events(*votes),
             lambda votes=votes: tq._apply_vote_events_plain(*votes),
             4 * rows * p + 10 * e, 10 * e, f"G={rows} P={p} E={e}"),
            (key[1], lambda lease=lease: tq.lease_expiry(*lease, timeout),
             lambda lease=lease: tq._lease_expiry_plain(*lease, timeout),
             7 * rows * p + 4 * rows, rows * (8 * p * p + 16),
             f"G={rows} P={p}")]
    for key, kernel, plain, nbytes, ops, shape in work:
        ms = timed(kernel)
        plain_ms = timed(plain)
        out[key] = (ms, plain_ms, *bound(nbytes, ops), shape)
        device_us[key] = per_call(key, kernel)


def run_timing(tq, tl, cases, bench, main, shapes, mesh_main,
               mesh_shapes) -> dict:
    """K1-K4 at the main paths' most common shape (K3's row entry at the
    vote passes' most common padded R; its public entry ``K3_public`` at
    G), K1 also with each tile size at G = 1024, 10240, 102400 and E = 64,
    16384 (at 1024 also E = 1024, 4096), at 1024 x 16384 padded as the
    engine pads, and on the mesh100k rung's flat control (``K1_100k``), K5 at
    the mesh path's
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

    # K1 at the main shape, with each tile, and at the mesh100k rung's
    # flat control (102400 x 8 x 8192, global rows)
    k1_timing(tq, st, cases.fast_events(rng, g, p, e1, NOW), out, "K1",
              device_us)
    k1_extra_timing(tq, cases, rng, p, out, device_us)
    ev = engine_padded(cases.fast_events(rng, 1024, p, 16384, NOW))
    k1_timing(tq, cases.resident_state(rng, 1024, p, NOW), ev, out,
              "K1_G1024_E16384_engine_padding", device_us)
    state, evs, evf, _ = bench.mesh100k_batch()
    k1_timing(tq, state, evf, out, "K1_100k", device_us)

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
    device_us["K2"] = per_call("K2", lambda: tq.engine_step_resident(
        a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS))
    k2_extra_timing(tq, cases, rng, p, out, device_us)

    # K3, the row entry the engine runs, at the vote passes' most common
    # padded R, packed as the engine packs it: uint16 [4, R] mask words,
    # int32 [R, P] priority and [R] self priority in, bool [4, R] out
    r3 = shapes["K3"].most_common(1)[0][0]
    arrays = cases.tally_inputs(rng, max(g, r3), p)
    rows = np.sort(rng.permutation(max(g, r3))[:max(1, r3 // 4)])
    v = cases.tally_plan(arrays, rows, "cpu", r3).views(r3)
    packed = cuda([v.masks, v.priority, v.self_priority])
    ms = timed(lambda: tq.tally_rows(*packed))
    plain = timed(lambda: tq._tally_rows_plain(*packed))
    out["K3"] = (ms, plain, *bound(8 * r3 + 4 * r3 * p + 4 * r3 + 4 * r3,
                                   r3 * (8 * p + 40)),
                 f"R={r3} ({len(rows)} open rounds) P={p}")
    device_us["K3"] = per_call("K3", lambda: tq.tally_rows(*packed))

    # K3's public [G, P] entry (no path launches it) at the main paths' G
    # and at 102400 rows: four bool and one int32 [G, P] inputs, int32
    # [G], bool [4, G] out
    for key, g3 in (("K3_public", g), ("K3_public_100k", 102_400)):
        args = cuda(cases.tally_inputs(rng, g3, p))
        ms = timed(lambda: tq.tally_votes_packed(*args))
        plain = timed(lambda: tq._tally_plain(*args))
        out[key] = (ms, plain, *bound(g3 * p * 8 + 4 * g3 + 4 * g3,
                                      g3 * (8 * p + 40)), f"G={g3} P={p}")
        device_us[key] = per_call(key,
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
    device_us["K4"] = per_call(
        "K4", lambda: tl.ledger_pass(*dev, *scalars, num_peers=w))

    # K5 at the mesh path's most common (S, E) and at the rung's batch
    s5, e5 = mesh_shapes["K5"].most_common(1)[0][0]
    g5 = mesh_main["capacity"]
    k5_timing(tq, cases.resident_state(rng, g5, p, NOW),
              cases.sliced_events(rng, g5, p, s5, e5, NOW), out, "K5",
              device_us)
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
        device_us[key] = per_call(key, lambda: tq.engine_step(*args))

    k7_timing(tq, cases, g, p, out, device_us)
    for k, (ms, plain, b_ms, by, shape) in out.items():
        dev = (f", device {device_us[k]:.3f} us/call" if device_us.get(k)
               else ", device not measured") + (
            f", graph {GRAPH_US[k]:.3f} us/call" if GRAPH_US.get(k)
            else "") + f", host {HOST_US[k]:.2f} us/call"
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
    kernels = {"K1": tq.K1, "K2": tq.K2, "K3": tq.K3,
               "K3_public": tq.K3_PUBLIC, "K4": tl.K4, "K5": tq.K5,
               "K6": tq.K6, "K7a": tq.K7a, "K7b": tq.K7b, "K7c": tq.K7c}

    # 2. build
    t0 = time.monotonic()
    _build.build_all()
    log(f"build: {time.monotonic() - t0:.2f} s wall; nvcc per source "
        + ", ".join(f"{s} {t:.2f} s" for s, t in _build.build_seconds.items()))
    for s, report in _build.build_reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {s}: {line.strip()}")

    # 3. parity at fixed shapes (the off-path kernels' launches here and
    # in phase 5 are their only ones: every path checks they made none)
    par = Parity()
    off_before = {k: kernels[k].launches for k in OFF_PATH}
    run_parity(tq, tl, cases, bench, par)
    k2_nodes = k2_one_launch(tq, cases)
    log(f"K2: one public-wrapper call captured in a CUDA graph: "
        f"{len(k2_nodes)} node, {k2_nodes[0]}")
    fast_nodes = fast_one_launch(tq, cases)
    fast_nodes.update(ledger_step_one_launch(tq, tl, cases, bench))
    fast_nodes.update(other_one_launch(tq, cases))
    for key, nodes in fast_nodes.items():
        log(f"{key}: one call captured in a CUDA graph: {len(nodes)} "
            f"node(s): " + " | ".join(n[:100] for n in nodes))
    off_launches = {k: {"parity": kernels[k].launches - off_before[k]}
                    for k in OFF_PATH}
    off_before = {k: kernels[k].launches for k in OFF_PATH}

    # 4a. the main path over the simulated transport
    recs = {k: ShapeRecorder(tq, tl) for k in ("sim", "tcp", "mesh",
                                           "durable_1024", "shared_256",
                                           "churn_1024")}
    main_res, sim_launches = run_main_path(tq, kernels, args.groups,
                                           args.writes, recs["sim"])
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
    tcp_res, tcp_launches = run_tcp_path(kernels, bench, recs["tcp"])
    log(f"main path (tcp): {card} | 3 servers x {TCP_GROUPS} groups | "
        f"bring-up {tcp_res['election_convergence_s']:.3f} s | "
        f"{tcp_res['acked']} writes acked, all replicas read back | "
        f"{tcp_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {tcp_res['p50_ms']:.2f} ms | p99 {tcp_res['p99_ms']:.2f} ms | "
        f"election timeouts (bring-up, warm-up, writes) "
        f"{tcp_res['election_timeouts']}")
    log(f"main path (tcp) launches: {tcp_launches}")
    shapes = {k: recs["sim"].shapes[k] + recs["tcp"].shapes[k]
              for k in recs["sim"].shapes}
    log(f"K1 E {dict(shapes['K1'])}; K2 (D, E) {dict(shapes['K2'])}")

    # 4d. the mesh path, then dryrun_multichip and the mesh100k rung
    rec_mesh = recs["mesh"]
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
        res, launches = run_durable_path(kernels, bench, groups, shared,
                                         recs[key])
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
    churn_res, churn_launches = run_churn_path(tq, kernels, bench,
                                               recs["churn_1024"])
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

    ledger_checks = {k: r.ledger_samples for k, r in recs.items()}
    log(f"ledger samples by path, each one call into the kernel library "
        f"and K4 +1: {ledger_checks}")

    # 5. parity at every shape the main paths gave a kernel, then timing
    run_parity_observed(tq, tl, cases, main_res, shapes, par, "main path")
    run_parity_observed(tq, tl, cases, mesh_res, rec_mesh.shapes, par,
                        "mesh path")
    routes = run_route_timing(tq, card)
    timing, device_us = run_timing(tq, tl, cases, bench, main_res, shapes,
                                   mesh_res, rec_mesh.shapes)
    split = k1_k2_split(tq, cases, main_res)
    for k in OFF_PATH:
        # every path in between checked 0: these are phase 5's comparisons
        off_launches[k]["timing"] = kernels[k].launches - off_before[k]
    k2_shapes = {path: {str(k): n for k, n in r.shapes["K2"].items()}
                 for path, r in recs.items()}
    log(f"K2 (D, E) by path: {k2_shapes}")
    k3_shapes = {path: dict(r.shapes["K3"]) for path, r in recs.items()}
    log(f"K3 R (padded) by path: {k3_shapes}")
    for key, control in (
            ("fast_dispatch", "refresh_dispatch"),
            ("mesh_fast_dispatch", "refresh_dispatch"),
            ("fast_dispatch", "fast_dispatch_earlier_route"),
            ("mesh_fast_dispatch", "mesh_fast_dispatch_earlier_route"),
            ("fast_plan_run", "refresh_plan_run"),
            ("mesh_fast_plan_run", "refresh_plan_run"),
            ("ledger_sample", "ledger_earlier_route"),
            ("ledger_plan_run", "ledger_earlier_route"),
            ("mesh_ledger_sample", "mesh_ledger_earlier_route")):
        a, b = routes[key]["ms"], routes[control]["ms"]
        log(f"{key} {a:.4f} ms vs {control} {b:.4f} ms: "
            f"{'at or below' if a <= b else 'NOT at or below'}")
    for name, us in (("graph", GRAPH_US), ("profiler", device_us)):
        for key in ("K1", "K5"):
            if us.get(key) and us.get("K2"):
                log(f"{key} device ({name}) {us[key]:.3f} us vs K2 "
                    f"{us['K2']:.3f} us")

    # 6. results
    # each kernel's counts as every path's run read them (the off-path
    # kernels' are all 0, checked there); their comparison launches are
    # listed beside them
    paths = {"sim": sim_launches, "kernel_rungs": rung_launches,
             "tcp": tcp_launches, "mesh": mesh_launches,
             "mesh_rungs": mesh_rung_launches,
             **{k: launches for k, (_, launches) in durable.items()},
             "churn_1024": churn_launches}
    by_path = {k: {p: n[k] for p, n in paths.items() if k in n}
               for k in kernels}
    # one call's CUDA-graph nodes, per kernel
    graph_nodes_of = {"K2": k2_nodes, **fast_nodes}
    rows = []
    for name, key, source, replaces in KERNELS:
        ms, plain, b_ms, by, shape = timing[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(by_path[key].values()),
                     "launches_by_path": {**by_path[key],
                                          **off_launches.get(key, {})},
                     "max_abs_err": par.errs[key], "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "library": NO_LIBRARY[key],
                     "nodes": len(graph_nodes_of[key]),
                     "device_us": GRAPH_US.get(key),
                     "profiler_device_us": device_us.get(key),
                     "host_us": HOST_US.get(key)})
        if key in REDESIGNED:
            rows[-1]["redesigned"] = REDESIGNED[key]
    by_key = {key: row for (_, key, _, _), row in zip(KERNELS, rows)}
    by_key["K1"]["engine_route_ms"] = routes["fast_dispatch"]["ms"]
    by_key["K2"]["engine_route_ms"] = routes["refresh_dispatch"]["ms"]
    by_key["K5"]["engine_route_ms"] = routes["mesh_fast_dispatch"]["ms"]
    by_key["K3"]["engine_route_ms"] = {r: routes[f"vote_pass_R{r}"]["ms"]
                                       for r in ROUTE_ROUNDS}
    by_key["K4"]["engine_route_ms"] = routes["ledger_sample"]["ms"]
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
                       "timing": {k: {**dict(zip(("ms", "plain_ms",
                                                  "bound_ms", "bound_by",
                                                  "shape"), v)),
                                      "nodes": len(graph_nodes_of[k])
                                      if k in graph_nodes_of else None}
                                  for k, v in timing.items()},
                       "device_us": GRAPH_US,
                       "profiler_device_us": device_us, "host_us": HOST_US,
                       "k1_k2_after_idle_gap": split,
                       "routes": routes, "k2_graph_nodes": k2_nodes,
                       "fast_graph_nodes": fast_nodes,
                       "k2_shapes_by_path": k2_shapes,
                       "k3_rows_by_path": k3_shapes,
                       "ledger_samples_by_path": ledger_checks,
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
