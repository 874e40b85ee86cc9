"""Time the redesigned kernels' public wrappers (the fast tick K1 and K5,
the ledger pass K4, the stateless tick K6, the vote-reply scatter K7a, the
all-members replicated index K7b, the lease expiry K7c and the public
vote tally K3) on one CUDA card; and the timing helpers ``chip_smoke.py``
times every kernel and route with.

    python ratis_tpu_torch/tools/fast_tick_timing.py [--label NAME] [--only k7]

Prints the card's name and power limit, then one JSON line: for each K1
and K5 shape, the kernel's median CUDA-event ms over 200 calls (each call on the
same fresh state, restored outside the events), its device us per call
from 20 calls captured in one CUDA graph, and the wrapper's host us per
call issued back to back, and its bound in us (``bound_us``: the larger
of the bytes one call must move over 3.35 TB/s and its integer
operations over 33.5 TOP/s, as ``chip_smoke.py`` counts them for K1 and
K5; the state bytes a call changes are counted on the CPU with the plain
version, which the kernel equals).  Shapes (``K1_SHAPES``): K1 at the
main path's 1024 x 8 rows with every event bucket the engine packs (64 * 4^k up to
its cap of 16384 columns), the buckets from 1024 up both with
``cases.fast_events``' padding on row 0 and with the engine's (a slot
that lands in no row), at 10240 x 8 x 1024, and on the ``mesh_100k``
rung's batch as its flat control (102400 x 8 x 8192, global rows); K5 at
the mesh path's 2048 rows x 8 in 8 slices x 64 and on the ``mesh_100k``
batch (8 slices x 1024).  K4 (``ledger_pass``, ``K4_SHAPES``) on
``cases.ledger_inputs`` at the served paths' 1024 rows x 8 peer slots with
a table of 8, at 1000 x 16, 2048 x 8 (the mesh path's capacity), 10240 x 8
and 1024 x 512 (a table whose counters do not fit in shared memory), and
at 1024 x 8 the host ms of one call of K4's prepared call
(``ops.ledger.LedgerPlan``, where the package has it: inputs up, the
launch, the packed vector down, synchronised) beside the earlier route
(``ledger_earlier_route``), medians of 200; K6 (``engine_step``) on the
bench's own batches at its two kernel rungs' shapes (``K6_SHAPES[1:]``),
its host us the median of five runs.  K7c (``lease_expiry``,
``K7C_SHAPES``) on ``cases.lease_inputs`` at 1024, 10240 and 102400 rows
x 8, and K7a (``apply_vote_events``, ``K7A_SHAPES``) on
``cases.vote_events`` at 1024 x 8 with 256 and 2048 events, 10240 x 8
with 20480 and 102400 x 8 with 204800, and at the shapes around its
choice between its two designs (``K7A_RULE_SHAPES``), each with
``bound_us`` as ``chip_smoke.py`` counts it (K7c also at 102400 x 16);
where the package has K7a's launch rule (``ops.quorum.vote_rows``), K7a
also forced to each of its designs (``_rows``: blocks owning rows,
``_grid``: one cooperative launch).  K7b (``all_replicated_min``, on
``cases.replicated_inputs``) and the public K3 (``tally_votes_packed``,
on ``cases.tally_inputs``) at ``LANE_SHAPES``: 1024, 10240, 20480,
40960 and 102400 rows x 8, and 102400 x 16 and x 3, each with
``bound_us``; where the package has the public K3's launch rule
(``ops.quorum.tally_tile``), K3 also forced to each of its designs
(``_lanes``: rows of 8 lanes, ``_tile``: staged tiles); and K3's row
entry (``tally_rows``, the engine's) at R = 64 x 8 packed as the engine's
vote pass packs it.  K4, K6, K7a-c and K3 are functional: every
call sees the same inputs.  ``--only k7`` times K7a-c and K3 (public and
row entry) alone.

It imports ``ratis_tpu_torch`` from the Python path, not from beside the
script, so the same script times another checkout of the package::

    PYTHONPATH=<checkout> python ratis_tpu_torch/tools/fast_tick_timing.py

which compares two versions of the kernels on one card in one run (run
them in turns: A, B, B, A; the inputs come from ``tools.cases`` there,
the engine's padding from this script).  It needs CUDA and fails
without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NOW = 100_000
TIMEOUT_MS = 300
SENT = np.iinfo(np.int32).min  # ops.quorum.PACK_SENTINEL
# (key, G, E, padded as the engine pads) of the flat K1 shapes; the
# engine's buckets at 1024 rows
K1_SHAPES = tuple((f"K1_G1024_E{e}", 1024, e, False)
                  for e in (64, 256, 1024, 4096, 16384)) + tuple(
    (f"K1_G1024_E{e}_engine_padding", 1024, e, True)
    for e in (1024, 4096, 16384)) + (
    ("K1_G10240_E1024", 10_240, 1024, False),)


def engine_padded(ev: np.ndarray) -> np.ndarray:
    """``ev`` (a fast pack from ``cases.fast_events`` or ``sliced_events``,
    [7, E] or [7, S, E]) with its padding columns (invalid acks whose
    updates are both sentinel) naming slot PACK_SENTINEL, which lands in
    no row, as the engine pads, where ``cases`` names row 0.  In place;
    returned.  Here, not in ``cases``, so that another checkout's package
    gets the same inputs."""
    ev[0][(ev[4] == 0) & (ev[5] == SENT) & (ev[6] == SENT)] = SENT
    return ev


# (key, G, P, table width) of the K4 shapes
K4_SHAPES = (("K4_G1024_W8", 1024, 8, 8), ("K4_G1000_W16", 1000, 8, 16),
             ("K4_G2048_W8", 2048, 8, 8), ("K4_G10240_W8", 10_240, 8, 8),
             ("K4_G1024_W512", 1024, 8, 512))
# (G, P, E) of K6: the bench's entry() and its two kernel rungs
K6_SHAPES = ((1024, 8, 256), (10_240, 8, 4096), (102_400, 8, 8192))
# (G, P) of K7c; (G, P, E) of K7a, then the shapes around its choice
# between its designs (design (a)'s blocks read 1-8 MB of event rows)
K7C_SHAPES = ((1024, 8), (10_240, 8), (102_400, 8), (102_400, 16))
K7A_SHAPES = ((1024, 8, 256), (1024, 8, 2048), (10_240, 8, 20_480),
              (102_400, 8, 204_800))
K7A_RULE_SHAPES = ((1024, 8, 8192), (4096, 8, 4096), (4096, 8, 8192),
                   (10_240, 8, 5120), (102_400, 8, 1024),
                   (102_400, 8, 4096))
LEASE_TIMEOUT_MS = 1000
# (G, P) of K7b and the public K3, both in rows of 8 lanes; K3's row entry
# at the engine's usual bucket of 64 rows
LANE_SHAPES = ((1024, 8), (10_240, 8), (20_480, 8), (40_960, 8),
               (102_400, 8), (102_400, 16), (102_400, 3))
K3_ROWS = 64


HBM_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 33.5e12


def bound_us(q, state_np, ev_np) -> float:
    """The least time one fast tick (K1 on [7, E], K5 on [7, S, E]) could
    take on an H100: each input read once (the state, the event columns,
    meta), the state elements the call changes and the int32 [4, G]
    output written once, against the integer operations of its row math
    (``chip_smoke.py``'s count).  The changed elements come from the plain
    version on the CPU, which the kernel equals."""
    g, p = state_np[0].shape
    before = q.device_state_from_numpy(state_np, "cpu")
    after = q.device_state_from_numpy(state_np, "cpu")
    ev = torch.from_numpy(np.ascontiguousarray(ev_np))
    meta = torch.tensor([NOW, TIMEOUT_MS], dtype=torch.int32)
    if ev.dim() == 3:
        q._resident_fast_sliced_plain(after, ev, meta)
    else:
        q._resident_fast_plain(after, ev, meta)
    wrote = sum(int((x != y).sum()) * x.element_size()
                for x, y in zip(before, after))
    cols = int(np.prod(ev_np.shape[1:]))
    nbytes = g * p * 11 + g * 17 + 28 * cols + 8 + wrote + 16 * g
    ops = g * (4 * p * p + 64) + 10 * cols
    return max(nbytes / HBM_BYTES_S, ops / PEAK_INT32_OPS_S) * 1e6


def timed(fn, setup=None, n: int = 200, warm: int = 5) -> float:
    """Median CUDA-event ms of ``fn``; ``setup`` runs before each call,
    outside the events (and is waited for)."""
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


def graph_us(fn, n: int = 20) -> float:
    """Device us per call of ``fn``: ``n`` calls captured in one CUDA
    graph, the graph replayed between two CUDA events, so the card runs
    the calls back to back with the host out of the loop (each call's
    kernels and copies plus the graph's gap between its nodes, ~1 us).
    Raises RuntimeError where a call cannot be captured."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def host_us(fn, n: int = 200, warm: int = 10) -> float:
    """Host us per call of ``fn`` issued back to back: the wrapper's own
    cost (checks, allocation, the call into the library); the card keeps
    up, as every kernel here takes far less on the device."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def timed_host(fn, setup=None, n: int = 200, warm: int = 10) -> float:
    """Median host wall ms of ``fn`` (each call ends synchronised: the
    engine's routes wait for their results); ``setup`` runs before each
    call, outside the clock."""
    times = []
    for i in range(warm + n):
        if setup:
            setup()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        if i >= warm:
            times.append((t1 - t0) * 1e3)
    return statistics.median(times)


def ledger_earlier_route(tl, tq, mirrors, scalars, width: int) -> np.ndarray:
    """One ledger sample on the route the engine took before K4's prepared
    call: the eleven mirrors uploaded in one pageable copy
    (``ops.quorum.upload``), the public wrapper, a synchronising pageable
    ``.cpu()``."""
    return tl.ledger_pass(*tq.upload(mirrors, "cuda"), *scalars,
                          num_peers=width).cpu().numpy()


def time_call(fn) -> dict:
    """ms, graph us and host us of a functional wrapper call; host us the
    median of five runs of 200 calls (one run swings by tens of us on a
    shared host)."""
    return {"ms": timed(fn), "graph_us": graph_us(fn),
            "host_us": statistics.median(host_us(fn) for _ in range(5))}


def time_ledger_and_step(tl, tq, bench, cases) -> dict:
    """K4 at ``K4_SHAPES`` (with the sample routes at 1024 x 8) and K6 at
    the kernel rungs' shapes."""
    res = {}
    for key, g, p, w in K4_SHAPES:
        arrays, scalars = cases.ledger_inputs(np.random.default_rng(g + w),
                                              g, p, w)
        dev = [torch.from_numpy(a).cuda() for a in arrays]
        res[key] = time_call(lambda: tl.ledger_pass(*dev, *scalars,
                                                    num_peers=w))
        if key != "K4_G1024_W8":
            continue
        res[key]["earlier_route_ms"] = timed_host(
            lambda: ledger_earlier_route(tl, tq, arrays, scalars, w))
        if hasattr(tl, "LedgerPlan"):
            plan = tl.LedgerPlan(g, p, "cuda")
            for v, a in zip(plan.views, arrays):
                np.copyto(v, a)
            res[key]["plan_run_ms"] = timed_host(
                lambda: plan.run(w, *scalars))
    for key, (g, p, e) in zip(("K6", "K6_100k"), K6_SHAPES[1:]):
        step = tq.engine_step_args_from_numpy(bench._example_batch(g, p, e),
                                              "cuda")
        res[key] = time_call(lambda: tq.engine_step(*step))
    return res


def k7_bound_us(key: str, g: int, p: int, e: int = 0) -> float:
    """K7a's, K7b's, K7c's or the public K3's bound as ``chip_smoke.py``
    counts it: K7a both [G, P] masks in and out and 10 bytes per event;
    K7b the int32 and three bool [G, P] arrays and int32 [G] in, int32
    [G] out, against ``G * (3 P + 4)`` integer operations; K7c the int32
    and three bool [G, P] arrays in and int32 [G] out, against its
    ``G * (8 P^2 + 16)``; K3 four bool and one int32 [G, P] array and
    int32 [G] in, bool [4, G] out, against ``G * (8 P + 40)``."""
    nbytes, ops = {
        "K7a": (4 * g * p + 10 * e, 10 * e),
        "K7b": (7 * g * p + 8 * g, g * (3 * p + 4)),
        "K7c": (7 * g * p + 4 * g, g * (8 * p * p + 16)),
        "K3_public": (8 * g * p + 8 * g, g * (8 * p + 40))}[key]
    return max(nbytes / HBM_BYTES_S, ops / PEAK_INT32_OPS_S) * 1e6


def time_rows_of_lanes(q, cases) -> dict:
    """K7b and the public K3 at ``LANE_SHAPES``, and K3's row entry at
    ``K3_ROWS`` rows x 8 (a quarter of them open rounds, the rest stale
    padding, as the engine's vote pass packs them)."""
    res = {}
    for g, p in LANE_SHAPES:
        tag = f"_G{g}" + ("" if p == 8 else f"_P{p}")
        repl = [torch.from_numpy(a).cuda() for a in cases.replicated_inputs(
            np.random.default_rng(g + p), g, p)]
        res["K7b" + tag] = {
            **time_call(lambda: q.all_replicated_min(*repl)),
            "bound_us": k7_bound_us("K7b", g, p)}
        tally = [torch.from_numpy(a).cuda() for a in cases.tally_inputs(
            np.random.default_rng(g * p), g, p)]
        res["K3_public" + tag] = {
            **time_call(lambda: q.tally_votes_packed(*tally)),
            "bound_us": k7_bound_us("K3_public", g, p)}
        if not hasattr(q, "tally_tile"):
            continue
        res["K3_public" + tag]["tile"] = q.tally_tile(g)
        for design, tile in (("lanes", 0), ("tile", q.TALLY_TILE)):
            with tally_design(q, tile):
                res[f"K3_public{tag}_{design}"] = time_call(
                    lambda: q.tally_votes_packed(*tally))
    arrays = cases.tally_inputs(np.random.default_rng(3), 1024, 8)
    v = cases.tally_plan(arrays, np.arange(0, 1024, 64), "cpu",
                         K3_ROWS).views(K3_ROWS)
    packed = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
              for a in (v.masks, v.priority, v.self_priority)]
    res[f"K3_rows_R{K3_ROWS}"] = time_call(lambda: q.tally_rows(*packed))
    return res


def time_votes_and_lease(q, cases) -> dict:
    """K7c at ``K7C_SHAPES`` and K7a at ``K7A_SHAPES`` and
    ``K7A_RULE_SHAPES`` (and, where the package has ``vote_rows``, K7a
    forced to each design, and the rows a block its rule gave)."""
    res = {}
    for g, p in K7C_SHAPES:
        args = [torch.from_numpy(a).cuda() for a in cases.lease_inputs(
            np.random.default_rng(g), g, p, NOW)]
        res[f"K7c_G{g}" + ("" if p == 8 else f"_P{p}")] = {
            **time_call(lambda: q.lease_expiry(*args, LEASE_TIMEOUT_MS)),
            "bound_us": k7_bound_us("K7c", g, p)}
    rule = getattr(q, "vote_rows", None)
    for g, p, e in K7A_SHAPES + K7A_RULE_SHAPES:
        args = [torch.from_numpy(a).cuda() for a in cases.vote_events(
            np.random.default_rng(g + e), g, p, e)]
        key = f"K7a_G{g}_E{e}"
        res[key] = {**time_call(lambda: q.apply_vote_events(*args)),
                    "bound_us": k7_bound_us("K7a", g, p, e)}
        if rule is None:
            continue
        res[key]["rows"] = rule(g, p, e)
        for design, rows in (("rows", q.vote_block_rows(g)), ("grid", 0)):
            with vote_design(q, rows):
                res[f"{key}_{design}"] = time_call(
                    lambda: q.apply_vote_events(*args))
    return res


@contextlib.contextmanager
def vote_design(q, rows: int):
    """K7a's launch rule ``q.vote_rows`` replaced by one that always
    answers ``rows`` (> 0: design (a) with that many rows a block; 0:
    design (b)) while the block runs, to time or check each design at any
    shape."""
    rule = q.vote_rows
    q.vote_rows = lambda *_: rows
    try:
        yield
    finally:
        q.vote_rows = rule


@contextlib.contextmanager
def tally_design(q, tile: int):
    """The public K3's launch rule ``q.tally_tile`` replaced by one that
    always answers ``tile`` (0: rows of 8 lanes; ``q.TALLY_TILE``: staged
    tiles) while the block runs, to time or check each design at any
    shape."""
    rule = q.tally_tile
    q.tally_tile = lambda *_: tile
    try:
        yield
    finally:
        q.tally_tile = rule


def time_fast_ticks(q, bench, cases) -> dict:
    """K1 at ``K1_SHAPES`` and on the mesh100k batch's flat control, K5 at
    2048 x 8 in 8 slices x 64 and on the mesh100k batch."""
    rng = np.random.default_rng(0)
    res = {}
    for key, g, e, engine in K1_SHAPES:
        ev = cases.fast_events(rng, g, 8, e, NOW)
        res[key] = time_shape(q, cases.resident_state(rng, g, 8, NOW),
                              engine_padded(ev) if engine else ev,
                              False)
    res["K5_G2048_S8_E64"] = time_shape(
        q, cases.resident_state(rng, 2048, 8, NOW),
        cases.sliced_events(rng, 2048, 8, 8, 64, NOW), True)
    state, evs, evf, _ = bench.mesh100k_batch()
    res["K1_100k"] = time_shape(q, state, evf, False)
    res["K5_100k"] = time_shape(q, state, evs, True)
    return res


def time_shape(q, state_np, ev_np, sliced: bool) -> dict:
    """One wrapper on one packed tick: ms, graph us, host us."""
    fresh = q.device_state_from_numpy(state_np, "cuda")
    a = q.device_state_from_numpy(state_np, "cuda")
    ev = torch.from_numpy(np.ascontiguousarray(ev_np)).cuda()
    meta = torch.tensor([NOW, TIMEOUT_MS], dtype=torch.int32, device="cuda")
    wrapper = (q.engine_step_resident_fast_sliced if sliced
               else q.engine_step_resident_fast)

    def restore():
        for x, y in zip(a, fresh):
            x.copy_(y)

    def call():
        wrapper(a, ev, meta)

    return {"shape": list(state_np[0].shape) + list(ev_np.shape[1:]),
            "ms": timed(call, restore), "graph_us": graph_us(call),
            "host_us": host_us(call),
            "bound_us": bound_us(q, state_np, ev_np)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this run")
    ap.add_argument("--only", choices=("all", "k7"), default="all",
                    help="k7: time K7a-c and K3 (public and row entry) "
                         "alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fast_tick_timing: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    from ratis_tpu_torch.ops import _build
    from ratis_tpu_torch.ops import ledger as tl
    from ratis_tpu_torch.ops import quorum as q
    from ratis_tpu_torch.tools import bench, cases
    _build.build_all()
    res = time_rows_of_lanes(q, cases)
    res.update(time_votes_and_lease(q, cases))
    if args.only == "all":
        res.update(time_fast_ticks(q, bench, cases))
        res.update(time_ledger_and_step(tl, q, bench, cases))
    print(json.dumps({"label": args.label, "card": card,
                      "package": q.__file__, "timing": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
