"""Where the main path's time goes on a CUDA card.

    python -m ratis_tpu_torch.tools.profile_main_path [--groups 1024]
        [--writes 4] [--transport sim|tcp] [--out FILE]

Brings up the port's 3-server cluster on ``cuda`` (``tools/cluster.py``)
over the simulated transport or localhost TCP,
then traces the write phase under ``torch.profiler`` (CPU and CUDA
activity) and reports, for that window:

- the device's busy time (every kernel, copy and memset the trace
  recorded) and its idle share of the wall clock;
- device time per kernel name (count, total, mean);
- the share of the wall clock the engines spent in batched dispatches
  (host view: pack, upload, launch, download), from their
  ``dispatchLatency`` timers;
- the window's commits/s and commit latency percentiles;
- the election timeouts fired in bring-up and in the window (churn).

The numbers describe the card it ran on; the script prints its name and
power limit first.  It needs CUDA and fails without it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import time

import torch


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def device_ops(fn, tries: int = 3) -> list[str]:
    """The device operations (kernel and copy names, in order) that one
    call of ``fn`` puts on the card, from a ``torch.profiler`` trace (a
    warm-up call first, outside the trace).  A trace that recorded no
    device activity at all is taken again, up to ``tries`` traces: it
    shows that the profiler saw nothing, not that ``fn`` launched
    nothing."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    evts = []
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if evts:
            break
    return [e.name for e in sorted(evts, key=lambda e: e.time_range.start)]


def is_copy(op: str) -> bool:
    """A copy or fill in a ``device_ops`` list (not a kernel)."""
    return op.lower().startswith(("memcpy", "memset"))


def graph_nodes(fn) -> list[str]:
    """What one call of ``fn`` puts on the card, without the profiler:
    the call captured in a CUDA graph (after a warm-up call), each node
    of the graph as the CUDA runtime's DOT dump describes it, in order.
    Unlike a profiler trace it cannot come back empty for a call that
    launched something: a graph with no node means no work, and a dump
    that was not written raises."""
    import os
    import re
    import tempfile
    import warnings
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump
    with torch.cuda.graph(g):
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "call.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the dump warns that it runs
            g.debug_dump(path)
        with open(path) as f:
            text = f.read()
    # a node's record starts a line ("graph_1_node_0"[style=...); an
    # edge's line starts with its source node and an arrow
    starts = [m.start() for m in
              re.finditer(r'^"graph_\d+_node_\d+"\[style=', text, re.M)]
    return [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]


def is_kernel_node(node: str) -> bool:
    """A kernel node in a ``graph_nodes`` list."""
    return "KERNEL" in node


async def _run(groups: int, writes: int, transport: str) -> dict:
    from ratis_tpu_torch.tools.cluster import Cluster
    cluster = Cluster(groups, device="cuda", transport=transport)
    cluster.prewarm()
    try:
        await cluster.start(timeout=600)
        timers = [s.engine._m.dispatch_timer for s in cluster.servers]
        timeouts = cluster.election_timeouts()
        before = [(t.count, t._total_s) for t in timers]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            stats = await cluster.write_all(writes)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dispatch = [(t.count - c, t._total_s - s)
                    for t, (c, s) in zip(timers, before)]
        timeouts = [timeouts, cluster.election_timeouts() - timeouts]
    finally:
        await cluster.close()
    kernels = {}
    busy_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us <= 0:
            continue
        busy_us += us
        kernels[evt.key] = {"count": evt.count, "total_us": us,
                            "mean_us": us / max(1, evt.count)}
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "engine_dispatches": [n for n, _ in dispatch],
            "engine_dispatch_s": [s for _, s in dispatch],
            "engine_dispatch_share": sum(s for _, s in dispatch) / wall,
            "commits_per_sec": stats["commits_per_sec"],
            "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
            "election_timeouts": timeouts,
            "kernels": dict(sorted(kernels.items(),
                                   key=lambda kv: -kv[1]["total_us"]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=1024)
    ap.add_argument("--writes", type=int, default=4)
    ap.add_argument("--transport", default="sim", choices=("sim", "tcp"))
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    res = asyncio.run(_run(args.groups, args.writes, args.transport))
    res["card"] = card
    res["transport"] = args.transport
    print(f"write window: {res['wall_s']:.3f} s wall, "
          f"{res['commits_per_sec']:.1f} commits/s, p50 {res['p50_ms']:.2f}"
          f" ms, p99 {res['p99_ms']:.2f} ms; election timeouts in "
          f"bring-up {res['election_timeouts'][0]}, in the window "
          f"{res['election_timeouts'][1]}")
    print(f"device busy {res['device_busy_s'] * 1e3:.3f} ms, idle share "
          f"{res['device_idle_share']:.6f}; engines in dispatch "
          f"{res['engine_dispatch_share']:.4f} of wall "
          f"({res['engine_dispatches']} dispatches)")
    for name, k in list(res["kernels"].items())[:12]:
        print(f"  {k['count']:6d} x {k['mean_us']:8.3f} us = "
              f"{k['total_us'] / 1e3:8.3f} ms  {name[:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
