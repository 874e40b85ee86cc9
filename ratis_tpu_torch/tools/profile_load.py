"""Dev tool: cProfile the bench load phase of the port at N groups (not
part of the framework; run as
`python -m ratis_tpu_torch.tools.profile_load [groups] [batched|scalar]
 [writes] [transport] [peers] [--device cuda|cpu]`).

The JAX package's tool of the same name on the port's harness: a
``tools/cluster.Cluster`` of ``peers`` servers x ``groups`` groups over
``transport`` on ``cluster_properties(..., batched=...)``, its engines on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions), brought up as the bench brings its clusters up, one warm-up
write per group at 128 in flight, then ``writes`` writes per group at 128
in flight under cProfile.  Prints the ``RESULT`` line (the JAX harness's
load keys, plus ``acked``: writes acknowledged) and the two ``pstats``
tables, by cumulative and by own time.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import json
import pstats

# the load's writes in flight (the JAX tool's run_load(..., 128))
CONCURRENCY = 128


async def run(groups: int, batched: bool, writes: int, transport: str,
              peers: int, device: str) -> tuple[dict, cProfile.Profile]:
    """Bring the cluster up, warm it up, profile its load; close it.
    Returns the load's result and the profile."""
    from ratis_tpu_torch.tools.bench import _device
    from ratis_tpu_torch.tools.cluster import (Cluster, bring_up_wave,
                                               cluster_properties, sealed)
    dev = str(_device(device))
    cluster = Cluster(groups, peers, device=dev, transport=transport,
                      properties=cluster_properties(groups, peers, dev,
                                                    transport,
                                                    batched=batched))
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        await cluster.write_all(1, CONCURRENCY)  # warm-up
        prof = cProfile.Profile()
        prof.enable()
        stats = await cluster.write_all(writes, CONCURRENCY)
        prof.disable()
    finally:
        await cluster.close()
    result = {"commits": stats["commits"], "write_failures": 0,
              "elapsed_s": stats["elapsed_s"],
              "commits_per_sec": stats["commits_per_sec"],
              "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
              "election_convergence_s": cluster.bring_up_s,
              "prewarm_s": cluster.prewarm_s,
              "acked": sum(stats["acked"].values())}
    return result, prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("groups", nargs="?", type=int, default=1024)
    ap.add_argument("mode", nargs="?", default="batched",
                    choices=("batched", "scalar"))
    ap.add_argument("writes", nargs="?", type=int, default=8)
    ap.add_argument("transport", nargs="?", default="sim")
    ap.add_argument("peers", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    args = ap.parse_args(argv)
    result, prof = asyncio.run(run(args.groups, args.mode == "batched",
                                   args.writes, args.transport, args.peers,
                                   args.device))
    print("RESULT " + json.dumps(result))
    for order, rows in (("cumulative", 45), ("tottime", 35)):
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats(order).print_stats(rows)
        print(s.getvalue())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
