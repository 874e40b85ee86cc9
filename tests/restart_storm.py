"""Count the election timeouts of one full restart, JAX package against
the port, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.restart_storm [--runs 3] [--groups 16]

The clusters are ``tests/test_torch_durable.py``'s: 3 servers x
``--groups`` groups over localhost TCP, ``ArithmeticStateMachine`` on
per-group segment files, the port's ``cluster_properties`` on both sides
(the JAX side runs the port's harness renamed, ``tests/jax_mirror.py``).
Each run starts the cluster, writes 3 times per group, restarts every
server from disk and waits for a leader in every group; the election
timeouts fired by the new servers until then are the restart's count.
The packages take turns (JAX, port, port, JAX, ...).  Prints one JSON
line: per package, each run's restart timeouts, bring-up timeouts and
restart seconds.  It is not a test: the count depends on timing.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile

from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

WRITES = 3
TIMEOUT = 120.0


async def _one_run(cluster) -> dict:
    try:
        await cluster.start(timeout=TIMEOUT)
        bring_up = cluster.election_timeouts()
        await cluster.write_all(WRITES)
        await cluster.restart(TIMEOUT)
        return {"restart_timeouts": cluster.election_timeouts(),
                "bring_up_timeouts": bring_up,
                "restart_s": cluster.restart_s}
    finally:
        await cluster.close()


def run(pkg: str, groups: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        props = cluster_properties(groups, 3, "cpu", "tcp", storage_dir=tmp)
        if pkg == "port":
            cluster = Cluster(groups, device="cpu", transport="tcp",
                              sm="arithmetic", properties=props)
        else:
            cluster = jax_cluster_module().Cluster(
                groups, device="cpu", transport="tcp", sm="arithmetic",
                properties=jax_properties(props))
            prewarm_small(cluster)
        return asyncio.run(_one_run(cluster))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--groups", type=int, default=16)
    args = ap.parse_args(argv)
    res = {"jax": [], "port": []}
    order = [("jax", "port")[(i + i // 2) % 2] for i in range(2 * args.runs)]
    for pkg in order:
        res[pkg].append(run(pkg, args.groups))
        print(pkg, res[pkg][-1], file=sys.stderr, flush=True)
    print(json.dumps({"groups": args.groups, "servers": 3, "order": order,
                      "runs": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
