"""The port's bench entry point: the JAX bench's kernel rungs and its
headline end-to-end rung, run on the port.

    python -m ratis_tpu_torch.tools.bench                 # on the CUDA card
    python -m ratis_tpu_torch.tools.bench --device cpu    # plain versions

Prints exactly one JSON line on stdout, with the key names of ``bench.py``'s
rungs:

- ``kernel`` (``child_kernel``): the stateless fused tick ``engine_step``
  (K6) over a 10240 groups x 8 peers batch with 4096 acks, 3 warm calls,
  then the best of 3 x 100 calls, each loop closed by a device sync:
  ``group_updates_per_sec``, and ``vs_scalar_loop`` against the scalar
  Python loop of ``ops/reference.py`` over 2048 groups;
- ``kernel_100k`` (``child_kernel_100k``): the same tick at 102400 x 8
  with 8192 acks, 10 calls: ``group_updates_per_sec_100k``;
- ``e2e`` (``child_e2e`` -> ``run_bench``), the headline: 3 servers x 1024
  groups over real localhost TCP sockets, ``CounterStateMachine``, one
  warm-up write per group, then 8 writes per group at concurrency 128;
  every write acknowledged and every counter read back equal from all
  three replicas: ``commits_per_sec``, ``p50_ms``, ``p99_ms``,
  ``election_convergence_s`` (bring-up: servers start -> every group has
  a ready leader), ``prewarm_s`` (the kernels' build and first launch)
  and ``election_timeouts`` (fired in bring-up, warm-up, measured writes).
  Leaders come from elections (the JAX bench appoints them), so the
  bring-up includes 1024 elections through the batched vote tally.

``--device cuda`` (the default) runs the kernels and fails where there is
no card; ``--device cpu`` runs the plain versions, for the tests.
``entry()`` is the counterpart of ``__graft_entry__.entry()``.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import sys
import time

import numpy as np
import torch

from ratis_tpu_torch.ops import quorum
from ratis_tpu_torch.ops import reference as ref

RUNGS = ("kernel", "kernel_100k", "e2e")
# the headline rung's load: one warm-up write per group, then the measured
# writes with this many in flight (bench.py's child_e2e at the headline)
WARMUP_WRITES = 1
CONCURRENCY = 128


def _example_batch(num_groups: int, num_peers: int, num_events: int,
                   seed: int = 0):
    """Build a plausible mixed-role group batch + packed ack batch."""
    rng = np.random.default_rng(seed)
    g, p, e = num_groups, num_peers, num_events

    # 5 voting members in slots 0..4, self in slot 0.
    conf_cur = np.zeros((g, p), bool)
    conf_cur[:, :5] = True
    conf_old = np.zeros((g, p), bool)
    self_mask = np.zeros((g, p), bool)
    self_mask[:, 0] = True

    role = np.where(rng.random(g) < 0.5, np.int8(3), np.int8(1))  # leader/follower
    commit_index = rng.integers(0, 1000, g, dtype=np.int32)
    flush_index = commit_index + rng.integers(0, 64, g, dtype=np.int32)
    match_index = np.minimum(
        commit_index[:, None] + rng.integers(-8, 64, (g, p), dtype=np.int32),
        flush_index[:, None]).astype(np.int32)
    first_leader_index = np.maximum(commit_index - 10, 0).astype(np.int32)
    last_ack_ms = rng.integers(0, 5000, (g, p), dtype=np.int32)
    election_deadline_ms = rng.integers(4000, 8000, g, dtype=np.int32)

    ev_group = rng.integers(0, g, e, dtype=np.int32)
    ev_peer = rng.integers(1, 5, e, dtype=np.int32)
    ev_match = rng.integers(0, 1100, e, dtype=np.int32)
    ev_time_ms = np.full(e, 5000, np.int32)
    ev_valid = np.ones(e, bool)

    now_ms = np.int32(5000)
    leadership_timeout_ms = np.int32(300)

    return (match_index, last_ack_ms, ev_group, ev_peer, ev_match, ev_time_ms,
            ev_valid, self_mask, flush_index, conf_cur, conf_old, commit_index,
            first_leader_index, role, election_deadline_ms, now_ms,
            leadership_timeout_ms)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the kernels run only there "
                           "(--device cpu runs the plain versions)")
    return dev


def device_info(device) -> dict:
    dev = _device(device)
    if dev.type == "cuda":
        return {"type": "cuda", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"type": dev.type, "kind": "cpu", "count": 1}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def entry(device="cuda"):
    """(fn, args): the stateless fused tick and its example arguments at
    1024 group slots x 8 peer slots with 256 acks, on ``device``."""
    args = _example_batch(num_groups=1024, num_peers=8, num_events=256)
    return quorum.engine_step, quorum.engine_step_args_from_numpy(
        args, _device(device))


def _scalar_rate(num_peers: int, groups: int) -> float:
    """Group updates per second of the scalar Python loop: the same math,
    one group at a time."""
    (match_index, last_ack_ms, _eg, _ep, _em, _et, _ev, _sm, flush_index,
     conf_cur, conf_old, commit_index, first_leader_index, role, _dl,
     now_ms, lead_timeout) = _example_batch(groups, num_peers, 1)
    self_slot = np.zeros(groups, np.int32)
    t0 = time.perf_counter()
    for _ in range(3):
        for g in range(groups):
            ref.update_commit(
                match_index[g].tolist(), int(self_slot[g]),
                int(flush_index[g]), conf_cur[g].tolist(),
                conf_old[g].tolist(), int(commit_index[g]),
                int(first_leader_index[g]), bool(role[g] == 3))
            ref.check_leadership(
                last_ack_ms[g].tolist(), int(self_slot[g]),
                conf_cur[g].tolist(), conf_old[g].tolist(),
                int(now_ms), int(lead_timeout), bool(role[g] == 3))
    return groups * 3 / (time.perf_counter() - t0)


def kernel_rung(device="cuda", groups: int = 10_240, peers: int = 8,
                events: int = 4096, iters: int = 100,
                scalar_groups: int = 2048) -> dict:
    """``child_kernel``: the best rate of 3 x ``iters`` calls."""
    dev = _device(device)
    args = quorum.engine_step_args_from_numpy(
        _example_batch(groups, peers, events), dev)
    for _ in range(3):
        quorum.engine_step(*args)
    _sync(dev)
    batched = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            quorum.engine_step(*args)
        _sync(dev)
        batched = max(batched, groups * iters / (time.perf_counter() - t0))
    scalar = _scalar_rate(peers, scalar_groups)
    return {"group_updates_per_sec": batched,
            "vs_scalar_loop": batched / scalar,
            "platform": device_info(dev)["kind"],
            "shape": [groups, peers, events]}


def kernel_100k_rung(device="cuda", groups: int = 102_400, peers: int = 8,
                     events: int = 8192, iters: int = 10) -> dict:
    """``child_kernel_100k``: one warm call, then ``iters`` timed calls."""
    dev = _device(device)
    args = quorum.engine_step_args_from_numpy(
        _example_batch(groups, peers, events), dev)
    quorum.engine_step(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        quorum.engine_step(*args)
    _sync(dev)
    return {"group_updates_per_sec_100k":
            groups * iters / (time.perf_counter() - t0),
            "platform": device_info(dev)["kind"],
            "shape": [groups, peers, events]}


def e2e_cluster(device="cuda", groups: int = 1024):
    """The e2e rung's cluster: 3 servers x ``groups`` groups over TCP,
    its kernels built and launched once (``Cluster.prewarm``), not yet
    started."""
    from ratis_tpu_torch.tools.cluster import Cluster
    cluster = Cluster(groups, device=str(_device(device)), transport="tcp")
    cluster.prewarm()
    return cluster


async def e2e_rung(cluster, writes: int = 8) -> dict:
    """``run_bench`` over TCP on an ``e2e_cluster``: bring it up, warm
    up, measure ``writes`` writes per group, read every counter back from
    every replica, close it."""
    dev = torch.device(cluster.device)
    groups = cluster.num_groups
    # bring-up allocates long-lived objects only: the collector stays off
    # until the servers' one deliberate seal (the JAX bench's scaffold)
    gc.disable()
    try:
        await cluster.start(timeout=600)
        cluster.servers[0].seal_heap()
        gc.enable()
        timeouts = [cluster.election_timeouts()]
        acked = (await cluster.write_all(WARMUP_WRITES,
                                         CONCURRENCY))["commits"]
        timeouts.append(cluster.election_timeouts())
        stats = await cluster.write_all(writes, CONCURRENCY)
        timeouts.append(cluster.election_timeouts())
        acked += stats["commits"]
        counters = await cluster.read_counters(timeout=300)
        want = [WARMUP_WRITES + writes] * len(cluster.servers)
        bad = {str(gid): v for gid, v in counters.items() if v != want}
        if len(counters) != groups or bad:
            raise AssertionError(f"counters differ from {want} in "
                                 f"{len(bad)} groups: {list(bad.items())[:4]}")
        # the watchdog's ledger pass samples once a second on every server
        deadline = time.monotonic() + 30
        while any(s.engine.ledger.samples.count == 0
                  for s in cluster.servers):
            if time.monotonic() > deadline:
                raise AssertionError("no ledger sample on some server")
            await asyncio.sleep(0.1)
        engines = [s.engine for s in cluster.servers]
        for e in engines:
            on = e._dev.match_index.device if e._dev is not None else None
            if e.device.type != dev.type or (on and on.type != dev.type) \
                    or e.metrics["batched_dispatches"] == 0:
                raise AssertionError(f"engine on {e.device}, state on {on}, "
                                     f"{e.metrics['batched_dispatches']} "
                                     f"batched dispatches")
        return {"groups": groups, "servers": len(cluster.servers),
                "transport": "tcp", "writes": writes,
                "warmup": WARMUP_WRITES, "concurrency": CONCURRENCY,
                "commits": stats["commits"],
                "acked": acked,
                "write_failures": 0, "elapsed_s": stats["elapsed_s"],
                "commits_per_sec": stats["commits_per_sec"],
                "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                "election_convergence_s": cluster.bring_up_s,
                # election timeouts fired in bring-up, in the warm-up
                # writes and in the measured writes (churn would show in
                # the last two)
                "election_timeouts": [timeouts[0],
                                      timeouts[1] - timeouts[0],
                                      timeouts[2] - timeouts[1]],
                "prewarm_s": cluster.prewarm_s,
                "replicas_read_back": len(counters) * len(cluster.servers),
                "batched_dispatches": sum(e.metrics["batched_dispatches"]
                                          for e in engines),
                "engine_ticks": sum(e.metrics["ticks"] for e in engines),
                "ledger_samples": [e.ledger.samples.count for e in engines],
                "engine_device": str(engines[0].device)}
    finally:
        gc.enable()
        await cluster.close()


def _shape(text: str) -> tuple[int, int, int]:
    g, p, e = (int(x) for x in text.split(","))
    return g, p, e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    ap.add_argument("--rungs", default=",".join(RUNGS),
                    help=f"comma-separated subset of {','.join(RUNGS)}")
    ap.add_argument("--kernel", type=_shape, default=(10_240, 8, 4096),
                    metavar="G,P,E", help="kernel rung shape")
    ap.add_argument("--kernel-100k", type=_shape, default=(102_400, 8, 8192),
                    metavar="G,P,E", help="kernel_100k rung shape")
    ap.add_argument("--iters", type=int, default=100,
                    help="calls per timed kernel-rung trial")
    ap.add_argument("--scalar-groups", type=int, default=2048)
    ap.add_argument("--groups", type=int, default=1024)
    ap.add_argument("--writes", type=int, default=8)
    args = ap.parse_args(argv)
    rungs = [r for r in args.rungs.split(",") if r]
    unknown = sorted(set(rungs) - set(RUNGS))
    if unknown:
        ap.error(f"unknown rungs {unknown}")
    out = {"metric": "aggregate_commits_per_sec", "value": None,
           "unit": "commits/s", "device": device_info(args.device)}
    if "kernel" in rungs:
        g, p, e = args.kernel
        out["kernel"] = kernel_rung(args.device, g, p, e, iters=args.iters,
                                    scalar_groups=args.scalar_groups)
    if "kernel_100k" in rungs:
        g, p, e = args.kernel_100k
        out["kernel_100k"] = kernel_100k_rung(args.device, g, p, e)
    if "e2e" in rungs:
        out["e2e"] = asyncio.run(e2e_rung(
            e2e_cluster(args.device, args.groups), args.writes))
        out["value"] = out["e2e"]["commits_per_sec"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
