"""The upkeep plane's loads on the port: the JAX bench's ``child_upkeep``
and its sparse pair (``bench.py``'s ``sparse_hib`` / ``sparse_plain``).

    python -m ratis_tpu_torch.tools.bench --rungs upkeep
    python -m ratis_tpu_torch.tools.bench --rungs sparse_hib   # sparse_plain

``upkeep_rung`` is ``run_upkeep_bench`` (``ratis_tpu/tools/
bench_cluster.py``) with ``child_upkeep``'s raw scan: 3 servers x
``groups`` idle groups over the simulated transport, hibernation and the
vectorized upkeep plane (``raft.tpu.upkeep.enabled``) on, no client load;
after ``settle_s`` the tick pair is timed on the same live divisions, one
side after the other: the plane's sweep (``array_tick``) against the
retired per-division walk with its ``hibernate_sweep`` calls
(``legacy_tick``), each the best of 3, worst server.  ``tick_array_ms`` /
``tick_legacy_ms`` are thread-CPU ms, as the JAX bench takes them;
``tick_array_wall_ms`` / ``tick_legacy_wall_ms`` the same on the wall clock
(a host whose thread-CPU clock ticks coarsely reads 0.000 there).
``sweep_ms_64`` / ``sweep_ms_1024`` are the raw due-scan of a plane of 64
and of 1024 idle slots (wall, best of 7 x 300 sweeps).

``hibernate_settle`` is the sparse rungs' settle: the JAX bench sleeps
``settle_s`` after bring-up when hibernation is on, so that idle groups
fall asleep before the writes.
"""

from __future__ import annotations

import asyncio
import time
import types

import torch

from ratis_tpu_torch.conf import RaftServerConfigKeys

# child_upkeep: 3 x 10240 idle groups, settle 25 s
UPKEEP_GROUPS = 10_240
UPKEEP_SETTLE_S = 25.0
# bench.py's sparse pair: 10240 hosted, 8 writes per group on the first
# 1024 at 128 in flight, no warm-up, settle 20 s (with hibernation on)
SPARSE_GROUPS = 10_240
SPARSE_ACTIVE = 1024
SPARSE_WRITES = 8
SPARSE_SETTLE_S = 20.0
UPKEEP = {RaftServerConfigKeys.Upkeep.ENABLED_KEY: "true"}


def scan_ms(n: int) -> float:
    """``child_upkeep``'s raw scan: wall ms of one sweep of a plane of
    ``n`` registered idle slots, the best of 7 x 300 sweeps."""
    from ratis_tpu_torch.server.upkeep import UpkeepPlane
    plane = UpkeepPlane(server=None, shard=0)
    for i in range(n):
        plane.register(types.SimpleNamespace(idx=i))
    best = None
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(300):
            plane.sweep(t0)
        dt = (time.perf_counter() - t0) / 300
        best = dt if best is None else min(best, dt)
    return best * 1e3


def legacy_tick(srv) -> None:
    """The retired ``HeartbeatScheduler._run`` body: every division's
    ``hibernate_sweep``, then a heartbeat item per appender of each awake
    leader (``run_upkeep_bench``'s ``legacy_tick``)."""
    now = time.monotonic()
    for div in list(srv.divisions.values()):
        if not div.is_leader() or div.leader_ctx is None:
            continue
        hib = div.hibernate_sweep(now)
        if hib == "asleep":
            continue
        for appender in list(div.leader_ctx.appenders.values()):
            appender.heartbeat_item(now, hibernate=(hib == "request"))


def array_tick(srv) -> None:
    """The plane's sweep: one vectorized due-scan per loop shard."""
    now = time.monotonic()
    for pl in srv.upkeep:
        pl.sweep(now)


def tick_pair(cluster) -> dict:
    """The upkeep tick pair on the cluster's live divisions, server by
    server, the plane's sweep then the legacy walk, each the best of 3 on
    the thread-CPU clock and then on the wall clock (worst server of
    each), with the hibernated groups, the plane's registered slots and
    its due groups of the last sweep."""
    from ratis_tpu_torch.tools.bench import _blocking_best_of_3
    out = {}
    for suffix, clock in (("ms", time.thread_time),
                          ("wall_ms", time.perf_counter)):
        array_worst = legacy_worst = 0.0
        for srv in cluster.servers:
            array_worst = max(array_worst, _blocking_best_of_3(
                lambda: array_tick(srv), clock))
            legacy_worst = max(legacy_worst, _blocking_best_of_3(
                lambda: legacy_tick(srv), clock))
        out[f"tick_array_{suffix}"] = array_worst * 1e3
        out[f"tick_legacy_{suffix}"] = legacy_worst * 1e3
    out["tick_ratio"] = out["tick_legacy_ms"] / max(1e-6,
                                                    out["tick_array_ms"])
    out["tick_ratio_wall"] = out["tick_legacy_wall_ms"] / max(
        1e-6, out["tick_array_wall_ms"])
    out["hibernated_groups"] = cluster.hibernated_groups()
    out["registered_slots"] = sum(pl.registered for s in cluster.servers
                                  for pl in s.upkeep)
    out["due_groups"] = sum(pl.last_due for s in cluster.servers
                            for pl in s.upkeep)
    return out


def hibernate_settle(settle_s: float, until_asleep: bool = False):
    """A settle for ``bench.e2e_rung``: wait ``settle_s`` after the
    bring-up when hibernation is on (nothing otherwise, as the JAX bench
    does); with ``until_asleep``, no longer than until every group's
    leader sleeps.  Its result: the seconds waited and the hibernated
    groups then."""
    async def settle(cluster) -> dict:
        t0 = time.monotonic()
        if RaftServerConfigKeys.Hibernate.enabled(cluster.properties):
            while time.monotonic() - t0 < settle_s:
                if until_asleep \
                        and cluster.hibernated_groups() == cluster.num_groups:
                    break
                await asyncio.sleep(0.25)
        return {"settle_s": time.monotonic() - t0,
                "hibernated_groups": cluster.hibernated_groups()}
    return settle


def upkeep_cluster(device="cuda", groups: int = UPKEEP_GROUPS):
    """``run_upkeep_bench``'s cluster: 3 servers x ``groups`` groups over
    the simulated transport, hibernation and the upkeep plane on,
    prewarmed, not yet started."""
    from ratis_tpu_torch.tools.bench import _device
    from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties
    dev = str(_device(device))
    props = cluster_properties(groups, 3, dev, "sim", hibernate=True)
    for k, v in UPKEEP.items():
        props.set(k, v)
    cluster = Cluster(groups, device=dev, properties=props)
    cluster.prewarm()
    return cluster


async def upkeep_rung(cluster, settle_s: float = UPKEEP_SETTLE_S,
                      teardown: bool = True) -> dict:
    """``child_upkeep`` on an ``upkeep_cluster``: the raw scans, then the
    bring-up, ``settle_s`` for the idle fleet to fall asleep and the tick
    pair.  ``teardown=False`` leaves the cluster up (a process that exits
    right after reporting need not unwind its divisions)."""
    from ratis_tpu_torch.tools.cluster import bring_up_wave, sealed
    sweeps = {"sweep_ms_64": scan_ms(64), "sweep_ms_1024": scan_ms(1024)}
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        await asyncio.sleep(settle_s)
        pair = tick_pair(cluster)
        engine = cluster.servers[0].engine
        if engine.device.type != torch.device(cluster.device).type:
            raise AssertionError(f"engine on {engine.device}")
        return {"groups": cluster.num_groups,
                "peers": len(cluster.servers), **pair, **sweeps,
                "settle_s": settle_s,
                "election_convergence_s": cluster.bring_up_s,
                "prewarm_s": cluster.prewarm_s,
                "engine_device": str(engine.device)}
    finally:
        if teardown:
            await cluster.close()
