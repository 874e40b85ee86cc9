"""The port's bench entry point: the JAX bench's kernel rungs and its
headline end-to-end rung, run on the port.

    python -m ratis_tpu_torch.tools.bench                 # on the CUDA card
    python -m ratis_tpu_torch.tools.bench --device cpu    # plain versions
    python -m ratis_tpu_torch.tools.bench --rungs mesh_100k,sim_10240
    python -m ratis_tpu_torch.tools.bench --rungs mesh

Prints exactly one JSON line on stdout, with the key names of ``bench.py``'s
rungs (the first three by default, the mesh rungs when ``--rungs`` names
them; at most one rung that brings up a cluster per run):

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
  and ``election_timeouts`` (fired in bring-up, warm-up, measured writes);
  ``dispatch``: each engine's batched dispatches in the measured writes
  (count, p50/p99/max ms on the host clock, share of the writes' wall,
  ack batch p50/p99/max), and ``pack_ms``: the host time of the flat and
  the slice-routed fast-tick pack at the largest p99 ack batch.
  Leaders come from elections (the JAX bench appoints them), so the
  bring-up includes 1024 elections through the batched vote tally;
- ``mesh_100k`` (``child_mesh100k``): a mesh engine's fast tick (K5) over
  8 slices of 102400 groups x 8 peers with 8192 acks routed to their
  slices, state updated in place as the engine does, against the flat
  fast tick (K1) on the same state and acks, each the best of 3 x 10
  calls closed by a device sync: ``updates_per_s``,
  ``per_slice_updates_per_s``, ``tick_ms``, ``control_tick_ms`` and
  ``efficiency_frac`` (control tick / mesh tick);
- ``mesh`` (``bench.py``'s mesh e2e rung): 3 servers x 10240 groups over
  the simulated transport with ``mesh-devices=8``, no warm-up, 2 writes
  per group at concurrency 128, the e2e rung's metrics; ``sim_10240`` is
  the same rung without a mesh, its control (the JAX ladder pairs them).

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: the stateless tick through
``sharded_engine_step``, then a mesh engine of ``n`` slices driven through
its intake and tick surface until commits advance.

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

from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.ops import quorum
from ratis_tpu_torch.ops import reference as ref

RUNGS = ("kernel", "kernel_100k", "e2e", "mesh_100k", "mesh", "sim_10240")
# what a run without --rungs measures: the headline and the kernel rungs
# (the mesh pair's bring-up of 2 x 10240 groups takes minutes)
DEFAULT_RUNGS = RUNGS[:3]
# the headline rung's load: one warm-up write per group, then the measured
# writes with this many in flight (bench.py's child_e2e at the headline)
WARMUP_WRITES = 1
CONCURRENCY = 128
# the slices of the mesh rungs (bench.py's "mesh": 8, child_mesh100k's S)
MESH_SLICES = 8
# the mesh rungs' load: writes per group, no warm-up (bench.py's mesh rung)
MESH_WRITES = 2
# rungs that bring up a cluster: one per process, as bench.py runs one
# child per rung (a second cluster in one process inherits the first's
# sealed heap and was measured churning elections)
E2E_RUNGS = ("e2e", "sim_10240", "mesh")


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


def mesh100k_batch(groups: int = 102_400, peers: int = 8,
                   events: int = 8192, slices: int = MESH_SLICES,
                   seed: int = 0):
    """``child_mesh100k``'s inputs: the ten DeviceState arrays (every
    group a leader of 5 voters), the acks routed to their slices
    (``[7, S, E / S]``, slice-local rows), the same acks flat (``[7, E]``,
    global rows) and ``meta``."""
    g, p, e, n = groups, peers, events, slices
    rng = np.random.default_rng(seed)
    conf = np.zeros((g, p), bool)
    conf[:, :5] = True
    self_mask = np.zeros((g, p), bool)
    self_mask[:, 0] = True
    state = [rng.integers(0, 512, (g, p)).astype(np.int32),
             rng.integers(0, 1000, (g, p)).astype(np.int32),
             self_mask, conf, np.zeros((g, p), bool),
             np.full(g, 3, np.int8),
             rng.integers(256, 512, g).astype(np.int32),
             np.zeros(g, np.int32), np.zeros(g, np.int32),
             np.full(g, 2 ** 31 - 1, np.int32)]
    evs = np.full((7, n, e // n), quorum.PACK_SENTINEL, np.int32)
    evs[0] = rng.integers(0, g // n, (n, e // n))
    evs[1] = rng.integers(0, 5, (n, e // n))
    evs[2] = rng.integers(0, 512, (n, e // n))
    evs[3] = 900
    evs[4] = 1
    evf = np.full((7, e), quorum.PACK_SENTINEL, np.int32)
    rows = evs.reshape(7, e)
    evf[:5] = rows[:5]
    evf[0] = (rows[0].reshape(n, e // n)
              + (np.arange(n) * (g // n))[:, None]).reshape(e)
    return state, evs, evf, np.array([1000, 10_000], np.int32)


def mesh_100k_rung(device="cuda", groups: int = 102_400, peers: int = 8,
                   events: int = 8192, slices: int = MESH_SLICES,
                   iters: int = 10, trials: int = 3) -> dict:
    """``child_mesh100k``: K5 over ``slices`` slices against the flat K1
    at the same load, each on its own copy of the state (updated in place
    call after call, as the engine's donated state is)."""
    from ratis_tpu_torch.parallel import (make_group_mesh,
                                          shard_device_state,
                                          sharded_resident_fast_step_sliced)
    dev = _device(device)
    state, evs, evf, meta = mesh100k_batch(groups, peers, events, slices)
    ev_s, ev_f, mt = (torch.from_numpy(a).to(dev) for a in (evs, evf, meta))

    def best_tick(step, st, ev) -> float:
        step(st, ev, mt)
        _sync(dev)
        best = None
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                step(st, ev, mt)
            _sync(dev)
            dt = (time.perf_counter() - t0) / iters
            best = dt if best is None else min(best, dt)
        return best

    mesh = make_group_mesh(slices, device=dev)
    t_mesh = best_tick(
        sharded_resident_fast_step_sliced(mesh),
        shard_device_state(mesh, quorum.device_state_from_numpy(state, dev)),
        ev_s)
    t_ctrl = best_tick(quorum.engine_step_resident_fast,
                       quorum.device_state_from_numpy(state, dev), ev_f)
    return {"groups": groups, "devices": slices,
            "updates_per_s": groups / t_mesh,
            "per_slice_updates_per_s": groups / slices / t_mesh,
            "tick_ms": t_mesh * 1e3, "control_tick_ms": t_ctrl * 1e3,
            "efficiency_frac": t_ctrl / t_mesh,
            "platform": device_info(dev)["kind"],
            "shape": [groups, peers, events]}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """``__graft_entry__.dryrun_multichip`` on a mesh of ``n_devices``
    slices of one device: the stateless tick through
    ``sharded_engine_step``, then a mesh :class:`QuorumEngine` driven
    through ``on_flush`` / ``on_ack`` / ``tick`` — a quorum ack must
    advance every group's commit to 5 on the sliced state, a dirty-row
    refresh tick must run, and the resident state must hold ``n_devices``
    slices on the device."""
    from ratis_tpu_torch.engine.engine import QuorumEngine
    from ratis_tpu_torch.engine.state import ROLE_LEADER
    from ratis_tpu_torch.parallel import (make_group_mesh, shard_batch,
                                          sharded_engine_step)
    dev = _device(device)
    mesh = make_group_mesh(n_devices, device=dev)
    g = max(8, n_devices) * 2  # tiny, divisible by n_devices
    out = sharded_engine_step(mesh)(*shard_batch(
        mesh, _example_batch(num_groups=g, num_peers=8, num_events=16)))
    _sync(dev)
    assert out.new_commit.shape == (g,)

    async def drive():
        eng = QuorumEngine(max_groups=g, max_peers=8,
                           scalar_fallback_threshold=0, use_device=True,
                           mesh=mesh, device=dev)
        commits: dict[int, int] = {}

        class Listener:
            def __init__(self):
                self.slot = -1

            def on_commit_advance_now(self, c):
                commits[self.slot] = c

            async def on_commit_advance(self, c):
                commits[self.slot] = c

            async def on_election_timeout(self):
                pass

            async def on_leadership_stale(self):
                pass

        s = eng.state
        slots = []
        for _ in range(g):
            lst = Listener()
            lst.slot = eng.attach(lst)
            slots.append(lst.slot)
            cur = np.zeros(8, bool)
            cur[:3] = True
            s.set_conf(lst.slot, 0, cur, np.zeros(8, bool),
                       np.zeros(8, np.int32), 0)
            s.role[lst.slot] = ROLE_LEADER
            s.last_ack_ms[lst.slot, :3] = eng.clock.now_ms()
            s.mark_dirty(lst.slot)
        # first tick: full upload of the sliced DeviceState
        await eng.tick()
        # steady state: flush + quorum acks through the sliced fast tick
        for slot in slots:
            eng.on_flush(slot, 5)
            eng.on_ack(slot, 1, 5)
        await eng.tick()
        assert all(commits.get(slot) == 5 for slot in slots), commits
        # dirty rows between ticks: the refresh tick runs too
        for slot in slots[:4]:
            s.last_ack_ms[slot, 2] = eng.clock.now_ms()
            s.mark_dirty(slot)
        await eng.tick()
        assert eng.metrics["refresh_ticks"] > 0, eng.metrics
        assert eng._dev is not None
        on = eng._dev.match_index
        assert eng.state.n_slices == n_devices and on.shape[0] == g, \
            (eng.state.n_slices, tuple(on.shape))
        assert on.device.type == dev.type, on.device
        res = {"n_devices": n_devices, "groups": g,
               "n_slices": eng.state.n_slices, "device": str(on.device),
               "commits": sorted(set(commits.values())),
               "fast_ticks": eng.metrics["fast_ticks"],
               "refresh_ticks": eng.metrics["refresh_ticks"]}
        await eng.close()
        return res

    return asyncio.run(drive())


def e2e_cluster(device="cuda", groups: int = 1024, transport: str = "tcp",
                mesh_devices: int = 0):
    """An e2e rung's cluster: 3 servers x ``groups`` groups over
    ``transport``, engines in ``mesh_devices`` slices when > 0, its kernels
    built and launched once (``Cluster.prewarm``), not yet started."""
    from ratis_tpu_torch.tools.cluster import Cluster
    cluster = Cluster(groups, device=str(_device(device)),
                      transport=transport, mesh_devices=mesh_devices)
    cluster.prewarm()
    return cluster


def _fresh_dispatch_timers(engines) -> list:
    """Give each engine fresh ``dispatchLatency`` / ``ackBatchSize``
    reservoirs, so that they hold the measured writes alone; returns the
    registry's own, for ``_dispatch_summary`` to put back."""
    from ratis_tpu_torch.metrics.registry import Histogram, Timekeeper
    saved = [(e._m.dispatch_timer, e._m.ack_batch) for e in engines]
    for e in engines:
        e._m.dispatch_timer, e._m.ack_batch = Timekeeper(), Histogram()
    return saved


def _dispatch_summary(engines, saved, elapsed_s: float) -> list[dict]:
    """Each engine's batched dispatches over the measured writes (pack,
    upload, kernel, download and the changed-row scan, host clock) and
    the ack batches they carried; puts the registry's timers back."""
    out = []
    for e, (timer, batch) in zip(engines, saved):
        t, b = e._m.dispatch_timer, e._m.ack_batch
        out.append({"dispatches": t.count,
                    "p50_ms": t.percentile_s(0.50) * 1e3,
                    "p99_ms": t.percentile_s(0.99) * 1e3,
                    "max_ms": t._max_s * 1e3,
                    "share": t._total_s / elapsed_s,
                    "ack_batch_p50": int(b.percentile_s(0.50)),
                    "ack_batch_p99": int(b.percentile_s(0.99)),
                    "ack_batch_max": int(b._max_s)})
        e._m.dispatch_timer, e._m.ack_batch = timer, batch
    return out


def pack_ms(engine, acks: int, reps: int = 200) -> dict:
    """Host ms of one flat (``_pack_tick``) and one slice-routed
    (``_pack_tick_sliced``; one slice on an engine without a mesh) fast-
    tick pack of ``acks`` acks over the engine's live slots (seed 0) and a
    slot update for each slot of the first half: the median of ``reps``
    calls."""
    rng = np.random.default_rng(0)
    live = np.array(sorted(engine.state.active), np.int64)
    slots = live[rng.integers(0, len(live), max(1, acks))]
    batch = [(int(x), 1, 5, 0) for x in slots]
    updates = {int(x): [5, 100] for x in slots[:len(slots) // 2]}
    saved = engine._last_event_rows, engine._last_event_cap
    out = {"acks": len(batch), "updates": len(updates)}
    for name, pack in (("flat", engine._pack_tick),
                       ("sliced", engine._pack_tick_sliced)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pack(batch, updates)
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times)) * 1e3
    engine._last_event_rows, engine._last_event_cap = saved
    return out


async def e2e_rung(cluster, writes: int = 8,
                   warmup: int = WARMUP_WRITES) -> dict:
    """``run_bench`` on an ``e2e_cluster``: bring it up (elections in
    waves of a tenth of the groups, at least 128), warm up with ``warmup``
    writes per group, measure ``writes`` writes per group, read every
    counter back from every replica, close it."""
    dev = torch.device(cluster.device)
    groups = cluster.num_groups
    # bring-up allocates long-lived objects only: the collector stays off
    # until the servers' one deliberate seal (the JAX bench's scaffold)
    gc.disable()
    try:
        # election timeouts grow with the channel count (8-16 s at 10240
        # groups), so a bring-up takes about ten waves at any size
        await cluster.start(wave=max(128, groups // 10), timeout=600)
        cluster.servers[0].seal_heap()
        gc.enable()
        timeouts = [cluster.election_timeouts()]
        acked = 0
        if warmup:
            acked = (await cluster.write_all(warmup, CONCURRENCY))["commits"]
        timeouts.append(cluster.election_timeouts())
        engines = [s.engine for s in cluster.servers]
        saved = _fresh_dispatch_timers(engines)
        stats = await cluster.write_all(writes, CONCURRENCY)
        timeouts.append(cluster.election_timeouts())
        dispatch = _dispatch_summary(engines, saved, stats["elapsed_s"])
        acked += stats["commits"]
        counters = await cluster.read_counters(timeout=300)
        want = [warmup + writes] * len(cluster.servers)
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
        mesh_n = RaftServerConfigKeys.Engine.mesh_devices(cluster.properties)
        for e in engines:
            on = e._dev.match_index.device if e._dev is not None else None
            if e.device.type != dev.type or (on and on.type != dev.type) \
                    or e.metrics["batched_dispatches"] == 0 \
                    or e.state.n_slices != max(1, mesh_n):
                raise AssertionError(f"engine on {e.device}, state on {on}, "
                                     f"{e.metrics['batched_dispatches']} "
                                     f"batched dispatches, "
                                     f"{e.state.n_slices} slices")
        return {"groups": groups, "servers": len(cluster.servers),
                "transport": cluster.transport, "writes": writes,
                "warmup": warmup, "concurrency": CONCURRENCY,
                "mesh_devices": mesh_n,
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
                # each engine's dispatches in the measured writes, and the
                # two packs' host time at the largest p99 ack batch
                "dispatch": dispatch,
                "pack_ms": pack_ms(engines[0], max(
                    d["ack_batch_p99"] for d in dispatch)),
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
    ap.add_argument("--rungs", default=",".join(DEFAULT_RUNGS),
                    help=f"comma-separated subset of {','.join(RUNGS)} "
                         f"(default {','.join(DEFAULT_RUNGS)})")
    ap.add_argument("--kernel", type=_shape, default=(10_240, 8, 4096),
                    metavar="G,P,E", help="kernel rung shape")
    ap.add_argument("--kernel-100k", type=_shape, default=(102_400, 8, 8192),
                    metavar="G,P,E", help="kernel_100k rung shape")
    ap.add_argument("--iters", type=int, default=100,
                    help="calls per timed kernel-rung trial")
    ap.add_argument("--scalar-groups", type=int, default=2048)
    ap.add_argument("--mesh-100k", type=_shape, default=(102_400, 8, 8192),
                    metavar="G,P,E", help="mesh_100k rung shape")
    ap.add_argument("--groups", type=int, default=1024)
    ap.add_argument("--writes", type=int, default=8)
    ap.add_argument("--mesh-groups", type=int, default=10_240,
                    help="groups of the mesh and sim_10240 rungs")
    args = ap.parse_args(argv)
    rungs = [r for r in args.rungs.split(",") if r]
    unknown = sorted(set(rungs) - set(RUNGS))
    if unknown:
        ap.error(f"unknown rungs {unknown}")
    if len(set(rungs) & set(E2E_RUNGS)) > 1:
        ap.error(f"one of {', '.join(E2E_RUNGS)} per run: run each in its "
                 f"own process")
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
    if "mesh_100k" in rungs:
        g, p, e = args.mesh_100k
        out["mesh_100k"] = mesh_100k_rung(args.device, g, p, e)
    # the mesh rung and its control (the JAX ladder runs them back to back,
    # each in its own child)
    for rung, mesh_n in (("sim_10240", 0), ("mesh", MESH_SLICES)):
        if rung in rungs:
            out[rung] = asyncio.run(e2e_rung(
                e2e_cluster(args.device, args.mesh_groups, "sim", mesh_n),
                MESH_WRITES, warmup=0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
