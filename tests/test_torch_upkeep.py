"""The upkeep plane and idle-group hibernation, the port against the JAX
package.

The port's server names ``server/upkeep.py`` behind
``raft.tpu.upkeep.enabled``; it is a verbatim copy now.  Here:

- the JAX package's plane checks (the due scan against its scalar
  reference, the next wake, the slot generation guard, growth past the
  initial capacity, the watch-dirty mark and idle-skip accounting, the
  row minimum under random operations) run on both packages'
  ``UpkeepPlane`` through one seeded script of operations: after every
  operation the due sets, the due channels, the next wake, the
  generations and the counters are equal;
- 3 servers x 32 groups over the simulated transport per package (the
  port's harness and the JAX package's through ``tests/jax_mirror.py``),
  hibernation and the upkeep plane on: every idle leader sleeps, writes
  to the first 8 groups wake those and no other, the counters read back
  are equal, and so are the plane's registered slots;
- ``cluster_properties(hibernate=True)`` is the JAX bench's
  ``bench_properties(batched=True, hibernate=True)`` key for key at 32,
  4096 and 10240 groups;
- the bench's ``upkeep``, ``sparse_hib`` and ``sparse_plain`` rungs run
  tiny through ``--device cpu``;
- K1 and K2 on the sleeping-rows family of ``tools/cases.py`` (most rows
  asleep, deadlines 60000-62000 ms ahead or INT32_MAX, leaders whose acks
  stopped, few acks), through the engine's prepared calls on the CPU,
  against the JAX package's ``engine_step_resident_fast`` and
  ``engine_step_resident``, also at a clock where ``now + 62000`` passes
  INT32_MAX and the deadlines clamp.
"""

import asyncio
import importlib
import json
import pathlib
import random
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ratis_tpu.ops import quorum as jq
from ratis_tpu.tools.bench_cluster import bench_properties
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.tools import cases, upkeep_bench
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("ratis_tpu_torch", "ratis_tpu")
GROUPS = 32
ACTIVE = 8
WRITES = 3
SETTLE_S = 20.0


def _modules(pkg: str):
    return (importlib.import_module(f"{pkg}.ops.upkeep"),
            importlib.import_module(f"{pkg}.server.upkeep"))


def _plane_state(ops, plane, now: float) -> tuple:
    """What a caller of the plane can observe at ``now``: the due slots
    and their channels, the next wake, the generations, the row minimum
    and the counters (a sweep is part of it: it counts)."""
    slots, mask = plane.sweep(now)
    return (slots.tolist(), mask.tolist(), float(ops.next_wake(
        plane.deadlines)), plane.gen.tolist(), plane.row_min.tolist(),
        plane.registered, plane.sweeps, plane.idle_skips, plane.last_due)


def _script(seed: int, steps: int) -> list:
    """A seeded list of plane operations (the JAX package's checks):
    register, unregister (also with a stale handle), set, clear, the
    watch-dirty mark, reads of the armed state, and sweeps at random
    times; enough registrations to grow the plane past its first
    capacity."""
    rng = random.Random(seed)
    ops_ = []
    live = 0
    for _ in range(steps):
        r = rng.random()
        if r < 0.3 or live == 0:
            ops_.append(("register",))
            live += 1
        elif r < 0.38:
            ops_.append(("unregister", rng.randrange(live), rng.random()
                         < 0.2))
            live -= 1
        elif r < 0.65:
            ops_.append(("set", rng.randrange(live), rng.randrange(5),
                         rng.uniform(-5.0, 5.0)))
        elif r < 0.78:
            ops_.append(("clear", rng.randrange(live), rng.randrange(5)))
        elif r < 0.86:
            ops_.append(("dirty", rng.randrange(live)))
        elif r < 0.93:
            ops_.append(("armed", rng.randrange(live), rng.randrange(5)))
        else:
            ops_.append(("sweep", rng.uniform(-5.0, 5.0)))
    return ops_


def _run_script(pkg: str, script: list) -> list:
    """The script on one package's plane; the observed state after every
    operation."""
    ops, up = _modules(pkg)
    plane = up.UpkeepPlane(server=None, shard=0)
    handles, stale, seen = [], [], []
    for op in script:
        kind = op[0]
        if kind == "register":
            handles.append(plane.register(types.SimpleNamespace()))
            got = handles[-1]
        elif kind == "unregister":
            slot, gen = handles.pop(op[1])
            plane.unregister(slot, gen)
            stale.append((slot, gen))
            if op[2]:
                # a stale handle: a no-op, even on the slot's next tenant
                plane.unregister(slot, gen)
                plane.set_deadline(slot, gen, 0, 0.0)
                plane.mark_watch_dirty(slot, gen)
            got = plane.division_at(slot) is None
        elif kind == "set":
            slot, gen = handles[op[1]]
            plane.set_deadline(slot, gen, op[2], op[3])
            got = None
        elif kind == "clear":
            slot, gen = handles[op[1]]
            plane.clear(slot, gen, op[2])
            got = None
        elif kind == "dirty":
            slot, gen = handles[op[1]]
            plane.mark_watch_dirty(slot, gen)
            got = None
        elif kind == "armed":
            slot, gen = handles[op[1]]
            got = plane.is_armed(slot, gen, op[2])
        else:
            slots, mask = plane.sweep(op[1])
            assert slots.tolist() == ops.reference_due(plane.deadlines,
                                                       op[1])
            got = (slots.tolist(), mask.tolist())
        assert np.array_equal(plane.row_min, plane.deadlines.min(axis=1))
        seen.append((got, _plane_state(ops, plane, 0.0)))
    for slot, gen in stale:
        assert not plane.is_armed(slot, gen, 0)
    return seen


@pytest.mark.parametrize("seed,steps", [(1507, 400), (77, 1200)])
def test_plane_script_matches_jax(seed, steps):
    script = _script(seed, steps)
    assert sum(op[0] == "register" for op in script) > 64  # grows
    port, jax = (_run_script(pkg, script) for pkg in PACKAGES)
    assert len(port) == len(jax) == steps
    for i, (a, b) in enumerate(zip(port, jax)):
        assert a == b, (i, script[i])


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_due_scan_and_next_wake_match_jax(seed):
    """The ops layer on random deadline fields: the due slots, their
    channels and the next wake are the scalar reference's, in both
    packages."""
    rng = random.Random(seed)
    (pops, _), (jops, _) = (_modules(pkg) for pkg in PACKAGES)
    for _ in range(40):
        cap = rng.choice((1, 7, 64, 257))
        d = pops.new_deadlines(cap)
        for s in range(cap):
            for ch in range(pops.N_CHANNELS):
                if rng.random() >= 0.4:
                    d[s, ch] = rng.uniform(-10.0, 10.0)
        now = rng.uniform(-5.0, 5.0)
        slots = pops.due_scan(d, now)
        assert slots.tolist() == jops.due_scan(d, now).tolist() \
            == pops.reference_due(d, now)
        assert np.array_equal(pops.due_channels(d, slots, now),
                              jops.due_channels(d, slots, now))
        assert pops.next_wake(d) == jops.next_wake(d)


def _sparse_props():
    p = cluster_properties(GROUPS, 3, "cpu", "sim", hibernate=True)
    for k, v in upkeep_bench.UPKEEP.items():
        p.set(k, v)
    return p


async def _sparse_script(cluster) -> dict:
    """Bring up, let every idle leader sleep, write to the first
    ``ACTIVE`` groups, read every counter back."""
    try:
        await cluster.start(timeout=60)
        deadline = time.monotonic() + SETTLE_S
        while cluster.hibernated_groups() < GROUPS:
            assert time.monotonic() < deadline, cluster.hibernated_groups()
            await asyncio.sleep(0.1)
        asleep = cluster.hibernated_groups()
        await cluster.write_all(WRITES, active_groups=ACTIVE)
        awake = [i for i, g in enumerate(cluster.groups)
                 if not any(s.divisions[g.group_id]._hibernating
                            for s in cluster.servers)]
        counters = await cluster.read_counters(timeout=60)
        return {"asleep": asleep, "awake": awake,
                "counters": [counters[g.group_id] for g in cluster.groups],
                "registered": sum(pl.registered for s in cluster.servers
                                  for pl in s.upkeep),
                "planes": [len(s.upkeep) for s in cluster.servers]}
    finally:
        await cluster.close()


def test_sparse_cluster_hibernates_as_jax():
    port = Cluster(GROUPS, device="cpu", properties=_sparse_props())
    jax = jax_cluster_module().Cluster(
        GROUPS, device="cpu", properties=jax_properties(_sparse_props()))
    prewarm_small(jax)
    runs = {"port": asyncio.run(_sparse_script(port)),
            "jax": asyncio.run(_sparse_script(jax))}
    for name, run in runs.items():
        assert run["asleep"] == GROUPS, name
        # the writes woke their groups and no other
        assert run["awake"] == list(range(ACTIVE)), (name, run["awake"])
        assert run["counters"] == [[WRITES] * 3] * ACTIVE \
            + [[0] * 3] * (GROUPS - ACTIVE), name
        assert run["registered"] == 3 * GROUPS and run["planes"] == [1] * 3
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("groups", [32, 4096, 10_240])
def test_hibernate_properties_are_the_jax_bench_properties(groups):
    port = dict(cluster_properties(groups, 3, "cuda", "sim",
                                   hibernate=True).items())
    jax = dict(bench_properties(True, groups, hibernate=True).items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    assert jax[RaftServerConfigKeys.Hibernate.ENABLED_KEY] == "true"


def _bench(*args, timeout=300):
    proc = subprocess.run([sys.executable, "-m",
                           "ratis_tpu_torch.tools.bench", "--device", "cpu",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_upkeep_rung_runs_tiny():
    out = _bench("--rungs", "upkeep", "--groups", "16", "--settle", "6")
    u = out["upkeep"]
    assert u["groups"] == 16 and u["peers"] == 3
    assert u["registered_slots"] == 48 and u["hibernated_groups"] > 0
    for key in ("tick_array_ms", "tick_legacy_ms", "tick_ratio",
                "tick_array_wall_ms", "tick_legacy_wall_ms",
                "tick_ratio_wall", "due_groups", "sweep_ms_64",
                "sweep_ms_1024"):
        assert key in u, key
    assert u["tick_array_wall_ms"] > 0 and u["tick_legacy_wall_ms"] > 0
    assert u["engine_device"] == "cpu"


@pytest.mark.parametrize("rung,hibernate", [("sparse_hib", True),
                                            ("sparse_plain", False)])
def test_sparse_rungs_run_tiny(rung, hibernate):
    out = _bench("--rungs", rung, "--groups", "24", "--active", "6",
                 "--settle", "6")
    r = out[rung]
    assert r["groups"] == 24 and r["active_groups"] == 6
    assert r["warmup"] == 0 and r["commits"] == 6 * 8
    assert r["replicas_read_back"] == 24 * 3
    if hibernate:
        assert r["settle"]["hibernated_groups"] > 0
        assert "hibernated_groups" in r
    else:
        assert r["settle"]["hibernated_groups"] == 0
        assert "hibernated_groups" not in r


NOW = 100_000
TIMEOUT = 300
# a clock late in the epoch: now + 62000 passes INT32_MAX, the armed
# deadlines clamp to it
LATE = 2 ** 31 - 61_000


@pytest.mark.parametrize("now", [NOW, LATE])
@pytest.mark.parametrize("g", [1000, 4096])
def test_sleeping_rows_k1_k2_match_jax(g, now):
    rng = np.random.default_rng(g + now % 997)
    p = 8
    st = cases.sleeping_state(rng, g, p, now)
    role, deadline = st[5], st[9]
    assert (deadline == 2 ** 31 - 1).mean() > 0.3
    assert ((deadline > now + 59_000) & (role == 1)).any() or now == LATE
    meta = jnp.asarray(np.array([now, TIMEOUT], np.int32))
    for e in (64, 1024):
        ev = cases.sleeping_events(rng, g, p, e, now)
        jr = jax.jit(jq.engine_step_resident_fast)(
            jq.DeviceState(*map(jnp.asarray, st)), jnp.asarray(ev), meta)
        state = tq.device_state_from_numpy(st, "cpu")
        out = cases.fast_plan(state, ev).run(e, now, TIMEOUT)
        np.testing.assert_array_equal(out, np.asarray(jr.out))
        for name, j, t in zip(tq.DeviceState._fields, jr.state, state):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
        # the sleeping leaders' acks stopped: the check calls them stale
        assert out[3].sum() > 0
    for d, e in ((64, 64), (1024, 1024)):
        rf_idx, rf, acks = cases.sleeping_refresh(rng, g, p, d, e, now)
        jr = jax.jit(jq.engine_step_resident)(
            jq.DeviceState(*map(jnp.asarray, st)), jnp.asarray(rf_idx),
            *map(jnp.asarray, rf), *map(jnp.asarray, acks), jnp.int32(now),
            jnp.int32(TIMEOUT))
        state = tq.device_state_from_numpy(st, "cpu")
        out = cases.refresh_plan(state, rf_idx, rf, acks).run(d, e, now,
                                                              TIMEOUT)
        np.testing.assert_array_equal(out[0], np.asarray(jr.new_commit))
        for i, f in enumerate(("commit_changed", "timeouts", "stale"), 1):
            np.testing.assert_array_equal(out[i] != 0,
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f)
        for name, j, t in zip(tq.DeviceState._fields, jr.state, state):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
