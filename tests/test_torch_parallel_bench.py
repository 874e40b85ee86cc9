"""``ratis_tpu_torch.parallel`` against ``ratis_tpu.parallel``, and the
bench's mesh rungs.

The port's mesh is S slices of the group batch on one device; its
``sharded_*`` functions return the port's kernel wrappers checked against
the mesh.  On the same numpy inputs they must give what the JAX package's
sharded programs give on the conftest's 8-virtual-device CPU fleet (exact:
int32 / bool).  The bench's ``mesh_100k``, ``mesh`` and ``sim_10240``
rungs run at tiny sizes with ``--device cpu`` and print ``bench.py``'s
keys in the one JSON line.
"""

import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratis_tpu import parallel as jp
from ratis_tpu.ops import quorum as jq
from ratis_tpu_torch import parallel as tp
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.tools import bench, cases

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = 8
NOW = 100_000


@pytest.mark.parametrize("groups", [1, 7, 8, 1000, 1024])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_pad_to_mesh_matches_jax(groups, n):
    assert tp.pad_to_mesh(groups, n) == jp.mesh.pad_to_mesh(groups, n)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_engine_step_matches_jax(n):
    args = bench._example_batch(32, P, 24, seed=n)
    want = jp.sharded_engine_step(jp.make_group_mesh(n))(
        *jp.shard_batch(jp.make_group_mesh(n), args))
    mesh = tp.make_group_mesh(n, device="cpu")
    got = tp.sharded_engine_step(mesh)(*tp.shard_batch(mesh, args))
    for name, a, b in zip(tq.EngineStep._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_shard_batch_checks_divisibility():
    args = bench._example_batch(12, P, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tp.shard_batch(tp.make_group_mesh(8, device="cpu"), args)
    with pytest.raises(ValueError, match="not divisible"):
        jp.shard_batch(jp.make_group_mesh(8), args)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_resident_steps_match_jax(n):
    """The fast tick (flat K1 and sliced K5) and the refresh tick (K2) as
    the mesh functions return them, against JAX's sharded programs."""
    rng = np.random.default_rng(n)
    g = 64
    st = cases.resident_state(rng, g, P, NOW)
    meta = np.array([NOW, 300], np.int32)
    jmesh, mesh = jp.make_group_mesh(n), tp.make_group_mesh(n, device="cpu")
    from ratis_tpu.parallel.mesh import (sharded_resident_fast_step_sliced,
                                         sharded_resident_step)

    def jstate():
        return jp.shard_device_state(
            jmesh, jq.DeviceState(*(jnp.asarray(a) for a in st)))

    def tstate():
        return tp.shard_device_state(
            mesh, tq.device_state_from_numpy(st, "cpu"))

    def same(got_state, got_out, want_state, want_out):
        np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
        for name, a, b in zip(tq.DeviceState._fields, got_state, want_state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)

    ev = cases.fast_events(rng, g, P, 32, NOW)
    want = jp.sharded_resident_fast_step(jmesh)(jstate(), jnp.asarray(ev),
                                                jnp.asarray(meta))
    got = tp.sharded_resident_fast_step(mesh)(tstate(), torch.from_numpy(ev),
                                              torch.from_numpy(meta))
    same(got.state, got.out, want.state, want.out)

    evs = cases.sliced_events(rng, g, P, n, 16, NOW, negative=True)
    want = sharded_resident_fast_step_sliced(jmesh)(
        jstate(), jnp.asarray(evs), jnp.asarray(meta))
    got = tp.sharded_resident_fast_step_sliced(mesh)(
        tstate(), torch.from_numpy(evs), torch.from_numpy(meta))
    same(got.state, got.out, want.state, want.out)
    with pytest.raises(ValueError, match="slices"):
        tp.sharded_resident_fast_step_sliced(mesh)(
            tstate(), torch.from_numpy(evs[:, :1]), torch.from_numpy(meta))

    rf_idx, rf, acks = cases.refresh(rng, g, P, 16, 32, NOW)
    want = sharded_resident_step(jmesh)(
        jstate(), *(jnp.asarray(a) for a in (rf_idx, *rf, *acks)),
        jnp.int32(NOW), jnp.int32(300))
    got = tp.sharded_resident_step(mesh)(
        tstate(), *(torch.from_numpy(a) for a in (rf_idx, *rf, *acks)),
        NOW, 300)
    same(got.state, torch.stack(got[1:]), want.state,
         np.stack([np.asarray(a) for a in want[1:]]))


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_ledger_pass_matches_jax(n):
    arrays, (now, lag, up) = cases.ledger_inputs(np.random.default_rng(n),
                                                 64, P, 8)
    want = jp.mesh.sharded_ledger_pass(jp.make_group_mesh(n), 8)(
        *(jnp.asarray(a) for a in arrays), jnp.int32(now), jnp.int32(lag),
        jnp.int32(up))
    got = tp.sharded_ledger_pass(tp.make_group_mesh(n, device="cpu"), 8)(
        *(torch.from_numpy(a) for a in arrays), now, lag, up)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mesh100k_batch_routes_each_ack_to_its_slice():
    """The rung's two event forms carry the same acks: the sliced form's
    local rows plus each slice's offset are the flat form's rows, so K5 on
    one and K1 on the other leave the same state."""
    state, evs, evf, meta = bench.mesh100k_batch(256, P, 64, 8)
    assert evs.shape == (7, 8, 8) and evf.shape == (7, 64)
    a = tq.device_state_from_numpy(state, "cpu")
    b = tq.device_state_from_numpy(state, "cpu")
    k5 = tq.engine_step_resident_fast_sliced(a, torch.from_numpy(evs),
                                             torch.from_numpy(meta))
    k1 = tq.engine_step_resident_fast(b, torch.from_numpy(evf),
                                      torch.from_numpy(meta))
    assert torch.equal(k5.out, k1.out)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


TINY = ["--mesh-100k", "256,8,64", "--mesh-groups", "4"]


def _bench(rungs: str):
    proc = subprocess.run(
        [sys.executable, "-m", "ratis_tpu_torch.tools.bench", "--device",
         "cpu", "--rungs", rungs, *TINY],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert "e2e" not in out and out["value"] is None
    return out


def test_bench_mesh_100k_rung():
    m = _bench("mesh_100k")["mesh_100k"]
    assert m["groups"] == 256 and m["devices"] == 8
    for key in ("updates_per_s", "per_slice_updates_per_s", "tick_ms",
                "control_tick_ms", "efficiency_frac"):
        assert m[key] > 0, key
    assert m["per_slice_updates_per_s"] == pytest.approx(
        m["updates_per_s"] / 8)


@pytest.mark.parametrize("rung,mesh_n", [("sim_10240", 0), ("mesh", 8)])
def test_bench_mesh_e2e_rungs(rung, mesh_n):
    e = _bench(rung)[rung]
    assert e["transport"] == "sim" and e["servers"] == 3
    assert e["mesh_devices"] == mesh_n and e["warmup"] == 0
    assert e["commits"] == 4 * 2 and e["acked"] == 4 * 2
    assert e["replicas_read_back"] == 4 * 3
    assert e["commits_per_sec"] > 0 and e["p99_ms"] > 0
    assert len(e["election_timeouts"]) == 3
    assert e["election_timeouts"][0] >= 4
    assert e["election_timeouts"][1] == 0
    assert len(e["dispatch"]) == 3
    # commits advance inline at ack intake, so at 4 groups the writes may
    # end before any sweep is due: an engine may not dispatch in them
    for d in e["dispatch"]:
        assert d["dispatches"] >= 0
        assert 0 <= d["p50_ms"] <= d["p99_ms"] <= d["max_ms"]
        assert 0 <= d["share"] < 1
        assert 0 <= d["ack_batch_p50"] <= d["ack_batch_p99"] <= d[
            "ack_batch_max"]
    p = e["pack_ms"]
    assert p["acks"] >= 1 and p["flat"] > 0 and p["sliced"] > 0


def test_bench_runs_one_cluster_rung_per_process():
    proc = subprocess.run(
        [sys.executable, "-m", "ratis_tpu_torch.tools.bench", "--device",
         "cpu", "--rungs", "sim_10240,mesh", *TINY],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "own process" in proc.stderr
