"""Seven peers end to end, the port against the JAX package.

BASELINE config 5's second half is 7-peer groups.  The engine's state is
``[G, max_peers = 8]``, so a 7-peer group is 7 live lanes and one empty
one, and a commit or a vote needs 4 of 7.  Here:

- a 7 x 8 cluster over the simulated transport on the port's harness and
  on the JAX package (the harness renamed, ``tests/jax_mirror.py``): every
  write acknowledged and every counter read back from all 7 replicas, the
  engines' rows 7 members wide in both;
- the ``peer7`` rung's properties (2048 groups, every 32nd write traced)
  and the smoke's 1024-group cut are the JAX bench's ``bench_properties``
  key for key: 6 links a group puts both on the 4 s / 8 s tier;
- the plain K1, K2 and K3 at ``[64, 8]`` with every row's conf of 7
  members and the 8th lane empty, and with a joint 5 -> 7 configuration,
  equal to the JAX functions;
- the ``peer7`` rung tiny through ``tools/bench.py --device cpu``.
"""

import asyncio
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratis_tpu.ops import quorum as jq
from ratis_tpu.tools.bench_cluster import bench_properties
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.tools import bench, cases
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

SERVERS = 7
GROUPS = 8
WRITES = 2
P = 8
NOW = 100_000
TIMEOUT = 300


async def _seven(cluster) -> dict:
    try:
        await cluster.start(timeout=60)
        stats = await cluster.write_all(WRITES)
        counters = await cluster.read_counters()
        rows = sorted({int(s.engine.state.conf_cur[d.engine_slot].sum())
                       for s in cluster.servers
                       for d in s.divisions.values()})
        widths = {s.engine.state.max_peers for s in cluster.servers}
        return {"commits": stats["commits"],
                "counters": [counters[g.group_id] for g in cluster.groups],
                "rows": rows, "widths": widths,
                "hosted": [len(s.divisions) for s in cluster.servers]}
    finally:
        await cluster.close()


def test_seven_peer_cluster_matches_jax():
    props = cluster_properties(GROUPS, SERVERS, "cpu", "sim")
    port = Cluster(GROUPS, SERVERS, device="cpu", properties=props)
    jax_c = jax_cluster_module().Cluster(
        GROUPS, SERVERS, device="cpu", properties=jax_properties(props))
    prewarm_small(jax_c)
    runs = {"port": asyncio.run(_seven(port)),
            "jax": asyncio.run(_seven(jax_c))}
    for name, res in runs.items():
        assert res["commits"] == GROUPS * WRITES, name
        assert res["counters"] == [[WRITES] * SERVERS] * GROUPS, name
        assert res["hosted"] == [GROUPS] * SERVERS, name
        # every row 7 members wide in an [G, 8] engine
        assert res["rows"] == [SERVERS] and res["widths"] == {P}, name
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("groups", [1024, 2048])
def test_peer7_properties_are_the_jax_benchs(groups):
    port = dict(cluster_properties(groups, SERVERS, "cuda", "sim",
                                   trace=True, trace_sample=32).items())
    jax_p = dict(bench_properties(True, groups, num_servers=SERVERS,
                                  transport="sim", trace=True,
                                  trace_sample=32).items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax_p
    assert port["raft.server.rpc.timeout.min"] == "4s"
    assert port[RaftServerConfigKeys.Trace.SAMPLE_EVERY_KEY] == "32"


def test_peer7_rung_cluster_is_the_config_5_probe():
    c = bench.peer7_cluster("cpu", 16)
    assert len(c.servers) == SERVERS and c.num_groups == 16
    assert c.transport == "sim"
    assert c.properties.get(RaftServerConfigKeys.Trace.SAMPLE_EVERY_KEY) \
        == "32"
    assert bench.PEER7 == {"groups": 2048, "servers": 7, "writes": 4,
                           "warmup": 0, "transport": "sim",
                           "trace_sample": 32}


# -- K1, K2, K3 at 7 of 8 lanes ---------------------------------------------

def _seven_lanes(rng, g: int, joint: bool) -> list:
    """``resident_state`` with every conf of 7 members, the 8th lane empty;
    ``joint``: every row in a joint round from the first 5 to the 7."""
    st = cases.resident_state(rng, g, P, NOW, members=SERVERS)
    st[4][:] = False
    if joint:
        st[4][:, :5] = True
    assert not st[3][:, SERVERS:].any()
    return st


def _jstate(st):
    return jq.DeviceState(*(jnp.asarray(a) for a in st))


def _assert_state(jr_state, tr_state):
    for name, j, t in zip(tq.DeviceState._fields, jr_state, tr_state):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("joint", [False, True], ids=["seven", "joint5to7"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_at_seven_of_eight_lanes_matches_jax(seed, joint):
    rng = np.random.default_rng(700 + seed)
    g = 64
    st = _seven_lanes(rng, g, joint)
    ev = cases.fast_events(rng, g, P, 256, NOW)
    meta = np.array([NOW, TIMEOUT], np.int32)
    jr = jax.jit(jq.engine_step_resident_fast)(
        _jstate(st), jnp.asarray(ev), jnp.asarray(meta))
    tr = tq.engine_step_resident_fast(
        tq.device_state_from_numpy(st, "cpu"), torch.from_numpy(ev),
        torch.from_numpy(meta))
    np.testing.assert_array_equal(tr.out.numpy(), np.asarray(jr.out))
    _assert_state(jr.state, tr.state)
    # some rows' commits moved on a 4-of-7 majority
    assert (tr.out.numpy()[1] != 0).any()


@pytest.mark.parametrize("joint", [False, True], ids=["seven", "joint5to7"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k2_at_seven_of_eight_lanes_matches_jax(seed, joint):
    rng = np.random.default_rng(710 + seed)
    g = 64
    st = _seven_lanes(rng, g, joint)
    rf_idx, rf, acks = cases.refresh(rng, g, P, 64, 256, NOW)
    rf[3][:] = False
    rf[3][:, :SERVERS] = True
    rf[4][:] = False
    if joint:
        rf[4][:, :5] = True
    jr = jax.jit(jq.engine_step_resident)(
        _jstate(st), jnp.asarray(rf_idx), *(jnp.asarray(a) for a in rf),
        *(jnp.asarray(a) for a in acks), jnp.int32(NOW), jnp.int32(TIMEOUT))
    tr = tq.engine_step_resident(
        tq.device_state_from_numpy(st, "cpu"), torch.from_numpy(rf_idx),
        *(torch.from_numpy(a) for a in rf),
        *(torch.from_numpy(a) for a in acks), NOW, TIMEOUT)
    _assert_state(jr.state, tr.state)
    np.testing.assert_array_equal(tr.new_commit.numpy(),
                                  np.asarray(jr.new_commit))
    for f in ("commit_changed", "timeouts", "stale"):
        np.testing.assert_array_equal(getattr(tr, f).numpy() != 0,
                                      np.asarray(getattr(jr, f)), err_msg=f)


@pytest.mark.parametrize("joint", [False, True], ids=["seven", "joint5to7"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k3_at_seven_of_eight_lanes_matches_jax(seed, joint):
    rng = np.random.default_rng(720 + seed)
    g = 64
    args = cases.tally_inputs(rng, g, P, members=SERVERS)
    args[3][:] = False
    if joint:
        args[3][:, :5] = True
    jr = jax.jit(jq.tally_votes)(*(jnp.asarray(a) for a in args))
    tr = tq.tally_votes(*(torch.from_numpy(a) for a in args))
    for f in tq.VoteTally._fields:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    # the rows span both verdicts of a 4-of-7 majority
    passed = tr.passed_on_timeout.numpy()
    assert passed.any() and not passed.all()


def test_peer7_rung_tiny_through_bench():
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = bench.main(["--device", "cpu", "--rungs", "peer7",
                           "--groups", "16"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])["peer7"]
    assert code == 0
    assert res["servers"] == SERVERS and res["transport"] == "sim"
    assert res["acked"] == 16 * 4 and res["warmup"] == 0
    assert res["replicas_read_back"] == 16 * SERVERS
    assert res["host_path_decomposition"]["traced_requests"] >= 1
    assert res["engine_device"] == "cpu"
