"""The admin plane on the port: TRANSFER_LEADERSHIP and SET_CONFIGURATION.

The port once lacked ``server/admin.py``, so both requests crashed the
division that took them.  Here a 3 x 4 cluster of the port (CPU engines,
the simulated transport) and of the JAX package (the port's harness
renamed, ``tests/jax_mirror.py``) run one script through each package's
``RaftClient`` admin API, after ``tests/test_reconfiguration.py``'s
``test_transfer_leadership`` and ``test_remove_peer_and_survive``:

- every group's leadership moves to a fixed peer (away first when that
  peer already leads);
- every group drops one follower (a joint entry, then the new conf), then
  takes it back (staged, a second joint round), while the group stays
  writable;
- leaders, the configurations after each step on every server, and the
  counters read back from every replica must equal the JAX cluster's.

Also the bench's ``churn`` rung at a tiny size on the CPU.
"""

import asyncio
import contextlib
import io
import json
import time

from ratis_tpu_torch.tools import bench
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

GROUPS = 4
TIMEOUT = 60.0


async def _until(pred, what: str) -> None:
    deadline = time.monotonic() + TIMEOUT
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.02)


def _confs(cluster, g) -> list:
    """Each server's view of ``g``'s configuration: (sorted voting peer
    ids, stable)."""
    out = []
    for s in cluster.servers:
        conf = s.divisions[g.group_id].state.configuration
        out.append((sorted(str(p.id) for p in conf.conf.peers),
                    conf.is_stable()))
    return out


async def _admin_script(cluster) -> dict:
    seen = {"leaders": [], "removed": [], "final": [], "transfers": 0}
    try:
        await cluster.start(timeout=TIMEOUT)
        for i, g in enumerate(cluster.groups):
            peers = sorted(g.peers, key=lambda p: str(p.id))
            admin = cluster.client(g).admin()
            target = peers[i % 3].id
            moves = [target]
            if cluster.leader_of(g).peer_id == target:
                moves.insert(0, peers[(i + 1) % 3].id)
            for to in moves:
                r = await admin.transfer_leadership(to, timeout_ms=5000.0)
                assert r.success, r.exception
                seen["transfers"] += 1
                await _until(lambda: (cluster.leader_of(g) is not None and
                                      cluster.leader_of(g).peer_id == to),
                             f"{to} leads {g.group_id}")
            seen["leaders"].append(str(cluster.leader_of(g).peer_id))
        for i, g in enumerate(cluster.groups):
            peers = sorted(g.peers, key=lambda p: str(p.id))
            admin = cluster.client(g).admin()
            gone = peers[(i + 1) % 3]
            keep = [p for p in peers if p.id != gone.id]
            r = await admin.set_configuration(keep)
            assert r.success, r.exception
            leader = cluster.leader_of(g)
            await _until(lambda: _confs(cluster, g)[
                cluster.servers.index(leader)][1], "stable 2-member conf")
            assert (await cluster.client(g).io().send(b"INCREMENT")).success
            seen["removed"].append(_confs(cluster, g)[
                cluster.servers.index(leader)])
            r = await admin.set_configuration(peers)
            assert r.success, r.exception
            want = (sorted(str(p.id) for p in peers), True)
            await _until(lambda: _confs(cluster, g) == [want] * 3,
                         "the follower back in every server's conf")
            seen["final"].append(_confs(cluster, g))
        stats = await cluster.write_all(2)
        assert stats["commits"] == GROUPS * 2
        read = await cluster.read_counters(TIMEOUT)
        seen["counters"] = [read[g.group_id] for g in cluster.groups]
        return seen
    finally:
        await cluster.close()


def test_transfer_and_set_configuration_match_jax():
    props = cluster_properties(GROUPS, 3, "cpu", "sim")
    port = Cluster(GROUPS, device="cpu", properties=props)
    jax = jax_cluster_module().Cluster(GROUPS, device="cpu",
                                       properties=jax_properties(props))
    prewarm_small(jax)
    runs = {"port": asyncio.run(_admin_script(port)),
            "jax": asyncio.run(_admin_script(jax))}
    for name, run in runs.items():
        assert run["leaders"] == ["s0", "s1", "s2", "s0"], name
        assert [ids for ids, _ in run["removed"]] == [
            ["s0", "s2"], ["s0", "s1"], ["s1", "s2"], ["s0", "s2"]], name
        assert all(stable for _, stable in run["removed"]), name
        assert run["final"] == [[(["s0", "s1", "s2"], True)] * 3] * GROUPS
        # one write between the two changes, two after
        assert run["counters"] == [[3, 3, 3]] * GROUPS, name
    for key in ("leaders", "removed", "final", "counters"):
        assert runs["port"][key] == runs["jax"][key], key


def test_churn_rung_runs_tiny_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.main(["--device", "cpu", "--rungs", "churn",
                           "--groups", "16", "--writes", "2"]) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    churn = res["churn"]
    assert churn["transfers_ok"] + churn["transfers_failed"] == \
        bench.CHURN_TRANSFERS
    assert churn["transfers_ok"] > 0
    assert churn["joint_ok"] == bench.CHURN_JOINT_GROUPS
    assert churn["commits"] == 16 * 2
    assert churn["replicas_read_back"] == 16 * 3
    assert churn["final_conf_sizes"] == [3]
    assert res["device"]["type"] == "cpu"
