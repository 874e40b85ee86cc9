"""The server's introspection endpoints on the port: ``health_info()`` (GET
/health) and ``divisions_info()`` (GET /divisions).

The port once lacked ``chaos/link.py`` and ``server/shards.py``, so both
calls raised ``ModuleNotFoundError`` on a running server.  Here a 3 x 4
cluster of the port (CPU engines, the simulated transport) and of the JAX
package (the port's harness renamed, ``tests/jax_mirror.py``) run one
script: every group's leadership moves to a fixed peer, every group takes
two writes, the followers catch up, and then every server answers both
calls.  The answers must match the JAX cluster's:

- ``health_info()`` has the same keys, nested blocks included, and the
  same status, lifecycle, division count and chaos block;
- ``divisions_info()`` gives, per server and group, the same role, the
  same term and commit relative to the group's leader (the absolute
  values count the bring-up's elections, which are random), and the same
  commit advance over the two writes; each entry also equals the
  division's own state;
- the ``?rollup=1`` form gives the same division and leadership counts.
"""

import asyncio
import time

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


def _keys(d: dict, prefix: str = "") -> list:
    """Every key of a nested dict as a dotted path."""
    out = []
    for k, v in d.items():
        out.append(prefix + k)
        if isinstance(v, dict):
            out += _keys(v, prefix + k + ".")
    return sorted(out)


def _commits(cluster, g) -> list:
    return [int(s.divisions[g.group_id].state.log
                .get_last_committed_index()) for s in cluster.servers]


async def _introspect_script(cluster) -> dict:
    seen = {}
    try:
        await cluster.start(timeout=TIMEOUT)
        for i, g in enumerate(cluster.groups):
            peers = sorted(g.peers, key=lambda p: str(p.id))
            target = peers[i % 3].id
            if cluster.leader_of(g).peer_id != target:
                r = await cluster.client(g).admin().transfer_leadership(
                    target, timeout_ms=5000.0)
                assert r.success, r.exception
                await _until(lambda: (cluster.leader_of(g) is not None and
                                      cluster.leader_of(g).peer_id == target),
                             f"{target} leads {g.group_id}")
        for g in cluster.groups:
            await _until(lambda: len(set(_commits(cluster, g))) == 1,
                         f"{g.group_id} replicas agree on commit")
        before = {g.group_id: _commits(cluster, g)[0] for g in cluster.groups}
        stats = await cluster.write_all(2)
        assert stats["commits"] == GROUPS * 2
        for g in cluster.groups:
            await _until(lambda: set(_commits(cluster, g)) ==
                         {before[g.group_id] + 2},
                         f"{g.group_id} replicas committed both writes")

        health = [s.health_info() for s in cluster.servers]
        seen["health_keys"] = [_keys(h) for h in health]
        seen["health"] = [(h["status"], h["lifecycle"], h["divisions"],
                           h["chaos"]) for h in health]
        infos = [{d["group"]: d for d in s.divisions_info()}
                 for s in cluster.servers]
        seen["divisions"] = []
        for g in cluster.groups:
            gid = str(g.group_id)
            lead = infos[cluster.servers.index(cluster.leader_of(g))][gid]
            row = []
            for s, info in zip(cluster.servers, infos):
                d = info[gid]
                div = s.divisions[g.group_id]
                assert d["role"] == div.role.name
                assert d["term"] == int(div.state.current_term)
                assert d["commitIndex"] == int(
                    div.state.log.get_last_committed_index())
                row.append((d["role"], d["term"] - lead["term"],
                            d["commitIndex"] - lead["commitIndex"],
                            d["commitIndex"] - before[g.group_id]))
            seen["divisions"].append(row)
        seen["rollup"] = [
            (r["divisions"], r["leading"])
            for r in (s.divisions_info({"rollup": ["1"]})
                      for s in cluster.servers)]
        return seen
    finally:
        await cluster.close()


def test_health_and_divisions_info_match_jax():
    props = cluster_properties(GROUPS, 3, "cpu", "sim")
    port = Cluster(GROUPS, device="cpu", properties=props)
    jax = jax_cluster_module().Cluster(GROUPS, device="cpu",
                                       properties=jax_properties(props))
    prewarm_small(jax)
    runs = {"port": asyncio.run(_introspect_script(port)),
            "jax": asyncio.run(_introspect_script(jax))}
    roles = [["LEADER", "FOLLOWER", "FOLLOWER"],
             ["FOLLOWER", "LEADER", "FOLLOWER"],
             ["FOLLOWER", "FOLLOWER", "LEADER"],
             ["LEADER", "FOLLOWER", "FOLLOWER"]]
    for name, run in runs.items():
        assert [[r[0] for r in row] for row in run["divisions"]] == roles, \
            name
        assert all(r[1:] == (0, 0, 2) for row in run["divisions"]
                   for r in row), name
        assert [h[:3] for h in run["health"]] == [
            ("ok", "RUNNING", GROUPS)] * 3, name
        assert run["rollup"] == [(GROUPS, 2), (GROUPS, 1), (GROUPS, 1)], name
    for key in ("health_keys", "health", "divisions", "rollup"):
        assert runs["port"][key] == runs["jax"][key], key
