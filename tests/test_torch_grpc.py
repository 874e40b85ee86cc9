"""The gRPC transport, the port against the JAX package (CPU only).

``transport/grpc.py`` is a verbatim copy; the harness (``tools/cluster.py``,
``transport="grpc"``) runs it as it runs TCP, each server on a port the
kernel picks.  The same script runs on a 3 x 4 cluster of each package
(the JAX one through the harness renamed, ``tests/jax_mirror.py``), as
``tests/test_raft_grpc.py`` drives the JAX package: writes on every group
and every counter read back from every replica; the leader of one group
killed, a new leader elected and a write without it; the killed server
restarted on its address with every group and caught up; a write
watched to ALL and read back stale at a follower.  Both packages must
give the same counters at every step.  The card host has no ``grpcio``:
the module skips there.
"""

import asyncio

import pytest

pytest.importorskip("grpc")

from ratis_tpu_torch.tools import cluster as port_cluster  # noqa: E402
from ratis_tpu_torch.tools.cluster import cluster_properties  # noqa: E402

from tests.jax_mirror import (jax_cluster_module, jax_properties,  # noqa
                              prewarm_small)

from ratis_tpu.protocol.requests import ReplicationLevel as JaxLevel  # noqa
from ratis_tpu_torch.protocol.requests import ReplicationLevel  # noqa

GROUPS = 4
WRITES = 2
LEVEL_ALL = {"port": ReplicationLevel.ALL, "jax": JaxLevel.ALL}


def _cluster(mod, pkg: str):
    props = cluster_properties(GROUPS, 3, "cpu", "grpc")
    if pkg == "jax":
        cluster = mod.Cluster(GROUPS, device="cpu", transport="grpc",
                              properties=jax_properties(props))
        prewarm_small(cluster)
        return cluster
    return mod.Cluster(GROUPS, device="cpu", transport="grpc",
                       properties=props)


async def _send(client, msg=b"INCREMENT"):
    reply = await client.io().send(msg)
    assert reply.success, reply.exception
    return reply


async def _script(mod, pkg: str) -> dict:
    cluster = _cluster(mod, pkg)
    out = {}
    try:
        await cluster.start(timeout=60)
        out["addresses_bound"] = all(
            int(s.transport.address.rsplit(":", 1)[1]) > 0
            for s in cluster.servers)
        out["transports"] = sorted({type(s.transport).__name__
                                    for s in cluster.servers})
        stats = await cluster.write_all(WRITES)
        out["acked"] = sorted(stats["acked"].values())
        counters = await cluster.read_counters(timeout=60)
        out["counters"] = [counters[g.group_id] for g in cluster.groups]

        # the leader of group 0 killed: a new one is elected, writes go on
        g = cluster.groups[0]
        client = cluster.client(g)
        leader = cluster.leader_of(g)
        await leader.close()
        others = [s for s in cluster.servers if s is not leader]
        deadline = asyncio.get_running_loop().time() + 30
        while not any((d := s.divisions.get(g.group_id)) is not None
                      and d.is_leader() for s in others):
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.05)
        reply = await _send(client)
        out["after_failover"] = int(reply.message.content)
        read = await client.io().send_read_only(b"GET")
        out["read_after_failover"] = int(read.message.content)

        # the killed server restarted on its address (an empty memory
        # log), hosting every group again, and caught up on group 0
        address = leader.transport.address
        reborn = mod.RaftServer(
            leader.peer_id, address,
            state_machine_registry=lambda gid: mod.CounterStateMachine(),
            properties=cluster.properties, transport_factory=cluster.factory)
        cluster.servers[cluster.servers.index(leader)] = reborn
        await reborn.start()
        for grp in cluster.groups:
            await reborn.group_add(grp)
        last = await _send(client)
        deadline = asyncio.get_running_loop().time() + 30
        while reborn.divisions[g.group_id].applied_index < last.log_index:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.05)
        out["rejoined_counter"] = int(
            reborn.divisions[g.group_id].state_machine.counter)

        # a write watched to ALL, then read stale at a follower
        g2 = cluster.groups[2]
        c2 = cluster.client(g2)
        w = await _send(c2)
        watched = await c2.io().watch(w.log_index, LEVEL_ALL[pkg])
        out["watched"] = watched.success
        follower = next(s for s in cluster.servers
                        if s is not cluster.leader_of(g2)
                        and s.divisions.get(g2.group_id) is not None)
        deadline = asyncio.get_running_loop().time() + 30
        while follower.divisions[g2.group_id].applied_index < w.log_index:
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.05)
        stale = await c2.io().send_stale_read(b"GET", w.log_index,
                                              follower.peer_id)
        out["stale"] = (stale.success, int(stale.message.content))
        return out
    finally:
        await cluster.close()


def test_grpc_cluster_matches_jax():
    port = asyncio.run(_script(port_cluster, "port"))
    jax = asyncio.run(_script(jax_cluster_module(), "jax"))
    assert port == jax
    assert port["transports"] == ["GrpcServerTransport"]
    assert port["addresses_bound"]
    assert port["acked"] == [WRITES] * GROUPS
    assert port["counters"] == [[WRITES] * 3] * GROUPS
    assert port["after_failover"] == port["read_after_failover"] \
        == WRITES + 1
    assert port["rejoined_counter"] == WRITES + 2
    assert port["watched"] and port["stale"] == (True, WRITES + 1)


@pytest.mark.parametrize("groups,tier", [(4, ("1s", "2s")),
                                         (1024, ("4s", "8s")),
                                         (2048, ("4s", "8s")),
                                         (8192, ("8s", "16s"))])
def test_grpc_properties_take_the_jax_grpc_tiers(groups, tier):
    from ratis_tpu.tools.bench_cluster import bench_properties
    from ratis_tpu_torch.conf import RaftServerConfigKeys
    port = dict(cluster_properties(groups, 3, "cuda", "grpc").items())
    jax = dict(bench_properties(True, groups, transport="grpc").items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    assert (port["raft.server.rpc.timeout.min"],
            port["raft.server.rpc.timeout.max"]) == tier
