"""The slice as a whole: the same workload on the JAX package's cluster and
on the port's (``ratis_tpu_torch.tools.cluster``, engines on the CPU).

3 servers x 32 groups over the simulated transport (the TCP transport:
``test_torch_tcp_cluster.py``, through the same two runs), the batched
engine on every tick (scalar-fallback-threshold 0), leaders by election, a
fixed
number of INCREMENTs per group through each package's RaftClient, and
every counter read back from all three replicas.  Both runs must reach
counter == writes on every replica, show fast and refresh ticks, batched
vote tallies and ledger samples; their per-group counters must be equal.
Applied indexes may differ by the placeholder entries that extra
elections add, so those are held only to >= writes.
"""

import asyncio
import time


from ratis_tpu.client.client import RaftClient as JaxClient
from ratis_tpu.conf import RaftProperties as JaxProperties
from ratis_tpu.engine.engine import QuorumEngine as JaxEngine
from ratis_tpu.models.counter import CounterStateMachine as JaxCounter
from ratis_tpu.protocol.group import RaftGroup as JaxGroup
from ratis_tpu.protocol.ids import RaftGroupId as JaxGroupId
from ratis_tpu.protocol.ids import RaftPeerId as JaxPeerId
from ratis_tpu.protocol.peer import RaftPeer as JaxPeer
from ratis_tpu.server.server import RaftServer as JaxServer
from ratis_tpu.transport.base import TransportFactory as JaxTransports
from ratis_tpu.transport.simulated import SimulatedNetwork as JaxNetwork
from ratis_tpu.transport.simulated import \
    SimulatedTransportFactory as JaxFactory
from ratis_tpu_torch.engine.engine import QuorumEngine as TorchEngine
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

GROUPS = 32
WRITES = 3
TIMEOUT = 60.0


def _count_vote_passes(monkeypatch, engine_cls):
    """Count engine vote passes that tallied open rounds (the batched
    tally runs inside them; prewarm's own tally launch is not counted)."""
    rounds = []
    orig = engine_cls._vote_pass

    def wrapper(self, now):
        if self._vote_rounds:
            rounds.append(len(self._vote_rounds))
        return orig(self, now)
    monkeypatch.setattr(engine_cls, "_vote_pass", wrapper)
    return rounds


async def _wait(pred, what):
    deadline = time.monotonic() + TIMEOUT
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.05)


async def _jax_run(transport: str = "sim", properties=None) -> dict:
    """The port harness's steps, with the JAX package's classes (and the
    port harness's properties, or ``properties``)."""
    props = JaxProperties(dict((properties or cluster_properties(
        GROUPS, 3, "cpu", transport)).items()))
    if transport == "tcp":
        import ratis_tpu.transport.tcp  # noqa: F401 (registers TCP)
        factory = JaxTransports.get("TCP")
        addresses = ["127.0.0.1:0"] * 3
    else:
        net = JaxNetwork()
        net.request_timeout_s = 3.0
        factory = JaxFactory(net)
        addresses = [f"sim:s{i}" for i in range(3)]
    servers = [JaxServer(JaxPeerId.value_of(f"s{i}"), a,
                         state_machine_registry=lambda gid: JaxCounter(),
                         properties=props, transport_factory=factory)
               for i, a in enumerate(addresses)]
    groups = []
    servers[0].engine.prewarm(group_counts=[64], event_counts=[64, 256])
    transport = factory.new_client_transport(props)

    def leader_of(g):
        for s in servers:
            d = s.divisions.get(g.group_id)
            if d is not None and d.is_leader() and d.leader_ctx is not None \
                    and d.leader_ctx.leader_ready.done():
                return s
        return None

    try:
        await asyncio.gather(*(s.start() for s in servers))
        peers = [JaxPeer(s.peer_id, address=s.transport.address)
                 for s in servers]
        groups.extend(JaxGroup.value_of(JaxGroupId.random_id(), peers)
                      for _ in range(GROUPS))
        await asyncio.gather(*(s.group_add(groups[0]) for s in servers))
        await _wait(lambda: leader_of(groups[0]), "first leader")
        await asyncio.gather(*(s.group_add(g) for g in groups[1:]
                               for s in servers))
        await _wait(lambda: all(leader_of(g) for g in groups), "leaders")

        async def write(g):
            c = (JaxClient.builder().set_raft_group(g)
                 .set_transport(transport).set_properties(props)
                 .set_leader_id(leader_of(g).peer_id).build())
            last = 0
            for _ in range(WRITES):
                reply = await c.io().send(b"INCREMENT")
                assert reply.success, reply.exception
                last = reply.log_index
            vals = []
            for s in servers:
                while True:
                    r = await c.io().send_stale_read(b"GET", last, s.peer_id)
                    if r.success:
                        vals.append(int(r.message.content))
                        break
                    await asyncio.sleep(0.02)
            return vals

        counters = await asyncio.wait_for(
            asyncio.gather(*(write(g) for g in groups)), TIMEOUT)
        await asyncio.sleep(1.2)  # at least one watchdog ledger sample
        return {"counters": counters, "engines": [s.engine for s in servers],
                "transports": [type(s.transport).__name__ for s in servers],
                "applied": [s.divisions[g.group_id].applied_index
                            for s in servers for g in groups]}
    finally:
        await transport.close()
        await asyncio.gather(*(s.close() for s in servers),
                             return_exceptions=True)


async def _torch_run(transport: str = "sim", properties=None) -> dict:
    cluster = Cluster(GROUPS, device="cpu", transport=transport,
                      properties=properties)
    try:
        await cluster.start(timeout=TIMEOUT)
        stats = await cluster.write_all(WRITES)
        assert all(v == WRITES for v in stats["acked"].values())
        read = await cluster.read_counters(timeout=TIMEOUT)
        await asyncio.sleep(1.2)  # at least one watchdog ledger sample
        return {"counters": [read[g.group_id] for g in cluster.groups],
                "engines": [s.engine for s in cluster.servers],
                "transports": [type(s.transport).__name__
                               for s in cluster.servers],
                "applied": [s.divisions[g.group_id].applied_index
                            for s in cluster.servers for g in cluster.groups],
                "addresses": sorted({p.address for g in cluster.groups
                                     for p in g.peers}),
                "listening": sorted(s.transport.address
                                    for s in cluster.servers)}
    finally:
        await cluster.close()


def run_both_and_compare(monkeypatch, transport: str,
                         properties=None) -> dict:
    """Both clusters over ``transport`` (with ``properties`` when
    given), held to the same bar."""
    jax_tallies = _count_vote_passes(monkeypatch, JaxEngine)
    torch_tallies = _count_vote_passes(monkeypatch, TorchEngine)
    runs = {"jax": asyncio.run(_jax_run(transport, properties)),
            "torch": asyncio.run(_torch_run(transport, properties))}
    for name, run in runs.items():
        assert run["counters"] == [[WRITES] * 3] * GROUPS, name
        assert min(run["applied"]) >= WRITES, name
        for e in run["engines"]:
            assert e.metrics["batched_dispatches"] > 0, name
            assert e.metrics["fast_ticks"] > 0, name
            assert e.metrics["refresh_ticks"] > 0, name
            assert e.ledger.samples.count > 0, name
    assert runs["jax"]["counters"] == runs["torch"]["counters"]
    assert runs["jax"]["transports"] == runs["torch"]["transports"]
    assert jax_tallies and torch_tallies
    for e in runs["torch"]["engines"]:
        assert e.device.type == "cpu"
        assert e._dev is None or e._dev.match_index.device.type == "cpu"
    return runs


def test_cluster_slice_matches_jax(monkeypatch):
    runs = run_both_and_compare(monkeypatch, "sim")
    assert set(runs["torch"]["transports"]) == {"SimulatedServerTransport"}

