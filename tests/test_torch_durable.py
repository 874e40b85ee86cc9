"""The port's server on its default durable log, against the JAX package's.

Upstream Ratis's default log is the durable segmented one, and so is the
port's: ``raft.server.log.use.memory`` defaults to false and
``raft.server.storage.dir`` to a directory.  Here:

- a server built on plain ``RaftProperties()`` (plus a storage dir under
  ``tmp_path``, and the CPU engine) starts, serves writes and restarts
  from its storage, step for step as the JAX package's does (the port
  once lacked ``server/storage.py`` and the durable logs, and raised
  ``ModuleNotFoundError`` on start);
- 3 servers x 16 groups over localhost TCP, ``ArithmeticStateMachine``,
  per-group segment files and the shared log plane, on the durable rungs'
  4 s / 8 s timeout tier (``_props``): the same script on
  the port's harness (``tools/cluster.py``) and on the JAX package (the
  harness renamed, ``tests/jax_mirror.py``) — writes, every replica's
  variable map held to the fold of the acknowledged writes, a full
  restart from disk (the groups come back from the boot scan, the TCP
  servers rebind their ports), the fold check again, then more writes;
  the maps must equal the fold and each other across packages;
- the durable rungs' properties are the JAX bench's durable tier key for
  key.
"""

import asyncio
import importlib
import uuid

import pytest

from ratis_tpu.models.arithmetic import evaluate as jax_evaluate
from ratis_tpu.tools.bench_cluster import bench_properties
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.tools import bench
from ratis_tpu_torch.tools.cluster import (Cluster, arithmetic_message,
                                           cluster_properties, fold_writes)

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

GROUPS = 16
WRITES = 3
TIMEOUT = 60.0


# -- a server on the default properties ---------------------------------------

async def _default_server_run(pkg: str, storage: str, group_id,
                              first: bool) -> list:
    """Start one server of ``pkg`` on ``RaftProperties()`` with a storage
    dir, on a one-peer group (added on the first run, recovered from disk
    on the second); one INCREMENT, one GET; close.  Returns what it saw."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    conf, ids = m("conf"), m("protocol.ids")
    sim = m("transport.simulated")
    props = conf.RaftProperties()
    conf.RaftServerConfigKeys.set_storage_dir(props, storage)
    if pkg == "ratis_tpu_torch":
        props.set(conf.RaftServerConfigKeys.Engine.DEVICE_KEY, "cpu")
    factory = sim.SimulatedTransportFactory(sim.SimulatedNetwork())
    pid = ids.RaftPeerId.value_of("s0")
    server = m("server.server").RaftServer(
        pid, "sim:s0", properties=props, transport_factory=factory,
        state_machine_registry=lambda gid: m(
            "models.counter").CounterStateMachine())
    group = m("protocol.group").RaftGroup.value_of(
        ids.RaftGroupId.value_of(group_id),
        [m("protocol.peer").RaftPeer(pid, address="sim:s0")])
    transport = None
    try:
        await server.start()
        if first:
            await server.group_add(group)
        seen = [[str(g) for g in server.divisions]]
        transport = factory.new_client_transport(props)
        client = (m("client.client").RaftClient.builder()
                  .set_raft_group(group).set_transport(transport)
                  .set_properties(props).build())
        w = await asyncio.wait_for(client.io().send(b"INCREMENT"), TIMEOUT)
        r = await asyncio.wait_for(client.io().send_read_only(b"GET"),
                                   TIMEOUT)
        seen += [w.success, r.message.content]
        return seen
    finally:
        if transport is not None:
            await transport.close()
        await server.close()


def test_server_on_default_properties_starts_and_restarts(tmp_path):
    gid = uuid.UUID(int=7)
    runs = {pkg: [asyncio.run(_default_server_run(pkg, str(tmp_path / pkg),
                                                  gid, first))
                  for first in (True, False)]
            for pkg in ("ratis_tpu", "ratis_tpu_torch")}
    first, again = runs["ratis_tpu_torch"]
    assert first[1:] == [True, b"1"]
    # the second server found the group on disk, with its state
    assert again == [first[0], True, b"2"] and len(first[0]) == 1
    assert runs["ratis_tpu_torch"] == runs["ratis_tpu"]


async def _step_down_mid_write(pkg: str):
    """A one-peer group on ``pkg``'s server; a write whose state machine's
    ``start_transaction`` waits until the test steps the leader down:
    the reply's exception (and whether the leader had a context left)."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    conf, ids = m("conf"), m("protocol.ids")
    sim = m("transport.simulated")
    counter = m("models.counter")
    props = conf.RaftProperties()
    conf.RaftServerConfigKeys.Log.set_use_memory(props, True)
    if pkg == "ratis_tpu_torch":
        props.set(conf.RaftServerConfigKeys.Engine.DEVICE_KEY, "cpu")
    entered, release = asyncio.Event(), asyncio.Event()

    class Held(counter.CounterStateMachine):
        async def start_transaction(self, request):
            entered.set()
            await release.wait()
            return await super().start_transaction(request)

    pid = ids.RaftPeerId.value_of("s0")
    server = m("server.server").RaftServer(
        pid, "sim:s0", properties=props,
        transport_factory=sim.SimulatedTransportFactory(
            sim.SimulatedNetwork()),
        state_machine_registry=lambda gid: Held())
    group = m("protocol.group").RaftGroup.value_of(
        ids.RaftGroupId.random_id(),
        [m("protocol.peer").RaftPeer(pid, address="sim:s0")])
    try:
        await server.start()
        await server.group_add(group)
        d = server.divisions[group.group_id]
        deadline = asyncio.get_running_loop().time() + TIMEOUT
        while not (d.is_leader() and d.leader_ctx is not None
                   and d.leader_ctx.leader_ready.done()):
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        req = m("protocol.requests").RaftClientRequest(
            ids.ClientId.random_id(), pid, group.group_id, 1,
            m("protocol.message").Message.value_of(b"INCREMENT"),
            type=m("protocol.requests").write_request_type())
        write = asyncio.ensure_future(d.submit_client_request(req))
        await entered.wait()
        await d.change_to_follower(d.state.current_term + 1, None,
                                   reason="test: mid-write step-down")
        release.set()
        reply = await asyncio.wait_for(write, TIMEOUT)
        return type(reply.exception).__name__, str(reply.exception)
    finally:
        await server.close()


def test_write_whose_leader_steps_down_mid_transaction_answers_not_leader():
    """The port's leader re-checks its leadership after the state
    machine's transaction: a write whose leader stepped down meanwhile is
    answered NotLeader, which a client retries at the new leader.  The
    reference appends through the cleared leader context and answers an
    AttributeError's text, which no client retries (a durable cluster's
    writes after a restart failed on it)."""
    port = asyncio.run(_step_down_mid_write("ratis_tpu_torch"))
    assert port[0] == "NotLeaderException", port
    jax = asyncio.run(_step_down_mid_write("ratis_tpu"))
    assert "'NoneType' object has no attribute 'pending'" in jax[1], jax


def test_default_properties_are_durable():
    from ratis_tpu_torch.conf import RaftProperties
    p = RaftProperties()
    assert not RaftServerConfigKeys.Log.use_memory(p)
    assert RaftServerConfigKeys.storage_dirs(p)


# -- 3 x 16 durable arithmetic clusters, port and JAX -------------------------

def _props(tmp, shared: bool):
    """The durable rungs' properties at 16 groups: the 4 s / 8 s tier
    (``bench.DURABLE_TIER``) over the cluster's.  Every vote and term
    change persists ``raft-meta`` (a new file, an fsync and a rename), and
    where such a write takes tens of ms, 48 divisions electing at once
    queue their votes behind each other for seconds: under the 1 s / 2 s
    tier that 16 groups would get, candidates then time out faster than
    the votes land, and bring-up never converges."""
    p = cluster_properties(GROUPS, 3, "cpu", "tcp", storage_dir=str(tmp),
                           shared_log=shared)
    for k, v in bench.DURABLE_TIER.items():
        p.set(k, v)
    return p


async def _durable_script(cluster) -> dict:
    """Start, write, fold-check, restart from disk, fold-check, write one
    more round, fold-check; returns the maps per group (in group order)
    and the addresses before and after the restart."""
    try:
        await cluster.start(timeout=TIMEOUT)
        before = [s.transport.address for s in cluster.servers]
        stats = await cluster.write_all(WRITES)
        assert stats["commits"] == GROUPS * WRITES
        assert await cluster.check_variables(TIMEOUT) == GROUPS * 3
        await cluster.restart(TIMEOUT)
        after = [s.transport.address for s in cluster.servers]
        assert await cluster.check_variables(TIMEOUT) == GROUPS * 3
        # a restart's elections may still be moving leaders (each vote an
        # fsynced raft-meta write): write once every group has a ready
        # leader again, as the writes before the restart did
        await cluster.wait_leaders(cluster.groups, TIMEOUT)
        await cluster.write_all(1)
        assert await cluster.check_variables(TIMEOUT) == GROUPS * 3
        maps = [cluster.servers[0].divisions[g.group_id].state_machine
                .variables for g in cluster.groups]
        writes = [cluster.acked_writes[g.group_id] for g in cluster.groups]
        return {"maps": maps, "writes": writes, "before": before,
                "after": after, "restart_s": cluster.restart_s}
    finally:
        await cluster.close()


@pytest.mark.parametrize("shared", [False, True], ids=["pergroup", "shared"])
def test_durable_arithmetic_cluster_matches_jax(tmp_path, shared):
    port = Cluster(GROUPS, device="cpu", transport="tcp", sm="arithmetic",
                   properties=_props(tmp_path / "port", shared))
    jmod = jax_cluster_module()
    jax = jmod.Cluster(GROUPS, device="cpu", transport="tcp",
                       sm="arithmetic", properties=jax_properties(
                           _props(tmp_path / "jax", shared)))
    prewarm_small(jax)
    runs = {"port": asyncio.run(_durable_script(port)),
            "jax": asyncio.run(_durable_script(jax))}
    for name, run in runs.items():
        # every TCP server came back on the port it had
        assert run["before"] == run["after"], name
        for i, (writes, got) in enumerate(zip(run["writes"], run["maps"])):
            assert len(writes) == WRITES + 1, (name, i)
            assert got == fold_writes(writes), (name, i)
            # the JAX package's own evaluate folds to the same map
            jmap: dict = {}
            for _, msg in sorted(writes):
                var, _, expr = msg.decode().partition("=")
                jmap[var.strip()] = jax_evaluate(expr.strip(), jmap)
            assert got == jmap, (name, i)
    assert runs["port"]["maps"] == runs["jax"]["maps"]
    assert [[m for _, m in w] for w in runs["port"]["writes"]] == \
        [[m for _, m in w] for w in runs["jax"]["writes"]]
    # every log lives on disk: a segment file per group on each of the 3
    # servers, or the shared plane's segments and none per group
    for pkg in ("port", "jax"):
        names = [f.name for f in (tmp_path / pkg).rglob("*") if f.is_file()]
        per_group = sum(n.startswith("log_") for n in names)
        plane = sum(n.startswith("shared_") for n in names)
        if shared:
            assert plane >= 3 and per_group == 0, (pkg, sorted(names))
        else:
            assert per_group >= GROUPS * 3 and plane == 0, (pkg, per_group)


def test_arithmetic_messages_are_the_jax_benchs():
    import itertools
    seq = itertools.count()
    # bench_cluster.py's factory draws the counter twice per message
    mf = lambda: f"v{next(seq) % 7}={next(seq) % 97}+1".encode()
    assert [arithmetic_message(k) for k in range(200)] == \
        [mf() for _ in range(200)]


@pytest.mark.parametrize("shared", [False, True])
def test_durable_rung_properties_are_the_jax_benchs(tmp_path, shared):
    port = dict(bench.durable_properties(1024, "cuda", str(tmp_path),
                                         shared).items())
    jax = dict(bench_properties(True, 1024, num_servers=3,
                                transport="tcp").items())
    # bench.py's durable rungs (child_mixed_durable): the log keys and the
    # durable timeout tier over bench_properties
    jax.update({"raft.server.log.use.memory": "false",
                "raft.server.storage.dir": str(tmp_path),
                "raft.tpu.log.shared": "1" if shared else "0",
                "raft.server.rpc.timeout.min": "4s",
                "raft.server.rpc.timeout.max": "8s",
                "raft.server.rpc.request.timeout": "8s"})
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
