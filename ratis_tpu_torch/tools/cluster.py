"""An in-process multi-Raft cluster of the port's servers.

``num_servers`` port ``RaftServer``s over one ``SimulatedNetwork``
(``transport="sim"``) or over real TCP sockets on ``127.0.0.1``
(``transport="tcp"``, the framed transport of ``transport/tcp.py``, each
server on a port the kernel picks when it binds, the groups made from the
ports the servers got), each hosting the same ``num_groups`` sibling
groups with a ``CounterStateMachine``, every group's consensus
ticked by one ``QuorumEngine`` per server on ``device``.  The properties
are the batched multi-Raft deployment of the JAX package's bench harness
(``ratis_tpu/tools/bench_cluster.py``, ``bench_properties`` with
``batched=True``): the batched engine on every tick
(scalar-fallback-threshold 0), appender and heartbeat coalescing, wire
write coalescing, the GC discipline, timeouts scaled to the channel
count, the default stall watchdog (so the ledger pass runs).

Leaders come from ordinary randomized-timeout elections (every round goes
through the batched vote tally), group by group in waves; writes go
through the port's ``RaftClient``; counters are read back from every
replica through stale reads.

    cluster = Cluster(num_groups=1024, device="cuda", transport="tcp")
    cluster.prewarm()             # optional: start() prewarms otherwise
    await cluster.start()
    stats = await cluster.write_all(writes_per_group=4)
    counters = await cluster.read_counters()
    await cluster.close()
"""

from __future__ import annotations

import asyncio
import time

from ratis_tpu_torch.client.client import RaftClient
from ratis_tpu_torch.conf import RaftProperties, RaftServerConfigKeys
from ratis_tpu_torch.conf.keys import WireConfigKeys
from ratis_tpu_torch.engine.engine import QuorumEngine
from ratis_tpu_torch.models.counter import CounterStateMachine
from ratis_tpu_torch.protocol.group import RaftGroup
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.peer import RaftPeer
from ratis_tpu_torch.server.server import RaftServer
from ratis_tpu_torch.transport.base import TransportFactory
from ratis_tpu_torch.transport.simulated import (SimulatedNetwork,
                                                 SimulatedTransportFactory)

TRANSPORTS = ("sim", "tcp")


def cluster_properties(num_groups: int, num_servers: int = 3,
                       device: str = "cuda", transport: str = "sim",
                       mesh_devices: int = 0) -> RaftProperties:
    """The batched deployment of ``num_groups`` groups on ``num_servers``
    servers: the JAX bench's ``bench_properties(batched=True, num_groups,
    num_servers=..., transport=..., mesh_devices=...)`` key for key, plus
    the port's engine device.  ``mesh_devices`` > 0 runs every engine as
    that many slices of its group batch (``parallel/mesh.py``)."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r}: one of {TRANSPORTS}")
    p = RaftProperties()
    channels = num_groups * max(num_servers - 1, 1)
    if channels >= 2048:
        # a busy handler at thousands of channels outlives a 3s deadline
        p.set(RaftServerConfigKeys.Rpc.REQUEST_TIMEOUT_KEY, "8s")
    if channels >= 32768:
        RaftServerConfigKeys.Rpc.set_timeout(p, "24s", "48s")
    elif channels >= 16384:
        RaftServerConfigKeys.Rpc.set_timeout(p, "8s", "16s")
    elif channels >= 4096:
        RaftServerConfigKeys.Rpc.set_timeout(p, "4s", "8s")
    else:
        RaftServerConfigKeys.Rpc.set_timeout(p, "1s", "2s")
    # commits advance inline at ack intake; the tick drives timeouts and
    # staleness, so a 20ms cadence batches more events per launch
    p.set(RaftServerConfigKeys.Engine.TICK_INTERVAL_KEY, "20ms")
    # pre-sized: adding the groups never regrows the resident batch
    p.set(RaftServerConfigKeys.Engine.MAX_GROUPS_KEY,
          str(max(QuorumEngine._bucket(num_groups), 64)))
    p.set(RaftServerConfigKeys.Engine.SCALAR_FALLBACK_THRESHOLD_KEY, "0")
    p.set(RaftServerConfigKeys.Engine.DEVICE_KEY, device)
    if mesh_devices:
        p.set(RaftServerConfigKeys.Engine.MESH_DEVICES_KEY, str(mesh_devices))
    RaftServerConfigKeys.Log.set_use_memory(p, True)
    # heap discipline: tuned collector thresholds, one seal after bring-up,
    # a steady-state re-freeze every 15s (the memory log never purges)
    p.set(RaftServerConfigKeys.Gc.DISCIPLINE_KEY, "true")
    p.set(RaftServerConfigKeys.Gc.REFREEZE_INTERVAL_KEY, "15s")
    p.set(RaftServerConfigKeys.Log.Appender.COALESCING_ENABLED_KEY, "true")
    p.set(RaftServerConfigKeys.Heartbeat.COALESCING_ENABLED_KEY, "true")
    # wire write coalescing: pending frames leave in one buffered flush per
    # connection, at 128KB or after 100us (the gRPC pair is set as the JAX
    # bench sets it; no transport of the port reads it yet)
    p.set(WireConfigKeys.Tcp.FLUSH_BYTES_KEY, "128KB")
    p.set(WireConfigKeys.Tcp.FLUSH_MICROS_KEY, "100")
    p.set(WireConfigKeys.Grpc.FLUSH_MICROS_KEY, "100")
    p.set(WireConfigKeys.Grpc.FLUSH_CHUNKS_KEY, "64")
    return p


class Cluster:
    def __init__(self, num_groups: int, num_servers: int = 3,
                 device: str = "cuda", properties=None,
                 transport: str = "sim", mesh_devices: int = 0):
        self.num_groups = num_groups
        self.device = device
        self.transport = transport
        self.properties = properties or cluster_properties(
            num_groups, num_servers, device, transport, mesh_devices)
        if transport == "tcp":
            import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers TCP)
            self.network = None
            self.factory = TransportFactory.get("TCP")
            # port 0: each server binds a port the kernel picks, so no
            # other process can take it between choosing and binding
            addresses = ["127.0.0.1:0"] * num_servers
        elif transport == "sim":
            self.network = SimulatedNetwork()
            # the hub's default 3s rpc deadline models a small cluster
            self.network.request_timeout_s = max(
                3.0, RaftServerConfigKeys.Rpc.timeout_min(
                    self.properties).seconds)
            self.factory = SimulatedTransportFactory(self.network)
            addresses = [f"sim:s{i}" for i in range(num_servers)]
        else:
            raise ValueError(f"transport {transport!r}: one of {TRANSPORTS}")
        self.servers = [
            RaftServer(RaftPeerId.value_of(f"s{i}"), a,
                       state_machine_registry=lambda gid: CounterStateMachine(),
                       properties=self.properties,
                       transport_factory=self.factory)
            for i, a in enumerate(addresses)]
        # made by start(), from the addresses the servers listen on
        self.groups: list[RaftGroup] = []
        self._client_transport = None
        self._clients: dict = {}
        # group id -> log index of its last acknowledged write
        self.last_index: dict = {}
        self.prewarm_s = None
        self.bring_up_s = 0.0

    def prewarm(self) -> None:
        """Build the kernels and launch each once (the build is process
        wide, so one engine covers the servers).  Must precede the first
        election: a first-use build inside the event loop would fire
        election timeouts."""
        t0 = time.monotonic()
        self.servers[0].engine.prewarm()
        self.prewarm_s = time.monotonic() - t0

    async def start(self, wave: int = 128, timeout: float = 120.0) -> None:
        """Prewarm unless done, start the servers, make the groups over the
        addresses they listen on, then add the groups (the first alone,
        then in waves) and wait for a ready leader in each."""
        if self.prewarm_s is None:
            self.prewarm()
        t0 = time.monotonic()
        await asyncio.gather(*(s.start() for s in self.servers))
        peers = [RaftPeer(s.peer_id, address=s.transport.address)
                 for s in self.servers]
        self.groups = [RaftGroup.value_of(RaftGroupId.random_id(), peers)
                       for _ in range(self.num_groups)]
        for lo, hi in [(0, 1)] + [(i, i + wave)
                                  for i in range(1, self.num_groups, wave)]:
            batch = self.groups[lo:hi]
            await asyncio.gather(*(s.group_add(g) for g in batch
                                   for s in self.servers))
            await self.wait_leaders(batch, timeout)
        self.bring_up_s = time.monotonic() - t0

    def election_timeouts(self) -> int:
        """Election timeouts fired so far, summed over every division of
        every server: a bring-up fires about one per group, and a rise
        while writes run is election churn."""
        return sum(d.election_metrics.timeout_count.count
                   for s in self.servers for d in s.divisions.values())

    def leader_of(self, group: RaftGroup):
        for s in self.servers:
            d = s.divisions.get(group.group_id)
            if d is not None and d.is_leader() and d.leader_ctx is not None \
                    and d.leader_ctx.leader_ready.done():
                return s
        return None

    async def wait_leaders(self, groups, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        pending = list(groups)
        while pending:
            pending = [g for g in pending if self.leader_of(g) is None]
            if not pending:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(pending)}/{len(groups)} groups "
                                   f"have no ready leader after {timeout}s")
            await asyncio.sleep(0.05)

    def client(self, group: RaftGroup) -> RaftClient:
        """The port's RaftClient for ``group`` (one per group, sharing one
        client transport)."""
        if self._client_transport is None:
            self._client_transport = self.factory.new_client_transport(
                self.properties)
        c = self._clients.get(group.group_id)
        if c is None:
            leader = self.leader_of(group)
            c = (RaftClient.builder().set_raft_group(group)
                 .set_transport(self._client_transport)
                 .set_properties(self.properties)
                 .set_leader_id(leader.peer_id if leader else None)
                 .build())
            self._clients[group.group_id] = c
        return c

    async def write_all(self, writes_per_group: int,
                        concurrency: int = 256) -> dict:
        """``writes_per_group`` sequential INCREMENTs per group, groups
        concurrent under ``concurrency`` writes in flight.  Returns the
        acknowledged count per group, commits/s and commit latency
        percentiles."""
        sem = asyncio.Semaphore(concurrency)
        latencies: list[float] = []
        acked = {g.group_id: 0 for g in self.groups}

        async def group_load(g: RaftGroup) -> None:
            c = self.client(g)
            for _ in range(writes_per_group):
                async with sem:
                    t0 = time.monotonic()
                    reply = await c.io().send(b"INCREMENT")
                    if not reply.success:
                        raise RuntimeError(
                            f"write to {g.group_id} failed: {reply.exception}")
                    latencies.append(time.monotonic() - t0)
                    acked[g.group_id] += 1
                    self.last_index[g.group_id] = reply.log_index

        t0 = time.monotonic()
        await asyncio.gather(*(group_load(g) for g in self.groups))
        elapsed = time.monotonic() - t0
        latencies.sort()
        n = len(latencies)
        return {"acked": acked, "commits": n, "elapsed_s": elapsed,
                "commits_per_sec": n / elapsed,
                "p50_ms": latencies[n // 2] * 1e3,
                "p99_ms": latencies[min(n - 1, n * 99 // 100)] * 1e3}

    async def read_counters(self, timeout: float = 60.0) -> dict:
        """Every group's counter as read from EACH server by a stale read
        at the group's last acknowledged write index: {group id: [counter
        per server]}."""
        deadline = time.monotonic() + timeout

        async def read(g: RaftGroup, s: RaftServer) -> int:
            c = self.client(g)
            min_index = self.last_index.get(g.group_id, 0)
            while True:
                reply = await c.io().send_stale_read(b"GET", min_index,
                                                     s.peer_id)
                if reply.success:
                    return int(reply.message.content)
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{s.peer_id} never applied "
                                       f"{g.group_id} up to {min_index}: "
                                       f"{reply.exception}")
                await asyncio.sleep(0.02)

        out = {}
        for i in range(0, len(self.groups), 256):
            batch = self.groups[i:i + 256]
            vals = await asyncio.gather(*(read(g, s) for g in batch
                                          for s in self.servers))
            k = len(self.servers)
            for j, g in enumerate(batch):
                out[g.group_id] = list(vals[j * k:(j + 1) * k])
        return out

    async def close(self) -> None:
        if self._client_transport is not None:
            await self._client_transport.close()
        await asyncio.gather(*(s.close() for s in self.servers),
                             return_exceptions=True)
