"""In-process chaos cluster harness: kill/restart, tail truncation, and
multi-group bring-up — the cluster the scenario engine drives.

Shape parity with the test MiniCluster (itself the reference
MiniRaftCluster analog, ratis-server/src/test/.../impl/MiniRaftCluster.java:86)
but packaged INSIDE ``ratis_tpu`` so the replay tool and the bench
campaign can build one without importing the test tree, and extended
with the pieces chaos needs: multi-group hosting at the batched shape
(appointed-leader wave bring-up, like tools/bench_cluster), durable
storage with crash-time tail truncation, and ``raft.tpu.chaos.enabled``
armed so every transport consults the link-fault table.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import List, Optional

from ratis_tpu_torch.chaos.faults import (find_group_current_dirs,
                                    find_shared_shard_dirs,
                                    truncate_log_tail,
                                    truncate_shared_log_tail)
from ratis_tpu_torch.chaos.link import link_faults
from ratis_tpu_torch.conf import RaftProperties, RaftServerConfigKeys
from ratis_tpu_torch.models.counter import CounterStateMachine
from ratis_tpu_torch.protocol.exceptions import (LeaderNotReadyException,
                                           NotLeaderException, RaftException)
from ratis_tpu_torch.protocol.group import RaftGroup
from ratis_tpu_torch.protocol.ids import ClientId, RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.message import Message
from ratis_tpu_torch.protocol.peer import RaftPeer
from ratis_tpu_torch.protocol.requests import RaftClientRequest, write_request_type
from ratis_tpu_torch.server.division import Division
from ratis_tpu_torch.server.server import RaftServer
from ratis_tpu_torch.server.statemachine import (BaseStateMachine,
                                           TransactionContext)
from ratis_tpu_torch.transport.simulated import (SimulatedNetwork,
                                           SimulatedTransportFactory)

LOG = logging.getLogger(__name__)

DEFAULT_TIMEOUT = 15.0

_handed_out_ports: set[int] = set()


def _free_port() -> int:
    """Bind-then-close port allocation that never hands the same port out
    twice in this process (same race fix as the test MiniCluster)."""
    import socket
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in _handed_out_ports:
            _handed_out_ports.add(port)
            return port


class ChaosRecordingStateMachine(BaseStateMachine):
    """Records every applied payload in order — the exactly-once /
    replica-agreement oracle for small scenario clusters (the reference's
    SimpleStateMachine4Testing role)."""

    def __init__(self) -> None:
        super().__init__()
        self.applied: List[bytes] = []

    async def start_transaction(self, request) -> TransactionContext:
        return TransactionContext(client_request=request,
                                  log_data=request.message.content)

    async def apply_transaction(self, trx: TransactionContext) -> Message:
        e = trx.log_entry
        payload = (e.smlog.log_data if e is not None and e.smlog is not None
                   else (trx.log_data or b""))
        self.applied.append(payload)
        if e is not None:
            self.update_last_applied_term_index(e.term, e.index)
        return Message.value_of(str(len(self.applied)))

    async def query(self, request: Message) -> Message:
        return Message.value_of(str(len(self.applied)))

    async def query_stale(self, request: Message, min_index: int) -> Message:
        return await self.query(request)


def chaos_properties(num_groups: int = 1, batched: Optional[bool] = None,
                     seed: int = 0, device: str = "cuda") -> RaftProperties:
    """Chaos-armed cluster properties.  Small clusters get the fast
    election timeouts the test MiniCluster uses; the 1024-group batched
    shape reuses the bench's density-scaled cost model so the campaign
    stresses exactly the configuration the perf rungs measure.  Every
    engine runs on ``device`` (``raft.torch.engine.device``)."""
    if num_groups >= 64 or batched:
        # the harness's batched deployment: the JAX bench's
        # bench_properties(batched=True, num_groups) key for key
        if batched is False:
            raise ValueError("the port's harness runs the batched "
                             "deployment only")
        from ratis_tpu_torch.tools.cluster import cluster_properties
        p = cluster_properties(num_groups, 3, device, "sim")
    else:
        p = RaftProperties()
        RaftServerConfigKeys.Rpc.set_timeout(p, "100ms", "200ms")
        p.set("raft.tpu.engine.tick-interval", "5ms")
        RaftServerConfigKeys.Log.set_use_memory(p, True)
        p.set(RaftServerConfigKeys.Engine.DEVICE_KEY, device)
    p.set(RaftServerConfigKeys.Chaos.ENABLED_KEY, "true")
    p.set(RaftServerConfigKeys.Chaos.SEED_KEY, str(seed))
    return p


class ChaosCluster:
    """``num_servers`` in-process peers hosting ``num_groups`` sibling
    groups, with crash/restart (plus durable tail truncation) and the
    chaos link-fault plane armed on every transport."""

    def __init__(self, num_servers: int = 3, num_groups: int = 1,
                 properties: Optional[RaftProperties] = None,
                 transport: str = "sim", sm: str = "recording",
                 storage_root: Optional[str] = None, seed: int = 0):
        self.num_servers = num_servers
        self.num_groups = num_groups
        self.transport = transport
        self.seed = seed
        self.properties = (properties if properties is not None
                           else chaos_properties(num_groups, seed=seed))
        self.properties = self.properties.clone()
        self.properties.set(RaftServerConfigKeys.Chaos.ENABLED_KEY, "true")
        # Continuous telemetry ON for chaos clusters (unless the caller
        # pinned it): a failing scenario attaches every server's flight
        # recorder window to its replay artifact, so the campaign's
        # post-mortem carries the rate history across the fault, not just
        # the final snapshot.  Fast cadence — scenarios last seconds.
        tk = RaftServerConfigKeys.Telemetry
        if self.properties.get(tk.ENABLED_KEY) is None:
            self.properties.set(tk.ENABLED_KEY, "true")
        if self.properties.get(tk.INTERVAL_KEY) is None:
            self.properties.set(tk.INTERVAL_KEY, "200ms")
        self.storage_root = storage_root
        if storage_root is not None:
            RaftServerConfigKeys.Log.set_use_memory(self.properties, False)
            RaftServerConfigKeys.set_storage_dir(self.properties,
                                                 str(storage_root))
        if transport in ("tcp", "grpc"):
            from ratis_tpu_torch.transport.base import TransportFactory
            if transport == "grpc":
                import ratis_tpu_torch.transport.grpc  # noqa: F401 (GRPC)
            import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers TCP)
            self.network = None
            self.factory = TransportFactory.get(
                "GRPC" if transport == "grpc" else "TCP")
            addr = lambda i: f"127.0.0.1:{_free_port()}"
        elif transport == "sim":
            self.network = SimulatedNetwork()
            self.factory = SimulatedTransportFactory(self.network)
            addr = lambda i: f"sim:s{i}"
            # density-scaled rpc deadline, like BenchCluster: a
            # legitimately-busy handler at thousands of co-hosted groups
            # must not blow the sim's small-cluster 3s default
            self.network.request_timeout_s = max(
                3.0, RaftServerConfigKeys.Rpc.timeout_min(
                    self.properties).seconds)
        else:
            raise ValueError(f"unknown chaos transport {transport!r}")
        self.peers = [RaftPeer(RaftPeerId.value_of(f"s{i}"), address=addr(i))
                      for i in range(num_servers)]
        self.groups = [RaftGroup.value_of(RaftGroupId.random_id(), self.peers)
                       for _ in range(num_groups)]
        if sm == "counter":
            self._sm_factory = CounterStateMachine
        else:
            self._sm_factory = ChaosRecordingStateMachine
        self.servers: dict[RaftPeerId, RaftServer] = {}
        self._dead: dict[RaftPeerId, RaftPeer] = {}
        self._call_ids = itertools.count(1)
        self._leader_hint: dict[RaftGroupId, RaftPeerId] = {}
        link_faults().reseed(seed)

    # ---------------------------------------------------------- lifecycle

    def _new_server(self, peer: RaftPeer) -> RaftServer:
        return RaftServer(
            peer.id, peer.address,
            state_machine_registry=lambda gid: self._sm_factory(),
            properties=self.properties, transport_factory=self.factory,
            group=self.groups[0])

    async def start(self, appoint: bool = True,
                    leader_timeout: float = 60.0) -> None:
        for peer in self.peers:
            self.servers[peer.id] = self._new_server(peer)
        await asyncio.gather(*(s.start() for s in self.servers.values()))
        first = self.peers[0].id
        wave = 128
        for i in range(1, len(self.groups), wave):
            batch = self.groups[i:i + wave]
            await asyncio.gather(*(s.group_add(g) for g in batch
                                   for s in self.servers.values()))
            if appoint:
                await self._appoint(batch, first)
        if appoint:
            await self._appoint(self.groups[:1], first)
        await self.wait_all_leaders(timeout=leader_timeout)

    async def _appoint(self, groups: list[RaftGroup],
                       server_id: RaftPeerId) -> None:
        """Appointed-leader bootstrap (deployment-mode bring-up; elections
        remain the fallback for any group the bootstrap cannot claim)."""
        server = self.servers[server_id]
        boots = []
        for g in groups:
            d = server.divisions.get(g.group_id)
            if d is not None and d.is_follower():
                boots.append(server.bootstrap_division(g.group_id))
        if boots:
            await asyncio.gather(*boots, return_exceptions=True)

    async def close(self) -> None:
        link_faults().heal_all()
        if self.network is not None:
            self.network.unblock_all()
        await asyncio.gather(*(s.close() for s in self.servers.values()),
                             return_exceptions=True)
        self.servers.clear()

    # ------------------------------------------------------- fault plane

    async def kill(self, peer_id: RaftPeerId) -> None:
        """Crash one server (close is the sharpest crash an in-process
        harness can deliver; in-flight RPCs toward it start failing)."""
        server = self.servers.pop(peer_id)
        self._dead[peer_id] = next(p for p in self.peers if p.id == peer_id)
        await server.close()

    async def restart(self, peer_id: RaftPeerId,
                      truncate_tail: int = 0) -> RaftServer:
        """Restart a killed server; with durable storage,
        ``truncate_tail`` first drops that many entries off every hosted
        group's log tail on disk (the lost-write-back-cache crash)."""
        peer = self._dead.pop(peer_id, None) \
            or next(p for p in self.peers if p.id == peer_id)
        if truncate_tail and self.storage_root is not None:
            root = f"{self.storage_root}/{peer_id}"
            for current in find_group_current_dirs(root):
                truncate_log_tail(current, truncate_tail)
            # shared log plane (raft.tpu.log.shared): the tail lives in
            # the per-shard interleaved segments, one chop per shard
            for shard in find_shared_shard_dirs(root):
                truncate_shared_log_tail(shard, truncate_tail)
        server = self._new_server(peer)
        self.servers[peer_id] = server
        await server.start()
        # memory-log multi-group restarts have nothing on disk to
        # boot-scan: re-add the hosted groups (empty logs; the leaders
        # re-replicate everything — the volatile-restart recovery shape)
        for g in self.groups:
            if g.group_id not in server.divisions:
                await server.group_add(g)
        return server

    def emit_fault_event(self, kind: str, detail: str,
                         fault_id: str) -> None:
        """Journal one fault event through every live server's watchdog —
        the /events plane is the campaign's flight recorder."""
        for s in self.servers.values():
            if s.watchdog is not None:
                s.watchdog.emit(kind, None, detail, fault=fault_id)

    def flight_snapshots(self, reason: str) -> list[dict]:
        """Every live server's flight-recorder window (telemetry-enabled
        servers only) — the scenario runner attaches these to a failing
        run's replay artifact."""
        out = []
        for s in self.servers.values():
            if s.flight is not None:
                try:
                    out.append(s.flight.snapshot(reason))
                except Exception:
                    LOG.exception("flight snapshot of %s failed", s.peer_id)
        return out

    # ------------------------------------------------------------ queries

    def live_peer_ids(self) -> list[RaftPeerId]:
        return sorted(self.servers, key=str)

    def all_peer_ids(self) -> list[RaftPeerId]:
        return [p.id for p in self.peers]

    def divisions(self, gid: Optional[RaftGroupId] = None) -> list[Division]:
        gid = gid or self.groups[0].group_id
        return [s.divisions[gid] for s in self.servers.values()
                if gid in s.divisions]

    def leaders(self, gid: Optional[RaftGroupId] = None) -> list[Division]:
        return [d for d in self.divisions(gid) if d.is_leader()]

    async def wait_for_leader(self, gid: Optional[RaftGroupId] = None,
                              timeout: float = DEFAULT_TIMEOUT) -> Division:
        """One leader at the top term, with no rival at that term."""
        gid = gid or self.groups[0].group_id
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            leaders = self.leaders(gid)
            if leaders:
                top = max(leaders, key=lambda d: d.state.current_term)
                if all(d.state.current_term < top.state.current_term
                       for d in leaders if d is not top):
                    self._leader_hint[gid] = top.member_id.peer_id
                    return top
            await asyncio.sleep(0.02)
        raise TimeoutError(
            f"no leader for {gid} after {timeout}s; roles: "
            f"{[(str(d.member_id.peer_id), d.role.name, d.state.current_term) for d in self.divisions(gid)]}")

    async def wait_all_leaders(self, timeout: float = 60.0,
                               groups: Optional[list] = None) -> float:
        """Every group has a READY leader (startup entry committed);
        returns how long convergence took — the re-election SLO number."""
        t0 = time.monotonic()
        pending = {g.group_id for g in (groups or self.groups)}
        deadline = t0 + timeout
        while pending and time.monotonic() < deadline:
            done = set()
            for gid in pending:
                for s in self.servers.values():
                    d = s.divisions.get(gid)
                    if d is not None and d.is_leader() \
                            and d.leader_ctx is not None \
                            and d.leader_ctx.leader_ready.done():
                        self._leader_hint[gid] = d.member_id.peer_id
                        done.add(gid)
                        break
            pending -= done
            if pending:
                await asyncio.sleep(0.05)
        if pending:
            raise TimeoutError(
                f"{len(pending)}/{len(groups or self.groups)} groups have "
                f"no ready leader after {timeout}s")
        return time.monotonic() - t0

    async def wait_quiesced(self, timeout: float = 60.0,
                            groups: Optional[list] = None) -> None:
        """Replication + apply drained: on every group, each live replica
        applied up to the leader's committed index."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        gids = [g.group_id for g in (groups or self.groups)]
        while loop.time() < deadline:
            settled = True
            for gid in gids:
                divs = self.divisions(gid)
                leaders = [d for d in divs if d.is_leader()]
                if not leaders:
                    settled = False
                    break
                commit = max(int(d.state.log.get_last_committed_index())
                             for d in leaders)
                if any(d.applied_index < commit for d in divs):
                    settled = False
                    break
            if settled:
                return
            await asyncio.sleep(0.05)
        raise TimeoutError(f"cluster did not quiesce within {timeout}s")

    # ------------------------------------------------------------- client

    def new_client(self, group: Optional[RaftGroup] = None,
                   retry_policy=None):
        """A full RaftClient (retry + failover + retry-cache-correct call
        ids) bound to one group — the writer the invariants trust."""
        from ratis_tpu_torch.client import RaftClient
        return (RaftClient.builder()
                .set_raft_group(group or self.groups[0])
                .set_transport(
                    self.factory.new_client_transport(self.properties))
                .set_retry_policy(retry_policy)
                .set_properties(self.properties)
                .build())

    async def write(self, gid: RaftGroupId, message: bytes = b"INCREMENT",
                    client=None, client_id: Optional[ClientId] = None,
                    timeout: float = 30.0) -> bool:
        """One write with leader-hint failover on a raw client transport
        (the campaign's high-volume driver; a fixed (client_id, call_id)
        pair per payload keeps retries retry-cache-deduped)."""
        own = client is None
        if own:
            client = self.factory.new_client_transport(self.properties)
        client_id = client_id or ClientId.random_id()
        call_id = next(self._call_ids)
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        target = self._leader_hint.get(gid) or next(iter(self.servers), None)
        try:
            while loop.time() < deadline:
                server = self.servers.get(target) if target else None
                if server is None:
                    live = self.live_peer_ids()
                    if not live:
                        await asyncio.sleep(0.05)
                        continue
                    target = live[0]
                    continue
                req = RaftClientRequest(client_id, target, gid, call_id,
                                        Message.value_of(message),
                                        type=write_request_type(),
                                        timeout_ms=8000.0)
                try:
                    reply = await asyncio.wait_for(
                        client.send_request(server.address, req), 10.0)
                except (RaftException, asyncio.TimeoutError, OSError):
                    await asyncio.sleep(0.05)
                    live = self.live_peer_ids()
                    if live:
                        target = live[(live.index(target) + 1) % len(live)] \
                            if target in live else live[0]
                    continue
                if reply.success:
                    self._leader_hint[gid] = target
                    return True
                exc = reply.exception
                if isinstance(exc, NotLeaderException):
                    if exc.suggested_leader is not None:
                        target = exc.suggested_leader.id
                    else:
                        live = self.live_peer_ids()
                        target = live[(live.index(target) + 1) % len(live)] \
                            if target in live else (live[0] if live else None)
                    await asyncio.sleep(0.02)
                    continue
                if isinstance(exc, LeaderNotReadyException):
                    await asyncio.sleep(0.02)
                    continue
                return False
            return False
        finally:
            if own:
                try:
                    await client.close()
                except Exception:
                    pass
