"""Membership console demo.

Capability parity with the reference membership example
(ratis-examples/src/main/java/org/apache/ratis/examples/membership/server/
Console.java:29, RaftCluster.java, CServer.java): an interactive console
hosting an in-process cluster of counter servers on real TCP ports, with
live membership changes driven through setConfiguration:

    update <p1,p2,...>  replace the membership with servers on these ports
    add <port>          add a peer
    remove <port>       remove a peer
    show                print current peers + roles
    incr / query        drive the counter state machine
    quit

Run: ``python -m ratis_tpu_torch.tools.membership_console 5100,5101,5102
[--device cuda|cpu]``
Scriptable via :func:`run_script` (how the test drives it).  Every
server's engine runs on ``device`` (``raft.torch.engine.device``; default
``cuda``, which raises where there is no card).
"""

from __future__ import annotations

import asyncio
import sys
from typing import Optional

from ratis_tpu_torch.client import RaftClient
from ratis_tpu_torch.conf import RaftProperties, RaftServerConfigKeys
from ratis_tpu_torch.models.counter import CounterStateMachine
from ratis_tpu_torch.protocol.group import RaftGroup
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.peer import RaftPeer
from ratis_tpu_torch.server.server import RaftServer


def _peer(port: int) -> RaftPeer:
    return RaftPeer(RaftPeerId.value_of(f"p{port}"),
                    address=f"127.0.0.1:{port}")


class MembershipCluster:
    """In-process counter cluster keyed by port (reference RaftCluster)."""

    def __init__(self, device: str = "cuda"):
        from ratis_tpu_torch.transport import tcp  # registers the factory
        from ratis_tpu_torch.transport.base import TransportFactory
        self.factory = TransportFactory.get("TCP")
        self.properties = RaftProperties()
        self.properties.set(RaftServerConfigKeys.Engine.DEVICE_KEY, device)
        RaftServerConfigKeys.Rpc.set_timeout(self.properties, "300ms", "600ms")
        RaftServerConfigKeys.Log.set_use_memory(self.properties, True)
        self.group_id = RaftGroupId.random_id()
        self.servers: dict[int, RaftServer] = {}
        self._client: Optional[RaftClient] = None

    def group(self) -> RaftGroup:
        return RaftGroup.value_of(
            self.group_id, [_peer(p) for p in sorted(self.servers)])

    async def init(self, ports: list[int]) -> None:
        group = RaftGroup.value_of(self.group_id,
                                   [_peer(p) for p in sorted(ports)])
        for port in ports:
            await self._start_server(port, group)

    async def _start_server(self, port: int, group: Optional[RaftGroup]):
        peer = _peer(port)
        server = RaftServer(
            peer.id, peer.address,
            state_machine_registry=lambda gid: CounterStateMachine(),
            properties=self.properties, transport_factory=self.factory,
            group=group)
        await server.start()
        self.servers[port] = server
        return server

    async def client(self) -> RaftClient:
        if self._client is None:
            self._client = (RaftClient.builder()
                            .set_raft_group(self.group())
                            .set_transport(
                                self.factory.new_client_transport(
                                    self.properties))
                            .build())
        return self._client

    async def _reset_client(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None

    async def update(self, ports: list[int]) -> str:
        """Membership -> exactly ``ports`` (reference RaftCluster.update):
        start newcomers empty, setConfiguration, stop the removed."""
        current = set(self.servers)
        target = set(ports)
        # Newcomers start already hosting the group (reference CServer
        # constructs its RaftServer with the group): they come up as
        # followers and the leader's staging appenders catch them up.
        newcomer_group = RaftGroup.value_of(
            self.group_id, [_peer(p) for p in sorted(target)])
        for port in target - current:
            await self._start_server(port, group=newcomer_group)
        client = await self.client()
        reply = await client.admin().set_configuration(
            [_peer(p) for p in sorted(target)])
        if not reply.success:
            raise RuntimeError(f"setConfiguration failed: {reply.exception}")
        # wait until every member actually hosts the group — the conf commit
        # can land before a bootstrapped newcomer finishes creating its
        # division, and a client could otherwise pick it and get
        # GroupMismatch
        deadline = asyncio.get_running_loop().time() + 10.0
        while any(self.group_id not in self.servers[p].divisions
                  for p in target):
            if asyncio.get_running_loop().time() > deadline:
                raise RuntimeError("new members did not join in time")
            await asyncio.sleep(0.05)
        for port in current - target:
            server = self.servers.pop(port)
            await server.close()
        await self._reset_client()
        return f"membership is now {sorted(target)}"

    async def add(self, port: int) -> str:
        return await self.update(sorted(set(self.servers) | {port}))

    async def remove(self, port: int) -> str:
        return await self.update(sorted(set(self.servers) - {port}))

    async def show(self) -> str:
        lines = []
        for port, server in sorted(self.servers.items()):
            div = server.divisions.get(self.group_id)
            role = div.role.name if div is not None else "(no group)"
            lines.append(f"  {server.peer_id}@{server.address}: {role}")
        return "cluster peers:\n" + "\n".join(lines)

    async def incr(self) -> str:
        client = await self.client()
        reply = await client.io().send(b"INCREMENT")
        if not reply.success:
            raise RuntimeError(str(reply.exception))
        return f"counter = {reply.message.content.decode()}"

    async def query(self) -> str:
        client = await self.client()
        reply = await client.io().send_read_only(b"GET")
        if not reply.success:
            raise RuntimeError(str(reply.exception))
        return f"counter = {reply.message.content.decode()}"

    async def close(self) -> None:
        await self._reset_client()
        for server in self.servers.values():
            await server.close()
        self.servers.clear()


USAGE = """Commands:
  update <p1,p2,..>  replace membership
  add <port>         add a peer
  remove <port>      remove a peer
  show               list peers and roles
  incr               increment the counter
  query              read the counter
  quit               exit"""


async def execute(cluster: MembershipCluster, line: str) -> Optional[str]:
    parts = line.strip().split()
    if not parts:
        return ""
    cmd = parts[0].lower()
    if cmd == "show":
        return await cluster.show()
    if cmd == "add":
        return await cluster.add(int(parts[1]))
    if cmd == "remove":
        return await cluster.remove(int(parts[1]))
    if cmd == "update":
        return await cluster.update(
            [int(x) for x in parts[1].split(",") if x])
    if cmd == "incr":
        return await cluster.incr()
    if cmd == "query":
        return await cluster.query()
    if cmd == "quit":
        return None
    return USAGE


async def run_script(initial_ports: list[int], commands: list[str],
                     device: str = "cuda") -> list[str]:
    """Drive the console non-interactively; returns one output per command."""
    cluster = MembershipCluster(device)
    await cluster.init(initial_ports)
    out = []
    try:
        for line in commands:
            result = await execute(cluster, line)
            if result is None:
                break
            out.append(result)
    finally:
        await cluster.close()
    return out


async def _interactive(ports: list[int], device: str) -> None:
    cluster = MembershipCluster(device)
    await cluster.init(ports)
    print("Raft membership example.", USAGE, sep="\n")
    try:
        while True:
            line = await asyncio.to_thread(input, "> ")
            try:
                result = await execute(cluster, line)
            except Exception as e:  # keep the console alive on bad input
                print(f"error: {e}")
                continue
            if result is None:
                break
            print(result)
    finally:
        await cluster.close()


def main() -> None:
    argv = sys.argv[1:]
    device = "cuda"
    if len(argv) == 3 and argv[1] == "--device":
        device = argv[2]
    elif len(argv) != 1:
        print("usage: python -m ratis_tpu_torch.tools.membership_console "
              "<port1,port2,...> [--device cuda|cpu]")
        sys.exit(2)
    ports = [int(x) for x in argv[0].split(",")]
    asyncio.run(_interactive(ports, device))


if __name__ == "__main__":
    main()
