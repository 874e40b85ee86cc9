"""An in-process multi-Raft cluster of the port's servers.

``num_servers`` port ``RaftServer``s over one ``SimulatedNetwork``
(``transport="sim"``) or over real sockets on ``127.0.0.1``
(``transport="tcp"``, the framed transport of ``transport/tcp.py``, or
``transport="grpc"``, ``transport/grpc.py``, which needs ``grpcio``; each
server on a port the kernel picks when it binds, the groups made from the
ports the servers got), each hosting the same ``num_groups`` sibling
groups with a ``CounterStateMachine`` (``sm="counter"``), an
``ArithmeticStateMachine`` (``sm="arithmetic"``) or a
``FileStoreStateMachine`` (``sm="filestore"``), every group's consensus
ticked by one ``QuorumEngine`` per server on ``device``.  With
``datastream=True`` every server also serves the DataStream plane on
localhost TCP, on a port the kernel picks when it binds (before any group
exists), and every group's peers advertise those addresses.  Without a
storage dir the groups keep the in-memory log, as the JAX bench does;
with ``cluster_properties(..., storage_dir=, shared_log=)`` they take the
server's default durable log (per-group segment files under
``<storage_dir>/<peer>``, or the shared log plane), and ``restart()``
closes every server and starts new ones on the same storage and
addresses, recovering the groups from disk.  The properties
are the batched multi-Raft deployment of the JAX package's bench harness
(``ratis_tpu/tools/bench_cluster.py``, ``bench_properties`` with
``batched=True``): the batched engine on every tick
(scalar-fallback-threshold 0), appender and heartbeat coalescing, wire
write coalescing, the GC discipline, timeouts scaled to the channel
count, the default stall watchdog (so the ledger pass runs), and host-path
tracing when asked; ``cluster_properties(..., batched=False)`` is the
same harness's scalar control (``bench_properties(batched=False)``), whose
engines never leave the per-division host loop.

Leaders come from ordinary randomized-timeout elections (every round goes
through the batched vote tally), group by group in waves; writes go
through the port's ``RaftClient``; counters are read back from every
replica through stale reads.  Arithmetic writes are the JAX bench's
(``arithmetic_message``); the harness keeps every acknowledged write's
``(log index, message)``, and ``check_variables()`` holds every replica's
variable map to the fold of those writes in log order.  FileStore writes
are the JAX bench's (``filestore_message``: a 128-byte file through the
log); ``stream_file()`` streams a file's bytes over the DataStream plane
(``stream_payload``: seeded bytes, so a packet lost or out of order
shows), and ``check_files()`` holds every replica's files, names, sizes
and bytes, to the acknowledged writes and streams.  With
``sm_storage_root`` every group's state machine keeps its snapshots in
``{root}/{peer}/{group}`` (the in-memory log purges what a snapshot
covers), and ``wipe(server, groups)`` removes a server's replicas and
adds them afresh, on the engine rows they released.

    cluster = Cluster(num_groups=1024, device="cuda", transport="tcp")
    cluster.prewarm()             # optional: start() prewarms otherwise
    await cluster.start()
    stats = await cluster.write_all(writes_per_group=4)
    counters = await cluster.read_counters()
    await cluster.close()

    cluster = Cluster(16, device="cpu", transport="tcp", sm="arithmetic",
                      properties=cluster_properties(16, 3, "cpu", "tcp",
                                                    storage_dir=tmp))
    await cluster.start()
    await cluster.write_all(4)
    await cluster.check_variables()
    await cluster.restart()       # recovery from disk, same addresses
    await cluster.check_variables()
    await cluster.close()

    cluster = Cluster(8, device="cpu", transport="tcp", sm="filestore",
                      datastream=True)
    await cluster.start()
    await cluster.write_all(2)
    reply = await cluster.stream_file(cluster.groups[0], "s.bin",
                                      stream_payload(0, 0, 1 << 20),
                                      packet=64 << 10, window=16)
    await cluster.check_files()
    await cluster.close()
"""

from __future__ import annotations

import asyncio
import gc
import math
import os
import time

import msgpack
import numpy as np

from ratis_tpu_torch.client.client import RaftClient
from ratis_tpu_torch.conf import RaftProperties, RaftServerConfigKeys
from ratis_tpu_torch.conf.keys import WireConfigKeys
from ratis_tpu_torch.engine.engine import QuorumEngine
from ratis_tpu_torch.models.arithmetic import (ArithmeticStateMachine,
                                               evaluate)
from ratis_tpu_torch.models.counter import CounterStateMachine
from ratis_tpu_torch.models.filestore import FileStoreStateMachine
from ratis_tpu_torch.protocol.group import RaftGroup
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.peer import RaftPeer
from ratis_tpu_torch.retry.policies import (ClientRetryEvent, RetryAction,
                                            RetryPolicy)
from ratis_tpu_torch.util.timeduration import TimeDuration
from ratis_tpu_torch.server.datastream import DataStreamManagement
from ratis_tpu_torch.server.server import RaftServer
from ratis_tpu_torch.transport.base import TransportFactory
from ratis_tpu_torch.transport.simulated import (SimulatedNetwork,
                                                 SimulatedTransportFactory)

TRANSPORTS = ("sim", "tcp", "grpc")
STATE_MACHINES = {"counter": CounterStateMachine,
                  "arithmetic": ArithmeticStateMachine,
                  "filestore": FileStoreStateMachine}
# the JAX bench's FileStore write: a file of this many bytes through the log
FILE_WRITE_BYTES = 128
# the JAX bench's traced rung: every 16th write traced end to end
TRACE_SAMPLE = 16
# the JAX snapshot rung's wipes: this many groups removed and added at once
WIPE_WAVE = 256
# the harness's clients retry every 100 ms for two of the cluster's
# longest election timeouts (a lost leader, a split vote, the next
# election), never fewer than the client's default 50 times: 50 at the
# 1 s / 2 s tier, 160 at the durable rungs' 4 s / 8 s
RETRY_SLEEP_MS = 100
RETRY_MIN = 50
# the scalar control's clients retry a call for the JAX harness's write
# budget instead, on the wall clock (its _write gives up 60 s after the
# write began, 240 s at 8192 groups and more): the one loop, walking every
# group each 2 ms tick beside one heartbeat stream per group and follower,
# can starve one write that long while the aggregate moves
SCALAR_RETRY_S = 60.0
SCALAR_RETRY_LARGE_S = 240.0
SCALAR_RETRY_LARGE_GROUPS = 8192
# the routes of a server's HTTP endpoint (raft.tpu.metrics.http-port) with
# telemetry on (raft.tpu.telemetry.enabled): Prometheus text, then JSON
HTTP_ROUTES = ("/metrics", "/health", "/divisions", "/events", "/lag",
               "/timeseries", "/hotgroups", "/flightrecorder")


def arithmetic_message(k: int) -> bytes:
    """The k-th write of the JAX bench's arithmetic workload (BASELINE
    config 2's ``var = expression`` shape): its factory draws two values
    of one global counter per message, ``v{a % 7}={b % 97}+1``."""
    return f"v{2 * k % 7}={(2 * k + 1) % 97}+1".encode()


def filestore_message(k: int) -> tuple[str, bytes, bytes]:
    """The k-th write of the JAX bench's FileStore workload
    (``run_mixed_bench``'s message factory): ``(path, data, message)``, a
    128-byte file ``w{k}`` written through the log."""
    path, data = f"w{k}", b"x" * FILE_WRITE_BYTES
    return path, data, msgpack.packb({"op": "write", "path": path,
                                      "data": data}, use_bin_type=True)


def stream_payload(seed: int, stream: int, nbytes: int) -> bytes:
    """The bytes of stream ``stream`` of a run seeded ``seed``: a numpy
    pattern of its own per stream (the JAX bench streams one constant
    byte, which hides a packet lost or landed out of order)."""
    rng = np.random.default_rng([seed, stream])
    return rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()


def fold_writes(writes) -> dict:
    """The plain reference of the arithmetic state machine: the variable
    map that ``(log index, message)`` writes give, applied in log
    order."""
    variables: dict = {}
    for _, msg in sorted(writes):
        var, _, expression = msg.decode().partition("=")
        variables[var.strip()] = evaluate(expression.strip(), variables)
    return variables


def fs_type(path: str) -> str:
    """The filesystem type ``/proc/mounts`` gives the mount holding
    ``path`` (on tmpfs an fsync writes nothing to a device)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt = parts[1]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) >= len(best):
                    best, kind = mnt, parts[2]
    except OSError:
        pass
    return kind


def log_fsyncs() -> int:
    """fsyncs issued so far by the process's live log workers (per open
    segment file with per-group logs, per shard on the shared plane)."""
    from ratis_tpu_torch.server.log.segmented import LogWorker
    return sum(w.sync_count for w in LogWorker._instances.values())


def log_sync_seconds(servers) -> list[float]:
    """Seconds each of ``servers`` has spent in its log workers' fsyncs so
    far: the ``syncTime`` timer (``metrics/server_metrics.py``) of every
    worker its logs write through (one per storage root with per-group
    segment files, one per shard on the shared plane), summed per
    server."""
    from ratis_tpu_torch.server.log.segmented import LogWorker
    return [sum(w.registry_metrics.sync_timer._total_s
                for key, w in LogWorker._instances.items()
                if key.startswith(f"{s.peer_id}:")) for s in servers]


def sync_keys(before: list, after: list, window_s: float) -> dict:
    """The durable results' fsync keys from ``log_sync_seconds`` before
    and after a write window of ``window_s``: each server's seconds of
    fsync in it (``sync_time_s``) and their share of the window
    (``sync_share``; the workers sync in threads, so shares of servers
    that sync at once may add up to more than 1)."""
    spent = [b - a for a, b in zip(before, after)]
    return {"sync_time_s": spent,
            "sync_share": [t / max(window_s, 1e-9) for t in spent]}


def cluster_properties(num_groups: int, num_servers: int = 3,
                       device: str = "cuda", transport: str = "sim",
                       mesh_devices: int = 0, storage_dir: str = None,
                       shared_log: bool = False,
                       trace: bool = False,
                       hibernate: bool = False,
                       trace_sample: int = TRACE_SAMPLE,
                       loop_shards: int = 1,
                       batched: bool = True) -> RaftProperties:
    """The deployment of ``num_groups`` groups on ``num_servers`` servers:
    the JAX bench's ``bench_properties(batched, num_groups,
    num_servers=..., transport=..., mesh_devices=..., trace=...,
    hibernate=..., loop_shards=...)`` key for key, plus the port's engine
    device.  ``batched`` (the default) is the batched deployment: the
    batched engine on every tick (scalar-fallback-threshold 0) at a 20 ms
    cadence, appender and heartbeat coalescing, wire write coalescing.
    ``batched=False`` is the JAX bench's scalar control, the reference's
    cost shape: a 2 ms tick whose threshold of 10^9 active groups keeps
    every tick on the per-division host loop (no kernel but the ledger's
    runs), one RPC per group and follower (no coalescing of any kind) and
    no replication sweep; ``hibernate`` needs the coalesced heartbeats and
    applies to the batched deployment only.  ``loop_shards`` > 1 runs
    every server's divisions on that
    many event loops, each division pinned to one
    (``raft.tpu.server.loop-shards``, ``server/shards.py``).
    ``hibernate`` lets an idle group's leader stop heartbeating it and its
    followers arm the long backstop deadline (``raft.tpu.hibernate.*``;
    it rides the coalesced heartbeats).  ``mesh_devices`` > 0 runs every
    engine as that many slices of its group batch (``parallel/mesh.py``);
    ``trace`` records the host-path stage spans of every
    ``trace_sample``-th write (``trace/``).  With
    ``storage_dir`` the log is the server's default durable one there
    (``raft.server.log.use.memory=false``), per group or, with
    ``shared_log``, the shared plane (``raft.tpu.log.shared``), as the
    JAX bench's durable rungs set it."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r}: one of {TRANSPORTS}")
    p = RaftProperties()
    if loop_shards > 1:
        p.set(RaftServerConfigKeys.LOOP_SHARDS_KEY, str(loop_shards))
    channels = num_groups * max(num_servers - 1, 1)
    if channels >= 2048:
        # a busy handler at thousands of channels outlives a 3s deadline
        p.set(RaftServerConfigKeys.Rpc.REQUEST_TIMEOUT_KEY, "8s")
    if channels >= 32768:
        RaftServerConfigKeys.Rpc.set_timeout(p, "24s", "48s")
    elif channels >= 16384:
        RaftServerConfigKeys.Rpc.set_timeout(p, "8s", "16s")
    elif channels >= (2048 if transport == "grpc" else 4096):
        # the costlier grpc.aio transport takes this tier from 2048
        # channels (the JAX bench's tiers)
        RaftServerConfigKeys.Rpc.set_timeout(p, "4s", "8s")
    else:
        RaftServerConfigKeys.Rpc.set_timeout(p, "1s", "2s")
    # batched: commits advance inline at ack intake; the tick drives
    # timeouts and staleness, so a 20ms cadence batches more events per
    # launch.  Scalar: the reference's per-division cadence.
    p.set(RaftServerConfigKeys.Engine.TICK_INTERVAL_KEY,
          "20ms" if batched else "2ms")
    # pre-sized: adding the groups never regrows the resident batch
    p.set(RaftServerConfigKeys.Engine.MAX_GROUPS_KEY,
          str(max(QuorumEngine._bucket(num_groups), 64)))
    p.set(RaftServerConfigKeys.Engine.DEVICE_KEY, device)
    if mesh_devices:
        p.set(RaftServerConfigKeys.Engine.MESH_DEVICES_KEY, str(mesh_devices))
    RaftServerConfigKeys.Log.set_use_memory(p, storage_dir is None)
    if storage_dir is not None:
        RaftServerConfigKeys.set_storage_dir(p, storage_dir)
        RaftServerConfigKeys.TpuLog.set_shared(p, shared_log)
    if trace:
        p.set(RaftServerConfigKeys.Trace.ENABLED_KEY, "true")
        p.set(RaftServerConfigKeys.Trace.SAMPLE_EVERY_KEY, str(trace_sample))
    # heap discipline: tuned collector thresholds, one seal after bring-up,
    # a steady-state re-freeze every 15s (the memory log never purges)
    p.set(RaftServerConfigKeys.Gc.DISCIPLINE_KEY, "true")
    p.set(RaftServerConfigKeys.Gc.REFREEZE_INTERVAL_KEY, "15s")
    if not batched:
        # one Python pass per group per event and one RPC per (group,
        # follower) batch, with per-request replication scheduling
        p.set(RaftServerConfigKeys.Engine.SCALAR_FALLBACK_THRESHOLD_KEY,
              "1000000000")
        p.set(RaftServerConfigKeys.Log.Appender.COALESCING_ENABLED_KEY,
              "false")
        p.set(RaftServerConfigKeys.Heartbeat.COALESCING_ENABLED_KEY, "false")
        p.set(RaftServerConfigKeys.Replication.SWEEP_KEY, "0")
        return p
    p.set(RaftServerConfigKeys.Engine.SCALAR_FALLBACK_THRESHOLD_KEY, "0")
    p.set(RaftServerConfigKeys.Log.Appender.COALESCING_ENABLED_KEY, "true")
    p.set(RaftServerConfigKeys.Heartbeat.COALESCING_ENABLED_KEY, "true")
    # wire write coalescing: pending frames leave in one buffered flush per
    # connection, at 128KB or after 100us (the gRPC pair as the JAX bench
    # sets it)
    p.set(WireConfigKeys.Tcp.FLUSH_BYTES_KEY, "128KB")
    p.set(WireConfigKeys.Tcp.FLUSH_MICROS_KEY, "100")
    p.set(WireConfigKeys.Grpc.FLUSH_MICROS_KEY, "100")
    p.set(WireConfigKeys.Grpc.FLUSH_CHUNKS_KEY, "64")
    if hibernate:
        p.set(RaftServerConfigKeys.Hibernate.ENABLED_KEY, "true")
    return p


def is_batched(properties) -> bool:
    """Whether ``properties`` are the batched deployment (every tick on the
    batched engine), not the scalar control (``cluster_properties(...,
    batched=False)``)."""
    key = RaftServerConfigKeys.Engine
    return properties.get_int(key.SCALAR_FALLBACK_THRESHOLD_KEY,
                              key.SCALAR_FALLBACK_THRESHOLD_DEFAULT) == 0


class RetryForDuration(RetryPolicy):
    """Retry a call every ``sleep_ms`` until ``budget_s`` have passed on
    the wall clock since its first failed attempt (a call keeps its call
    id across retries), then give up."""

    def __init__(self, budget_s: float, sleep_ms: int):
        self.budget_s = budget_s
        self.sleep = TimeDuration.valueOf(f"{sleep_ms}ms")
        self._first_failure: dict[int, float] = {}

    def handle_attempt_failure(self, event: ClientRetryEvent) -> RetryAction:
        now = time.monotonic()
        call = event.request.call_id
        if event.attempt_count == 1:
            # calls that failed and later succeeded leave an entry behind
            self._first_failure = {c: t for c, t
                                   in self._first_failure.items()
                                   if now - t <= self.budget_s}
            self._first_failure[call] = now
        if now - self._first_failure.get(call, now) > self.budget_s:
            self._first_failure.pop(call, None)
            return RetryAction(False)
        return RetryAction(True, self.sleep)

    def __str__(self) -> str:
        return f"RetryForDuration({self.budget_s}s, sleep {self.sleep})"


def client_retry_policy(properties, num_groups: int):
    """The harness clients' retry policy for a cluster of ``num_groups``
    groups on ``properties``: ``RETRY_MIN`` to two of the longest election
    timeouts' worth of attempts ``RETRY_SLEEP_MS`` apart, or on the scalar
    control (``is_batched`` false) the JAX harness's wall-clock write
    budget (``SCALAR_RETRY_S``, ``SCALAR_RETRY_LARGE_S`` from
    ``SCALAR_RETRY_LARGE_GROUPS`` groups)."""
    from ratis_tpu_torch.retry.policies import RetryPolicies
    if not is_batched(properties):
        return RetryForDuration(
            SCALAR_RETRY_LARGE_S if num_groups >= SCALAR_RETRY_LARGE_GROUPS
            else SCALAR_RETRY_S, RETRY_SLEEP_MS)
    longest = RaftServerConfigKeys.Rpc.timeout_max(properties).seconds
    attempts = max(RETRY_MIN, math.ceil(2e3 * longest / RETRY_SLEEP_MS))
    return RetryPolicies.retry_up_to_maximum_count_with_fixed_sleep(
        attempts, f"{RETRY_SLEEP_MS}ms")


def bring_up_wave(cluster) -> int:
    """Groups per bring-up wave: a tenth, at least 128.  Election timeouts
    grow with the channel count (8-16 s at 10240 groups), so a bring-up
    takes about ten waves at any size."""
    return max(128, cluster.num_groups // 10)


async def sealed(cluster, bring_up) -> None:
    """Await ``bring_up`` (``cluster.start(...)`` or ``restart(...)``),
    then seal the heap.  Bring-up allocates long-lived objects only, so
    the collector stays off until the servers' one deliberate seal (the
    JAX bench's scaffold)."""
    gc.disable()
    try:
        await bring_up
        cluster.servers[0].seal_heap()
    finally:
        gc.enable()


class Cluster:
    def __init__(self, num_groups: int, num_servers: int = 3,
                 device: str = "cuda", properties=None,
                 transport: str = "sim", mesh_devices: int = 0,
                 sm: str = "counter", datastream: bool = False,
                 sm_storage_root: str = None):
        if sm not in STATE_MACHINES:
            raise ValueError(f"sm {sm!r}: one of {sorted(STATE_MACHINES)}")
        self.num_groups = num_groups
        self.device = device
        self.transport = transport
        self.sm = sm
        self.datastream = datastream
        self.sm_storage_root = sm_storage_root
        self.properties = properties or cluster_properties(
            num_groups, num_servers, device, transport, mesh_devices)
        if transport in ("tcp", "grpc"):
            if transport == "tcp":
                import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers)
            else:
                import ratis_tpu_torch.transport.grpc  # noqa: F401
            self.network = None
            self.factory = TransportFactory.get(transport.upper())
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
        self.servers = self._new_servers(addresses)
        # made by start(), from the addresses the servers listen on
        self.groups: list[RaftGroup] = []
        self._client_transport = None
        self._clients: dict = {}
        # group id -> log index of its last acknowledged write
        self.last_index: dict = {}
        # group id -> [(log index, message)] of its acknowledged writes
        self.acked_writes: dict = {}
        # group id -> {path: bytes} of its acknowledged FileStore writes
        # and streams
        self.acked_files: dict = {}
        # arithmetic or FileStore messages drawn so far (their k)
        self._messages = 0
        self.prewarm_s = None
        self.bring_up_s = 0.0
        self.restart_s = None

    def _new_servers(self, addresses, datastream_addresses=None
                     ) -> list[RaftServer]:
        """Servers on ``addresses``; with ``datastream``, each with its
        DataStream plane on the matching entry of ``datastream_addresses``
        (default ``127.0.0.1:0``), which the server's ``start()`` binds."""
        servers = [RaftServer(peer, a,
                              state_machine_registry=self._registry(peer),
                              properties=self.properties,
                              transport_factory=self.factory)
                   for peer, a in ((RaftPeerId.value_of(f"s{i}"), a)
                                   for i, a in enumerate(addresses))]
        if self.datastream:
            for s, a in zip(servers, datastream_addresses
                            or ["127.0.0.1:0"] * len(servers)):
                s.datastream = DataStreamManagement(s, a)
        return servers

    def _registry(self, peer_id):
        """The state machine registry of server ``peer_id``: a fresh state
        machine per group; with ``sm_storage_root`` its snapshot storage
        in ``{root}/{peer_id}/{group_id}`` (the JAX bench's real snapshot
        storage under the in-memory log, ``BenchCluster._registry_for``)."""
        sm, root = STATE_MACHINES[self.sm], self.sm_storage_root
        if root is None:
            return lambda gid: sm()

        def registry(gid):
            m = sm()
            m.get_state_machine_storage().init(f"{root}/{peer_id}/{gid}")
            return m
        return registry

    async def wipe(self, server: RaftServer, groups) -> None:
        """Wipe ``server``'s replicas of ``groups``: ``group_remove``, then
        a fresh ``group_add`` of the same group, in waves of ``WIPE_WAVE``
        (the JAX snapshot rung's in-memory analog of losing a disk).  The new
        divisions start from an empty log and reuse the engine rows the
        old ones released.  Each wiped replica's snapshot directory
        (``sm_storage_root``) goes too, so a snapshot it holds afterwards
        is one a leader installed."""
        import shutil
        for i in range(0, len(groups), WIPE_WAVE):
            batch = groups[i:i + WIPE_WAVE]
            await asyncio.gather(*(server.group_remove(g.group_id)
                                   for g in batch))
            if self.sm_storage_root is not None:
                # off the loop, which the cluster's elections and
                # heartbeats share
                await asyncio.to_thread(lambda: [shutil.rmtree(
                    f"{self.sm_storage_root}/{server.peer_id}/{g.group_id}",
                    ignore_errors=True) for g in batch])
            await asyncio.gather(*(server.group_add(g) for g in batch))

    def datastream_address(self, server: RaftServer):
        """The DataStream address ``server`` listens on, or None."""
        if server.datastream is None:
            return None
        port = server.datastream.bound_port
        if not port:
            raise RuntimeError(f"{server.peer_id}: DataStream plane not "
                               f"bound")
        return f"127.0.0.1:{port}"

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
        peers = [RaftPeer(s.peer_id, address=s.transport.address,
                          datastream_address=self.datastream_address(s))
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

    def hibernated_groups(self) -> int:
        """Groups whose leader sleeps now (``Division._hibernating``, set
        on the leader), summed over every server: the JAX bench's
        ``hibernated_groups``."""
        return sum(1 for s in self.servers for d in s.divisions.values()
                   if d._hibernating)

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
                 .set_retry_policy(client_retry_policy(self.properties,
                                                       self.num_groups))
                 .build())
            self._clients[group.group_id] = c
        return c

    async def write_all(self, writes_per_group: int,
                        concurrency: int = 256,
                        active_groups: int = None) -> dict:
        """``writes_per_group`` sequential writes per group, groups
        concurrent under ``concurrency`` writes in flight (only the first
        ``active_groups`` groups when given, the sparse shape where the
        rest stay idle): INCREMENTs, or
        the arithmetic or FileStore workload's messages, drawn from one
        counter group by group within each round of writes (so every
        group's sequence, its variable map and its file names are the
        same from run to run).  Returns the acknowledged count per group,
        commits/s and commit latency percentiles."""
        sem = asyncio.Semaphore(concurrency)
        latencies: list[float] = []
        groups = self.groups[:active_groups]
        acked = {g.group_id: 0 for g in groups}
        base, n_groups = self._messages, len(groups)
        if self.sm in ("arithmetic", "filestore"):
            self._messages += writes_per_group * n_groups

        async def group_load(i: int, g: RaftGroup) -> None:
            c = self.client(g)
            writes = self.acked_writes.setdefault(g.group_id, [])
            files = self.acked_files.setdefault(g.group_id, {})
            for w in range(writes_per_group):
                k = base + w * n_groups + i
                if self.sm == "filestore":
                    path, data, msg = filestore_message(k)
                else:
                    msg = (arithmetic_message(k) if self.sm == "arithmetic"
                           else b"INCREMENT")
                async with sem:
                    t0 = time.monotonic()
                    reply = await c.io().send(msg)
                    if not reply.success:
                        raise RuntimeError(
                            f"write to {g.group_id} failed: {reply.exception}")
                    latencies.append(time.monotonic() - t0)
                    acked[g.group_id] += 1
                    self.last_index[g.group_id] = reply.log_index
                    writes.append((reply.log_index, msg))
                    if self.sm == "filestore":
                        files[path] = data

        t0 = time.monotonic()
        await asyncio.gather(*(group_load(i, g)
                               for i, g in enumerate(groups)))
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

    async def check_variables(self, timeout: float = 60.0) -> int:
        """Hold every replica's variable map to the plain reference: once
        each replica has applied its group up to the last acknowledged
        write, its ``ArithmeticStateMachine.variables`` must equal the fold
        of the group's acknowledged writes in log order.  An acknowledged
        write that is missing fails.  Returns the replicas checked."""
        if self.sm != "arithmetic":
            raise ValueError("check_variables needs sm='arithmetic'")
        deadline = time.monotonic() + timeout
        checked = 0
        for g in self.groups:
            want = fold_writes(self.acked_writes.get(g.group_id, ()))
            last = self.last_index.get(g.group_id, -1)
            for s in self.servers:
                d = s.divisions.get(g.group_id)
                if d is None:
                    raise AssertionError(f"{s.peer_id} does not host "
                                         f"{g.group_id}")
                sm = d.state_machine
                while sm.get_last_applied_term_index().index < last:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{s.peer_id} applied {g.group_id} only up to "
                            f"{sm.get_last_applied_term_index().index} of "
                            f"{last}")
                    await asyncio.sleep(0.02)
                if sm.variables != want:
                    raise AssertionError(
                        f"{s.peer_id} {g.group_id}: variables "
                        f"{sm.variables} != the fold of its acknowledged "
                        f"writes {want}")
                checked += 1
        return checked

    async def stream_file(self, group: RaftGroup, path: str, data: bytes,
                          packet: int, window: int):
        """Stream ``data`` into file ``path`` of ``group`` over the
        DataStream plane, as the JAX bench's stream loads do: a client of
        its own, a ``stream`` header, ``packet``-byte packets with at most
        ``window`` unacknowledged, then the close, which commits the file
        through the log.  Returns the close's reply; an acknowledged
        stream joins the files ``check_files()`` holds every replica
        to."""
        if not self.datastream:
            raise ValueError("stream_file needs datastream=True")
        transport = self.factory.new_client_transport(self.properties)
        client = (RaftClient.builder().set_raft_group(group)
                  .set_transport(transport)
                  .set_properties(self.properties).build())
        try:
            cmd = msgpack.packb({"op": "stream", "path": path},
                                use_bin_type=True)
            out = await client.data_stream().stream(cmd, window=window)
            for off in range(0, len(data), packet):
                await out.write_async(data[off:off + packet])
            reply = await out.close_async()
        finally:
            await client.close()
            await transport.close()
        if reply.success:
            gid = group.group_id
            self.acked_files.setdefault(gid, {})[path] = data
            self.last_index[gid] = max(self.last_index.get(gid, 0),
                                       reply.log_index)
        return reply

    async def check_files(self, timeout: float = 60.0) -> dict:
        """Hold every replica's FileStore to the plain reference: once each
        replica has applied its group up to the last acknowledged write or
        stream, its ``FileStoreStateMachine.files`` must name exactly the
        acknowledged files with their sizes, and each file's bytes on its
        disk must equal what was written or streamed.  A file missing,
        short, extra or with other bytes fails.  Returns {group position:
        {path: size}} (the same on every replica)."""
        if self.sm != "filestore":
            raise ValueError("check_files needs sm='filestore'")
        deadline = time.monotonic() + timeout
        out = {}
        for i, g in enumerate(self.groups):
            want = self.acked_files.get(g.group_id, {})
            sizes = {p: len(b) for p, b in want.items()}
            last = self.last_index.get(g.group_id, -1)
            for s in self.servers:
                d = s.divisions.get(g.group_id)
                if d is None:
                    raise AssertionError(f"{s.peer_id} does not host "
                                         f"{g.group_id}")
                sm = d.state_machine
                while sm.get_last_applied_term_index().index < last:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{s.peer_id} applied {g.group_id} only up to "
                            f"{sm.get_last_applied_term_index().index} of "
                            f"{last}")
                    await asyncio.sleep(0.02)
                if sm.files != sizes:
                    raise AssertionError(
                        f"{s.peer_id} {g.group_id}: files {sm.files} != "
                        f"the acknowledged writes and streams {sizes}")
                paths = sorted(want)
                got = await asyncio.to_thread(
                    lambda: [sm.resolve(p).read_bytes() for p in paths])
                for p, b in zip(paths, got):
                    if b != want[p]:
                        raise AssertionError(
                            f"{s.peer_id} {g.group_id}: {p} holds "
                            f"{len(b)} bytes that differ from the "
                            f"{len(want[p])} acknowledged")
            out[i] = sizes
        return out

    def http_addresses(self) -> list[str]:
        """Each server's HTTP endpoint, ``127.0.0.1:<bound port>``."""
        out = []
        for s in self.servers:
            http = s.metrics_http
            if http is None or http.address is None:
                raise RuntimeError(f"{s.peer_id} serves no HTTP endpoint "
                                   f"(raft.tpu.metrics.http-port unset)")
            out.append(http.address)
        return out

    async def fetch_routes(self, timeout: float = 30.0) -> dict:
        """GET every one of ``HTTP_ROUTES`` from every server over HTTP:
        {peer: {route: body}}, ``/metrics`` parsed as Prometheus text
        ({sample: value}), the others as JSON; ``/lag`` asks for every
        group (``?n=<groups>``).  A route that does not answer 200 or does
        not parse raises."""
        from ratis_tpu_torch.metrics.aggregate import (fetch_json, fetch_text,
                                                 parse_prometheus_text)
        out = {}
        for s, address in zip(self.servers, self.http_addresses()):
            got = {}
            for route in HTTP_ROUTES:
                if route == "/metrics":
                    got[route] = parse_prometheus_text(
                        await fetch_text(address, route, timeout))
                else:
                    query = f"?n={self.num_groups}" if route == "/lag" else ""
                    got[route] = await fetch_json(address, route + query,
                                                  timeout)
            out[str(s.peer_id)] = got
        return out

    def watch_lag(self) -> list:
        """From now on each ``GET /lag`` of each server also records, at
        the instant the route runs, the commit index of every row it leads
        in the ledger sample the route took, beside the leading division's
        own: appends ``(peer, {group id: (ledger commit, division commit)},
        payload)`` to the returned list."""
        seen: list = []
        for s in self.servers:
            routes = s.metrics_http.json_routes

            def lag(query, s=s, route=routes["/lag"]):
                payload = route(query)
                sample = s.engine.ledger.last_sample
                rows = {}
                for slot in np.nonzero(sample.leader_mask)[0]:
                    d = s.engine._listeners.get(int(slot))
                    if d is not None:
                        rows[d.group_id] = (
                            int(sample.commit[slot]),
                            d.state.log.get_last_committed_index())
                seen.append((str(s.peer_id), rows, payload))
                return payload
            routes["/lag"] = lag
        return seen

    async def restart(self, timeout: float = 120.0) -> None:
        """Close every server, then build and start new ones on the same
        storage and the same addresses (a TCP server rebinds the port it
        had: the recovered confs name it) and wait for a ready leader in
        every group.  The groups come back from the servers' boot scan of
        their storage, not from the harness; ``restart_s`` is the time
        from the new servers' start to every group having a leader."""
        if RaftServerConfigKeys.Log.use_memory(self.properties):
            raise ValueError("restart needs durable storage (a storage "
                             "dir in cluster_properties)")
        addresses = [s.transport.address for s in self.servers]
        streams = [self.datastream_address(s) for s in self.servers]
        await self._close_clients()
        await asyncio.gather(*(s.close() for s in self.servers))
        # the kernels stay built and loaded in the process: no prewarm
        self.servers = self._new_servers(addresses, streams)
        t0 = time.monotonic()
        await asyncio.gather(*(s.start() for s in self.servers))
        want = {g.group_id for g in self.groups}
        for s in self.servers:
            if set(s.divisions) != want:
                raise AssertionError(
                    f"{s.peer_id} recovered {len(s.divisions)} of "
                    f"{len(want)} groups from its storage")
        await self.wait_leaders(self.groups, timeout)
        self.restart_s = time.monotonic() - t0

    async def _close_clients(self) -> None:
        if self._client_transport is not None:
            await self._client_transport.close()
        self._client_transport = None
        self._clients = {}

    async def close(self) -> None:
        await self._close_clients()
        await asyncio.gather(*(s.close() for s in self.servers),
                             return_exceptions=True)
