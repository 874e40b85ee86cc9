"""The multi-process deployment on the port: one process per peer, each
server's divisions on its loop shards, the load from client processes
(the JAX package's ``run_multiproc_bench``,
``ratis_tpu/tools/bench_cluster.py``).

    python -m ratis_tpu_torch.tools.bench --rungs peer5_mp    # on the card
    python -m ratis_tpu_torch.tools.bench --rungs peer5_mp --device cpu \\
        --groups 8 --writes 2

    out = await run_multiproc_bench(1024, 2, num_servers=5, loop_shards=3,
                                    client_procs=4, device="cuda")

Every peer runs as ``python -m ratis_tpu_torch.tools.multiproc_bench
--server``: its own ``RaftServer`` with its own ``QuorumEngine`` on
``device``, its divisions on ``loop_shards`` event loops
(``raft.tpu.server.loop-shards``), the batched deployment of
``tools/cluster.py`` over localhost TCP, ``CounterStateMachine`` on the
in-memory log, the HTTP endpoint and the telemetry sampler on.  The load
runs in ``client_procs`` processes (``--client``), each writing
``writes_per_group`` INCREMENTs to every group of its share of the
groups, ``concurrency`` split among them.

Protocol (newline-delimited over each child's stdin/stdout, the JAX
harness's lines plus ``PEERS`` and ``COUNTERS``):

- parent -> server: one JSON spec line, then ``PEERS <json>``,
  ``ADDGROUPS``, ``APPOINT`` (server 0), ``SEAL``, ``RESET_TRACE``,
  ``TRACEDUMP <path>``, ``COUNTERS <json>``, ``TRANSFER``, ``REPORT``,
  ``EXIT``;
- server -> parent: ``MPSTARTED <raft port> <http port>``, ``MPPEERS``,
  ``MPADDED``, ``MPREADY <s>``, ``MPSEALED``, ``MPTRACED``,
  ``MPTRACEDUMPED``, ``MPCOUNTERS <json>``, ``MPTRANSFERRED <group>
  <0|1>``, ``MPREPORT <json>``;
- parent -> client: one JSON spec line; client -> parent:
  ``MPRESULT <json>``.

Where it differs from the JAX harness (``PERF.md`` section 4):

- each server carries the engine's device (``raft.torch.engine.device``,
  ``cuda`` unless asked); a server asked for ``cuda`` where there is no
  card raises, and client processes never touch CUDA (their result says
  whether ``torch.cuda`` was initialized in them: it must not be);
- each server binds ``127.0.0.1:0`` and reports the port it got in
  ``MPSTARTED``; the parent then sends the peer table (``PEERS``) and the
  servers build their groups from it: no port is chosen before the
  process that binds it;
- ``REPORT`` also carries the engine's device and the process's kernel
  launches (K1-K7, counted from after its prewarm); with
  ``record_plans``, also what its prepared calls were given
  (``tools/plan_recorder.py``: the kernels' shapes, the vote rounds'
  members, its ledger samples with their library calls and K4 launches,
  its prepared calls made off the home loop's thread); every server
  reports, not only the first;
- ``COUNTERS`` answers every group's counter once it has reached the
  writes the clients had acknowledged (at most ``COUNTERS_WAIT_S``);
  each client reports, per group, the writes it had acknowledged and
  those it sent, and keeps a write's call id across its retries (the JAX
  harness draws a new one), so every counter on every replica must lie
  between the two (``replica_mismatches`` counts those that do not);
- after the load, each server in turn (server 0 last) takes the
  leadership of one group it does not lead by a leadership transfer
  (``TRANSFER``): one election on every server, whose vote round its
  engine tallies (the JAX harness's appointed leaders leave a server
  that never timed out with no vote round at all); a transfer that
  fails is answered as failed (``transfers_failed``), not raised;
- each child's stderr goes to a file of a temporary directory; on any
  failure the parent raises with the last ``TAIL_LINES`` lines of every
  child that exited or stopped answering;
- the kernels are built by the parent before any child starts, so the
  children only load them;
- the children's flags are ``--server`` and ``--client``: the JAX
  harness's ``--mp-server`` / ``--mp-client`` are what the JAX package's
  tests look for among every process of the machine once their own run
  ends;
- the ``counter`` state machine only.

``live_children(pids)`` lists those of a run's ``child_pids`` still
running: the harness kills and reaps every child when it ends, so none
is.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]
# the JAX harness's appointment batches and waits, its group waves
APPOINT_BATCH = 256
APPOINT_WAIT_S = 300.0
ADD_WAVE = 512
# a server's wait for its counters to reach the acknowledged writes
COUNTERS_WAIT_S = 60.0
# lines of each failed child's stderr in the parent's error
TAIL_LINES = 40
# a client write's retry budget: the JAX harness's, by its share of groups
WRITE_BUDGET_S = (60.0, 240.0)
WRITE_BUDGET_GROUPS = 8192


def _foreign_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process (a
    child reports them: the port loads none)."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "ratis_tpu")
                  or m.startswith(("jax.", "ratis_tpu.")))


def _properties(spec: dict, num_groups: int, num_servers: int,
                device: str):
    """A child's properties: the batched deployment of ``num_groups``
    groups on ``num_servers`` servers over TCP (``cluster_properties``)
    with the spec's tracing and loop shards."""
    from ratis_tpu_torch.tools.cluster import cluster_properties
    return cluster_properties(num_groups, num_servers, device, "tcp",
                              trace=spec.get("trace", False),
                              trace_sample=spec.get("trace_sample", 32),
                              loop_shards=spec.get("loop_shards", 1))


def _groups(peer_table: list, gids_hex: list) -> list:
    from ratis_tpu_torch.protocol.group import RaftGroup
    from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
    from ratis_tpu_torch.protocol.peer import RaftPeer
    peers = [RaftPeer(RaftPeerId.value_of(pid), address=addr)
             for pid, addr in peer_table]
    return [RaftGroup.value_of(RaftGroupId.value_of(bytes.fromhex(h)), peers)
            for h in gids_hex]


# ------------------------------------------------------------ server child

def _mp_server_main() -> None:
    """One cluster peer as its own process (``--server``)."""
    spec = json.loads(sys.stdin.readline())
    gc.disable()  # bring-up heap discipline, as the in-process harness
    asyncio.run(_mp_server(spec))


async def _mp_server(spec: dict) -> None:
    import torch

    import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers TCP)
    from ratis_tpu_torch.conf import RaftServerConfigKeys
    from ratis_tpu_torch.models.counter import CounterStateMachine
    from ratis_tpu_torch.protocol.ids import RaftPeerId
    from ratis_tpu_torch.server.server import RaftServer
    from ratis_tpu_torch.tools.plan_recorder import (ShapeRecorder,
                                                     kernel_launchers)
    from ratis_tpu_torch.transport.base import TransportFactory

    index, device = spec["peer_index"], spec["device"]
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"server {index}: engine device {device!r} "
                           f"asked for, but CUDA is not available")
    gids_hex = spec["groups"]
    properties = _properties(spec, len(gids_hex), spec["num_servers"],
                             device)
    # every server serves its HTTP endpoint on a port it binds (reported
    # in MPSTARTED, scraped and merged at the end) and samples telemetry
    properties.set(RaftServerConfigKeys.Metrics.HTTP_PORT_KEY, "0")
    properties.set(RaftServerConfigKeys.Telemetry.ENABLED_KEY, "true")
    server = RaftServer(RaftPeerId.value_of(f"s{index}"), "127.0.0.1:0",
                        state_machine_registry=lambda gid:
                        CounterStateMachine(),
                        properties=properties,
                        transport_factory=TransportFactory.get("TCP"))
    # the kernels are built (by the parent) and launched once before the
    # server elects; the launch counts start after that
    server.engine.prewarm()
    kernels = kernel_launchers()
    for k in kernels.values():
        k.launches = 0
    # the recorder swaps the plans' calls for counting ones: on only when
    # asked, so a timed run carries none of it
    recorder = (ShapeRecorder().__enter__() if spec.get("record_plans")
                else None)
    await server.start()
    http = server.metrics_http
    print(f"MPSTARTED {server.transport.address.rsplit(':', 1)[1]} "
          f"{http.bound_port if http is not None else 0}", flush=True)

    groups: list = []
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        cmd, _, arg = line.strip().partition(" ")
        if not line or cmd == "EXIT":
            # no graceful unwind of thousands of divisions: the OS
            # reclaims the process, as the JAX harness's children do
            os._exit(0)
        elif cmd == "PEERS":
            groups = _groups(json.loads(arg), gids_hex)
            print("MPPEERS", flush=True)
        elif cmd == "ADDGROUPS":
            for i in range(0, len(groups), ADD_WAVE):
                await asyncio.gather(*(server.group_add(g)
                                       for g in groups[i:i + ADD_WAVE]))
            print("MPADDED", flush=True)
        elif cmd == "APPOINT":
            t0 = time.monotonic()
            await _appoint(server, groups)
            print(f"MPREADY {time.monotonic() - t0:.2f}", flush=True)
        elif cmd == "SEAL":
            server.seal_heap()
            gc.enable()
            print("MPSEALED", flush=True)
        elif cmd == "RESET_TRACE":
            from ratis_tpu_torch.trace import get_tracer
            get_tracer().reset()
            print("MPTRACED", flush=True)
        elif cmd == "TRACEDUMP":
            from ratis_tpu_torch.trace import get_tracer
            from ratis_tpu_torch.trace.export import write_chrome_trace
            write_chrome_trace(arg, get_tracer().snapshot())
            print("MPTRACEDUMPED", flush=True)
        elif cmd == "REPORT":
            print("MPREPORT " + json.dumps(_report(server, spec, kernels,
                                                    recorder)), flush=True)
        elif cmd == "COUNTERS":
            counters = await _counters(server, groups, json.loads(arg))
            print("MPCOUNTERS " + json.dumps(counters), flush=True)
        elif cmd == "TRANSFER":
            h, ok = await _take_leadership(server, groups)
            print(f"MPTRANSFERRED {h} {int(ok)}", flush=True)


async def _appoint(server, groups: list) -> None:
    """Server 0 bootstraps itself as every group's leader, in batches, and
    waits until each group has a ready leader here or a leader known
    elsewhere (a follower election that won first); exits 3 if a batch
    is not ready within ``APPOINT_WAIT_S``."""
    for i in range(0, len(groups), APPOINT_BATCH):
        batch = groups[i:i + APPOINT_BATCH]
        res = await asyncio.gather(*(server.bootstrap_division(g.group_id)
                                     for g in batch), return_exceptions=True)
        for r in res:
            if isinstance(r, BaseException):
                print(f"multiproc server: bootstrap fell back: {r}",
                      file=sys.stderr, flush=True)
        deadline = time.monotonic() + APPOINT_WAIT_S
        pending = {g.group_id for g in batch}
        while pending and time.monotonic() < deadline:
            pending = {gid for gid in pending if not _has_leader(server, gid)}
            if pending:
                await asyncio.sleep(0.05)
        if pending:
            print(f"multiproc server: {len(pending)} groups not ready "
                  f"after {APPOINT_WAIT_S:.0f}s", file=sys.stderr, flush=True)
            os._exit(3)


def _has_leader(server, gid) -> bool:
    d = server.divisions.get(gid)
    if d is None:
        return False
    if d.is_leader():
        return d.leader_ctx is not None and d.leader_ctx.leader_ready.done()
    return d.state.leader_id is not None


def _report(server, spec: dict, kernels: dict, recorder) -> dict:
    engine = server.engine
    report = {
        "pid": os.getpid(),
        "peer": str(server.peer_id),
        "device": str(engine.device),
        "launches": {k: fn.launches for k, fn in kernels.items()},
        "engine": {k: engine.metrics.get(k, 0)
                   for k in ("ticks", "batched_dispatches",
                             "commit_advances")},
        "engine_occupancy": round(len(engine.state.active)
                                  / engine.state.capacity, 4),
        "engine_shape": {"capacity": engine.state.capacity,
                         "peers": engine.state.max_peers,
                         "ledger_width": engine.ledger._table_width()},
        "watchdog_events": (server.watchdog.event_count()
                            if server.watchdog is not None else 0),
        "append_rewinds": server.replication.metrics.get("rewinds", 0),
        # one server per process: the process-wide hop counters line up
        # with this engine's commits
        "reply_hops_per_commit": server.reply_hops_per_commit(),
        "divisions": len(server.divisions),
        "loop_shards": server.loop_shards,
        "shards_used": len({server.shard_of_group(g)
                            for g in server.divisions}),
        "foreign_modules": _foreign_modules(),
    }
    if recorder is not None:
        report.update(recorder.report())
    if spec.get("trace"):
        from ratis_tpu_torch.trace import get_tracer
        from ratis_tpu_torch.trace.export import host_path_decomposition
        report["host_path_decomposition"] = host_path_decomposition(
            get_tracer().snapshot())
    return report


async def _counters(server, groups: list, acked: dict) -> dict:
    """Every group's counter on this server once it has reached the
    writes acknowledged to the clients (``acked``: group hex -> count;
    at most ``COUNTERS_WAIT_S``): group hex -> counter, or None where the
    server does not host the group."""
    def value(g):
        d = server.divisions.get(g.group_id)
        return None if d is None else d.state_machine.counter

    deadline = time.monotonic() + COUNTERS_WAIT_S
    while time.monotonic() < deadline:
        if all((value(g) or 0) >= acked.get(g.group_id.to_bytes().hex(), 0)
               for g in groups):
            break
        await asyncio.sleep(0.05)
    return {g.group_id.to_bytes().hex(): value(g) for g in groups}


async def _take_leadership(server, groups: list) -> tuple[str, bool]:
    """Ask, through a client of this process, for the leadership of the
    first group this server does not lead to move here: this server's
    election (its vote round tallied by its engine, K3).  Returns the
    group's hex id and whether the transfer succeeded; a transfer that
    raised (a client timeout) did not, and its error goes to stderr."""
    from ratis_tpu_torch.client.client import RaftClient
    from ratis_tpu_torch.transport.base import TransportFactory
    g = next(g for g in groups
             if not server.divisions[g.group_id].is_leader())
    transport = TransportFactory.get("TCP").new_client_transport(
        server.properties)
    client = (RaftClient.builder().set_raft_group(g)
              .set_transport(transport)
              .set_properties(server.properties).build())
    try:
        reply = await client.admin().transfer_leadership(server.peer_id)
        ok = reply.success
    except Exception as e:
        print(f"multiproc server: transfer of {g.group_id} failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        ok = False
    finally:
        await client.close()
        await transport.close()
    return g.group_id.to_bytes().hex(), ok


# ------------------------------------------------------------ client child

def _mp_client_main() -> None:
    """One load-generator share as its own process (``--client``)."""
    spec = json.loads(sys.stdin.readline())
    asyncio.run(_mp_client(spec))


async def _mp_client(spec: dict) -> None:
    import itertools

    import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers TCP)
    from ratis_tpu_torch.protocol.exceptions import (
        LeaderNotReadyException, NotLeaderException, RaftException)
    from ratis_tpu_torch.protocol.ids import (ClientId, RaftGroupId,
                                              RaftPeerId)
    from ratis_tpu_torch.protocol.message import Message
    from ratis_tpu_torch.protocol.requests import (RaftClientRequest,
                                                   write_request_type)
    from ratis_tpu_torch.trace import configure_from_properties
    from ratis_tpu_torch.trace.tracer import STAGE_CLIENT, TRACER
    from ratis_tpu_torch.transport.base import TransportFactory

    gids_hex = spec["groups"]
    # the servers' wire and trace keys; the client builds no engine
    properties = _properties(spec, len(gids_hex), len(spec["peers"]),
                             "cpu")
    # a client builds no RaftServer: the process tracer is enabled here
    configure_from_properties(properties)
    peers = [(RaftPeerId.value_of(pid), addr) for pid, addr in spec["peers"]]
    by_id = dict(peers)
    client = TransportFactory.get("TCP").new_client_transport(properties)
    writes = spec["writes"]
    call_ids = itertools.count(1)
    leader_hint: dict = {}
    sem = asyncio.Semaphore(max(1, spec.get("concurrency", 32)))
    latencies: list[float] = []
    failures: list[str] = []
    acked = {h: 0 for h in gids_hex}
    sent = {h: 0 for h in gids_hex}
    budget = WRITE_BUDGET_S[len(gids_hex) >= WRITE_BUDGET_GROUPS]

    async def one_write(client_id, gid) -> None:
        pid, addr = leader_hint.get(gid, peers[0])
        # one call id for every attempt: the server's retry cache applies
        # the write at most once, so the sent count bounds the counter
        call_id = next(call_ids)
        deadline = time.monotonic() + budget
        i = 0
        while True:
            trace_id = TRACER.begin_trace()
            req = RaftClientRequest(client_id, pid, gid, call_id,
                                    Message.value_of(b"INCREMENT"),
                                    type=write_request_type(),
                                    timeout_ms=10_000.0, trace_id=trace_id)
            t0 = TRACER.now() if trace_id else 0
            try:
                reply = await client.send_request(addr, req)
            except (RaftException, asyncio.TimeoutError, OSError):
                reply = None
            finally:
                if trace_id:
                    TRACER.record(trace_id, STAGE_CLIENT, t0, TRACER.now())
            if reply is not None and reply.success:
                leader_hint[gid] = (pid, addr)
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"write to {gid} kept failing")
            exc = reply.exception if reply is not None else None
            if isinstance(exc, NotLeaderException) \
                    and exc.suggested_leader is not None \
                    and exc.suggested_leader.id in by_id:
                pid = exc.suggested_leader.id
                addr = by_id[pid]
            elif isinstance(exc, LeaderNotReadyException):
                await asyncio.sleep(0.01)
            else:
                i += 1
                pid, addr = peers[i % len(peers)]
                await asyncio.sleep(0.01)

    async def group_load(h: str) -> None:
        gid = RaftGroupId.value_of(bytes.fromhex(h))
        client_id = ClientId.random_id()
        for _ in range(writes):
            async with sem:
                t0 = time.monotonic()
                sent[h] += 1
                try:
                    await one_write(client_id, gid)
                except TimeoutError as e:
                    failures.append(h)
                    print(f"multiproc client: WRITE FAILED {gid}: {e}",
                          file=sys.stderr, flush=True)
                    continue
                acked[h] += 1
                latencies.append(time.monotonic() - t0)

    wall_start = time.time()
    t0 = time.monotonic()
    await asyncio.gather(*(group_load(h) for h in gids_hex))
    elapsed = time.monotonic() - t0
    torch = sys.modules.get("torch")
    out = {
        "pid": os.getpid(),
        "commits": len(latencies),
        "failures": len(failures),
        "elapsed_s": round(elapsed, 3),
        "wall_start": wall_start,
        "wall_end": time.time(),
        "lat_ms": [round(x * 1e3, 1) for x in latencies],
        "acked": acked,
        "sent": sent,
        "cuda_initialized": bool(torch is not None
                                 and torch.cuda.is_initialized()),
        "foreign_modules": _foreign_modules(),
    }
    if spec.get("trace"):
        from ratis_tpu_torch.trace import get_tracer
        from ratis_tpu_torch.trace.export import host_path_decomposition
        out["client_decomp"] = host_path_decomposition(
            get_tracer().snapshot())
    print("MPRESULT " + json.dumps(out), flush=True)
    os._exit(0)


# ------------------------------------------------------------------ parent

class _Child:
    """A child process, its name and the file its stderr goes to."""

    def __init__(self, who: str, proc, log_path: str):
        self.who, self.proc, self.log_path = who, proc, log_path
        self.stalled = False

    async def send(self, line: str) -> None:
        self.proc.stdin.write((line + "\n").encode())
        await self.proc.stdin.drain()

    async def wait_line(self, prefix: str, timeout_s: float) -> str:
        try:
            return await _mp_wait_line(self.proc, prefix, timeout_s,
                                       self.who)
        except TimeoutError:
            self.stalled = True
            raise

    async def ask(self, line: str, prefix: str, timeout_s: float) -> str:
        await self.send(line)
        return await self.wait_line(prefix, timeout_s)

    def tail(self) -> str:
        try:
            with open(self.log_path, errors="replace") as f:
                lines = f.read().splitlines()[-TAIL_LINES:]
        except OSError as e:
            lines = [f"(no stderr: {e})"]
        state = ("stopped answering" if self.stalled
                 else f"exited {self.proc.returncode}")
        return (f"\n--- {self.who} (pid {self.proc.pid}, {state}), its "
                f"last {len(lines)} stderr lines:\n" + "\n".join(lines))


async def _mp_wait_line(proc, prefix: str, timeout_s: float, who: str) -> str:
    """Read the child's stdout until a ``prefix`` line (stray lines pass
    through to stderr so child diagnostics stay visible)."""
    deadline = time.monotonic() + timeout_s
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"{who}: no {prefix} within {timeout_s}s")
        try:
            line = await asyncio.wait_for(proc.stdout.readline(), remaining)
        except TimeoutError:
            raise TimeoutError(f"{who}: no {prefix} within {timeout_s}s")
        if not line:
            await proc.wait()
            raise RuntimeError(f"{who} exited before {prefix} "
                               f"(rc={proc.returncode})")
        text = line.decode(errors="replace").rstrip()
        if text.startswith(prefix):
            return text
        print(f"bench[{who}]: {text}", file=sys.stderr, flush=True)


def live_children(pids) -> list[int]:
    """Those of ``pids`` that are still a running process of this
    harness (``--server`` or ``--client``)."""
    alive = []
    for pid in pids:
        try:
            cmdline = pathlib.Path(f"/proc/{pid}/cmdline").read_bytes()
            stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
        except OSError:
            continue
        if stat.rsplit(")", 1)[1].split()[0] == "Z":
            continue  # exited, not yet reaped
        args = cmdline.split(b"\0")
        if b"ratis_tpu_torch.tools.multiproc_bench" in args and (
                b"--server" in args or b"--client" in args):
            alive.append(pid)
    return alive


async def run_multiproc_bench(num_groups: int, writes_per_group: int, *,
                              num_servers: int = 5,
                              device: str = "cuda",
                              loop_shards: int = 1,
                              client_procs: int = 4,
                              concurrency: int = 128,
                              trace: bool = False,
                              trace_sample: int = 32,
                              trace_out: Optional[str] = None,
                              record_plans: bool = False,
                              bringup_timeout_s: float = 900.0,
                              load_timeout_s: float = 1200.0) -> dict:
    """The cluster as ``num_servers`` server processes and
    ``client_procs`` client processes over localhost TCP; returns the JAX
    harness's result dict (``mp``, ``cluster_metrics``,
    ``cluster_timeseries``; with ``trace`` and ``trace_out`` every
    server's Chrome trace merged by pid into ``trace_out``) plus
    ``device``, ``servers`` (every server's ``REPORT``; with
    ``record_plans`` each server runs under ``ShapeRecorder`` and reports
    it), ``clients``, ``replicas_read_back``, ``replica_mismatches``
    (with ``mismatch_examples``), ``transfers`` (the leadership each
    server took after the load), ``transfers_failed`` and
    ``child_pids``.  Raises, with the failed
    children's stderr, if a child fails or stops answering, or if more
    writes failed than the JAX harness allows (``max(8, total //
    100)``)."""
    from ratis_tpu_torch.protocol.ids import RaftGroupId
    if device.startswith("cuda"):
        from ratis_tpu_torch.ops import _build
        _build.build_all()
    gids_hex = [RaftGroupId.random_id().to_bytes().hex()
                for _ in range(num_groups)]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    logdir = tempfile.mkdtemp(prefix="ratis-mp-")
    children: list[_Child] = []

    async def spawn(who: str, mode: str, spec: dict) -> _Child:
        log_path = os.path.join(logdir, f"{who}.err")
        with open(log_path, "wb") as err:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "ratis_tpu_torch.tools.multiproc_bench",
                mode, stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE, stderr=err, env=env,
                cwd=str(ROOT),
                # an MPRESULT line carries every latency sample
                limit=64 << 20)
        child = _Child(who, proc, log_path)
        children.append(child)
        await child.send(json.dumps(spec))
        return child

    try:
        t_spawn = time.monotonic()
        servers = [await spawn(f"server{i}", "--server", {
            "peer_index": i, "num_servers": num_servers, "groups": gids_hex,
            "device": device, "loop_shards": loop_shards, "trace": trace,
            "trace_sample": trace_sample, "record_plans": record_plans})
            for i in range(num_servers)]
        ports, http_ports, startup_s = [], [], []
        for s in servers:
            _, port, http = (await s.wait_line("MPSTARTED",
                                               bringup_timeout_s)).split()
            ports.append(int(port))
            http_ports.append(int(http))
            startup_s.append(round(time.monotonic() - t_spawn, 3))
        peer_table = [[f"s{i}", f"127.0.0.1:{p}"] for i, p in enumerate(ports)]
        for s in servers:
            await s.ask("PEERS " + json.dumps(peer_table), "MPPEERS", 60.0)
        t0 = time.monotonic()
        for s in servers:
            await s.send("ADDGROUPS")
        for s in servers:
            await s.wait_line("MPADDED", bringup_timeout_s)
        addgroups_s = time.monotonic() - t0
        t0 = time.monotonic()
        ready = await servers[0].ask("APPOINT", "MPREADY", bringup_timeout_s)
        convergence_s = time.monotonic() - t0
        for s in servers:
            await s.ask("SEAL", "MPSEALED", 120.0)
        if trace:
            for s in servers:
                await s.ask("RESET_TRACE", "MPTRACED", 60.0)

        parts = [p for p in (gids_hex[i::client_procs]
                             for i in range(client_procs)) if p]
        clients = [await spawn(f"client{i}", "--client", {
            "peers": peer_table, "groups": part, "writes": writes_per_group,
            "concurrency": max(1, concurrency // len(parts)),
            "trace": trace, "trace_sample": trace_sample})
            for i, part in enumerate(parts)]
        outs = [json.loads((await c.wait_line("MPRESULT", load_timeout_s))
                           [len("MPRESULT "):]) for c in clients]

        total = len(gids_hex) * writes_per_group
        commits = sum(o["commits"] for o in outs)
        failures = sum(o["failures"] for o in outs)
        lat = sorted(x for o in outs for x in o["lat_ms"])
        if not lat or failures > max(8, total // 100):
            raise TimeoutError(f"{failures}/{total} multiproc writes failed")

        # the merged snapshot of every server's HTTP endpoint, while they live
        from ratis_tpu_torch.metrics.aggregate import (
            scrape_cluster, scrape_cluster_timeseries)
        addresses = [f"127.0.0.1:{p}" for p in http_ports if p]
        cluster_metrics = await scrape_cluster(addresses)
        cluster_timeseries = await scrape_cluster_timeseries(addresses)

        merged_trace_pids = 0
        if trace and trace_out:
            from ratis_tpu_torch.trace.export import merge_chrome_trace_files
            tdir = tempfile.mkdtemp(prefix="ratis-mp-trace-")
            try:
                paths = []
                for i, s in enumerate(servers):
                    path = os.path.join(tdir, f"trace_s{i}.json")
                    await s.ask(f"TRACEDUMP {path}", "MPTRACEDUMPED", 120.0)
                    paths.append(path)
                merged = merge_chrome_trace_files(paths, trace_out)
            finally:
                shutil.rmtree(tdir, ignore_errors=True)
            merged_trace_pids = len({e.get("pid")
                                     for e in merged["traceEvents"]})

        acked = {h: n for o in outs for h, n in o["acked"].items()}
        sent = {h: n for o in outs for h, n in o["sent"].items()}
        mismatches = []
        for s in servers:
            got = json.loads((await s.ask("COUNTERS " + json.dumps(acked),
                                          "MPCOUNTERS",
                                          COUNTERS_WAIT_S + 60.0))
                             [len("MPCOUNTERS "):])
            mismatches += [(s.who, h, got.get(h), acked[h], sent[h])
                           for h in gids_hex
                           if got.get(h) is None
                           or not acked[h] <= got[h] <= sent[h]]
        # one election on every server, the first server's last
        transfers = []
        for s in (*servers[1:], servers[0]):
            _, h, ok = (await s.ask("TRANSFER", "MPTRANSFERRED",
                                    120.0)).split()
            transfers.append({"peer": s.who, "group": h, "ok": ok == "1"})
        reports = [json.loads((await s.ask("REPORT", "MPREPORT", 120.0))
                              [len("MPREPORT "):]) for s in servers]

        # wall clock over the union of the client windows (each child's
        # import and start-up stay outside)
        elapsed = (max(o["wall_end"] for o in outs)
                   - min(o["wall_start"] for o in outs))
        n = len(lat)
        first = reports[0]
        result = {
            "commits": commits,
            "write_failures": failures,
            "elapsed_s": round(elapsed, 3),
            "commits_per_sec": round(commits / elapsed, 1),
            "p50_ms": round(lat[n // 2], 2),
            "p99_ms": round(lat[min(n - 1, (n * 99) // 100)], 2),
            "election_convergence_s": round(convergence_s, 2),
            "child_convergence_s": float(ready.split()[1]),
            "prewarm_s": 0.0,
            "groups": len(gids_hex),
            "mode": "batched",
            "transport": "tcp",
            "peers": num_servers,
            "mp": {"server_procs": num_servers, "client_procs": len(parts),
                   "loop_shards": loop_shards},
            "device": device,
            "startup_s": startup_s,
            "addgroups_s": round(addgroups_s, 3),
            "cluster_metrics": cluster_metrics,
            "watchdog_events": cluster_metrics.get("watchdog_events", 0),
            "cluster_timeseries": cluster_timeseries,
            "append_rewinds": first.get("append_rewinds", 0),
            "engine_occupancy": first.get("engine_occupancy"),
            "reply_hops_per_commit": first.get("reply_hops_per_commit"),
            "servers": reports,
            "clients": [{k: o[k] for k in ("pid", "commits", "failures",
                                           "elapsed_s", "cuda_initialized",
                                           "foreign_modules")}
                        for o in outs],
            "replicas_read_back": len(gids_hex) * len(servers),
            "replica_mismatches": len(mismatches),
            "mismatch_examples": mismatches[:5],
            "transfers": transfers,
            "transfers_failed": sum(not t["ok"] for t in transfers),
            "child_pids": [c.proc.pid for c in children],
        }
        if trace:
            result["host_path_decomposition"] = first.get(
                "host_path_decomposition")
            result["client_decomp"] = outs[0].get("client_decomp")
        if trace and trace_out:
            result["trace_out"] = os.path.abspath(trace_out)
            result["trace_pids"] = merged_trace_pids
        return result
    except Exception as e:
        tails = "".join(c.tail() for c in children
                        if c.stalled or c.proc.returncode is not None)
        raise RuntimeError(f"multi-process run failed: "
                           f"{type(e).__name__}: {e}{tails}") from e
    finally:
        for c in children:
            try:
                c.proc.kill()
            except ProcessLookupError:
                pass
        for c in children:
            await c.proc.wait()
        shutil.rmtree(logdir, ignore_errors=True)


if __name__ == "__main__":
    if "--server" in sys.argv[1:]:
        _mp_server_main()
    elif "--client" in sys.argv[1:]:
        _mp_client_main()
    else:
        sys.exit("usage: python -m ratis_tpu_torch.tools.multiproc_bench "
                 "--server | --client (a spec line on stdin; "
                 "run_multiproc_bench starts them)")
