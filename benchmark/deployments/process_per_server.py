"""The ``process_per_server`` deployment: every server of the configuration
in a process of its own, every client process beside them, on one host
and one card.

    records = await run(config, mix, seed, seconds, trace, device, workdir)

Each server process (``python -m benchmark.deployments.process_per_server
--server``, a JSON spec line on its standard input) is one port
``RaftServer`` with its ``QuorumEngine`` on ``device``, the
configuration's state machine and its Raft properties, written out in the
configuration's file.  The launcher drives them line by line:

- ``STARTED <port>``: the server has prewarmed its engine (the kernels are
  built by the launcher first, so a server only loads them) and bound
  ``127.0.0.1:0``;
- ``PEERS <table>``: the peer table of the ports the servers got; every
  group is made from it;
- ``ADDGROUPS``: every server adds every group;
- ``APPOINT``: server ``g mod N`` bootstraps group ``g`` as its leader
  (its peer has the group's highest priority), so leadership is balanced
  as a deployment balances it; each server waits for a ready leader in
  each group it bootstraps;
- ``SEAL``: the one deliberate heap seal after bring-up and the clients'
  initial writes, then the collector runs again (the deployment's GC
  discipline);
- ``WINDOW <start> <end>``: at ``start`` and ``end`` (the host's monotonic
  clock) the server takes its counters; with tracing it keeps the
  host-path spans (``trace/``) recorded in the window and ends its
  ``torch.profiler`` session, which it started before it bound its port,
  at ``end`` (the readers clip its events to the window);
- ``REPORT``: the counters, the engine's shape, the window's ack batches,
  the collector's pauses, the card's name and the process's peak of
  device memory, the trace files, and the modules of JAX or the JAX
  package it loaded;
- ``EXIT``.

The client processes are ``benchmark/clients.py``.  Every child's
standard error goes to a file of ``workdir``; a failure raises with the
end of each file.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
APPOINT_BATCH = 256
APPOINT_WAIT_S = 300.0
ADD_WAVE = 512
TAIL_LINES = 40
START_S = 300.0       # a server's start: CUDA, the kernels, the engine
BRINGUP_S = 600.0     # adding or appointing every group
START_MARGIN_S = 0.5  # from GO to the clients' first operation
LAG_PROBE_S = 0.01    # the traced runs' loop probe


def _import(path: str):
    module, _, name = path.partition(":")
    import importlib
    return getattr(importlib.import_module(module), name)


# ------------------------------------------------------------ server child

def _server_main() -> None:
    spec = json.loads(sys.stdin.readline())
    gc_clock = _GcClock()
    gc.disable()  # bring-up allocates long-lived objects; SEAL re-enables
    asyncio.run(_server(spec, gc_clock))


async def _server(spec: dict, gc_clock: "_GcClock") -> None:
    import torch

    import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers TCP)
    from ratis_tpu_torch.conf import RaftProperties
    from ratis_tpu_torch.protocol.group import RaftGroup
    from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
    from ratis_tpu_torch.protocol.peer import RaftPeer
    from ratis_tpu_torch.server.server import RaftServer
    from ratis_tpu_torch.transport.base import TransportFactory

    index, n = spec["index"], spec["servers"]
    properties = RaftProperties(spec["properties"])
    device = torch.device(properties.get("raft.torch.engine.device"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"server {index}: CUDA is not available")
    machine = _import(spec["state_machine"])
    server = RaftServer(RaftPeerId.value_of(f"s{index}"), "127.0.0.1:0",
                        state_machine_registry=lambda gid: machine(),
                        properties=properties,
                        transport_factory=TransportFactory.get(
                            spec["transport"]))
    server.engine.prewarm()
    window: dict = {}
    if spec["trace"]:
        # started before any group exists: starting a session stalls the
        # process, which with groups would fire election timeouts; the
        # readers keep only the window's events
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        window["profiler"] = torch.profiler.profile(activities=acts)
        window["profiler"].start()
    await server.start()
    print(f"STARTED {server.transport.address.rsplit(':', 1)[1]}",
          flush=True)

    groups: list = []
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        cmd, _, arg = line.strip().partition(" ")
        if not line or cmd == "EXIT":
            # thousands of divisions need no graceful unwind: the OS
            # reclaims the process
            os._exit(0)
        elif cmd == "PEERS":
            peers = [RaftPeer(RaftPeerId.value_of(pid), address=addr)
                     for pid, addr in json.loads(arg)]
            # group g's leader is server g mod N: its peer has the
            # highest priority there (the bootstrap's appointee, and the
            # peer an election yields to)
            groups = [RaftGroup.value_of(
                RaftGroupId.value_of(bytes.fromhex(h)),
                [p.with_priority(int(i == g % n)) for i, p in
                 enumerate(peers)])
                for g, h in enumerate(spec["groups"])]
            print("PEERED", flush=True)
        elif cmd == "ADDGROUPS":
            for i in range(0, len(groups), ADD_WAVE):
                await asyncio.gather(*(server.group_add(g)
                                       for g in groups[i:i + ADD_WAVE]))
            print("ADDED", flush=True)
        elif cmd == "APPOINT":
            await _appoint(server, groups[index::n])
            print("APPOINTED", flush=True)
        elif cmd == "SEAL":
            server.seal_heap()
            gc.enable()
            print("SEALED", flush=True)
        elif cmd == "WINDOW":
            start, end = (float(x) for x in arg.split())
            _schedule_window(server, spec, window, start, end, gc_clock)
            print("WINDOWED", flush=True)
        elif cmd == "REPORT":
            print("REPORT " + json.dumps(_report(server, spec, window,
                                                 device, gc_clock)),
                  flush=True)


async def _appoint(server, groups: list) -> None:
    """Bootstrap this server as the leader of ``groups``, in batches, and
    wait for each to have a ready leader here or a leader known elsewhere
    (a follower's election that won first); exits 3 if a batch is not
    ready within ``APPOINT_WAIT_S``."""
    for i in range(0, len(groups), APPOINT_BATCH):
        batch = groups[i:i + APPOINT_BATCH]
        res = await asyncio.gather(*(server.bootstrap_division(g.group_id)
                                     for g in batch), return_exceptions=True)
        for r in res:
            if isinstance(r, BaseException):
                print(f"server: bootstrap fell back: {r!r}",
                      file=sys.stderr, flush=True)
        deadline = time.monotonic() + APPOINT_WAIT_S
        pending = {g.group_id for g in batch}
        while pending and time.monotonic() < deadline:
            pending = {gid for gid in pending if not _has_leader(server, gid)}
            if pending:
                await asyncio.sleep(0.05)
        if pending:
            print(f"server: {len(pending)} groups without a leader after "
                  f"{APPOINT_WAIT_S:.0f} s", file=sys.stderr, flush=True)
            os._exit(3)


def _has_leader(server, gid) -> bool:
    d = server.divisions.get(gid)
    if d is None:
        return False
    if d.is_leader():
        return d.leader_ctx is not None and d.leader_ctx.leader_ready.done()
    return d.state.leader_id is not None


class _GcClock:
    """Seconds this process has spent in the collector, by ``gc.callbacks``."""

    def __init__(self):
        self.total_s, self._t0 = 0.0, 0.0
        # the pauses of a second or more: (start on the monotonic clock,
        # seconds, generation)
        self.pauses: list = []
        gc.callbacks.append(self._on)

    def _on(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            self._m0 = time.monotonic()
        else:
            took = time.perf_counter() - self._t0
            self.total_s += took
            if took >= 0.02:
                self.pauses.append((self._m0, took, info["generation"]))


def _counters(server, gc_clock: "_GcClock") -> dict:
    """What the per-layer metrics read, taken at an instant."""
    from ratis_tpu_torch.metrics import hops
    engine = server.engine
    m = engine.metrics
    reads = server.serving.read_batch
    return {
        "t": time.monotonic(),
        "cpu_s": time.process_time(),
        "gc_s": gc_clock.total_s,
        "election_timeouts": sum(d.election_metrics.timeout_count.count
                                 for d in list(server.divisions.values())),
        "commit_advances": m["commit_advances"],
        "acks": m["acks"],
        "refresh_rows": m["refresh_rows"],
        "fast_ticks": m["fast_ticks"],
        "refresh_ticks": m["refresh_ticks"],
        "dispatches": engine._m.dispatch_timer.count,
        "dispatch_s": engine._m.dispatch_timer._total_s,
        "reply_hops": hops.reply_plane_hops(),
        "read_sweeps": reads.sweeps if reads is not None else 0,
        "reads_confirmed": reads.confirmed if reads is not None else 0,
    }


async def _probe_loop(window: dict, start: float, end: float) -> None:
    """How late the event loop wakes from a ``LAG_PROBE_S`` sleep, and the
    CPU seconds the process used, in each second of the window: the
    loop's lag and busy share, which say whether a second that acked
    little had a loop that was busy or one that waited."""
    loop = asyncio.get_running_loop()
    n = max(1, round(end - start))
    worst, late = [0.0] * n, [0.0] * n
    cpu = [None] * (n + 1)  # process time at each second's first wake-up
    while (now := loop.time()) < end:
        k = min(int(now - start), n - 1)
        if cpu[k] is None:
            cpu[k] = time.process_time()
        await asyncio.sleep(LAG_PROBE_S)
        lag = loop.time() - now - LAG_PROBE_S
        worst[k], late[k] = max(worst[k], lag), late[k] + lag
    cpu[n] = time.process_time()
    for k in range(n - 1, -1, -1):  # a second without a wake-up
        if cpu[k] is None:
            cpu[k] = cpu[k + 1]
    window["loop"] = {"worst_lag_s": worst, "lag_s": late,
                      "cpu_s": [b - a for a, b in zip(cpu, cpu[1:])]}


def _schedule_window(server, spec, window, start, end, gc_clock) -> None:
    """Take the counters at ``start`` and ``end``; start a fresh
    ``ackBatchSize`` histogram at ``start``, so its samples are the
    window's; with tracing, probe the loop (``_probe_loop``), keep the
    host-path spans recorded in the window and end the profiler's session
    at ``end``."""
    from ratis_tpu_torch.metrics.registry import Histogram
    from ratis_tpu_torch.trace import get_tracer
    loop = asyncio.get_running_loop()

    def open_window() -> None:
        server.engine._m.ack_batch = Histogram()
        if spec["trace"]:
            get_tracer().reset()
            window["probe"] = asyncio.ensure_future(
                _probe_loop(window, start, end))
        window["start"] = _counters(server, gc_clock)

    def close_window() -> None:
        window["end"] = _counters(server, gc_clock)
        window["ack_batches"] = list(server.engine._m.ack_batch._samples)
        if spec["trace"]:
            window["profiler"].stop()
            window["spans"] = get_tracer().snapshot()

    loop.call_at(start, open_window)
    loop.call_at(end, close_window)


def _report(server, spec, window, device, gc_clock) -> dict:
    import torch

    from benchmark.clients import foreign_modules
    engine = server.engine
    report = {
        "index": spec["index"],
        "pid": os.getpid(),
        "clock_offset_s": time.time() - time.monotonic(),
        "device": str(engine.device),
        "window": {k: window.get(k) for k in ("start", "end")},
        "ack_batches": window.get("ack_batches", []),
        "engine": {"capacity": engine.state.capacity,
                   "max_peers": engine.state.max_peers,
                   "live_rows": len(engine.state.active)},
        "divisions": len(server.divisions),
        "gc_pauses": gc_clock.pauses,
        "loop": window.get("loop"),
        "foreign_modules": foreign_modules(),
    }
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
        report["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if spec["trace"] and "profiler" in window:
        window["profiler"].export_chrome_trace(spec["profile_path"])
        with open(spec["spans_path"], "w") as f:
            json.dump(window.get("spans", []), f)
        report["profile_path"] = spec["profile_path"]
        report["spans_path"] = spec["spans_path"]
    return report


# ------------------------------------------------------------------ launcher

class _Child:
    """A child process, its name and the file its stderr goes to."""

    def __init__(self, who: str, proc, log_path: str):
        self.who, self.proc, self.log_path = who, proc, log_path
        self.stalled = False

    async def send(self, line: str) -> None:
        self.proc.stdin.write((line + "\n").encode())
        await self.proc.stdin.drain()

    async def wait_line(self, prefix: str, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            try:
                if remaining <= 0:
                    raise TimeoutError
                line = await asyncio.wait_for(self.proc.stdout.readline(),
                                              remaining)
            except TimeoutError:
                self.stalled = True
                raise TimeoutError(f"{self.who}: no {prefix} within "
                                   f"{timeout_s} s") from None
            if not line:
                await self.proc.wait()
                raise RuntimeError(f"{self.who} exited before {prefix} "
                                   f"(rc={self.proc.returncode})")
            text = line.decode(errors="replace").rstrip()
            if text.startswith(prefix):
                return text
            print(f"[{self.who}] {text}", file=sys.stderr, flush=True)

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


async def run(config: dict, mix: dict, seed: int, seconds: float,
              trace: bool, device: str, workdir: str) -> dict:
    """One run of ``mix`` on the configuration's deployment; returns the
    run's raw records: ``window`` (start and end on the monotonic clock),
    ``drain_s`` (how long answers were awaited after it),
    ``servers`` (every server's ``REPORT``), ``clients`` (every client
    process's result), ``phases`` (seconds of each set-up step) and
    ``child_pids``."""
    import numpy as np

    from benchmark.generator import seed_key
    if device.startswith("cuda"):
        from ratis_tpu_torch.ops import _build
        _build.build_all()
    n = config["servers"]
    if config["peers_per_group"] != n:
        raise ValueError("every server hosts every group: peers_per_group "
                         "must equal servers")
    rng = np.random.default_rng([seed_key(seed), 3])
    gids = [rng.bytes(16).hex() for _ in range(config["groups"])]
    properties = dict(config["properties"])
    properties["raft.torch.engine.device"] = device
    if trace:
        properties["raft.tpu.trace.enabled"] = "true"
        properties["raft.tpu.trace.sample-every"] = "16"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    children: list[_Child] = []
    phases: dict = {}

    async def spawn(who: str, module: str, args: list, spec: dict) -> _Child:
        log_path = os.path.join(workdir, f"{who}.err")
        with open(log_path, "wb") as err:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", module, *args,
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE, stderr=err, env=env,
                cwd=str(ROOT), limit=64 << 20)
        child = _Child(who, proc, log_path)
        children.append(child)
        await child.send(json.dumps(spec))
        return child

    def mark(name: str, t0: float) -> float:
        now = time.monotonic()
        phases[name] = round(now - t0, 3)
        return now

    try:
        t = time.monotonic()
        servers = [await spawn(f"server{i}", __name__, ["--server"], {
            "index": i, "servers": n, "groups": gids,
            "properties": properties,
            "state_machine": config["state_machine"]["class"],
            "transport": config["transport"],
            "trace": trace,
            "profile_path": os.path.join(workdir, f"profile{i}.json"),
            "spans_path": os.path.join(workdir, f"spans{i}.json")})
            for i in range(n)]
        ports = [int((await s.wait_line("STARTED", START_S)).split()[1])
                 for s in servers]
        t = mark("servers_started_s", t)
        table = json.dumps([[f"s{i}", f"127.0.0.1:{p}"]
                            for i, p in enumerate(ports)])
        for s in servers:
            await s.ask("PEERS " + table, "PEERED", 60.0)
        for step, reply in (("ADDGROUPS", "ADDED"), ("APPOINT", "APPOINTED")):
            for s in servers:
                await s.send(step)
            for s in servers:
                await s.wait_line(reply, BRINGUP_S)
            t = mark(step.lower() + "_s", t)

        procs = mix["client_procs"]
        peer_table = json.loads(table)
        clients = [await spawn(f"client{p}", "benchmark.clients", [], {
            "config": config, "mix": mix, "seed": seed,
            "properties": properties, "peers": peer_table, "groups": gids,
            "clients": list(range(p, mix["clients"], procs)),
            "result_path": os.path.join(workdir, f"client{p}.json")})
            for p in range(procs)]
        for c in clients:
            await c.wait_line("READY", BRINGUP_S)
        t = mark("clients_ready_s", t)
        # the seal freezes the bring-up and the initial writes, and starts
        # the heap's refreeze cadence at the same offset from the window
        # in every run
        for s in servers:
            await s.ask("SEAL", "SEALED", BRINGUP_S)
        t = mark("seal_s", t)

        start = time.monotonic() + START_MARGIN_S
        w0 = start + mix["warmup_s"]
        w1 = w0 + seconds
        for s in servers:
            await s.ask(f"WINDOW {w0} {w1}", "WINDOWED", 60.0)
        for c in clients:
            await c.send(f"GO {start} {w0} {w1}")
        results = []
        for c in clients:
            await c.wait_line("RESULT", seconds + mix["warmup_s"]
                              + mix["drain_s"] + 600.0)
            with open(os.path.join(workdir, f"{c.who}.json")) as f:
                results.append(json.load(f))
        mark("load_and_readback_s", w1)
        reports = [json.loads((await s.ask("REPORT", "REPORT ", 300.0))
                              [len("REPORT "):]) for s in servers]
        return {"window": [w0, w1], "drain_s": mix["drain_s"],
                "servers": reports, "clients": results,
                "phases": phases,
                "child_pids": [c.proc.pid for c in children]}
    except Exception as e:
        tails = "".join(c.tail() for c in children
                        if c.stalled or c.proc.returncode is not None)
        raise RuntimeError(f"run failed: {type(e).__name__}: {e}{tails}") \
            from e
    finally:
        for c in children:
            if c.proc.returncode is None:
                try:
                    await c.send("EXIT")
                except (ConnectionError, RuntimeError):
                    pass
        for c in children:
            try:
                await asyncio.wait_for(c.proc.wait(), 10.0)
            except TimeoutError:
                c.proc.kill()
                await c.proc.wait()


if __name__ == "__main__":
    if "--server" in sys.argv[1:]:
        _server_main()
    else:
        sys.exit("usage: python -m benchmark.deployments.process_per_server "
                 "--server (a spec line on stdin; run() starts it)")
