"""One client process of a run (``python -m benchmark.clients``, started by
the deployment with a JSON spec line on its standard input).

It runs the closed-loop clients ``spec["clients"]`` through the port's
``RaftClient`` (``io().send`` for writes, ``io().send_read_only`` for
linearizable reads at the leader, ``io().send_stale_read`` for the
read-back), one ``RaftClient`` a group sharing one client transport of
the configuration's kind, each built with the group's appointed leader as
its first target.  A
client keeps a call's id across its retries, so the servers' retry cache
applies a write once.

Protocol on standard input and output:

1. the process writes every arithmetic group's initial writes (each
   owned group's, one group at a time, ``INITIAL_CONCURRENCY`` groups at
   once), then prints ``READY``;
2. it reads ``GO <start> <window start> <window end>`` (the host's
   monotonic clock, shared by every process of the run): the clients start
   at ``start``, stop sending at ``window end``, and the process waits up
   to ``drain_s`` for the answers still out;
3. it reads every owned group back from every server, by a stale read at
   the group's last acknowledged index, writes its result (``result_path``,
   JSON) and prints ``RESULT``.

The process never touches CUDA; its result says whether ``torch.cuda``
was initialized in it, and which modules of JAX or the JAX package it
loaded (none may be).
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import sys
import time

from benchmark import generator

INITIAL_CONCURRENCY = 256
READBACK_CONCURRENCY = 256
# how long a replica may take to apply a group up to its last
# acknowledged index before its read-back counts as failed
READBACK_WAIT_S = 60.0
READ_RETRY_S = 0.01
READBACK_PAUSE_S = 0.05
READBACK_PAUSE_MAX_S = 1.0


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: the port's name begins with it)."""
    banned = {"jax", "jaxlib", "flax", "ratis_tpu"}
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in banned)


def main() -> None:
    spec = json.loads(sys.stdin.readline())
    asyncio.run(_run(spec))


async def _run(spec: dict) -> None:
    import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers TCP)
    from ratis_tpu_torch.client.client import RaftClient
    from ratis_tpu_torch.conf import RaftProperties
    from ratis_tpu_torch.protocol.exceptions import (RaftException,
                                                     StateMachineException)
    from ratis_tpu_torch.protocol.group import RaftGroup
    from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
    from ratis_tpu_torch.protocol.peer import RaftPeer
    from ratis_tpu_torch.retry.policies import RetryPolicies
    from ratis_tpu_torch.trace import configure_from_properties
    from ratis_tpu_torch.transport.base import TransportFactory

    config, mix, seed = spec["config"], spec["mix"], spec["seed"]
    sm = config["state_machine"]
    properties = RaftProperties(spec["properties"])
    # with tracing, the clients mint the sampled requests' trace ids that
    # the servers' spans carry
    configure_from_properties(properties)
    peers = [RaftPeer(RaftPeerId.value_of(pid), address=addr)
             for pid, addr in spec["peers"]]
    gids = [RaftGroupId.value_of(bytes.fromhex(h)) for h in spec["groups"]]
    transport = TransportFactory.get(config["transport"]) \
        .new_client_transport(properties)
    retry = config["client"]
    clients: dict = {}

    def client(g: int):
        c = clients.get(g)
        if c is None:
            c = (RaftClient.builder()
                 .set_raft_group(RaftGroup.value_of(gids[g], peers))
                 .set_transport(transport).set_properties(properties)
                 .set_leader_id(peers[g % len(peers)].id)
                 .set_retry_policy(
                     RetryPolicies.retry_up_to_maximum_count_with_fixed_sleep(
                         retry["retry_attempts"],
                         f"{retry['retry_sleep_ms']}ms"))
                 .build())
            clients[g] = c
        return c

    async def call(kind: str, g: int, payload: bytes) -> list:
        """Send one operation: [reply time, success, answer] (the answer
        an exception's name where the client gave up)."""
        c = client(g)
        try:
            if kind != generator.READ:
                reply = await c.io().send(payload)
            else:
                # a read that fails short of the state machine (its
                # leadership not confirmed in time) is sent again, as an
                # application would; a write is not: a new call would
                # apply it twice
                while True:
                    reply = await c.io().send_read_only(payload)
                    if reply.success or isinstance(
                            reply.exception, StateMachineException) \
                            or time.monotonic() > read_deadline:
                        break
                    await asyncio.sleep(READ_RETRY_S)
        except (RaftException, asyncio.TimeoutError, OSError) as e:
            return [time.monotonic(), False, type(e).__name__]
        if reply.success and kind != generator.READ:
            last_index[g] = max(last_index.get(g, 0), reply.log_index)
        return [time.monotonic(), bool(reply.success),
                reply.message.content.decode(errors="replace")
                if reply.success else repr(reply.exception)]

    my_clients = spec["clients"]
    owned = sorted(g for i in my_clients for g in generator.owned_groups(
        i, mix["clients"], config["groups"]))
    last_index: dict[int, int] = {}
    # reads are sent again until the drain ends (set at GO)
    read_deadline = float("inf")

    # 1. the initial writes, one group at a time each
    initial: dict[int, list] = {}
    sem = asyncio.Semaphore(INITIAL_CONCURRENCY)

    async def initialize(g: int) -> None:
        async with sem:
            for op in generator.initial_writes(seed, sm, g):
                rec = [time.monotonic(), None, False, "unanswered"]
                initial.setdefault(g, []).append(rec)
                rec[1:] = await call(op.kind, g, op.payload)

    await asyncio.gather(*(initialize(g) for g in owned))
    print("READY", flush=True)

    # 2. the load
    loop = asyncio.get_running_loop()
    line = await loop.run_in_executor(None, sys.stdin.readline)
    cmd, start, w0, w1 = line.split()
    start, w0, w1 = float(start), float(w0), float(w1)
    read_deadline = w1 + mix["drain_s"]
    ops: dict[int, list] = {i: [] for i in my_clients}

    async def closed_loop(i: int) -> None:
        gen = generator.ClientOps(seed, i, config, mix)
        log = ops[i]
        while time.monotonic() < w1:
            op = gen.next()
            rec = [op.kind, op.group, time.monotonic(), None, False,
                   "unanswered"]
            log.append(rec)
            rec[3:] = await call(op.kind, op.group, op.payload)

    cpu: list = []
    in_gc = [0.0, 0.0]  # seconds in the collector so far, its last start

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            in_gc[1] = time.perf_counter()
        else:
            in_gc[0] += time.perf_counter() - in_gc[1]

    gc.callbacks.append(on_gc)

    def take_cpu() -> None:
        cpu.append((time.process_time(), in_gc[0]))

    loop.call_at(w0, take_cpu)
    loop.call_at(w1, take_cpu)
    await asyncio.sleep(max(0.0, start - time.monotonic()))
    tasks = [asyncio.create_task(closed_loop(i)) for i in my_clients]
    done, pending = await asyncio.wait(
        tasks, timeout=max(0.0, w1 + mix["drain_s"] - time.monotonic()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)

    # 3. the read-back of every owned group from every server
    readback: list = []
    payload = generator.readback_payload(sm)
    sem = asyncio.Semaphore(READBACK_CONCURRENCY)

    async def read_back(g: int, s: int) -> None:
        async with sem:
            deadline = time.monotonic() + READBACK_WAIT_S
            answer, ok, pause = "unanswered", False, READBACK_PAUSE_S
            while time.monotonic() < deadline:
                try:
                    reply = await client(g).io().send_stale_read(
                        payload, last_index.get(g, 0), peers[s].id)
                except (RaftException, asyncio.TimeoutError, OSError) as e:
                    reply, answer = None, type(e).__name__
                if reply is not None and reply.success:
                    answer, ok = reply.message.content.decode(), True
                    break
                if reply is not None:
                    answer = repr(reply.exception)
                    if isinstance(reply.exception, StateMachineException):
                        break  # the replica's state machine answered
                # a follower learns the last commit from its next append or
                # heartbeat: back off until then
                await asyncio.sleep(pause)
                pause = min(2 * pause, READBACK_PAUSE_MAX_S)
            readback.append([g, s, ok, answer])

    # leaders first: their replicas have applied every acknowledged write
    await asyncio.gather(*(read_back(g, s) for lead in (True, False)
                           for g in owned for s in range(len(peers))
                           if (g % len(peers) == s) == lead))
    await transport.close()

    torch = sys.modules.get("torch")
    out = {
        "pid": os.getpid(),
        "ops": ops,
        "initial": initial,
        "readback": readback,
        "window_cpu_s": cpu[1][0] - cpu[0][0],
        "window_gc_s": cpu[1][1] - cpu[0][1],
        "cuda_initialized": bool(torch is not None
                                 and torch.cuda.is_initialized()),
        "foreign_modules": foreign_modules(),
    }
    with open(spec["result_path"], "w") as f:
        json.dump(out, f)
    print("RESULT", flush=True)


if __name__ == "__main__":
    main()
