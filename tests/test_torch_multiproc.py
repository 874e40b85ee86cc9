"""The port's loop-sharded servers and multi-process deployment against
the JAX package's (``tests/test_loop_shards.py``): the same placement of
groups on loop shards, the same engine state from intake on worker
threads, a loop-sharded TCP cluster in both packages, and the
multi-process harness (``tools/multiproc_bench.py``) beside JAX's
``run_multiproc_bench`` at the same shape, every child gone afterwards.

``tests/test_loop_shards.py`` holds every process of the machine to
carrying no ``--mp-server`` / ``--mp-client`` once its own run ends: the
port's children take ``--server`` / ``--client``, and the JAX harness's
children started here take theirs through ``_JAX_CHILD``.
"""

import asyncio
import contextlib
import json
import os
import pathlib
import random
import subprocess
import sys
import types

import numpy as np
import pytest

from jax_mirror import jax_cluster_module, jax_properties, prewarm_small
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties
from ratis_tpu_torch.tools.multiproc_bench import (live_children,
                                                   run_multiproc_bench)
from ratis_tpu_torch.tools.plan_recorder import ShapeRecorder

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the modules either package's children run
HARNESSES = ("ratis_tpu_torch.tools.multiproc_bench",
             "ratis_tpu.tools.bench_cluster")
# a JAX harness child as ``python -c _JAX_CHILD server|client``: its flag
# is put back together in the child, so its command line does not carry it
_JAX_CHILD = ("import runpy, sys; sys.argv[1:] = ['--mp-' + a for a in "
              "sys.argv[1:]]; runpy.run_module("
              "'ratis_tpu.tools.bench_cluster', run_name='__main__', "
              "alter_sys=True)")


def _run(coro, limit_s: float):
    """Run ``coro`` to its end, failing it after ``limit_s`` seconds (each
    test's own time limit)."""
    return asyncio.run(asyncio.wait_for(coro, limit_s))


def _procs() -> list[tuple[int, int, str]]:
    """(pid, parent pid, command line) of every process."""
    out = subprocess.run(["ps", "-eo", "pid=,ppid=,args="],
                         capture_output=True, text=True, check=True).stdout
    rows = []
    for line in out.splitlines():
        parts = line.split(None, 2)
        if len(parts) == 3:
            rows.append((int(parts[0]), int(parts[1]), parts[2]))
    return rows


def _my_mp_children() -> list[str]:
    """Processes of either package's multi-process harness whose parent
    is this process."""
    me = os.getpid()
    return [args for pid, ppid, args in _procs()
            if ppid == me and any(h in args for h in HARNESSES)]


@contextlib.contextmanager
def _jax_children_as_python_c():
    """Start the JAX harness's children as ``python -c _JAX_CHILD``."""
    spawn = asyncio.create_subprocess_exec

    async def unflagged(program, *args, **kw):
        if args[:2] == ("-m", "ratis_tpu.tools.bench_cluster"):
            args = ("-c", _JAX_CHILD,
                    *(a.removeprefix("--mp-") for a in args[2:]))
        return await spawn(program, *args, **kw)
    asyncio.create_subprocess_exec = unflagged
    try:
        yield
    finally:
        asyncio.create_subprocess_exec = spawn


# -------------------------------------------------------- (a) placement

@pytest.mark.parametrize("shards", [2, 3])
def test_groups_land_on_the_same_shard_in_both_packages(shards):
    from ratis_tpu.protocol.ids import RaftGroupId as JaxGroupId
    from ratis_tpu.server.server import RaftServer as JaxServer
    from ratis_tpu.transport.simulated import (
        SimulatedNetwork as JaxNetwork,
        SimulatedTransportFactory as JaxFactory)
    from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
    from ratis_tpu_torch.server.server import RaftServer
    from ratis_tpu_torch.transport.simulated import (
        SimulatedNetwork, SimulatedTransportFactory)
    from ratis_tpu.protocol.ids import RaftPeerId as JaxPeerId

    props = cluster_properties(64, 3, "cpu", "sim", loop_shards=shards)
    port = RaftServer(RaftPeerId.value_of("s0"), "sim:s0",
                      state_machine_registry=lambda gid: None,
                      properties=props,
                      transport_factory=SimulatedTransportFactory(
                          SimulatedNetwork()))
    jax = JaxServer(JaxPeerId.value_of("s0"), "sim:s0",
                    state_machine_registry=lambda gid: None,
                    properties=jax_properties(props),
                    transport_factory=JaxFactory(JaxNetwork()))
    rng = np.random.default_rng(shards)
    ids = [rng.bytes(16) for _ in range(64)]
    got = [port.shard_of_group(RaftGroupId.value_of(b)) for b in ids]
    want = [jax.shard_of_group(JaxGroupId.value_of(b)) for b in ids]
    assert port.loop_shards == jax.loop_shards == shards
    assert got == want
    assert set(got) == set(range(shards))


# ------------------------------------- (b) engine intake from worker threads

def _intake_script(seed: int, threads: int = 4, slots: int = 8,
                   rounds: int = 150) -> list[list[tuple]]:
    """Each worker thread's events, seeded: acks (slot, peer, match) on
    any row, and flushes (slot, index) rising on the rows the thread owns
    (a log's flushes come from its own loop, in order)."""
    rng = random.Random(seed)
    script = []
    for k in range(threads):
        owned = [i for i in range(slots) if i % threads == k]
        flushed = dict.fromkeys(owned, 0)
        events = []
        for _ in range(rounds * slots):
            if rng.random() < 0.75:
                events.append(("ack", rng.randrange(slots),
                               rng.randrange(1, 3), rng.randrange(0, 400)))
            else:
                i = rng.choice(owned)
                flushed[i] += rng.randrange(0, 4)
                events.append(("flush", i, flushed[i]))
        script.append(events)
    return script


def _engine_run(engine_cls, leader_role, batched: bool, intake: str,
                script, threaded: bool, record: bool = False,
                **device) -> dict:
    """A leader engine of 8 rows of 3 peers fed ``script``, one worker
    thread per list (or the lists in order on one thread), its tick task
    on the home loop; returns the mirrors and each row's inline commit
    advances; with ``record``, under a ``ShapeRecorder`` entered on the
    home loop's thread, and its prepared calls made off that thread."""
    advances: dict = {}

    class Leader:
        def __init__(self, slot):
            self.slot = slot

        def on_commit_advance_now(self, commit):
            advances.setdefault(self.slot, []).append(commit)

        async def on_commit_advance(self, commit):
            self.on_commit_advance_now(commit)

        async def on_election_timeout(self):
            pass

        async def on_leadership_stale(self):
            pass

    async def body():
        eng = engine_cls(max_groups=64, max_peers=8, tick_interval_s=0.001,
                         scalar_fallback_threshold=0 if batched else 10**9,
                         **device)
        st = eng.state
        slots = []
        for i in range(8):
            slot = eng.attach(Leader(i))
            cur = np.zeros(8, bool)
            cur[:3] = True
            st.set_conf(slot, 0, cur, np.zeros(8, bool),
                        np.zeros(8, np.int32), 0)
            st.role[slot] = leader_role
            st.first_leader_index[slot] = 0
            st.election_deadline_ms[slot] = 1 << 29
            slots.append(slot)
        rec = ShapeRecorder().__enter__() if record else None
        await eng.start()

        def feed(events):
            for ev in events:
                if ev[0] == "flush":
                    eng.on_flush(slots[ev[1]], ev[2])
                elif intake == "batch_intake":
                    eng.on_ack_batch([(slots[ev[1]], ev[2], ev[3])])
                else:
                    eng.on_ack(slots[ev[1]], ev[2], ev[3])
        try:
            if threaded:
                await asyncio.gather(*(asyncio.to_thread(feed, evs)
                                       for evs in script))
            else:
                for evs in script:
                    feed(evs)
            for _ in range(400):
                await asyncio.sleep(0.005)
                if not eng._ack_ring and not eng._slot_updates:
                    break
            assert not eng._ack_ring, "ack ring never drained"
            out = {"commit": st.commit_index[slots].tolist(),
                   "flush": st.flush_index[slots].tolist(),
                   "match": st.match_index[slots, :3].tolist(),
                   "acks": eng.metrics["acks"],
                   "advances": {i: advances.get(i, []) for i in range(8)}}
            if rec is not None:
                # a ledger sample on the home loop, as the watchdog's
                eng.ledger.sample()
                rec.__exit__(None, None, None)
                out["off_home"] = dict(rec.off_home_calls)
            return out
        finally:
            await eng.close()

    return _run(body(), 60.0)


@pytest.mark.parametrize("batched", [False, True], ids=["scalar", "batched"])
@pytest.mark.parametrize("intake", ["intake", "batch_intake"])
def test_engine_intake_from_worker_threads_matches_jax(intake, batched):
    from ratis_tpu.engine.engine import QuorumEngine as JaxEngine
    from ratis_tpu.engine.state import ROLE_LEADER as JAX_LEADER
    from ratis_tpu_torch.engine.engine import QuorumEngine
    from ratis_tpu_torch.engine.state import ROLE_LEADER
    script = _intake_script(7)
    port = _engine_run(QuorumEngine, ROLE_LEADER, batched, intake, script,
                       threaded=True, record=True, device="cpu")
    jax = _engine_run(JaxEngine, JAX_LEADER, batched, intake, script,
                      threaded=True)
    alone = _engine_run(QuorumEngine, ROLE_LEADER, batched, intake, script,
                        threaded=False, device="cpu")
    for key in ("commit", "flush", "match", "acks"):
        assert port[key] == jax[key] == alone[key], key
    acks = sum(ev[0] == "ack" for evs in script for ev in evs)
    assert port["acks"] == acks
    for i, seq in port["advances"].items():
        # every inline advance raised the commit, and the last is where
        # the row's commit stands, on whatever thread it came
        assert seq == sorted(set(seq)), i
        assert not seq or seq[-1] == port["commit"][i], i
    assert {i: s[-1:] for i, s in port["advances"].items()} == \
        {i: s[-1:] for i, s in jax["advances"].items()}
    # the worker threads reached only the intake: no prepared call ran
    # off the home loop's thread
    assert port["off_home"] == {}


def test_prepared_call_off_the_home_thread_is_counted():
    """The recorder's ``off_home_calls`` sees a prepared call made on a
    worker thread: the count the multi-process harness reports is not
    vacuous."""
    from ratis_tpu_torch.engine.engine import QuorumEngine

    async def body():
        eng = QuorumEngine(max_groups=64, max_peers=8,
                           scalar_fallback_threshold=0, device="cpu")
        slot = eng.attach(object())
        await eng.start()
        try:
            with ShapeRecorder() as rec:
                eng._tally_rounds(np.array([slot]))
                eng.ledger.sample()
                assert rec.off_home_calls == {}
                await asyncio.to_thread(eng._tally_rounds, np.array([slot]))
                await asyncio.to_thread(eng.ledger.sample)
            return dict(rec.off_home_calls)
        finally:
            await eng.close()

    assert _run(body(), 30.0) == {"TallyPlan": 1, "LedgerPlan": 1}


# ----------------------------------------- (c) a loop-sharded TCP cluster

async def _sharded_script(cluster) -> dict:
    try:
        await cluster.start(timeout=60)
        placed = {}
        for s in cluster.servers:
            assert s.shards is not None and s.shards.n == 2
            for g in cluster.groups:
                idx = s.shard_of_group(g.group_id)
                placed[(str(s.peer_id), g.group_id.to_bytes().hex())] = idx
                # the division's standing apply task lives on its loop
                d = s.divisions[g.group_id]
                assert d._apply_task.get_loop() is s.shards.loop(idx)
        stats = await cluster.write_all(2, concurrency=8)
        counters = await cluster.read_counters()
        return {"placed": placed, "commits": stats["commits"],
                "counters": sorted(counters.values())}
    finally:
        await cluster.close()


def test_loop_sharded_tcp_cluster_matches_jax():
    props = cluster_properties(8, 3, "cpu", "tcp", loop_shards=2)
    assert props.get("raft.tpu.server.loop-shards") == "2"
    port = Cluster(8, 3, device="cpu", transport="tcp", properties=props)
    jmod = jax_cluster_module()
    jax = jmod.Cluster(8, 3, device="cpu", transport="tcp",
                       properties=jax_properties(props))
    prewarm_small(jax)
    runs = {"port": _run(_sharded_script(port), 120.0),
            "jax": _run(_sharded_script(jax), 120.0)}
    for name, run in runs.items():
        assert run["commits"] == 16, name
        assert run["counters"] == [[2, 2, 2]] * 8, name
        assert len(set(run["placed"].values())) == 2, name


# ------------------------------------------------ (d) the multi-process run

def test_multiproc_run_matches_jax():
    from ratis_tpu.tools.bench_cluster import \
        run_multiproc_bench as jax_run_multiproc_bench
    port = _run(run_multiproc_bench(
        4, 2, num_servers=3, loop_shards=2, client_procs=2, device="cpu",
        concurrency=8, record_plans=True, bringup_timeout_s=120.0,
        load_timeout_s=120.0), 240.0)
    assert live_children(port["child_pids"]) == []
    assert _my_mp_children() == []
    with _jax_children_as_python_c():
        jax = _run(jax_run_multiproc_bench(
            4, 2, num_servers=3, transport="tcp", loop_shards=2,
            client_procs=2, concurrency=8, bringup_timeout_s=420.0,
            load_timeout_s=300.0), 600.0)
    assert _my_mp_children() == []
    for name, out in (("port", port), ("jax", jax)):
        assert out["write_failures"] == 0, name
        assert out["commits"] == 8, name
        assert out["mp"] == {"server_procs": 3, "client_procs": 2,
                             "loop_shards": 2}, name
        assert out["commits_per_sec"] > 0, name
        cm = out["cluster_metrics"]
        assert cm["servers"] == 3 and cm["healthy"] == 3, name
        assert len(cm["procs"]) == 3, name
    # every write counted on all 3 replicas, between acked and sent
    assert port["replicas_read_back"] == 12
    assert port["replica_mismatches"] == 0, port["mismatch_examples"]
    assert port["device"] == "cpu"
    # each server took one group's leadership by a transfer: its vote
    # round went through its engine's tally
    assert [t["ok"] for t in port["transfers"]] == [True] * 3
    assert port["transfers_failed"] == 0
    assert [t["peer"] for t in port["transfers"]] == \
        ["server1", "server2", "server0"]
    for r in port["servers"]:
        assert r["shapes"]["K3"], r["peer"]
        assert r["device"] == "cpu" and r["divisions"] == 4
        assert r["loop_shards"] == 2
        assert r["off_home_calls"] == {}
        assert r["ledger_samples"] > 0 and r["ledger_faults"] == []
    assert not any(c["cuda_initialized"] for c in port["clients"])
    # no server or client process loaded JAX or the JAX package
    assert [r["foreign_modules"] for r in port["servers"] + port["clients"]] \
        == [[]] * 5
    assert len({c["pid"] for c in port["clients"]}) == 2


def test_multiproc_trace_merges_every_server(tmp_path):
    """With tracing on, every server's Chrome trace is merged by pid and
    each server reports its host-path decomposition."""
    out = _run(run_multiproc_bench(
        4, 2, num_servers=3, loop_shards=2, client_procs=2, device="cpu",
        concurrency=8, trace=True, trace_sample=1,
        trace_out=str(tmp_path / "trace.json"),
        bringup_timeout_s=120.0, load_timeout_s=120.0), 240.0)
    assert live_children(out["child_pids"]) == []
    assert out["trace_pids"] == 3
    merged = json.loads((tmp_path / "trace.json").read_text())
    assert len({e.get("pid") for e in merged["traceEvents"]}) == 3
    assert all("host_path_decomposition" in r for r in out["servers"])


def test_server_child_on_cuda_without_a_card_raises(tmp_path):
    """A server child asked for ``cuda`` where there is none raises at
    start-up; it never falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = {"peer_index": 0, "num_servers": 3, "groups": ["00" * 16],
            "device": "cuda", "loop_shards": 1}
    proc = subprocess.run(
        [sys.executable, "-m", "ratis_tpu_torch.tools.multiproc_bench",
         "--server"], input=json.dumps(spec) + "\n", capture_output=True,
        text=True, cwd=ROOT, timeout=100)
    assert proc.returncode != 0
    assert "MPSTARTED" not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_a_failed_child_is_named_with_its_stderr():
    """Children that exit during start-up fail the run with the last
    lines of their stderr, and none is left."""
    with pytest.raises(RuntimeError) as err:
        _run(run_multiproc_bench(4, 2, num_servers=3, client_procs=2,
                                 device="no-such-device",
                                 bringup_timeout_s=120.0), 240.0)
    text = str(err.value)
    assert "server0 exited before MPSTARTED" in text
    assert "--- server0 (pid" in text and "no-such-device" in text
    assert _my_mp_children() == []


def test_a_failed_transfer_is_answered_not_raised(monkeypatch):
    """A leadership transfer that raises (a client timeout) is answered
    as failed: the server's command loop goes on, and the run reports it
    in ``transfers_failed``."""
    import ratis_tpu_torch.transport.tcp  # noqa: F401 (registers TCP)
    from ratis_tpu_torch.client.client import AdminApi
    from ratis_tpu_torch.protocol.group import RaftGroup
    from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
    from ratis_tpu_torch.protocol.peer import RaftPeer
    from ratis_tpu_torch.tools import multiproc_bench as mp

    async def times_out(self, new_leader, *a, **kw):
        raise TimeoutError("no reply")
    monkeypatch.setattr(AdminApi, "transfer_leadership", times_out)
    peers = [RaftPeer(RaftPeerId.value_of(f"s{i}"),
                      address=f"127.0.0.1:{1 + i}") for i in range(3)]
    groups = [RaftGroup.value_of(RaftGroupId.random_id(), peers)
              for _ in range(2)]
    leads = {groups[0].group_id: True, groups[1].group_id: False}
    server = types.SimpleNamespace(
        peer_id=peers[0].id,
        properties=cluster_properties(2, 3, "cpu", "tcp"),
        divisions={gid: types.SimpleNamespace(is_leader=lambda v=v: v)
                   for gid, v in leads.items()})
    h, ok = _run(mp._take_leadership(server, groups), 30.0)
    assert (h, ok) == (groups[1].group_id.to_bytes().hex(), False)


# ------------------------------------------ the bench's peer5 rung pair

@pytest.mark.parametrize("cpus,shape", [(1, (2, 2)), (7, (2, 2)),
                                        (8, (4, 3)), (32, (4, 3))])
def test_peer5_rungs_are_the_jax_benchs(cpus, shape):
    from ratis_tpu.tools.bench_cluster import bench_properties
    from ratis_tpu_torch.conf import RaftServerConfigKeys
    from ratis_tpu_torch.tools import bench
    # bench.py:766-778: 4 client processes and 3 shards from 8 CPUs
    assert bench.peer5_mp_shape(cpus) == shape
    assert bench.PEER5 == {"groups": 10_240, "servers": 5, "writes": 2,
                           "warmup": 0, "transport": "tcp",
                           "trace_sample": 32}
    port = dict(cluster_properties(10_240, 5, "cuda", "tcp", trace=True,
                                   trace_sample=32,
                                   loop_shards=shape[1]).items())
    jax = dict(bench_properties(True, 10_240, num_servers=5,
                                transport="tcp", trace=True,
                                trace_sample=32,
                                loop_shards=shape[1]).items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    assert port["raft.server.rpc.timeout.min"] == "24s"


@pytest.mark.parametrize("rung", ["peer5_mp", "peer5_sp"])
def test_peer5_rungs_tiny_through_bench(rung, tmp_path):
    import io
    from contextlib import redirect_stdout

    from ratis_tpu_torch.tools import bench
    buf = io.StringIO()
    trace = tmp_path / "trace.json"
    with redirect_stdout(buf):
        code = bench.main(["--device", "cpu", "--rungs", rung, "--groups",
                           "64", "--trace-out", str(trace)])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])[rung]
    assert code == 0, res
    # 128 writes, every 32nd traced
    assert res["commits"] == 128 and res["write_failures"] == 0
    assert trace.exists()
    if rung == "peer5_mp":
        # the client spans are in the client processes, the stages of
        # the same requests in the servers'
        assert res["client_decomp"]["traced_requests"] >= 1
        assert all(r["host_path_decomposition"]["stages"]
                   for r in res["servers"])
        clients, shards = bench.peer5_mp_shape()
        assert res["mp"] == {"server_procs": 5, "client_procs": clients,
                             "loop_shards": shards}
        assert res["replicas_read_back"] == 320
        assert res["replica_mismatches"] == 0
        assert res["trace_pids"] == 5
        assert res["transfers_failed"] == 0
        # the timed rung's servers run without the plan recorder
        assert not any("shapes" in r or "off_home_calls" in r
                       for r in res["servers"])
        assert live_children(res["child_pids"]) == []
    else:
        assert res["host_path_decomposition"]["traced_requests"] >= 1
        assert res["servers"] == 5 and res["warmup"] == 0
        assert res["replicas_read_back"] == 320
        assert res["engine_device"] == "cpu"
