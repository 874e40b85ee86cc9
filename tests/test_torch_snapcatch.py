"""The snapshot catch-up rung and the engine's row reuse, the port against
the JAX package.

The port's ``tools/snapshot_bench.py`` ports ``run_snapshot_catchup_bench``
(the InstallSnapshot half of BASELINE config 5): seed, snapshot and purge
every leader, wipe one server's replicas (``Cluster.wipe``: remove, then a
fresh add, on the engine rows the old divisions released), load again
while the leaders install their snapshots.  Here:

- the rung at 3 x 8 over the simulated transport (1024 + 1024 writes, so
  that each load lasts about a second) on the port and on the JAX
  package (the same text renamed, ``tests/jax_mirror.py``), on the 4 s /
  8 s tier and with the wipe in waves of 3: every group caught up by an
  install, each group's snapshot index the index of its last
  acknowledged seed write (the groups and their elected leaders differ
  from run to run, so the indexes are held to that rule, the same in
  both), every counter on all
  3 replicas equal to both loads' acknowledged writes, the wiped server's
  engine on the same 8 rows; the JAX package's own rung at the same size
  gives the keys the port's returns and installs every group too;
- the rung's properties are the JAX bench's, and its snapshot storage
  lies where the JAX bench's does (``{root}/{peer}/{group}``);
- the engine across a detach and an attach of the same row: a released
  row's queued acks and vote replies never reach the division attached to
  the row next (the JAX engine hands them on: recorded, not repaired, its
  package is the reference), and a lockstep script of detaches and
  attaches under ack traffic keeps the port's engine state equal to the
  JAX engine's after every tick (with the JAX engine's queued events for
  a detached row dropped by hand, ``detach_both``);
- the ``snapcatch`` rung tiny through ``tools/bench.py --device cpu``;
- two groups' snapshot installs on one server, interleaved, staged
  apart (each in its own state machine storage).
"""

import asyncio
import hashlib
import io
import json
import random
import struct
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest

from ratis_tpu.engine.engine import QuorumEngine as JaxEngine
from ratis_tpu.protocol.ids import RaftGroupId as JaxGroupId
from ratis_tpu.tools import bench_cluster as jax_bench
from ratis_tpu.tools.bench_cluster import bench_properties
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.engine.engine import QuorumEngine as TorchEngine
from ratis_tpu_torch.engine.state import ROLE_FOLLOWER, ROLE_LEADER
from ratis_tpu_torch.models.counter import CounterStateMachine
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.raftrpc import (FileChunk,
                                              InstallSnapshotRequest,
                                              InstallSnapshotResult,
                                              RaftRpcHeader)
from ratis_tpu_torch.protocol.termindex import TermIndex
from ratis_tpu_torch.server.snapshot import SnapshotInstaller
from ratis_tpu_torch.tools import bench
from ratis_tpu_torch.tools import cluster as cluster_module
from ratis_tpu_torch.tools import snapshot_bench as sb
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties
from ratis_tpu_torch.util.lifecycle import LifeCycleState

from tests.jax_mirror import (jax_cluster_module, jax_properties,
                              jax_tools_module, prewarm_small)
from tests.test_torch_engine import (MIRRORS, FakeClock, Recorder,
                                     _assert_same, detach_both)

GROUPS = 8
# writes per group and load: on the simulated transport a load of 8 x 2
# writes lasts a few ms, and one slow snapshot file write beside other test
# processes then reads as the rung's write collapse (commits/s during the
# installs under a quarter of those before); 8 x 1024 lasts about a second
WRITES = 1024
# the keys of run_snapshot_catchup_bench's result
JAX_KEYS = {"commits_per_sec", "cps_before", "p99_ms", "write_failures",
            "catchup_s", "installs", "groups", "transport", "peers",
            "election_convergence_s"}


# -- the rung, port and JAX ---------------------------------------------------

def _tiny_properties():
    """The rung's properties (``snapcatch_cluster``'s at 3 x 8 over the
    simulated transport) on the durable rungs' 4 s / 8 s tier: a load of
    8 x 1024 writes lasts about a second, and beside other test processes
    the 1 s / 2 s tier re-elected groups within it, some back onto the
    server about to be wiped."""
    p = cluster_properties(GROUPS, 3, "cpu", "sim")
    for k, v in bench.DURABLE_TIER.items():
        p.set(k, v)
    return p


def _port_rung(tmp):
    cluster = Cluster(GROUPS, 3, device="cpu", transport="sim",
                      properties=_tiny_properties(),
                      sm_storage_root=str(tmp))
    cluster.prewarm()
    return asyncio.run(sb.snapcatch_rung(cluster, WRITES))


def _jax_mirror_rung(tmp):
    props = jax_properties(_tiny_properties())
    cluster = jax_cluster_module().Cluster(
        GROUPS, 3, device="cpu", transport="sim", properties=props,
        sm_storage_root=str(tmp))
    prewarm_small(cluster)
    return asyncio.run(jax_tools_module("snapshot_bench").snapcatch_rung(
        cluster, WRITES))


def test_snapcatch_tiny_matches_jax(tmp_path, monkeypatch):
    # the wipe in waves smaller than the groups, as at full size (256 of
    # 1024): a wave of all 8 left the wiped engine no live row for a
    # moment, a tick then dropped its device state, and the rows came
    # back by a full upload, not by the refresh (K2) counted below
    for module in (cluster_module, jax_cluster_module()):
        monkeypatch.setattr(module, "WIPE_WAVE", 3)
    runs = {"port": _port_rung(tmp_path / "port"),
            "jax": _jax_mirror_rung(tmp_path / "jax")}
    for name, res in runs.items():
        assert JAX_KEYS <= set(res), name
        assert res["installs"] == GROUPS, (name, res["installs"])
        assert res["snapshots_at_last_seed_write"] == GROUPS, name
        assert all(i >= WRITES for i in res["snapshot_index"].values()), name
        # both loads acknowledged, on every replica, the wiped one too
        assert res["commits"] == GROUPS * WRITES * 2, name
        assert res["replica_mismatches"] == 0, (name, res)
        assert sorted(res["counters"].values()) == \
            [[2 * WRITES] * 3] * GROUPS, name
        # the wiped server's engine took the rows it released
        assert res["victim_live_rows"] == GROUPS, name
        assert res["victim_rows_reused"] == GROUPS, name
        assert res["refresh_rows_during_catchup"] >= GROUPS, name
        assert res["peers"] == 3 and res["transport"] == "sim", name
    assert runs["port"]["engine_device"] == "cpu"
    assert set(runs["port"]) == set(runs["jax"])


def test_jax_snapcatch_rung_gives_the_keys_and_installs():
    jax = asyncio.run(jax_bench.run_snapshot_catchup_bench(
        GROUPS, WRITES, concurrency=128, transport="sim"))
    assert set(jax) == JAX_KEYS
    assert jax["installs"] == GROUPS and jax["write_failures"] == 0


@pytest.mark.parametrize("transport", ["sim", "tcp"])
def test_snapcatch_properties_are_the_jax_benchs(tmp_path, transport):
    cluster = sb.snapcatch_cluster("cpu", GROUPS, str(tmp_path),
                                   transport=transport)
    port = dict(cluster.properties.items())
    jax = dict(bench_properties(True, GROUPS, num_servers=3,
                                transport=transport).items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cpu"
    assert port == jax
    assert cluster.sm_storage_root == str(tmp_path)


def test_snapshot_storage_is_laid_out_as_the_jax_benchs(tmp_path):
    """A group's state machine keeps its snapshots in
    ``{root}/{peer}/{group}`` on each server, as ``BenchCluster`` lays
    them out."""
    port = Cluster(4, 3, device="cpu", sm_storage_root=str(tmp_path / "p"))
    jax = jax_bench.BenchCluster(4, batched=True, num_servers=3,
                                 sm_storage_root=str(tmp_path / "j"))
    g = RaftGroupId.random_id()
    jg = JaxGroupId.value_of(g.uuid)
    for ps, js in zip(port.servers, jax.servers):
        pdir = ps._sm_registry(g) \
            .get_state_machine_storage().directory
        jdir = js._sm_registry(jg) \
            .get_state_machine_storage().directory
        assert pdir.relative_to(tmp_path / "p") == \
            jdir.relative_to(tmp_path / "j")
        assert pdir.is_dir()


def test_wipe_forgets_the_replicas_snapshots(tmp_path, monkeypatch):
    # waves of 3 over 4 groups: a full wave and a partial one
    monkeypatch.setattr(cluster_module, "WIPE_WAVE", 3)

    async def run():
        c = Cluster(4, 3, device="cpu", sm_storage_root=str(tmp_path))
        try:
            await c.start(timeout=60)
            await c.write_all(2)
            victim = c.servers[-1]
            for g in c.groups:
                await victim.divisions[g.group_id].take_snapshot_async()
            held = [victim.divisions[g.group_id].state_machine
                    .get_latest_snapshot() for g in c.groups]
            slots = {victim.divisions[g.group_id].engine_slot
                     for g in c.groups}
            await c.wipe(victim, c.groups)
            fresh = [victim.divisions[g.group_id] for g in c.groups]
            return (held, slots, {d.engine_slot for d in fresh},
                    [d.state_machine.get_latest_snapshot() for d in fresh])
        finally:
            await c.close()
    held, slots, fresh_slots, fresh_snaps = asyncio.run(run())
    assert all(h is not None for h in held)
    # new divisions on the released rows, nothing of the old ones left
    assert fresh_slots == slots
    assert fresh_snaps == [None] * 4


# -- the engine across a detach and an attach ---------------------------------

P = 4


def _engine(cls, **kw):
    e = cls(max_groups=16, max_peers=P, scalar_fallback_threshold=0,
            leadership_timeout_ms=300, use_device=True, **kw)
    e.clock = FakeClock()
    return e


def _setup(e, slot, role, flush, members=3):
    s = e.state
    s.set_conf(slot, 0, np.arange(P) < members, np.zeros(P, bool),
               np.zeros(P, np.int32), 0)
    s.role[slot] = role
    s.flush_index[slot] = flush
    s.first_leader_index[slot] = 0
    if role == ROLE_FOLLOWER:
        s.election_deadline_ms[slot] = e.clock.t + 10 ** 6


async def _reuse_row(cls, stale: str, **kw) -> dict:
    """Four follower rows; row 0 turns leader, takes ``stale`` traffic (two
    acks at 50, one at a time or as a batch, or a granted vote reply in
    an open round), is detached before the next tick and its row given to
    a new leader with flush 60 that opens a vote round: what the new
    listener saw, and the row's device state after the tick."""
    e = _engine(cls, **kw)
    for _ in range(4):
        _setup(e, e.attach(Recorder()), ROLE_FOLLOWER, 5)
    e.clock.t += 20
    await e.tick()
    e.state.role[0] = ROLE_LEADER
    e.state.mark_dirty(0)
    e.clock.t += 20
    await e.tick()
    if stale == "ack":
        e.on_ack(0, 1, 50)
        e.on_ack(0, 2, 50)
    elif stale == "ack_batch":
        e.on_ack_batch([(0, 1, 50), (0, 2, 50)])
    else:
        e.begin_vote_round(0, e.clock.t + 1000)
        e.on_vote_reply(0, 1, True)
    e.detach(0)
    rec = Recorder()
    slot = e.attach(rec)
    _setup(e, slot, ROLE_LEADER, 60)
    fut = e.begin_vote_round(slot, e.clock.t + 1000)
    e.clock.t += 20
    await e.tick()
    await asyncio.sleep(0)
    out = {"slot": slot, "events": list(rec.events),
           "vote": fut.result() if fut.done() else None,
           "grants": e.state.vote_grants[slot].tolist(),
           "match": np.asarray(e._dev.match_index[slot]).tolist()}
    await e.close()
    return out


@pytest.mark.parametrize("stale", ["ack", "ack_batch", "vote"])
def test_released_rows_events_never_reach_the_next_division(stale):
    port = asyncio.run(_reuse_row(TorchEngine, stale, device="cpu"))
    assert port["slot"] == 0
    assert port["events"] == []
    assert port["match"] == [-1] * P
    # only the candidate's own vote: the old round's reply went with it
    assert port["vote"] is None and port["grants"] == [True, False, False,
                                                       False]
    jax = asyncio.run(_reuse_row(JaxEngine, stale))
    # the reference hands the released row's events to the row's next
    # owner (its package is not edited here; recorded so a change shows)
    if stale == "vote":
        assert jax["grants"] == [True, True, False, False]
    else:
        assert jax["events"] == [("commit", 50)]


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_engine_state_matches_jax_across_detach_attach(seed):
    """Rows detached and attached every few ticks while acks, flushes and
    vote replies flow, some for the rows about to be released: after
    every tick the listener callbacks, the mirrors and the device state
    equal the JAX engine's (its released rows' queued events dropped by
    hand), and every reused row's device state is its mirror's (the
    refresh wrote all ten arrays)."""
    async def run():
        rng = random.Random(seed)
        j, t = _engine(JaxEngine), _engine(TorchEngine, device="cpu")
        recs = {}
        reused = 0

        def attach():
            rj, rt = Recorder(), Recorder()
            sj, st = j.attach(rj), t.attach(rt)
            assert sj == st
            recs[sj] = (rj, rt)
            role = rng.choice([ROLE_LEADER, ROLE_LEADER, ROLE_FOLLOWER])
            flush = rng.randint(0, 30)
            members = rng.randint(1, P)
            for e in (j, t):
                _setup(e, sj, role, flush, members)
            return sj

        for _ in range(12):
            attach()
        for step in range(40):
            for e in (j, t):
                e.clock.t += 37
            slots = sorted(recs)
            rows = [(rng.choice(slots), rng.randint(0, P - 1),
                     rng.randint(-1, 40)) for _ in range(rng.randint(1, 12))]
            for e in (j, t):
                e.on_ack_batch(rows)
            if rng.random() < 0.5:
                g, f = rng.choice(slots), rng.randint(0, 45)
                for e in (j, t):
                    e.on_flush(g, f)
            if rng.random() < 0.3:
                g = rng.choice(slots)
                if g not in j._vote_rounds:
                    dl = j.clock.t + rng.randint(50, 300)
                    j.begin_vote_round(g, dl)
                    t.begin_vote_round(g, dl)
            for g in list(j._vote_rounds):
                p, granted = rng.randint(1, P - 1), rng.random() < 0.6
                for e in (j, t):
                    e.on_vote_reply(g, p, granted)
            fresh = []
            if step % 3 == 1:
                for g in rng.sample(slots, rng.randint(1, 3)):
                    # more traffic for the row just before it goes
                    for e in (j, t):
                        e.on_ack(g, 1, 99)
                    detach_both(j, t, g)
                    recs.pop(g)
                for _ in range(len(slots) - len(recs)):
                    fresh.append(attach())
            await j.tick()
            await t.tick()
            await asyncio.sleep(0)
            _assert_same(j, t, step)
            for slot, (rj, rt) in recs.items():
                assert rj.events == rt.events, (step, slot)
            for slot in fresh:
                reused += 1
                for name in ("match_index", "flush_index", "conf_cur",
                             "role"):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(t._dev, name)[slot]),
                        getattr(t.state, name)[slot],
                        err_msg=f"step {step}: row {slot} {name}")
        assert reused >= 10
        assert t.metrics["refresh_ticks"] > 0
        for e in (j, t):
            await e.close()

    asyncio.run(run())
    assert "match_index" in MIRRORS


def test_snapcatch_rung_tiny_through_bench():
    """The rung through the bench over TCP at 16 groups and 8 writes a
    group: with 2 writes a group a load lasts tens of ms, and beside other
    test processes one slow snapshot file write on the loop read as the
    rung's write collapse."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = bench.main(["--device", "cpu", "--rungs", "snapcatch",
                           "--groups", "16", "--writes", "8"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])["snapcatch"]
    assert code == 0
    assert res["installs"] == 16 and res["missed_installs"] == 0
    assert res["replicas_read_back"] == 48 and res["replica_mismatches"] == 0
    assert res["commits"] == 16 * 8 * 2
    assert res["transport"] == "tcp" and res["engine_device"] == "cpu"
    assert sum(res["snapshot_index"].values()) == 16


# -- installs staged per group ------------------------------------------------

def _installer(root, group: str):
    """A follower's snapshot installer on the in-memory log, its counter
    state machine keeping snapshots in ``root/group``."""
    sm = CounterStateMachine()
    sm.get_state_machine_storage().init(root / group)
    sm.life_cycle.transition(LifeCycleState.STARTING)
    sm.life_cycle.transition(LifeCycleState.RUNNING)
    boundary = []
    div = SimpleNamespace(
        storage=None, state_machine=sm,
        member_id=SimpleNamespace(peer_id=RaftPeerId.value_of("s2")),
        state=SimpleNamespace(log=SimpleNamespace(
            set_snapshot_boundary=boundary.append)),
        set_applied_index=boundary.append)
    return SnapshotInstaller(div), sm


def _install_request(ti, chunks, done):
    header = RaftRpcHeader(RaftPeerId.value_of("s0"),
                           RaftPeerId.value_of("s2"),
                           RaftGroupId.random_id())
    return InstallSnapshotRequest(header, ti.term, snapshot_term_index=ti,
                                  chunks=tuple(chunks), done=done)


def test_installs_of_two_groups_stage_apart(tmp_path):
    """Two groups of one server install snapshots of the same name
    (``snapshot.1_5``: the same term and index) at once, the first in two
    chunks with the second group's whole install between them: each group
    ends with its own counter, staged in its own state machine storage.
    (Staged in one directory for all groups, the second install's start
    cleared the first's staged file, and its last chunk failed.)"""
    ti = TermIndex(1, 5)
    name = "snapshot.1_5"
    a, sm_a = _installer(tmp_path, "a")
    b, sm_b = _installer(tmp_path, "b")
    data_a, data_b = struct.pack(">q", 7), struct.pack(">q", 9)
    md5_a, md5_b = hashlib.md5(data_a).digest(), hashlib.md5(data_b).digest()

    def chunk(data, digest, i, off, part, done):
        return FileChunk(name, len(data), digest if done else b"", i, off,
                         part, done)

    async def run():
        r1 = await a.receive(_install_request(
            ti, [chunk(data_a, md5_a, 0, 0, data_a[:4], False)], False))
        assert (tmp_path / "a" / "tmp" / (name + ".install")).exists()
        r2 = await b.receive(_install_request(
            ti, [chunk(data_b, md5_b, 0, 0, data_b, True)], True))
        r3 = await a.receive(_install_request(
            ti, [chunk(data_a, md5_a, 1, 4, data_a[4:], True)], True))
        return r1, r2, r3

    results = asyncio.run(run())
    assert results == (InstallSnapshotResult.IN_PROGRESS,
                       InstallSnapshotResult.SUCCESS,
                       InstallSnapshotResult.SUCCESS)
    assert (sm_a.counter, sm_b.counter) == (7, 9)
    for g in ("a", "b"):
        assert (tmp_path / g / name).read_bytes() == \
            {"a": data_a, "b": data_b}[g]
        assert list((tmp_path / g / "tmp").iterdir()) == []
