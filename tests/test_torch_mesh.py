"""The mesh-sliced engine: the port against the JAX package's.

A mesh engine (``raft.tpu.engine.mesh-devices`` = S) keeps its group batch
as S contiguous slices; its fast tick is K5,
``engine_step_resident_fast_sliced``, over slice-routed ``[7, S, E]``
event planes whose rows are local to their slice.  The port runs the S
slices on one device; the JAX package runs them on the conftest's
8-virtual-device CPU fleet.  Everything here is int32 / int8 / bool, so
every comparison is exact:

- K5's plain version against JAX's for S in {1, 2, 8}, seeded planes with
  rows past the slice, negative rows and padding columns, and the two acks
  that show each slice wraps and drops by its own extent;
- the engine's slice-routed pack against JAX's;
- a mesh engine of 8 and of 2 slices against JAX's under one seeded churn
  script: the same raw slots, mirrors, device state, callbacks and
  metrics, tick for tick;
- a 3 x 32 cluster with ``mesh-devices=8``, port against JAX;
- ``dryrun_multichip`` and the refusal of a mesh over distinct cards.
"""

import asyncio
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratis_tpu.engine.engine import QuorumEngine as JaxEngine
from ratis_tpu.ops import quorum as jq
from ratis_tpu.parallel import make_group_mesh as jax_mesh
from ratis_tpu.tools.bench_cluster import bench_properties
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.engine.engine import QuorumEngine as TorchEngine
from ratis_tpu_torch.engine.state import (ROLE_CANDIDATE, ROLE_FOLLOWER,
                                          ROLE_LEADER)
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.parallel import make_group_mesh
from ratis_tpu_torch.tools import bench, cases
from ratis_tpu_torch.tools.cluster import cluster_properties

from tests.test_torch_cluster import GROUPS, WRITES, run_both_and_compare

P = 8
NOW = 100_000
SENT = tq.PACK_SENTINEL


def _jax_sliced(st, ev, meta):
    r = jq.engine_step_resident_fast_sliced(
        jq.DeviceState(*(jnp.asarray(a) for a in st)), jnp.asarray(ev),
        jnp.asarray(meta))
    return [np.asarray(r.out), *(np.asarray(a) for a in r.state)]


def _torch_sliced(st, ev, meta):
    r = tq.engine_step_resident_fast_sliced(
        tq.device_state_from_numpy(st, "cpu"), torch.from_numpy(ev),
        torch.from_numpy(meta))
    return [r.out.numpy(), *(t.numpy() for t in r.state)]


def _assert_equal(got, want):
    names = ("out",) + tq.DeviceState._fields
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_slices", [1, 2, 8])
def test_sliced_step_matches_jax(n_slices, seed, negative):
    rng = np.random.default_rng(100 * n_slices + seed)
    g, e = 64, 32
    st = cases.resident_state(rng, g, P, NOW)
    ev = cases.sliced_events(rng, g, P, n_slices, e, NOW, negative)
    meta = np.array([NOW, 300], np.int32)
    _assert_equal(_torch_sliced(st, ev, meta), _jax_sliced(st, ev, meta))


def test_each_slice_wraps_and_drops_by_its_own_extent():
    """G = 8 in 2 slices of 4 rows, 3 peers.  Slice 0's ack at local row 5
    lies past its slice: dropped, not spilled into row 5 of slice 1.
    Slice 1's ack at local row -1 is its own last row (global 7), not
    global row 3."""
    g, p = 8, 3
    st = [np.zeros((g, p), np.int32), np.zeros((g, p), np.int32),
          np.zeros((g, p), bool), np.zeros((g, p), bool),
          np.zeros((g, p), bool), np.zeros(g, np.int8),
          np.zeros(g, np.int32), np.zeros(g, np.int32),
          np.zeros(g, np.int32), np.full(g, 2 ** 31 - 1, np.int32)]
    ev = np.full((7, 2, 1), SENT, np.int32)
    ev[:, 0, 0] = [5, 1, 7, 100, 1, SENT, SENT]
    ev[:, 1, 0] = [-1, 2, 9, 100, 1, SENT, SENT]
    meta = np.array([100, 300], np.int32)
    got = _torch_sliced(st, ev, meta)
    _assert_equal(got, _jax_sliced(st, ev, meta))
    match = got[1]
    assert match[7, 2] == 9
    assert np.count_nonzero(match) == 1


@pytest.mark.parametrize("negative", [False, True])
def test_one_slice_is_the_flat_fast_step(negative):
    rng = np.random.default_rng(7)
    g = 64
    st = cases.resident_state(rng, g, P, NOW)
    ev = cases.fast_events(rng, g, P, 32, NOW, negative)
    meta = np.array([NOW, 300], np.int32)
    a = tq.device_state_from_numpy(st, "cpu")
    b = tq.device_state_from_numpy(st, "cpu")
    k5 = tq.engine_step_resident_fast_sliced(a, torch.from_numpy(ev[:, None]),
                                             torch.from_numpy(meta))
    k1 = tq.engine_step_resident_fast(b, torch.from_numpy(ev),
                                      torch.from_numpy(meta))
    assert torch.equal(k5.out, k1.out)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sliced_step_checks_its_slices():
    st = tq.device_state_from_numpy(
        cases.resident_state(np.random.default_rng(0), 12, P, NOW), "cpu")
    meta = torch.tensor([NOW, 300], dtype=torch.int32)
    with pytest.raises(ValueError, match="divide"):
        tq.engine_step_resident_fast_sliced(
            st, torch.zeros((7, 8, 4), dtype=torch.int32), meta)
    with pytest.raises(ValueError, match=r"\[7, S, E\]"):
        tq.engine_step_resident_fast_sliced(
            st, torch.zeros((7, 4), dtype=torch.int32), meta)


# -- the engine --------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0

    def now_ms(self):
        return self.t

    def advance_epoch(self, delta_ms):
        self.t -= delta_ms


class Recorder:
    def __init__(self):
        self.events = []

    async def on_election_timeout(self):
        self.events.append("timeout")

    async def on_commit_advance(self, c):
        self.events.append(("commit", c))

    async def on_leadership_stale(self):
        self.events.append("stale")


def _mesh_engines(n_slices: int, g: int):
    kw = dict(max_groups=g, max_peers=P, scalar_fallback_threshold=0,
              leadership_timeout_ms=300, use_device=True)
    j = JaxEngine(mesh=jax_mesh(n_slices), **kw)
    t = TorchEngine(mesh=make_group_mesh(n_slices, device="cpu"),
                    device="cpu", **kw)
    for e in (j, t):
        e.clock = FakeClock()
    return j, t


def test_sliced_pack_matches_jax():
    j, t = _mesh_engines(8, 64)
    rng = np.random.default_rng(5)
    for n_acks, n_up in ((0, 0), (1, 0), (0, 3), (40, 9), (300, 20)):
        acks = [(int(rng.integers(0, 64)), int(rng.integers(0, P)),
                 int(rng.integers(0, 99)), int(rng.integers(0, 999)))
                for _ in range(n_acks)]
        slots = rng.permutation(64)[:n_up]
        updates = {int(s): [int(rng.integers(-1, 99)),
                            int(rng.choice([SENT, 500]))] for s in slots}
        want = j._pack_tick_sliced(acks, dict(updates)).copy()
        got = t._pack_tick_sliced(acks, dict(updates))
        assert got.dtype == want.dtype and got.shape == want.shape
        # padding columns (invalid, both updates sentinel) name a dropped
        # slot in the port, where the JAX package names row 0: both land
        # nowhere
        pad = (want[4] == 0) & (want[5] == SENT) & (want[6] == SENT)
        assert (want[0][pad] == 0).all()
        want[0][pad] = SENT
        np.testing.assert_array_equal(got, want)
        assert (t._last_event_rows, t._last_event_cap) == \
            (j._last_event_rows, j._last_event_cap)


MIRRORS = ("role", "match_index", "last_ack_ms", "flush_index",
           "commit_index", "election_deadline_ms", "vote_deadline_ms",
           "vote_grants", "vote_rejects", "conf_cur", "conf_old")
METRICS = ("batched_dispatches", "fast_ticks", "refresh_ticks",
           "refresh_rows")


def _assert_same(j, t, step):
    for name in MIRRORS:
        np.testing.assert_array_equal(getattr(t.state, name),
                                      getattr(j.state, name),
                                      err_msg=f"step {step}: mirror {name}")
    assert (j._dev is None) == (t._dev is None), step
    if t._dev is not None:
        for name, a, b in zip(tq.DeviceState._fields, j._dev, t._dev):
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(a),
                err_msg=f"step {step}: device {name}")
    for name in METRICS:
        assert t.metrics[name] == j.metrics[name], (step, name)


@pytest.mark.parametrize("n_slices,seed", [(8, 11), (2, 12)])
def test_mesh_engine_churn_matches_jax(n_slices, seed):
    """One seeded script on both mesh engines: attach pinned to each
    group's crc32 slice (as divisions attach) and detach, acks scalar and
    batched, flush advances and regressions, deadline re-arms, role and
    conf flips (dirty-row refreshes), vote rounds, and a backlog above the
    dispatch chunk cap.  Raw slot numbers, mirrors, device state,
    callbacks and metrics must be equal after every tick."""
    g = 64

    async def run():
        rng = random.Random(seed)
        j, t = _mesh_engines(n_slices, g)
        engines = (j, t)
        recs = {}       # slot -> (jax recorder, torch recorder)
        futs = []
        next_key = [0]

        def both(fn):
            for e in engines:
                fn(e)

        def attach():
            key = f"group-{seed}-{next_key[0]}".encode()
            next_key[0] += 1
            pin = t.slice_of(key)
            assert pin == j.slice_of(key)
            if not t.state._free[pin]:
                pin = -1  # the slice is full: the lowest with room
            rj, rt = Recorder(), Recorder()
            sj, st = j.attach(rj, pin), t.attach(rt, pin)
            assert sj == st
            assert pin < 0 or st // (g // n_slices) == pin
            recs[sj] = (rj, rt)
            role = rng.choice([ROLE_LEADER, ROLE_LEADER, ROLE_FOLLOWER,
                               ROLE_CANDIDATE])
            n = rng.randint(1, 5)
            cur = np.arange(P) < n
            flush, dl = rng.randint(-1, 10), rng.randint(1, 400)

            def setup(e):
                s = e.state
                s.set_conf(sj, 0, cur, np.zeros(P, bool),
                           np.zeros(P, np.int32), 0)
                s.role[sj] = role
                s.flush_index[sj] = flush
                s.first_leader_index[sj] = 0
                s.last_ack_ms[sj, :n] = e.clock.t
                if role == ROLE_FOLLOWER:
                    s.election_deadline_ms[sj] = e.clock.t + dl
            both(setup)

        for _ in range(20):
            attach()
        for step in range(40):
            for e in engines:
                e.clock.t += 37
            now = j.clock.t
            slots = sorted(recs)
            for _ in range(rng.randint(0, 10)):
                s_, p, m = rng.choice(slots), rng.randint(0, P - 1), \
                    rng.randint(-1, 14)
                both(lambda e: e.on_ack(s_, p, m))
            if rng.random() < 0.3:
                rows = [(rng.choice(slots), rng.randint(0, P - 1),
                         rng.randint(0, 14)) for _ in range(6)]
                both(lambda e: e.on_ack_batch(rows))
            if rng.random() < 0.5:
                s_, f = rng.choice(slots), rng.randint(-1, 16)
                both(lambda e: e.on_flush(s_, f))
            if rng.random() < 0.3:
                s_ = rng.choice(slots)
                if j.state.role[s_] == ROLE_FOLLOWER:
                    d = now + rng.randint(1, 300)
                    both(lambda e: e.on_deadline(s_, d))
            if rng.random() < 0.2:
                s_ = rng.choice(slots)
                role = rng.choice([ROLE_LEADER, ROLE_FOLLOWER])
                old = np.arange(P) < rng.randint(0, 4)

                def change(e):
                    st = e.state
                    st.role[s_] = role
                    st.conf_old[s_] = old
                    st.mark_dirty(s_)
                    if role == ROLE_FOLLOWER:
                        st.election_deadline_ms[s_] = now + 50
                both(change)
            if rng.random() < 0.15:
                s_ = rng.choice(slots)
                if s_ not in j._vote_rounds:
                    dl = now + rng.randint(50, 200)
                    futs.append((j.begin_vote_round(s_, dl),
                                 t.begin_vote_round(s_, dl)))
            for s_ in list(j._vote_rounds):
                if rng.random() < 0.5:
                    p, granted = rng.randint(1, P - 1), rng.random() < 0.6
                    both(lambda e: e.on_vote_reply(s_, p, granted))
            if step in (10, 25):
                s_ = rng.choice(slots)
                both(lambda e: e.detach(s_))
                recs.pop(s_)
                attach()
                attach()
            if step == 30:
                # backlog above the chunk cap: dispatched in chunks of the
                # flat event count, each packed per slice
                big = [(rng.choice(slots), rng.randint(0, P - 1),
                        rng.randint(0, 20))
                       for _ in range(JaxEngine._MAX_EVENT_BUCKET + 700)]
                both(lambda e: e.on_ack_batch(big))
            before = t.metrics["batched_dispatches"]
            await j.tick()
            await t.tick()
            await asyncio.sleep(0)
            if step == 30:
                assert t.metrics["batched_dispatches"] - before >= 2
            _assert_same(j, t, step)
            for slot, (rj, rt) in recs.items():
                assert rj.events == rt.events, (step, slot)
            for fj, ft in futs:
                assert fj.done() == ft.done(), step
                if fj.done() and not fj.cancelled():
                    assert fj.result() == ft.result(), step

        assert t.metrics["fast_ticks"] > 0 and t.metrics["refresh_ticks"] > 0
        assert t.state.n_slices == n_slices
        seen = {x if isinstance(x, str) else x[0]
                for rj, _ in recs.values() for x in rj.events}
        assert "commit" in seen and "timeout" in seen, seen
        for e in engines:
            await e.close()

    asyncio.run(run())


def test_mesh_engine_launches_the_sliced_step(monkeypatch):
    """A mesh engine's fast ticks go through the fast plan as K5 over its
    8 slices (never K1, and never a public wrapper), its refresh ticks
    through K2's prepared call, both on the flat state with global rows."""
    calls = []
    for name in ("engine_step_resident_fast", "engine_step_resident",
                 "engine_step_resident_fast_sliced"):
        fn = getattr(tq, name)

        def rec(*a, _fn=fn, _name=name):
            calls.append((_name, tuple(a[1].shape)))
            return _fn(*a)
        monkeypatch.setattr(tq, name, rec)
    for cls in (tq.RefreshPlan, tq.FastPlan):
        run = cls.run

        def rec_run(plan, *a, _run=run, _name=f"{cls.__name__}.run"):
            calls.append((_name, tuple(plan.state.match_index.shape)))
            if _name == "FastPlan.run":
                calls.append(("fast kernel", (plan.kernel.symbol,
                                              plan.n_slices)))
            return _run(plan, *a)
        monkeypatch.setattr(cls, "run", rec_run)
    res = bench.dryrun_multichip(8, device="cpu")
    names = {n for n, _ in calls}
    assert names == {"FastPlan.run", "fast kernel", "RefreshPlan.run"}
    # both run on the whole flat [G, P] state
    assert {shape for n, shape in calls if n.endswith("Plan.run")} == {
        (res["groups"], P)}
    assert {shape for n, shape in calls if n == "fast kernel"} == {
        ("k5_resident_fast_sliced", 8)}
    assert res["refresh_ticks"] > 0 and res["fast_ticks"] > 0


def test_engine_pads_capacity_to_the_mesh():
    t = TorchEngine(max_groups=60, max_peers=P, device="cpu",
                    mesh=make_group_mesh(8, device="cpu"))
    j = JaxEngine(max_groups=60, max_peers=P, mesh=jax_mesh(8))
    assert t.state.capacity == j.state.capacity == 64
    assert t.state.slice_rows == 8
    assert (t.state.role == 0).all()
    with pytest.raises(ValueError, match="mesh on"):
        TorchEngine(device="cpu", mesh=make_group_mesh(2, device="meta"))


@pytest.mark.parametrize("n", [8, 2])
def test_dryrun_multichip(n):
    res = bench.dryrun_multichip(n, device="cpu")
    assert res["n_slices"] == n and res["commits"] == [5]
    assert res["device"] == "cpu" and res["refresh_ticks"] > 0


def test_mesh_over_distinct_cards_is_refused():
    with pytest.raises(NotImplementedError, match="several GPUs"):
        make_group_mesh(devices=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="several GPUs"):
        make_group_mesh(2, devices=["cpu", "cuda:0", "cuda:1"])
    mesh = make_group_mesh(devices=["cuda", "cuda:0"])
    assert mesh.n_slices == 2 and mesh.device == torch.device("cuda")


# -- the cluster --------------------------------------------------------------

@pytest.mark.parametrize("groups", [32, 1024, 10240])
def test_mesh_properties_are_the_jax_bench_properties(groups):
    port = dict(cluster_properties(groups, 3, "cuda", "sim", 8).items())
    jax = dict(bench_properties(True, groups, mesh_devices=8, num_servers=3,
                                transport="sim").items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    assert port[RaftServerConfigKeys.Engine.MESH_DEVICES_KEY] == "8"


def test_mesh_cluster_matches_jax(monkeypatch):
    props = cluster_properties(GROUPS, 3, "cpu", "sim", mesh_devices=8)
    # crc32 pins fill the 8 slices unevenly: room for 32 groups in each
    props.set(RaftServerConfigKeys.Engine.MAX_GROUPS_KEY, "256")
    runs = run_both_and_compare(monkeypatch, "sim", props)
    for name, run in runs.items():
        for e in run["engines"]:
            assert e.state.n_slices == 8, name
            assert e.mesh is not None, name
    assert runs["torch"]["counters"] == [[WRITES] * 3] * GROUPS
