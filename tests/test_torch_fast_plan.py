"""The engine's fast tick (K1, and K5 on a mesh engine) through its prepared
call, ``ops.quorum.FastPlan``, against the JAX package.

The engine packs each fast tick's acks and slot updates into one buffer
(``FastPlan.events``: the seven rows of the fast pack, each [S, E], back to
back); on a card one call copies the buffer up, launches the kernel and
copies the result down.  On the CPU the same buffer feeds the plain
versions, so these tests hold the packing itself against the JAX
functions, jitted on the CPU:

- seeded ticks at every event bucket and at 3, 5, 8 and 16 peers, with
  negative and out-of-range rows and peers, sentinel updates and
  duplicate acks, against ``engine_step_resident_fast``;
- a hand-made tick: rows and peers counted from the end and dropped, a
  deadline re-armed and timed out in the same tick, a flush update and an
  ack on one row;
- every ack aimed at three rows (a few hot groups' backlog), flat and
  sliced;
- the sliced plan against ``engine_step_resident_fast_sliced`` at 1, 2 and
  8 slices, slices whose extent is not a multiple of the kernel's tile,
  and one slice equal to the flat tick;
- ``FAST_LAYOUT``: the offsets the C entry takes, the [7, S, E] view over
  the same bytes, 16-byte aligned rows;
- the engine's fast route tick for tick against the JAX engine on the
  same acks, flat and in 8 slices, every fast tick one ``FastPlan.run``.

Everything is int32 / int8 / bool: every comparison is exact.
"""

import asyncio
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ratis_tpu.engine.engine import QuorumEngine as JaxEngine
from ratis_tpu.ops import quorum as jq
from ratis_tpu.parallel import make_group_mesh as jax_mesh
from ratis_tpu_torch.engine.engine import QuorumEngine as TorchEngine
from ratis_tpu_torch.engine.state import ROLE_FOLLOWER, ROLE_LEADER
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.parallel import make_group_mesh
from ratis_tpu_torch.tools import cases

from tests.test_torch_engine import FakeClock, Recorder
from tests.test_torch_mesh import _assert_same

NOW = 100_000
TIMEOUT = 300
SENT = tq.PACK_SENTINEL
INT32_MAX = 2 ** 31 - 1

_jfast = jax.jit(jq.engine_step_resident_fast)
_jsliced = jax.jit(jq.engine_step_resident_fast_sliced)


def _plan_both(st, ev, sliced=False):
    """The JAX fast tick (flat, or sliced for a [7, S, E] ``ev``) and the
    port's fast plan on the CPU, packed as the engine packs: equal out
    and equal state.  Returns the plan's out."""
    g = len(st[0])
    meta = jnp.asarray(np.array([NOW, TIMEOUT], np.int32))
    fn = _jsliced if sliced else _jfast
    jr = fn(jq.DeviceState(*map(jnp.asarray, st)), jnp.asarray(ev), meta)
    state = tq.device_state_from_numpy(st, "cpu")
    plan = cases.fast_plan(state, ev, sliced)
    out = plan.run(ev.shape[-1], NOW, TIMEOUT)
    assert out.shape == (4, g) and out.dtype == np.int32
    assert plan.kernel is (tq.K5 if sliced else tq.K1)
    np.testing.assert_array_equal(out, np.asarray(jr.out))
    for name, j, t in zip(tq.DeviceState._fields, jr.state, state):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    return out


@pytest.mark.parametrize("e", [64, 256, 1024, 4096, 16384])
@pytest.mark.parametrize("p", [3, 5, 8, 16])
def test_fast_plan_matches_jax(p, e):
    rng = np.random.default_rng(p * 100 + e)
    g = 150
    _plan_both(cases.resident_state(rng, g, p, NOW),
               cases.fast_events(rng, g, p, e, NOW, negative=e % 2 == 0))


@pytest.mark.parametrize("p", [3, 5, 8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_fast_plan_negative_and_dropped_indices_match_jax(p, seed):
    rng = np.random.default_rng(seed + 10 * p)
    g, e = 64, 256
    ev = cases.fast_events(rng, g, p, e, NOW, negative=True)
    # acks past the rows and the peers (dropped), and a sentinel update
    # column on a real row (changes nothing)
    ev[0, :4] = [g, g + 3, -g - 1, -2 * g]
    ev[1, 4:8] = [p, p + 2, -p - 1, -3 * p]
    ev[4, :8] = 1
    col = e // 2
    ev[0, col], ev[5, col], ev[6, col] = 5, SENT, SENT
    _plan_both(cases.resident_state(rng, g, p, NOW), ev)


def test_fast_plan_hand_made_tick():
    """G = 4, P = 3, every row a 3-member conf with slot 0 the leader's
    own: acks at row -4 (row 0) peer -2 (peer 1) and at row 0 peer 1 again
    (the larger lands), at peer 2 of row 0, and at rows 4, -5 and peer 3
    (dropped), an invalid ack carrying garbage; a flush update on row 0;
    row 3, a follower whose deadline is disarmed, re-armed to the past in
    this tick (it times out now, and is disarmed again); a sentinel
    update on row 2 (nothing changes)."""
    g, p = 4, 3
    role = np.array([ROLE_LEADER, ROLE_LEADER, ROLE_FOLLOWER, ROLE_FOLLOWER],
                    np.int8)
    st = [np.zeros((g, p), np.int32), np.full((g, p), NOW, np.int32),
          np.eye(g, p, dtype=bool), np.ones((g, p), bool),
          np.zeros((g, p), bool), role, np.full(g, 2, np.int32),
          np.zeros(g, np.int32), np.zeros(g, np.int32),
          np.full(g, INT32_MAX, np.int32)]
    cols = [  # slot, peer, match, time, valid, flush, deadline
        (-4, -2, 3, NOW, 1, SENT, SENT), (0, 1, 6, NOW, 1, SENT, SENT),
        (0, 2, 5, NOW, 1, SENT, SENT), (4, 1, 9, NOW, 1, SENT, SENT),
        (-5, 1, 9, NOW, 1, SENT, SENT), (1, 3, 9, NOW, 1, SENT, SENT),
        (1, 1, 99, 7, 0, SENT, SENT), (0, 0, SENT, SENT, 0, 8, SENT),
        (3, 0, SENT, SENT, 0, SENT, NOW - 1), (2, 0, SENT, SENT, 0, SENT,
                                               SENT)]
    ev = np.full((7, 64), SENT, np.int32)
    ev[(0, 1, 4), :] = 0
    ev[:, :len(cols)] = np.array(cols, np.int32).T
    out = _plan_both(st, ev)
    # row 0: own flush 8, peers 6 and 5: commit 6; row 1: no acks
    assert list(out[0]) == [6, 0, 0, 0]
    assert list(out[1]) == [1, 0, 0, 0]
    # row 3 timed out on the deadline re-armed in this tick
    assert list(out[2]) == [0, 0, 0, 1]


@pytest.mark.parametrize("e", [4096, 16384])
@pytest.mark.parametrize("sliced", [False, True])
def test_fast_plan_hot_rows_match_jax(sliced, e):
    """Every ack aimed at three rows (of each slice): a few hot groups'
    backlog, which the kernel lands in several rounds of one tile."""
    rng = np.random.default_rng(e + sliced)
    g, p = 256, 8
    ev = (cases.sliced_events(rng, g, p, 2, e, NOW) if sliced
          else cases.fast_events(rng, g, p, e, NOW))
    _plan_both(cases.resident_state(rng, g, p, NOW), cases.hot_acks(rng, ev),
               sliced)


@pytest.mark.parametrize("p", [3, 8, 16])
@pytest.mark.parametrize("n_slices,g", [(1, 100), (2, 200), (8, 264),
                                        (8, 2048)])
@pytest.mark.parametrize("negative", [False, True])
def test_sliced_fast_plan_matches_jax(n_slices, g, p, negative):
    """Slices of 100, 33 and 256 rows: the first two no multiple of the
    kernel's tile (a tile straddles two slices there)."""
    rng = np.random.default_rng(n_slices + g + p + negative)
    _plan_both(cases.resident_state(rng, g, p, NOW),
               cases.sliced_events(rng, g, p, n_slices, 256, NOW, negative),
               sliced=True)


def test_one_slice_is_the_flat_tick():
    rng = np.random.default_rng(4)
    g, p = 100, 5
    st = cases.resident_state(rng, g, p, NOW)
    ev = cases.fast_events(rng, g, p, 1024, NOW, negative=True)
    flat = _plan_both(st, ev).copy()
    sliced = _plan_both(st, ev[:, None], sliced=True)
    np.testing.assert_array_equal(flat, sliced)


@pytest.mark.parametrize("s,e", [(1, 64), (1, 16384), (8, 64), (8, 256)])
def test_fast_layout_offsets_and_alignment(s, e):
    """The offsets ``fast_tick`` takes are FAST_LAYOUT's, row by row in
    FAST_ROWS order, then the total; each row starts 16-byte aligned (the
    kernel's 16-byte index loads); the plan's [7, S, E] view reads the
    same bytes; the buffer holds the largest tick and refuses more."""
    shapes = tq.fast_shapes(s, e)
    offs = tq.layout_offsets(tq.FAST_LAYOUT, shapes)
    got = list(tq.tick_offsets(tq.FAST_LAYOUT, shapes, tq.FAST_ROWS))
    assert got == offs == [4 * s * e * i for i in range(8)]
    assert all(o % 16 == 0 for o in got)
    st = tq.device_state_from_numpy(
        cases.resident_state(np.random.default_rng(0), 8 * s, 3, NOW), "cpu")
    plan = tq.FastPlan(st, e, s if s > 1 else None)
    ev = plan.events(e)
    assert ev.shape == (7, s, e) and ev.dtype == np.int32
    base = plan._host.numpy().ctypes.data
    for row, name in enumerate(tq.FAST_ROWS):
        assert ev[row].ctypes.data - base == offs[row], name
    assert plan.events(e // 2).ctypes.data == base
    with pytest.raises(ValueError, match="holds"):
        plan.events(e + 1)


def test_fast_plan_refuses_what_it_cannot_hold():
    st = tq.device_state_from_numpy(
        cases.resident_state(np.random.default_rng(0), 12, 3, NOW), "cpu")
    with pytest.raises(ValueError, match="slices do not divide"):
        tq.FastPlan(st, 64, 8)
    plan = tq.FastPlan(st, 64, 4)
    other = tq.device_state_from_numpy(
        cases.resident_state(np.random.default_rng(0), 16, 3, NOW), "cpu")
    with pytest.raises(ValueError, match="the plan is for"):
        plan.bind(other)


def _lockstep_engines(n_slices):
    kw = dict(max_groups=64, max_peers=5, scalar_fallback_threshold=0,
              leadership_timeout_ms=300, use_device=True)
    if n_slices:
        j = JaxEngine(mesh=jax_mesh(n_slices), **kw)
        t = TorchEngine(mesh=make_group_mesh(n_slices, device="cpu"),
                        device="cpu", **kw)
    else:
        j, t = JaxEngine(**kw), TorchEngine(device="cpu", **kw)
    for e in (j, t):
        e.clock = FakeClock()
    return j, t


@pytest.mark.parametrize("n_slices", [0, 8])
def test_engine_fast_route_matches_jax(monkeypatch, n_slices):
    """The JAX engine against the port's on one script of acks (scalar
    and batched, duplicates, on followers too), flush advances and
    deadline re-arms that expire: after the first tick's full upload
    every tick is a fast tick, each one ``FastPlan.run`` (K1 flat, K5 over 8
    slices); mirrors, device state, callbacks and metrics equal after
    every tick."""
    runs = []
    run = tq.FastPlan.run

    def rec_run(plan, *a):
        runs.append(plan.kernel)
        return run(plan, *a)
    monkeypatch.setattr(tq.FastPlan, "run", rec_run)

    async def script():
        rng = random.Random(31 + n_slices)
        j, t = _lockstep_engines(n_slices)
        engines = (j, t)
        recs = {}

        def both(fn):
            for e in engines:
                fn(e)

        for i in range(48):
            rj, rt = Recorder(), Recorder()
            sj, st = j.attach(rj), t.attach(rt)
            assert sj == st
            recs[sj] = (rj, rt)
            role = ROLE_LEADER if i % 3 else ROLE_FOLLOWER
            n = rng.randint(1, 5)

            def setup(e, slot=sj, role=role, n=n):
                s = e.state
                s.set_conf(slot, 0, np.arange(5) < n, np.zeros(5, bool),
                           np.zeros(5, np.int32), 0)
                s.role[slot] = role
                s.flush_index[slot] = 0
                s.first_leader_index[slot] = 0
                s.last_ack_ms[slot, :n] = 0
                if role == ROLE_FOLLOWER:
                    s.election_deadline_ms[slot] = 10_000
            both(setup)
        await j.tick()
        await t.tick()
        slots = sorted(recs)
        for step in range(60):
            for e in engines:
                e.clock.t += 23
            now = j.clock.t
            for _ in range(rng.randint(0, 30)):
                s_, p, m = rng.choice(slots), rng.randint(0, 4), \
                    rng.randint(-1, 40)
                both(lambda e: e.on_ack(s_, p, m))
            if rng.random() < 0.5:
                rows = [(rng.choice(slots), rng.randint(0, 4),
                         rng.randint(0, 40)) for _ in range(20)]
                rows += rows[:3]  # duplicates in one batch
                both(lambda e: e.on_ack_batch(rows))
            for s_ in rng.sample(slots, rng.randint(0, 8)):
                f = int(j.state.flush_index[s_]) + rng.randint(0, 5)
                both(lambda e: e.on_flush(s_, f))
            for s_ in rng.sample(slots, rng.randint(0, 4)):
                if j.state.role[s_] == ROLE_FOLLOWER:
                    d = now + rng.choice([-5, 0, 40, 200])
                    both(lambda e: e.on_deadline(s_, d))
            await j.tick()
            await t.tick()
            await asyncio.sleep(0)
            _assert_same(j, t, step)
            for slot, (rj, rt) in recs.items():
                assert rj.events == rt.events, (step, slot)
        assert t.metrics["refresh_ticks"] == j.metrics["refresh_ticks"] == 0
        assert t.metrics["fast_ticks"] == len(runs) >= 50
        seen = {x if isinstance(x, str) else x[0]
                for rj, _ in recs.values() for x in rj.events}
        assert {"commit", "timeout"} <= seen, seen
        for e in engines:
            await e.close()

    asyncio.run(script())
    assert set(runs) == {tq.K5 if n_slices else tq.K1}
