"""The engine's prepared calls (K2's refresh tick, K3's vote pass) against
the JAX package.

The engine packs each refresh tick into one buffer (``RefreshPlan``) and
each vote pass's open rounds into another (``TallyPlan``); on a card one
call copies the buffer up, launches the kernel and copies the result
down.  On the CPU the same buffers feed the plain versions, so these tests
hold the packing layout itself against the JAX functions:

- K2: seeded refresh ticks written into the plan's views at every bucket
  of D and E from 64 to 16384, with padding index G, negative indices,
  duplicate acks and acks on refreshed rows, against
  ``ratis_tpu.ops.quorum.engine_step_resident``;
- K3: the rows of some groups gathered into the plan as bit words and
  padded with stale rows, at 3, 5, 8 and 16 peers with joint confs and
  priority vetoes, against ``ratis_tpu.ops.quorum.tally_votes`` on all
  rows; K3's row entry as a function (``tally_rows``) likewise;
- the byte offsets each prepared call hands its C entry, section by
  section from the host's layout;
- an engine lockstep run (JAX engine against the port's on the CPU) with
  many open vote rounds, dirty rows on most ticks and a capacity regrow.

Everything is int32 / int8 / bool: every comparison is exact.
"""

import asyncio
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratis_tpu.engine.engine import QuorumEngine as JaxEngine
from ratis_tpu.ops import quorum as jq
from ratis_tpu_torch.engine.engine import QuorumEngine as TorchEngine
from ratis_tpu_torch.engine.state import (ROLE_CANDIDATE, ROLE_FOLLOWER,
                                          ROLE_LEADER)
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.tools import cases

from tests.test_torch_engine import FakeClock, Recorder, _assert_same

NOW = 100_000
TIMEOUT = 300

_jrefresh = jax.jit(jq.engine_step_resident)
_jtally = jax.jit(jq.tally_votes)


def _refresh_both(st, rf_idx, rf, acks):
    g = len(st[0])
    d, e = len(rf_idx), len(acks[0])
    jr = _jrefresh(jq.DeviceState(*map(jnp.asarray, st)),
                   jnp.asarray(rf_idx), *map(jnp.asarray, rf),
                   *map(jnp.asarray, acks), jnp.int32(NOW),
                   jnp.int32(TIMEOUT))
    state = tq.device_state_from_numpy(st, "cpu")
    out = cases.refresh_plan(state, rf_idx, rf, acks).run(d, e, NOW, TIMEOUT)
    assert out.shape == (4, g) and out.dtype == np.int32
    np.testing.assert_array_equal(out[0], np.asarray(jr.new_commit))
    for i, f in enumerate(("commit_changed", "timeouts", "stale"), 1):
        np.testing.assert_array_equal(out[i] != 0, np.asarray(getattr(jr, f)),
                                      err_msg=f)
    for name, j, t in zip(tq.DeviceState._fields, jr.state, state):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    return out


# every bucket the engine pads D and E to, each once on either side
@pytest.mark.parametrize("d,e", [(64, 16384), (256, 4096), (1024, 1024),
                                 (4096, 256), (16384, 64)])
@pytest.mark.parametrize("negative", [False, True])
def test_refresh_plan_layout_matches_jax(d, e, negative):
    rng = np.random.default_rng(d + e + negative)
    g, p = 200, 5
    st = cases.resident_state(rng, g, p, NOW)
    rf_idx, rf, acks = cases.refresh(rng, g, p, d, e, NOW, negative)
    # acks on refreshed rows land on top of the refresh; duplicates max
    real = rf_idx[rf_idx < g]
    hit = rng.integers(0, e, size=min(e, 3 * len(real)))
    acks[0][hit] = rng.choice(real, size=len(hit))
    acks[4][hit] = True
    acks[0][hit[:8]] = acks[0][hit[0]]
    acks[1][hit[:8]] = acks[1][hit[0]]
    assert (rf_idx == g).any() and len(set(real.tolist())) == len(real)
    _refresh_both(st, rf_idx, rf, acks)


def test_refresh_plan_hand_made_rows():
    """G = 4, P = 3: refresh rows 1 and -1 (row 3), padding G and -G-1
    (both dropped); an ack on refreshed row 1 lands on top of it, two
    acks on one (group, peer) keep the larger, an invalid ack writes
    nothing."""
    g, p = 4, 3
    st = [np.zeros((g, p), np.int32), np.zeros((g, p), np.int32),
          np.eye(g, p, dtype=bool), np.ones((g, p), bool),
          np.zeros((g, p), bool), np.full(g, ROLE_LEADER, np.int8),
          np.full(g, 9, np.int32), np.zeros(g, np.int32),
          np.zeros(g, np.int32), np.full(g, 2 ** 31 - 1, np.int32)]
    rf_idx = np.array([1, -1, g, -g - 1], np.int32)
    rf = [np.full((4, p), 5, np.int32), np.full((4, p), NOW, np.int32),
          np.eye(4, p, dtype=bool), np.ones((4, p), bool),
          np.zeros((4, p), bool), np.full(4, ROLE_LEADER, np.int8),
          np.full(4, 9, np.int32), np.full(4, 2, np.int32),
          np.zeros(4, np.int32), np.full(4, 2 ** 31 - 1, np.int32)]
    acks = [np.array([1, 0, 0, 2], np.int32), np.array([2, 1, 1, 0], np.int32),
            np.array([8, 3, 6, 99], np.int32),
            np.array([NOW, NOW, NOW, NOW], np.int32),
            np.array([True, True, True, False])]
    out = _refresh_both(st, rf_idx, rf, acks)
    # row 0: acks 3 and 6 on peer 1, commit 6; row 1: refreshed to 5s, the
    # ack raises peer 2 to 8, commit 8; row 3 (refreshed as -1): commit 5
    assert list(out[0]) == [6, 8, 0, 5]


@pytest.mark.parametrize("p", [3, 5, 8, 16])
@pytest.mark.parametrize("r", [1, 64, 300])
def test_gathered_tally_matches_jax(p, r):
    rng = np.random.default_rng(p * 1000 + r)
    g = 512
    grants, rejects, cur, old, prio, self_prio = cases.tally_inputs(rng, g, p)
    # vetoes: a rejecting member with a priority above the candidate's
    veto = rng.random(g) < 0.1
    prio[veto, 0] = self_prio[veto] + 1
    rejects[veto, 0] = cur[veto, 0]
    grants[veto, 0] = False
    want = _jtally(*map(jnp.asarray, (grants, rejects, cur, old, prio,
                                      self_prio)))
    rows = np.sort(rng.permutation(g)[:r])
    rcap = TorchEngine._bucket(r)
    plan = cases.tally_plan(
        [grants, rejects, cur, old, prio, self_prio], rows, "cpu", rcap)
    got = plan.run(rcap)
    assert got.dtype == np.bool_
    # the padding rows (stale rows of other groups) are tallied too
    full = cases.padded_rows(rows, rcap, g)
    for i, f in enumerate(jq.VoteTally._fields):
        np.testing.assert_array_equal(
            got[i], np.asarray(getattr(want, f))[full], err_msg=f)


@pytest.mark.parametrize("p", [3, 5, 8, 16])
def test_tally_rows_matches_jax(p):
    """K3's row entry as a function (CPU tensors: its plain version) on
    gathered rows packed as bit words, against the JAX tally of the same
    rows."""
    rng = np.random.default_rng(p)
    g = 256
    arrays = cases.tally_inputs(rng, g, p)
    want = _jtally(*map(jnp.asarray, arrays))
    rows = rng.permutation(g)[:100]
    masks = np.empty((4, len(rows)), np.uint16)
    for words, mask in zip(masks, arrays[:4]):
        tq.pack_mask_bits(mask[rows], words)
    got = tq.tally_rows(torch.from_numpy(masks),
                        torch.from_numpy(arrays[4][rows]),
                        torch.from_numpy(arrays[5][rows]))
    assert got.dtype == torch.bool and got.shape == (4, len(rows))
    for i, f in enumerate(jq.VoteTally._fields):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(getattr(want, f))[rows], err_msg=f)


@pytest.mark.parametrize("layout,shapes,sections", [
    (tq.REFRESH_LAYOUT, tq.refresh_shapes(64, 256, 5), tq._K2_TICK),
    (tq.TALLY_LAYOUT, tq.tally_shapes(3, 16), tq._K3_TICK)])
def test_tick_offsets_follow_the_host_layout(layout, shapes, sections):
    """The offsets a prepared call hands its C entry are the host
    layout's, section by section in the entry's order, then the total;
    the views read the same bytes."""
    offs = tq.layout_offsets(layout, shapes)
    where = {name: off for (name, _, _), off in zip(layout, offs)}
    got = list(tq.tick_offsets(layout, shapes, sections))
    assert got == [where[n] for n in sections] + [offs[-1]]
    assert sorted(sections) == sorted(name for name, _, _ in layout)
    buf = np.arange(offs[-1], dtype=np.uint8)
    for (name, dt, _), view in zip(layout,
                                   tq._layout_views(buf, layout, shapes)):
        assert view.ctypes.data - buf.ctypes.data == where[name]


def test_tick_offsets_refuse_a_misaligned_section():
    layout = (("flag", np.bool_, "N"), ("value", np.int32, "N"))
    with pytest.raises(ValueError, match="misaligned"):
        tq.tick_offsets(layout, {"N": (3,)}, ("flag", "value"))


def test_pack_mask_bits_is_one_bit_per_peer():
    rows = np.zeros((3, 16), bool)
    rows[0, 0] = rows[1, 15] = True
    rows[2] = True
    out = np.empty(3, np.uint16)
    tq.pack_mask_bits(rows, out)
    assert list(out) == [1, 1 << 15, 0xFFFF]


def test_plans_refuse_what_they_cannot_hold():
    st = tq.device_state_from_numpy(
        cases.resident_state(np.random.default_rng(0), 8, 3, NOW), "cpu")
    plan = tq.RefreshPlan(st, 64, 64)
    with pytest.raises(ValueError, match="holds"):
        plan.views(256, 64)
    other = tq.device_state_from_numpy(
        cases.resident_state(np.random.default_rng(0), 16, 3, NOW), "cpu")
    with pytest.raises(ValueError, match="the plan is for"):
        plan.bind(other)
    with pytest.raises(ValueError, match="holds"):
        tq.TallyPlan(3, 64, "cpu").views(256)


def test_lockstep_engine_with_open_rounds_and_dirty_rows():
    """The JAX engine against the port's (CPU): 5 peers, most ticks with
    dirty rows and many vote rounds open at once, the capacity regrown
    mid-run (the refresh plan is rebuilt); after every tick the mirrors,
    the device state, the callbacks and the vote results are equal."""
    p = 5

    async def run():
        rng = random.Random(77)
        kw = dict(max_groups=32, max_peers=p, scalar_fallback_threshold=0,
                  leadership_timeout_ms=300, use_device=True)
        j, t = JaxEngine(**kw), TorchEngine(device="cpu", **kw)
        engines = (j, t)
        for e in engines:
            e.clock = FakeClock()
        recs, futs = {}, []

        def both(fn):
            for e in engines:
                fn(e)

        def attach():
            rj, rt = Recorder(), Recorder()
            sj, st = j.attach(rj), t.attach(rt)
            assert sj == st
            recs[sj] = (rj, rt)
            n = rng.randint(1, p)
            cur = np.arange(p) < n
            old = np.arange(p) < rng.randint(0, p) if rng.random() < 0.3 \
                else np.zeros(p, bool)
            prio = np.array([rng.choice([0, 0, 1, 2]) for _ in range(p)],
                            np.int32)
            role = rng.choice([ROLE_LEADER, ROLE_FOLLOWER, ROLE_CANDIDATE])
            flush = rng.randint(-1, 10)

            def setup(e):
                s = e.state
                s.set_conf(sj, 0, cur, old, prio, int(prio[0]))
                s.role[sj] = role
                s.flush_index[sj] = flush
                s.first_leader_index[sj] = 0
                if role == ROLE_FOLLOWER:
                    s.election_deadline_ms[sj] = e.clock.t + 100
            both(setup)

        for _ in range(24):
            attach()
        assert t.state.capacity == 32
        for step in range(50):
            for e in engines:
                e.clock.t += 37
            now = j.clock.t
            if step == 25:  # past the capacity: the state regrows
                for _ in range(12):
                    attach()
                assert t.state.capacity == j.state.capacity == 64
            slots = sorted(recs)
            for _ in range(rng.randint(0, 12)):
                g, pp, m = rng.choice(slots), rng.randint(0, p - 1), \
                    rng.randint(-1, 14)
                both(lambda e: e.on_ack(g, pp, m))
            if rng.random() < 0.8:  # dirty rows on most ticks
                for g in rng.sample(slots, rng.randint(1, 6)):
                    role = rng.choice([ROLE_LEADER, ROLE_FOLLOWER])
                    f = rng.randint(-1, 16)

                    def change(e):
                        s = e.state
                        s.role[g] = role
                        s.flush_index[g] = f
                        s.mark_dirty(g)
                        if role == ROLE_FOLLOWER:
                            s.election_deadline_ms[g] = now + 40
                    both(change)
            for g in rng.sample(slots, rng.randint(0, 6)):
                if g not in j._vote_rounds:
                    dl = now + rng.randint(40, 160)
                    futs.append((step, g, j.begin_vote_round(g, dl),
                                 t.begin_vote_round(g, dl)))
            for g in list(j._vote_rounds):
                if rng.random() < 0.6:
                    pp, granted = rng.randint(0, p - 1), rng.random() < 0.6
                    both(lambda e: e.on_vote_reply(g, pp, granted))
                if rng.random() < 0.05:
                    both(lambda e: e.expire_vote_round(g))
            await j.tick()
            await t.tick()
            await asyncio.sleep(0)
            _assert_same(j, t, step)
            for slot, (rj, rt) in recs.items():
                assert rj.events == rt.events, (step, slot)
            for s_, g, fj, ft in futs:
                assert fj.done() == ft.done(), (step, s_, g)
                if fj.done() and not fj.cancelled():
                    assert fj.result() == ft.result(), (step, g)

        assert t.metrics["refresh_ticks"] >= 25
        assert t._refresh_plan.capacity == 64
        results = {f.result() for _, _, f, _ in futs
                   if f.done() and not f.cancelled()}
        assert {"PASSED", "REJECTED"} <= results, results
        assert len(futs) >= 40
        for e in engines:
            await e.close()

    asyncio.run(run())
