"""The port's CUDA kernels against their plain-torch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA card is present
(the kernels have no CPU mode).  The file imports neither jax nor
``ratis_tpu``, so it also runs on a machine that has no JAX, without the
JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``chip_smoke.py`` holds the kernels to the same bar at the main path's
shapes and beyond.
"""

import asyncio

import numpy as np
import pytest
import torch

from ratis_tpu_torch.ops import ledger as tl
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.tools import bench, cases

pytestmark = pytest.mark.cuda

P = 8
NOW = 100_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")
    return torch.device("cuda")


def _cuda(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("g,e", [(1024, 64), (1024, 16384), (10240, 1024)])
def test_fast_step_kernel_matches_plain(card, g, e, negative):
    rng = np.random.default_rng(g + e)
    st = cases.resident_state(rng, g, P, NOW)
    ev, meta = _cuda([cases.fast_events(rng, g, P, e, NOW, negative),
                      np.array([NOW, 300], np.int32)])
    a = tq.device_state_from_numpy(st, card)
    b = tq.device_state_from_numpy(st, card)
    k = tq.engine_step_resident_fast(a, ev, meta)
    assert torch.equal(k.out, tq._resident_fast_plain(b, ev, meta))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("n_slices,g,e", [(1, 1024, 256), (2, 1024, 64),
                                          (8, 1024, 64), (8, 10240, 1024)])
def test_sliced_step_kernel_matches_plain(card, n_slices, g, e, negative):
    rng = np.random.default_rng(n_slices + g + e)
    st = cases.resident_state(rng, g, P, NOW)
    ev, meta = _cuda([cases.sliced_events(rng, g, P, n_slices, e, NOW,
                                          negative),
                      np.array([NOW, 300], np.int32)])
    a = tq.device_state_from_numpy(st, card)
    b = tq.device_state_from_numpy(st, card)
    k = tq.engine_step_resident_fast_sliced(a, ev, meta)
    assert torch.equal(k.out, tq._resident_fast_sliced_plain(b, ev, meta))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sliced_step_kernel_at_one_slice_is_k1(card):
    rng = np.random.default_rng(5)
    st = cases.resident_state(rng, 1024, P, NOW)
    ev, meta = _cuda([cases.fast_events(rng, 1024, P, 1024, NOW, True),
                      np.array([NOW, 300], np.int32)])
    a = tq.device_state_from_numpy(st, card)
    b = tq.device_state_from_numpy(st, card)
    k5 = tq.engine_step_resident_fast_sliced(a, ev[:, None].contiguous(),
                                             meta)
    k1 = tq.engine_step_resident_fast(b, ev, meta)
    assert torch.equal(k5.out, k1.out)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sliced_step_kernel_counts_its_launches(card):
    st = tq.device_state_from_numpy(
        cases.resident_state(np.random.default_rng(6), 64, P, NOW), card)
    ev, meta = _cuda([cases.sliced_events(np.random.default_rng(6), 64, P,
                                          8, 16, NOW),
                      np.array([NOW, 300], np.int32)])
    n1, n5 = tq.K1.launches, tq.K5.launches
    tq.engine_step_resident_fast_sliced(st, ev, meta)
    assert (tq.K1.launches, tq.K5.launches) == (n1, n5 + 1)


# -- K1 and K5 in one launch, and their prepared call -------------------------

def _fast_kernel_plan_and_plain(card, st, ev, sliced):
    """K1 (or K5 for a [7, S, E] ``ev``) through its public wrapper (one
    launch) and through the engine's prepared call, each on its own copy
    of the state, against the plain version on a third: equal outputs and
    equal states, one launch each."""
    ev_t, meta = _cuda([ev, np.array([NOW, 300], np.int32)])
    a, b, c = (tq.device_state_from_numpy(st, card) for _ in range(3))
    kernel = tq.K5 if sliced else tq.K1
    wrapper, plain = ((tq.engine_step_resident_fast_sliced,
                       tq._resident_fast_sliced_plain) if sliced
                      else (tq.engine_step_resident_fast,
                            tq._resident_fast_plain))
    n = kernel.launches
    k = wrapper(a, ev_t, meta)
    assert kernel.launches == n + 1
    want = plain(b, ev_t, meta)
    assert torch.equal(k.out, want)
    plan = cases.fast_plan(c, ev, sliced)
    out = plan.run(ev.shape[-1], NOW, 300)
    assert kernel.launches == n + 2
    assert np.array_equal(out, want.cpu().numpy())
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(z, y)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("g,e", [(1, 64), (100, 1024), (1024, 64),
                                 (1024, 16384), (10240, 1024)])
@pytest.mark.parametrize("p", [3, 5, 8, 16])
def test_fast_kernel_matches_plain_at_every_peer_count(card, p, g, e,
                                                       negative):
    rng = np.random.default_rng(p + g + e + negative)
    _fast_kernel_plan_and_plain(
        card, cases.resident_state(rng, g, p, NOW),
        cases.fast_events(rng, g, p, e, NOW, negative), False)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("n_slices,g", [(1, 100), (2, 200), (8, 264),
                                        (8, 2048), (8, 10240)])
@pytest.mark.parametrize("p", [3, 5, 8, 16])
def test_sliced_kernel_matches_plain_at_every_peer_count(card, p, n_slices,
                                                         g, negative):
    """Slices of 100, 33, 256 and 1280 rows: a tile straddles two slices
    in the first two."""
    rng = np.random.default_rng(p + n_slices + g + negative)
    _fast_kernel_plan_and_plain(
        card, cases.resident_state(rng, g, p, NOW),
        cases.sliced_events(rng, g, p, n_slices, 256, NOW, negative), True)


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("g,p,n_slices", [(100, 5, 0), (10240, 16, 0),
                                          (264, 8, 8), (2048, 3, 2)])
def test_fast_kernel_tiles_agree(card, monkeypatch, tile, g, p, n_slices):
    monkeypatch.setattr(tq, "tick_tile", lambda g: tile)
    rng = np.random.default_rng(tile + g)
    ev = (cases.sliced_events(rng, g, p, n_slices, 1024, NOW, True)
          if n_slices else cases.fast_events(rng, g, p, 1024, NOW, True))
    _fast_kernel_plan_and_plain(card, cases.resident_state(rng, g, p, NOW),
                                ev, n_slices > 0)


@pytest.mark.parametrize("e", [4096, 16384])
@pytest.mark.parametrize("sliced", [False, True])
def test_fast_kernel_lands_a_hot_tile(card, sliced, e):
    """Every ack aimed at three rows of one tile (of each slice): the tile
    lists more columns than one of the kernel's rounds holds."""
    rng = np.random.default_rng(e + sliced)
    g = 2048
    ev = (cases.sliced_events(rng, g, P, 2, e, NOW) if sliced
          else cases.fast_events(rng, g, P, e, NOW))
    _fast_kernel_plan_and_plain(card, cases.resident_state(rng, g, P, NOW),
                                cases.hot_acks(rng, ev), sliced)


@pytest.mark.parametrize("sliced", [False, True])
def test_fast_tick_is_one_kernel_launch(card, sliced):
    """One public K1 call, and one K5 call, captured in a CUDA graph hold
    one node each, the kernel ``tile_tick`` (the earlier design put two
    kernels); the plan's tick is one call into the library that counts
    one launch of K1 (flat) or K5 (sliced) and none of the other."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(8)
    g = 2048
    st = cases.resident_state(rng, g, P, NOW)
    ev = (cases.sliced_events(rng, g, P, 8, 64, NOW) if sliced
          else cases.fast_events(rng, g, P, 64, NOW))
    ev_t, meta = _cuda([ev, np.array([NOW, 300], np.int32)])
    a = tq.device_state_from_numpy(st, card)
    wrapper = (tq.engine_step_resident_fast_sliced if sliced
               else tq.engine_step_resident_fast)
    nodes = graph_nodes(lambda: wrapper(a, ev_t, meta))
    assert len(nodes) == 1 and is_kernel_node(nodes[0]), nodes
    assert "tile_tick" in nodes[0] and "FastEvents" in nodes[0], nodes
    plan = cases.fast_plan(tq.device_state_from_numpy(st, card), ev, sliced)
    calls = []
    tick = plan._tick
    plan._tick = lambda *a: calls.append(a) or tick(*a)
    n1, n5 = tq.K1.launches, tq.K5.launches
    plan.run(ev.shape[-1], NOW, 300)
    assert len(calls) == 1
    assert (tq.K1.launches - n1, tq.K5.launches - n5) == (
        (0, 1) if sliced else (1, 0))


def test_engine_fast_tick_is_one_library_call(card):
    """A card engine's fast tick (no dirty rows) is one call of its fast
    plan, K1 +1 and nothing else launched, and leaves the state a CPU
    engine's fast tick leaves on the same acks."""
    from ratis_tpu_torch.engine.engine import QuorumEngine
    from ratis_tpu_torch.engine.state import ROLE_LEADER

    class Listener:
        async def on_commit_advance(self, c):
            pass

        async def on_election_timeout(self):
            pass

        async def on_leadership_stale(self):
            pass

    engines = [QuorumEngine(max_groups=64, max_peers=P,
                            scalar_fallback_threshold=0, use_device=True,
                            device=d) for d in (card, "cpu")]
    now = engines[0].clock.now_ms()
    acks = [(s, 1 + s % 2, 5 + s % 7, now) for s in range(64)] * 2
    for eng in engines:
        for _ in range(64):
            slot = eng.attach(Listener())
            eng.state.set_conf(slot, 0, np.arange(P) < 3, np.zeros(P, bool),
                               np.zeros(P, np.int32), 0)
            eng.state.role[slot] = ROLE_LEADER
            eng.state.flush_index[slot] = 9
        eng._tick_batched([], now)  # the full upload
    plan = engines[0]._fast_plan
    calls = []
    tick = plan._tick
    plan._tick = lambda *a: calls.append(a) or tick(*a)
    counts = (tq.K1.launches, tq.K2.launches, tq.K5.launches)
    for eng in engines:
        eng._tick_batched_pass(acks, now)
    assert len(calls) == 1
    assert (tq.K1.launches, tq.K2.launches, tq.K5.launches) == (
        counts[0] + 1, counts[1], counts[2])
    for x, y in zip(*(e._dev for e in engines)):
        assert torch.equal(x.cpu(), y)
    assert (engines[1]._dev.commit_index > 0).all()


@pytest.mark.parametrize("negative", [False, True])
def test_refresh_step_kernel_matches_plain(card, negative):
    rng = np.random.default_rng(1)
    g = 1024
    st = cases.resident_state(rng, g, P, NOW)
    rf_idx, rf, acks = cases.refresh(rng, g, P, 256, 1024, NOW, negative)
    rf_idx, *rf = _cuda([rf_idx, *rf])
    acks = _cuda(acks)
    a = tq.device_state_from_numpy(st, card)
    b = tq.device_state_from_numpy(st, card)
    k = tq.engine_step_resident(a, rf_idx, *rf, *acks, NOW, 300)
    want = tq._resident_refresh_plain(b, rf_idx, rf, acks, NOW, 300)
    assert torch.equal(torch.stack(k[1:]), want)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- K2 in one launch, and its prepared call ---------------------------------

def _refresh_case(seed, g, p, d, e, negative):
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW)
    rf_idx, rf, acks = cases.refresh(rng, g, p, d, e, NOW, negative)
    return st, rf_idx, rf, acks


def _refresh_kernel_and_plain(card, st, rf_idx, rf, acks):
    """The public wrapper (one launch) and the plain version on the same
    card tensors: equal outputs and equal states."""
    rf_idx_t, *rf_t = _cuda([rf_idx, *rf])
    acks_t = _cuda(acks)
    a = tq.device_state_from_numpy(st, card)
    b = tq.device_state_from_numpy(st, card)
    n = tq.K2.launches
    k = tq.engine_step_resident(a, rf_idx_t, *rf_t, *acks_t, NOW, 300)
    assert tq.K2.launches == n + 1
    want = tq._resident_refresh_plain(b, rf_idx_t, rf_t, acks_t, NOW, 300)
    assert torch.equal(torch.stack(k[1:]), want)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    return torch.stack(k[1:]), a


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("d,e", [(64, 64), (64, 16384), (16384, 1024)])
@pytest.mark.parametrize("g", [1, 100, 1024, 10240])
@pytest.mark.parametrize("p", [3, 5, 8, 16])
def test_refresh_kernel_matches_plain_at_every_shape(card, p, g, d, e,
                                                     negative):
    _refresh_kernel_and_plain(card, *_refresh_case(
        p + g + d + e, g, p, d, e, negative))


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("g,p", [(100, 5), (1024, 8), (10240, 16)])
def test_refresh_kernel_tiles_agree(card, monkeypatch, tile, g, p):
    monkeypatch.setattr(tq, "tick_tile", lambda g: tile)
    _refresh_kernel_and_plain(card, *_refresh_case(tile + g, g, p, 1024,
                                                   1024, True))


@pytest.mark.parametrize("g,p,d,e", [(1024, 8, 64, 64), (100, 3, 256, 4096),
                                     (10240, 16, 1024, 16384)])
def test_refresh_plan_matches_the_public_wrapper(card, g, p, d, e):
    """The engine's route (the packed buffer, one C call) against the
    public wrapper on the same inputs."""
    case = _refresh_case(g + d, g, p, d, e, True)
    want_out, want_state = _refresh_kernel_and_plain(card, *case)
    st, rf_idx, rf, acks = case
    state = tq.device_state_from_numpy(st, card)
    plan = cases.refresh_plan(state, rf_idx, rf, acks)
    n = tq.K2.launches
    out = plan.run(d, e, NOW, 300)
    assert tq.K2.launches == n + 1
    assert np.array_equal(out, want_out.cpu().numpy())
    for x, y in zip(state, want_state):
        assert torch.equal(x, y)


def test_refresh_is_one_kernel_launch(card):
    """One K2 call counts one launch and puts exactly one kernel on the
    card: the call captured in a CUDA graph holds one node, the kernel
    ``tile_tick`` on K2's refresh events (the earlier design put three).
    The plan's tick is one
    call into the library that counts one launch; its kernel comes from
    the same C launcher as the wrapper's."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    st, rf_idx, rf, acks = _refresh_case(3, 1024, P, 64, 64, False)
    rf_idx_t, *rf_t = _cuda([rf_idx, *rf])
    acks_t = _cuda(acks)
    a = tq.device_state_from_numpy(st, card)
    n = tq.K2.launches
    tq.engine_step_resident(a, rf_idx_t, *rf_t, *acks_t, NOW, 300)
    assert tq.K2.launches == n + 1
    nodes = graph_nodes(lambda: tq.engine_step_resident(
        a, rf_idx_t, *rf_t, *acks_t, NOW, 300))
    assert len(nodes) == 1 and is_kernel_node(nodes[0]), nodes
    assert "tile_tick" in nodes[0] and "RefreshEvents" in nodes[0], nodes
    plan = cases.refresh_plan(tq.device_state_from_numpy(st, card), rf_idx,
                              rf, acks)
    calls = []
    tick = plan._tick
    plan._tick = lambda *a: calls.append(a) or tick(*a)
    n = tq.K2.launches
    plan.run(64, 64, NOW, 300)
    assert len(calls) == 1 and tq.K2.launches == n + 1


def test_graph_nodes_lists_every_kernel_and_copy(card):
    """The graph listing behind the one-kernel checks, on a call known to
    put a copy and a kernel on the card: a device-to-device ``copy_`` of
    a tensor, then K7b on it.  (A node's label holds the start of the
    kernel's mangled name only, cut short by the graph's own listing, so
    the checks count nodes and read the launch counters.)"""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    args = _cuda(cases.replicated_inputs(np.random.default_rng(6), 1024, P))
    match = torch.empty_like(args[0])

    def call():
        match.copy_(args[0])
        tq.all_replicated_min(match, *args[1:])

    nodes = graph_nodes(call)
    assert [is_kernel_node(n) for n in nodes] == [False, True], nodes


def test_public_tally_counts_apart_from_the_engines(card):
    args = _cuda(cases.tally_inputs(np.random.default_rng(4), 100, P))
    n3, n3p = tq.K3.launches, tq.K3_PUBLIC.launches
    tq.tally_votes_packed(*args)
    assert (tq.K3.launches, tq.K3_PUBLIC.launches) == (n3, n3p + 1)


@pytest.mark.parametrize("r", [1, 64, 1000])
@pytest.mark.parametrize("p", [3, 5, 8, 16])
def test_tally_plan_matches_plain(card, p, r):
    """K3's row entry through the engine's prepared call, padded to the
    engine's bucket with stale rows, against the plain tally of the same
    rows and against the kernel launched on separate tensors."""
    rng = np.random.default_rng(p + r)
    g = 2048
    arrays = cases.tally_inputs(rng, g, p)
    rows = np.sort(rng.permutation(g)[:r])
    rcap = 64 if r <= 64 else 1024
    plan = cases.tally_plan(arrays, rows, card, rcap)
    n = tq.K3.launches
    got = plan.run(rcap).copy()
    assert tq.K3.launches == n + 1
    full = cases.padded_rows(rows, rcap, g)
    want = tq._tally_plain(*(torch.from_numpy(np.ascontiguousarray(a[full]))
                             for a in arrays))
    assert np.array_equal(got, want.numpy())
    v = plan.views(rcap)
    packed = _cuda([v.masks, v.priority, v.self_priority])
    k = tq.tally_rows(*packed)
    assert tq.K3.launches == n + 2
    assert np.array_equal(k.cpu().numpy(), got)
    assert torch.equal(k, tq._tally_rows_plain(*packed))


def test_card_engine_matches_the_cpu_engine_across_a_regrow(card):
    """A card engine against a CPU engine under one seeded script of acks,
    dirty rows and vote rounds, its capacity regrown midway (the refresh
    plan is rebuilt): mirrors, device state, callbacks and vote results
    equal after every tick."""
    import random

    from ratis_tpu_torch.engine.engine import QuorumEngine
    from ratis_tpu_torch.engine.state import ROLE_FOLLOWER, ROLE_LEADER

    class Clock:
        t = 0

        def now_ms(self):
            return self.t

    class Rec:
        def __init__(self):
            self.events = []

        async def on_election_timeout(self):
            self.events.append("timeout")

        async def on_commit_advance(self, c):
            self.events.append(("commit", c))

        async def on_leadership_stale(self):
            self.events.append("stale")

    async def run():
        rng = random.Random(5)
        kw = dict(max_groups=32, max_peers=5, scalar_fallback_threshold=0,
                  leadership_timeout_ms=300, use_device=True)
        gpu, cpu = QuorumEngine(device=card, **kw), QuorumEngine(
            device="cpu", **kw)
        engines = (gpu, cpu)
        for e in engines:
            e.clock = Clock()
        recs, futs = {}, []

        def attach():
            ra, rb = Rec(), Rec()
            slot = gpu.attach(ra)
            assert cpu.attach(rb) == slot
            recs[slot] = (ra, rb)
            cur = np.arange(5) < rng.randint(1, 5)
            prio = np.array([rng.choice([0, 1, 2]) for _ in range(5)],
                            np.int32)
            for e in engines:
                e.state.set_conf(slot, 0, cur, np.zeros(5, bool), prio,
                                 int(prio[0]))
                e.state.role[slot] = ROLE_LEADER

        for _ in range(24):
            attach()
        for step in range(40):
            for e in engines:
                e.clock.t += 37
            if step == 20:
                for _ in range(12):
                    attach()
            slots = sorted(recs)
            for _ in range(rng.randint(0, 10)):
                g, p, m = rng.choice(slots), rng.randint(0, 4), \
                    rng.randint(-1, 14)
                for e in engines:
                    e.on_ack(g, p, m)
            for g in rng.sample(slots, rng.randint(0, 5)):
                role, f = rng.choice([ROLE_LEADER, ROLE_FOLLOWER]), \
                    rng.randint(-1, 16)
                for e in engines:
                    e.state.role[g] = role
                    e.state.flush_index[g] = f
                    e.state.election_deadline_ms[g] = e.clock.t + 40
                    e.state.mark_dirty(g)
            for g in rng.sample(slots, rng.randint(0, 4)):
                if g not in gpu._vote_rounds:
                    dl = gpu.clock.t + rng.randint(40, 160)
                    futs.append((gpu.begin_vote_round(g, dl),
                                 cpu.begin_vote_round(g, dl)))
            for g in list(gpu._vote_rounds):
                if rng.random() < 0.6:
                    p, ok = rng.randint(0, 4), rng.random() < 0.6
                    for e in engines:
                        e.on_vote_reply(g, p, ok)
            for e in engines:
                await e.tick()
            await asyncio.sleep(0)
            for name in ("match_index", "last_ack_ms", "commit_index",
                         "election_deadline_ms", "vote_deadline_ms"):
                assert np.array_equal(getattr(gpu.state, name),
                                      getattr(cpu.state, name)), (step, name)
            for x, y in zip(gpu._dev, cpu._dev):
                assert torch.equal(x.cpu(), y), step
            for ra, rb in recs.values():
                assert ra.events == rb.events, step
            for fa, fb in futs:
                assert fa.done() == fb.done(), step
                if fa.done() and not fa.cancelled():
                    assert fa.result() == fb.result(), step
        assert gpu._refresh_plan.capacity == 64
        assert gpu.metrics["refresh_ticks"] > 20
        for e in engines:
            await e.close()

    n2, n3 = tq.K2.launches, tq.K3.launches
    asyncio.run(run())
    assert tq.K2.launches > n2 and tq.K3.launches > n3


def _step_both(args):
    """K6 and its plain version on the same card tensors: equal outputs,
    inputs unchanged."""
    before = [t.clone() for t in args[:15]]
    k = tq.engine_step(*args)
    want = tq._engine_step_plain(*args)
    for name, x, y in zip(tq.EngineStep._fields, k, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name
    for x, y in zip(args, before):
        assert torch.equal(x, y)
    return k


@pytest.mark.parametrize("p", [3, 5, 7, 8, 16])
@pytest.mark.parametrize("g,e", [(1024, 256), (10240, 4096),
                                 (102400, 8192), (1001, 256), (1023, 1024)])
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_step_kernel_matches_plain(card, g, e, seed, p):
    """K6 against its plain version; G = 1001 and 1023 are no multiple of
    4, so the outputs' one buffer ends on a partial int32 word."""
    rng = np.random.default_rng(seed)
    _step_both(tq.engine_step_args_from_numpy(
        cases.step_args(rng, g, p, e, NOW), card))
    _step_both(tq.engine_step_args_from_numpy(
        bench._example_batch(g, p, e, seed), card))


def test_engine_step_is_one_kernel(card):
    """One K6 call captured in a CUDA graph is one node, the kernel (the
    earlier design put two copies and two kernels), and calls back to
    back agree with the plain version every time, also at a smaller batch
    after a larger and with every ack on one row (more than a block
    lists)."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    fn, args = bench.entry(card)
    n = tq.K6.launches
    nodes = graph_nodes(lambda: fn(*args))
    assert len(nodes) == 1 and is_kernel_node(nodes[0]), nodes
    assert tq.K6.launches == n + 2  # the warm-up call and the captured
    for g, p, e, hot in ((10240, 8, 4096, False), (100, 16, 5000, False),
                         (10240, 8, 4096, False), (10240, 8, 4096, True)):
        args_np = cases.step_args(np.random.default_rng(g + p), g, p, e, NOW)
        if hot:
            args_np[2][:] = 7  # every ack on one row
        step = tq.engine_step_args_from_numpy(args_np, card)
        for _ in range(3):
            _step_both(step)


def test_engine_step_kernel_counts_its_launches(card):
    fn, args = bench.entry(card)
    n = tq.K6.launches
    fn(*args)
    assert tq.K6.launches == n + 1


def test_tally_kernel_matches_plain(card):
    args = _cuda(cases.tally_inputs(np.random.default_rng(2), 10240, P))
    assert torch.equal(tq.tally_votes_packed(*args), tq._tally_plain(*args))


@pytest.mark.parametrize("big_cell", [False, True])
@pytest.mark.parametrize("g,width", [(1024, 8), (1000, 16), (1024, 512),
                                     (1000, 512)])
def test_ledger_kernel_matches_plain(card, big_cell, g, width):
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(3), g, P,
                                          width, big_cell=big_cell)
    dev = _cuda(arrays)
    n = tl.K4.launches
    got = tl.ledger_pass(*dev, *scalars, num_peers=width)
    assert tl.K4.launches == n + 1
    assert torch.equal(got, tl._ledger_plain(*dev, *scalars, width))


@pytest.mark.parametrize("g,p", [(1024, 8), (1000, 5), (10240, 8), (64, 3),
                                 (1024, 16)])
def test_ledger_plan_matches_plain(card, g, p):
    """K4 through the engine's prepared call, one call and one launch a
    sample, against the plain pass, across table widths 8 -> 16 -> 512 ->
    8 on one plan (the output grows), twice at each."""
    plan = tl.LedgerPlan(g, p, card)
    for seed, width in enumerate((8, 8, 16, 16, 512, 512, 8)):
        arrays, scalars = cases.ledger_inputs(np.random.default_rng(seed),
                                              g, p, width)
        for v, a in zip(plan.views, arrays):
            np.copyto(v, a)
        calls = []
        tick = plan._tick
        plan._tick = lambda *a: calls.append(a) or tick(*a)
        n = tl.K4.launches
        got = plan.run(width, *scalars).copy()
        plan._tick = tick
        assert len(calls) == 1 and tl.K4.launches == n + 1
        want = tl._ledger_plain(*_cuda(arrays), *scalars, width)
        assert np.array_equal(got, want.cpu().numpy()), width


def test_ledger_plan_without_its_c_plan_raises(card):
    """A CUDA plan whose C plan was freed raises rather than computing the
    pass on the CPU from its pinned views."""
    plan = tl.LedgerPlan(64, P, card)
    plan._free()
    n = tl.K4.launches
    with pytest.raises(RuntimeError, match="freed"):
        plan.run(8, NOW, 100, 1000)
    assert tl.K4.launches == n


def test_ledger_is_one_kernel(card):
    """One K4 wrapper call captured in a CUDA graph is one node, the
    kernel; one prepared call is its two copies around the same one
    kernel (captured, the call does not synchronise); replaying 20
    captured calls leaves the result of one call."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(4), 1024, P,
                                          8)
    dev = _cuda(arrays)
    n = tl.K4.launches
    nodes = graph_nodes(lambda: tl.ledger_pass(*dev, *scalars, num_peers=8))
    assert len(nodes) == 1 and is_kernel_node(nodes[0]), nodes
    assert tl.K4.launches == n + 2  # the warm-up call and the captured
    plan = tl.LedgerPlan(1024, P, card)
    for v, a in zip(plan.views, arrays):
        np.copyto(v, a)

    def plan_call():
        plan._stream = torch.cuda.current_stream().cuda_stream
        plan.run(8, *scalars)

    n = tl.K4.launches
    nodes = graph_nodes(plan_call)
    assert [is_kernel_node(n) for n in nodes] == [False, True, False], nodes
    assert tl.K4.launches == n + 2
    want = tl._ledger_plain(*dev, *scalars, 8)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(20):
            got = tl.ledger_pass(*dev, *scalars, num_peers=8)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("p", [3, 5, 7, 8, 16])
@pytest.mark.parametrize("g", [1024, 102400])
def test_vote_events_kernel_matches_plain(card, g, p):
    args = _cuda(cases.vote_events(np.random.default_rng(g + p), g, p,
                                   g // 4))
    before = [t.clone() for t in args]
    n = tq.K7a.launches
    got = tq.apply_vote_events(*args)
    assert tq.K7a.launches == n + 1
    want = tq._apply_vote_events_plain(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for x, y in zip(args, before):  # functional: no input written
        assert torch.equal(x, y)


@pytest.mark.parametrize("g,p", [(4, 3), (2, 3), (16, 8), (8, 16)])
def test_vote_event_edges_kernel_matches_plain(card, g, p):
    args = _cuda(cases.vote_event_edges(g, p))
    got = tq.apply_vote_events(*args)
    want = tq._apply_vote_events_plain(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("p", [3, 5, 7, 8, 16])
@pytest.mark.parametrize("g", [1024, 102400])
def test_replicated_min_kernel_matches_plain(card, g, p):
    args = _cuda(cases.replicated_inputs(np.random.default_rng(g + p), g, p))
    n = tq.K7b.launches
    got = tq.all_replicated_min(*args)
    assert tq.K7b.launches == n + 1
    assert torch.equal(got, tq._all_replicated_min_plain(*args))


@pytest.mark.parametrize("timeout", cases.LEASE_TIMEOUTS)
@pytest.mark.parametrize("p", [3, 5, 7, 8, 16])
def test_lease_kernel_matches_plain(card, p, timeout):
    args = _cuda(cases.lease_inputs(np.random.default_rng(p), 1024, p))
    n = tq.K7c.launches
    got = tq.lease_expiry(*args, timeout)
    assert tq.K7c.launches == n + 1
    assert torch.equal(got, tq._lease_expiry_plain(*args, timeout))


# K7a and K7c, redesigned: rows that fill no multiple of 4 (1001, 1023),
# a block's worth and beyond, and the P that leave slots of K7c's rows of
# 8 lanes unfilled (P > 8: two slots a lane)
K7_ROWS = (1, 2, 1001, 1023, 1024, 10240, 102400)
K7_PEERS = (3, 5, 7, 8, 9, 12, 16)


@pytest.mark.parametrize("p", K7_PEERS)
@pytest.mark.parametrize("g", K7_ROWS)
def test_lease_kernel_matches_plain_at_every_shape(card, g, p):
    args = _cuda(cases.lease_inputs(np.random.default_rng(g * p), g, p))
    before = [t.clone() for t in args]
    for timeout in cases.LEASE_TIMEOUTS:
        n = tq.K7c.launches
        got = tq.lease_expiry(*args, timeout)
        assert tq.K7c.launches == n + 1
        assert torch.equal(got, tq._lease_expiry_plain(*args, timeout)), \
            timeout
    for x, y in zip(args, before):
        assert torch.equal(x, y)


def _span(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _votes_every_design(monkeypatch, args) -> None:
    """K7a through its wrapper's own launch and forced to each design
    (blocks owning rows; one cooperative launch), one launch each,
    against the plain version: no input written, the two outputs
    contiguous and apart from each other and from every input."""
    before = [t.clone() for t in args]
    want = tq._apply_vote_events_plain(*args)
    g, p = args[0].shape
    rule = tq.vote_rows
    for rows in (None, tq.vote_block_rows(g), 0):
        if rows is not None:
            monkeypatch.setattr(tq, "vote_rows", lambda *_: rows)
        n = tq.K7a.launches
        got = tq.apply_vote_events(*args)
        monkeypatch.setattr(tq, "vote_rows", rule)
        assert tq.K7a.launches == n + 1
        for x, y in zip(got, want):
            assert x.is_contiguous() and x.shape == (g, p)
            assert torch.equal(x, y), rows
        spans = [_span(t) for t in (*got, *args)]
        for i in (0, 1):
            for j, other in enumerate(spans):
                if j != i:
                    assert spans[i][1] <= other[0] or other[1] <= spans[i][0]
    for x, y in zip(args, before):
        assert torch.equal(x, y)


@pytest.mark.parametrize("p", K7_PEERS)
@pytest.mark.parametrize("g", K7_ROWS)
def test_vote_events_kernel_matches_plain_at_every_shape(card, monkeypatch,
                                                         g, p):
    for e in sorted({0, 1, g // 4, 2 * g}):
        _votes_every_design(monkeypatch, _cuda(cases.vote_events(
            np.random.default_rng(g + p + e), g, p, e)))


@pytest.mark.parametrize("g,p,e", [(1024, 8, 2048), (1001, 3, 5000),
                                   (102400, 8, 4096), (10240, 16, 20480)])
def test_vote_events_on_one_row(card, monkeypatch, g, p, e):
    """Every event on one row (7): more than a block of design (a) lists
    (1024), so it scans the events again; and on the last row through
    -1."""
    for row in (7, -1):
        args = cases.vote_events(np.random.default_rng(e), g, p, e)
        args[2][:] = row
        _votes_every_design(monkeypatch, _cuda(args))


def test_vote_and_lease_are_one_kernel(card, monkeypatch):
    """One K7a call (either design) and one K7c call, each captured in a
    CUDA graph, are one node each, the kernel (K7a's earlier design put
    two copies before its kernel)."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    votes = _cuda(cases.vote_events(np.random.default_rng(8), 1024, P,
                                    2048))
    lease = _cuda(cases.lease_inputs(np.random.default_rng(9), 1024, P))
    rule = tq.vote_rows
    calls = [(tq.K7c, lambda: tq.lease_expiry(*lease, 1000))]
    for rows in (tq.vote_block_rows(1024), 0):
        calls.append((tq.K7a, lambda rows=rows: (
            monkeypatch.setattr(tq, "vote_rows", lambda *_: rows),
            tq.apply_vote_events(*votes))))
    for kernel, call in calls:
        n = kernel.launches
        nodes = graph_nodes(call)
        assert len(nodes) == 1 and is_kernel_node(nodes[0]), nodes
        assert kernel.launches == n + 2  # the warm-up call and the captured
    monkeypatch.setattr(tq, "vote_rows", rule)


# K7b and the public K3, redesigned: rows of 8 lanes, one slot a lane up
# to 8 peers and two from 9; rows that fill no whole warp (1, 2, 31) or
# block (1001, 1023), a block's worth and beyond
LANE_ROWS = (1, 2, 31, 1001, 1023, 1024, 10240, 102400)
LANE_PEERS = (1, 3, 5, 7, 8, 9, 12, 16)


def _one_launch_matches(kernel, wrapper, plain, arrays) -> None:
    """One wrapper call is one launch of ``kernel``, equal to the plain
    version on the same card tensors, and writes none of its inputs."""
    args = _cuda(arrays)
    before = [t.clone() for t in args]
    n = kernel.launches
    got = wrapper(*args)
    assert kernel.launches == n + 1
    assert torch.equal(got, plain(*args))
    for x, y in zip(args, before):
        assert torch.equal(x, y)


@pytest.mark.parametrize("p", LANE_PEERS)
@pytest.mark.parametrize("g", LANE_ROWS)
def test_replicated_min_kernel_matches_plain_at_every_shape(card, g, p):
    rng = np.random.default_rng(g * p + 3)
    for arrays in (cases.replicated_inputs(rng, g, p),
                   cases.replicated_self_edges(rng, g, p)):
        _one_launch_matches(tq.K7b, tq.all_replicated_min,
                            tq._all_replicated_min_plain, arrays)


@pytest.mark.parametrize("p", LANE_PEERS)
@pytest.mark.parametrize("g", LANE_ROWS)
def test_public_tally_kernel_matches_plain_at_every_shape(card, monkeypatch,
                                                          g, p):
    """The public K3 by its launch rule and forced to each of its designs
    (rows of 8 lanes; staged tiles)."""
    rng = np.random.default_rng(g * p + 5)
    rule = tq.tally_tile
    for arrays in (cases.tally_inputs(rng, g, p),
                   cases.tally_edges(rng, g, p)):
        for tile in (None, 0, tq.TALLY_TILE):
            monkeypatch.setattr(tq, "tally_tile", rule if tile is None
                                else lambda *_, tile=tile: tile)
            _one_launch_matches(tq.K3_PUBLIC, tq.tally_votes_packed,
                                tq._tally_plain, arrays)


@pytest.mark.parametrize("g", [1024, 102400])
def test_replicated_min_and_public_tally_are_one_kernel(card, monkeypatch,
                                                        g):
    """One K7b call and one public K3 call (either design), each captured
    in a CUDA graph, are one node each, the kernel."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(g)
    repl = _cuda(cases.replicated_inputs(rng, g, P))
    tally = _cuda(cases.tally_inputs(rng, g, P))
    calls = [(tq.K7b, lambda: tq.all_replicated_min(*repl))]
    for tile in (0, tq.TALLY_TILE):
        calls.append((tq.K3_PUBLIC, lambda tile=tile: (
            monkeypatch.setattr(tq, "tally_tile", lambda *_: tile),
            tq.tally_votes_packed(*tally))))
    for kernel, call in calls:
        n = kernel.launches
        nodes = graph_nodes(call)
        assert len(nodes) == 1 and is_kernel_node(nodes[0]), nodes
        assert kernel.launches == n + 2  # the warm-up call and the captured


@pytest.mark.parametrize("g", [1, 1001, 102400])
def test_row_launches_refuse_a_grid_short_of_the_rows(card, g):
    """K7b's and the public K3's C entries take their grid from the host
    and refuse one that leaves a row out (and an unknown K3 design)."""
    repl = _cuda(cases.replicated_inputs(np.random.default_rng(g), g, P))
    tally = _cuda(cases.tally_inputs(np.random.default_rng(g), g, P))
    out = torch.empty(4 * g, dtype=torch.int32, device=card)
    ptrs = [t.data_ptr() for t in repl]
    short = tq.lane_blocks(g) - 1
    with pytest.raises(RuntimeError, match="invalid argument"):
        tq.K7b(card, *ptrs, out.data_ptr(), g, P, 1, short)
    ptrs = [t.data_ptr() for t in tally]
    for tile, blocks in ((0, short), (tq.TALLY_TILE,
                                      tq.tally_blocks(g, tq.TALLY_TILE) - 1),
                         (64, tq.lane_blocks(g))):
        with pytest.raises(RuntimeError, match="invalid argument"):
            tq.K3_PUBLIC(card, *ptrs, out.data_ptr(), g, P, 1, tile, blocks)


@pytest.mark.parametrize("transport", ["sim", "tcp"])
def test_cluster_runs_on_the_card(card, transport):
    from ratis_tpu_torch.tools.cluster import Cluster

    async def run():
        cluster = Cluster(32, device="cuda", transport=transport)
        try:
            await cluster.start(timeout=60)
            await cluster.write_all(3)
            read = await cluster.read_counters(timeout=60)
            assert all(v == [3, 3, 3] for v in read.values())
            for s in cluster.servers:
                assert s.engine._dev.match_index.is_cuda
        finally:
            await cluster.close()
    asyncio.run(run())


@pytest.mark.parametrize("shared", [False, True])
def test_durable_cluster_restarts_on_the_card(card, tmp_path, shared):
    """3 x 32 over TCP on the default durable log (per group, or the
    shared plane), ArithmeticStateMachine: every map equal to the fold of
    the acknowledged writes before and after a full restart from disk."""
    from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

    async def run():
        cluster = Cluster(32, device="cuda", transport="tcp",
                          sm="arithmetic", properties=cluster_properties(
                              32, 3, "cuda", "tcp", storage_dir=str(tmp_path),
                              shared_log=shared))
        try:
            await cluster.start(timeout=60)
            await cluster.write_all(3)
            assert await cluster.check_variables(60) == 96
            await cluster.restart(60)
            assert await cluster.check_variables(60) == 96
            for s in cluster.servers:
                assert s.engine._dev.match_index.is_cuda
        finally:
            await cluster.close()
    asyncio.run(run())


def test_mesh_cluster_runs_on_the_card(card):
    """3 x 32 with mesh-devices=8 on the card: every fast tick is K5."""
    from ratis_tpu_torch.conf import RaftServerConfigKeys
    from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties
    props = cluster_properties(32, 3, "cuda", "sim", mesh_devices=8)
    props.set(RaftServerConfigKeys.Engine.MAX_GROUPS_KEY, "256")
    cluster = Cluster(32, device="cuda", properties=props)
    cluster.prewarm()
    n1, n5 = tq.K1.launches, tq.K5.launches

    async def run():
        try:
            await cluster.start(timeout=60)
            await cluster.write_all(3)
            read = await cluster.read_counters(timeout=60)
            assert all(v == [3, 3, 3] for v in read.values())
            for s in cluster.servers:
                assert s.engine._dev.match_index.is_cuda
                assert s.engine.state.n_slices == 8
        finally:
            await cluster.close()
    asyncio.run(run())
    assert tq.K1.launches == n1 and tq.K5.launches > n5


def test_five_peer_filestore_cluster_runs_on_the_card(card):
    """5 x 8 FileStore groups on the card with 2 DataStream streams: every
    replica's files equal the acknowledged writes and streams, and K1-K4
    launched on the 5-member path (K5 not)."""
    from ratis_tpu_torch.tools.cluster import Cluster, stream_payload
    cluster = Cluster(8, 5, device="cuda", transport="tcp", sm="filestore",
                      datastream=True)
    cluster.prewarm()
    kernels = (tq.K1, tq.K2, tq.K3, tl.K4, tq.K5)
    before = [k.launches for k in kernels]

    async def run():
        try:
            await cluster.start(timeout=60)
            stats = await cluster.write_all(2)
            assert stats["commits"] == 16
            replies = await asyncio.gather(*(
                cluster.stream_file(cluster.groups[i], f"s{i}.bin",
                                    stream_payload(1, i, 256 << 10),
                                    packet=64 << 10, window=16)
                for i in range(2)))
            assert all(r.success for r in replies)
            files = await cluster.check_files(timeout=60)
            assert sum(len(f) for f in files.values()) == 16 + 2
            # the watchdog's ledger pass runs once a second on every server
            for _ in range(40):
                if all(s.engine.ledger.samples.count
                       for s in cluster.servers):
                    break
                await asyncio.sleep(0.1)
            for s in cluster.servers:
                assert s.engine._dev.match_index.is_cuda
                assert s.engine.ledger.samples.count > 0
        finally:
            await cluster.close()
    asyncio.run(run())
    launched = [k.launches - n for k, n in zip(kernels, before)]
    assert all(n > 0 for n in launched[:4]) and launched[4] == 0, launched


@pytest.mark.parametrize("name", ["crash_restart_leader", "rebalance_storm"])
def test_chaos_scenario_runs_on_the_card(card, name):
    """A 3 x 8 ChaosCluster on the card with the batched engine on every
    tick (scalar-fallback threshold 0, as the JAX package's batched chaos
    test sets it; 8 groups are under the default threshold): the scenario
    passes its SLOs, the servers a crash rebuilt run on the card too, and
    K1-K4 launched on the fault path (K5 not)."""
    from ratis_tpu_torch.chaos.cluster import ChaosCluster, chaos_properties
    from ratis_tpu_torch.chaos.scenario import run_scenario
    from ratis_tpu_torch.chaos.scenarios import build_scenario
    from ratis_tpu_torch.engine.engine import QuorumEngine
    QuorumEngine(max_groups=64, device=card).prewarm()
    kernels = (tq.K1, tq.K2, tq.K3, tl.K4, tq.K5)
    cfg = {"servers": 3, "groups": 8, "writers": 4, "active_groups": 8,
           "sm": "counter", "convergence_s": 30.0, "recovery_s": 60.0,
           "min_acked": 20}

    async def run():
        p = chaos_properties(8, seed=7)
        p.set("raft.tpu.engine.scalar-fallback-threshold", "0")
        cluster = ChaosCluster(3, 8, properties=p, sm="counter", seed=7)
        await cluster.start()
        before = [k.launches for k in kernels]
        try:
            result = await run_scenario(cluster,
                                        build_scenario(name, 7, cfg))
            assert result.passed, (result.error, result.journal)
            assert result.acked > cfg["min_acked"]
            for s in cluster.servers.values():
                assert s.engine.device.type == "cuda"
                assert s.engine._dev is None \
                    or s.engine._dev.match_index.is_cuda
        finally:
            await cluster.close()
        return [k.launches - n for k, n in zip(kernels, before)]
    launched = asyncio.run(run())
    assert all(n > 0 for n in launched[:4]) and launched[4] == 0, launched


@pytest.mark.parametrize("rung", ["readmix", "zipf"])
def test_read_rung_runs_tiny_on_the_card(card, rung):
    """The bench's read rungs tiny on the card (3 x 8 over TCP; the zipf
    fleet 256 clients, 64 in flight, element limit 16), the batched engine
    on every tick (the harness's scalar-fallback threshold 0): every read
    value and every replica within its bounds, K1-K4 launched on the read
    path, K5 and K7c (the lease expiry stays on the host, as in the
    reference) not."""
    from ratis_tpu_torch.tools import read_bench as rb
    kernels = (tq.K1, tq.K2, tq.K3, tl.K4, tq.K5, tq.K7c)
    before = [k.launches for k in kernels]
    if rung == "readmix":
        res = asyncio.run(rb.readmix_rung(rb.read_cluster("cuda", 8),
                                          writes=2))
        assert res["commits"] == 16 and res["reads_ok"] == 48
    else:
        res = asyncio.run(rb.zipf_rung(
            rb.read_cluster("cuda", 8, zipf=True, element_limit=16),
            clients=256, concurrency=64, element_limit=16,
            unsat_clients=16))
        assert res["writes_ok"] == res["reads_ok"] == 256
        assert res["pending_peak"] <= 16
    launched = [k.launches - n for k, n in zip(kernels, before)]
    assert (res["read_mismatches"], res["replica_mismatches"]) == (0, 0)
    assert res["engine_device"].startswith("cuda")
    assert all(n > 0 for n in launched[:4]) and launched[4:] == [0, 0], \
        launched


# -- BASELINE config 5: 7 of 8 lanes, the snapshot rung, 7 peers ------------

def _seven_lanes(rng, g: int, joint: bool) -> list:
    """``resident_state`` with every conf of 7 members (the 8th lane
    empty); ``joint``: every row in a joint round from 5 to the 7."""
    st = cases.resident_state(rng, g, P, NOW, members=7)
    st[4][:] = False
    if joint:
        st[4][:, :5] = True
    return st


@pytest.mark.parametrize("joint", [False, True], ids=["seven", "joint5to7"])
@pytest.mark.parametrize("g", [64, 1024])
def test_k1_k2_k3_at_seven_of_eight_lanes_match_plain(card, g, joint):
    rng = np.random.default_rng(g + joint)
    st = _seven_lanes(rng, g, joint)
    ev, meta = _cuda([cases.fast_events(rng, g, P, 256, NOW),
                      np.array([NOW, 300], np.int32)])
    a = tq.device_state_from_numpy(st, card)
    b = tq.device_state_from_numpy(st, card)
    k = tq.engine_step_resident_fast(a, ev, meta)
    assert torch.equal(k.out, tq._resident_fast_plain(b, ev, meta))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    rf_idx, rf, acks = cases.refresh(rng, g, P, 64, 256, NOW)
    rf[3][:] = False
    rf[3][:, :7] = True
    rf[4][:] = False
    if joint:
        rf[4][:, :5] = True
    _refresh_kernel_and_plain(card, st, rf_idx, rf, acks)
    arrays = cases.tally_inputs(rng, g, P, members=7)
    if joint:
        arrays[3][:] = False
        arrays[3][:, :5] = True
    rows = np.arange(g)
    plan = cases.tally_plan(arrays, rows, card, 64 if g <= 64 else 1024)
    got = plan.run(64 if g <= 64 else 1024).copy()
    want = tq._tally_plain(*(torch.from_numpy(np.ascontiguousarray(x))
                             for x in arrays))
    assert np.array_equal(got[:, :g], want.numpy()[:, :g])


def test_snapcatch_rung_runs_tiny_on_the_card(card, tmp_path):
    """The bench's snapcatch rung small on the card (3 x 64 over TCP, 4 +
    4 writes: at 8 groups a load is 16 writes and one slow install write
    on the card host's filesystem reads as the rung's write collapse):
    every wiped replica caught up by an install, every counter equal to
    both loads' writes, the wiped engine on the rows it released; K1-K4
    launched, K5 not."""
    from ratis_tpu_torch.tools import snapshot_bench as sb
    kernels = (tq.K1, tq.K2, tq.K3, tl.K4, tq.K5)
    before = [k.launches for k in kernels]
    res = asyncio.run(sb.snapcatch_rung(
        sb.snapcatch_cluster("cuda", 64, str(tmp_path)), writes=4))
    launched = [k.launches - n for k, n in zip(kernels, before)]
    assert res["installs"] == 64 and res["replica_mismatches"] == 0
    assert res["commits"] == 512 and res["victim_live_rows"] == 64
    assert res["victim_rows_reused"] == 64
    assert res["engine_device"].startswith("cuda")
    assert all(n > 0 for n in launched[:4]) and launched[4] == 0, launched


def test_seven_peer_rung_runs_tiny_on_the_card(card):
    """The bench's peer7 rung tiny on the card (7 x 16 over the simulated
    transport, 4 writes a group, traced): every counter read back from 7
    replicas; K1-K4 launched, K5 not."""
    kernels = (tq.K1, tq.K2, tq.K3, tl.K4, tq.K5)
    before = [k.launches for k in kernels]
    res = asyncio.run(bench.e2e_rung(bench.peer7_cluster("cuda", 16), 4,
                                     warmup=0))
    launched = [k.launches - n for k, n in zip(kernels, before)]
    assert res["acked"] == 64 and res["replicas_read_back"] == 16 * 7
    assert res["engine_device"].startswith("cuda")
    assert "host_path_decomposition" in res
    assert all(n > 0 for n in launched[:4]) and launched[4] == 0, launched


def test_multiproc_run_tiny_on_the_card(card):
    """The multi-process harness tiny on the card (3 server processes x 4
    groups on 2 loop shards each, 2 client processes): every write acked
    and counted on all 3 replicas; each server's engine on the card, K2
    launched in its own process and K5-K7 and the public K3 not, no
    prepared call off its home loop's thread; no client touched CUDA; no
    child left."""
    from ratis_tpu_torch.tools.multiproc_bench import (live_children,
                                                       run_multiproc_bench)
    res = asyncio.run(run_multiproc_bench(
        4, 2, num_servers=3, loop_shards=2, client_procs=2, device="cuda",
        concurrency=8, record_plans=True, bringup_timeout_s=300.0,
        load_timeout_s=300.0))
    assert res["commits"] == 8 and res["write_failures"] == 0
    assert res["replicas_read_back"] == 12
    assert res["replica_mismatches"] == 0, res["mismatch_examples"]
    assert res["transfers_failed"] == 0, res["transfers"]
    for r in res["servers"]:
        assert r["device"].startswith("cuda")
        assert r["launches"]["K2"] > 0, r["launches"]
        assert not any(r["launches"][k] for k in
                       ("K5", "K6", "K7a", "K7b", "K7c", "K3_public"))
        assert r["off_home_calls"] == {} and r["ledger_faults"] == []
    assert not any(c["cuda_initialized"] for c in res["clients"])
    assert live_children(res["child_pids"]) == []


def test_scalar_cluster_runs_on_the_card(card):
    """The scalar control tiny on the card (3 x 16 over TCP, every tick on
    the per-division host loop): every counter read back from 3 replicas,
    the engines on the card, no K1, K2, K3 or K5 launched after the
    prewarm, and one K4 launch per ledger sample."""
    from ratis_tpu_torch.tools.plan_recorder import ShapeRecorder
    cluster = bench.e2e_cluster("cuda", 16, "tcp", batched=False)
    kernels = (tq.K1, tq.K2, tq.K3, tl.K4, tq.K5)
    before = [k.launches for k in kernels]
    with ShapeRecorder() as rec:
        res = asyncio.run(bench.e2e_rung(cluster, 2))
    launched = [k.launches - n for k, n in zip(kernels, before)]
    assert res["mode"] == "scalar" and res["acked"] == 16 * 3
    assert res["replicas_read_back"] == 16 * 3
    assert res["engine_device"].startswith("cuda")
    assert launched[:3] == [0, 0, 0] and launched[4] == 0, launched
    assert launched[3] == rec.ledger_samples > 0, launched


def test_profiler_hook_traces_the_kernels_on_the_card(card, tmp_path):
    """A profiled cluster on the card (3 x 16, simulated transport): the
    owner's session has CUDA activity, so its trace holds the engine's
    ``engine_tick`` ranges and the kernel events of ``tile_tick``."""
    import json

    from ratis_tpu_torch.conf import RaftServerConfigKeys
    from ratis_tpu_torch.engine.engine import QuorumEngine
    cluster = bench.e2e_cluster("cuda", 16, "sim", props={
        RaftServerConfigKeys.Engine.PROFILE_DIR_KEY: str(tmp_path)})
    res = asyncio.run(bench.e2e_rung(cluster, 2))
    assert res["acked"] == 16 * 3
    assert QuorumEngine._profiling_owner is None
    traces = list(tmp_path.iterdir())
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "engine_tick" for e in events)
    assert any(e.get("cat") == "kernel" and "tile_tick" in e.get("name", "")
               for e in events)
