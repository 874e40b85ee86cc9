"""K4's prepared call (``ops.ledger.LedgerPlan``) and the engine's ledger
samples against the JAX package.

The engine's ledger writes its host mirrors into one buffer per sample
(``LedgerPlan.views``); on a card one call copies the buffer up, launches
K4 once and copies the packed vector down.  On the CPU the same buffer
feeds the plain version, so these tests hold the packing itself against
the jitted JAX ``ledger_pass``, section by section:

- the plan on seeded ``tools.cases.ledger_inputs`` at several (G, P, W),
  a table wider than shared memory holds on the card (W = 512) included;
- the byte offsets the plan hands its C entry, from the host's layout;
- one plan across a table-width growth 8 -> 16 (its output grows);
- a CPU engine's ``LagLedger.sample()`` across a peer-table growth and a
  capacity growth (the plan is remade), each sample equal to the JAX pass
  on the same mirrors and baselines;
- two samples in a row: the first sample's arrays are not rewritten by
  the second (a sample keeps views of its own copy of the packed vector);
- a mesh engine's sample equal to a flat engine's on the same mirrors.

Everything is int32 / int8 / bool: every comparison is exact.
"""

import functools

import jax
import numpy as np
import pytest

from ratis_tpu.ops import ledger as jl
from ratis_tpu_torch.engine.engine import QuorumEngine
from ratis_tpu_torch.ops import ledger as tl
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.parallel import make_group_mesh
from ratis_tpu_torch.tools import cases

from tests.test_torch_engine import FakeClock

P = 8


@functools.lru_cache(maxsize=None)
def _jpass(width):
    return jax.jit(functools.partial(jl.ledger_pass, num_peers=width))


def _jax(arrays, scalars, width):
    now, thr, window = scalars
    return np.asarray(_jpass(width)(*arrays, np.int32(now), np.int32(thr),
                                    np.int32(window)))


def _same(got, want, g, width):
    assert got.shape == want.shape == (tl.packed_size(g, width),)
    for name, sl in tl.pack_slices(g, width).items():
        np.testing.assert_array_equal(got[sl], want[sl], err_msg=name)


def _fill(plan, arrays):
    for v, a in zip(plan.views, arrays):
        np.copyto(v, a)


@pytest.mark.parametrize("g,p,width", [(64, 8, 8), (300, 8, 16),
                                       (128, 5, 8), (64, 3, 512)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_matches_jax(seed, g, p, width):
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(seed), g, p,
                                          width)
    plan = tl.LedgerPlan(g, p, "cpu")
    _fill(plan, arrays)
    n = tl.K4.launches
    _same(plan.run(width, *scalars), _jax(arrays, scalars, width), g, width)
    assert tl.K4.launches == n  # the CPU runs the plain version


def test_plan_big_cell_matches_jax():
    g, width = 800, 8
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(7), g, P,
                                          width, big_cell=True)
    plan = tl.LedgerPlan(g, P, "cpu")
    _fill(plan, arrays)
    got = plan.run(width, *scalars)
    _same(got, _jax(arrays, scalars, width), g, width)
    assert got[tl.pack_slices(g, width)["hist"]][0] > 2048


@pytest.mark.parametrize("g,p", [(64, 8), (100, 5), (1, 3)])
def test_plan_offsets_follow_the_layout(g, p):
    """The offsets the C entry gets are each view's byte offset in the
    one buffer, in ledger_pass's argument order, then the buffer's size;
    every int32 section is 4-byte aligned."""
    plan = tl.LedgerPlan(g, p, "cpu")
    base = plan._host.numpy().ctypes.data
    offs = list(plan._offsets)
    assert len(offs) == len(tl.LedgerViews._fields) + 1
    for name, v, off in zip(tl.LedgerViews._fields, plan.views, offs):
        assert v.ctypes.data - base == off, name
        assert off % v.itemsize == 0, name
    assert offs[-1] == plan._host.numel() == tq.layout_offsets(
        tl.LEDGER_LAYOUT, tl.ledger_shapes(g, p))[-1]


def test_one_plan_across_a_width_growth():
    g = 128
    plan = tl.LedgerPlan(g, P, "cpu")
    assert plan.width == 8
    for seed, width in enumerate((8, 16, 16, 8)):
        arrays, scalars = cases.ledger_inputs(np.random.default_rng(seed),
                                              g, P, width)
        _fill(plan, arrays)
        _same(plan.run(width, *scalars).copy(), _jax(arrays, scalars, width),
              g, width)
    assert plan.width == 16


def _engine(capacity, mesh=None):
    eng = QuorumEngine(max_groups=capacity, max_peers=P,
                       scalar_fallback_threshold=0, use_device=True,
                       device="cpu", mesh=mesh)
    eng.clock = FakeClock()
    eng.clock.t = 100_000
    return eng


def _write_mirrors(eng, arrays, gen):
    """The ledger's inputs as the engine's host mirrors."""
    st = eng.state
    (st.role[:], st.match_index[:], st.commit_index[:], st.applied_index[:],
     st.conf_cur[:], st.conf_old[:], st.self_mask[:], st.last_ack_ms[:],
     st.peer_index[:]) = arrays[:9]
    st.alloc_gen[:] = gen


def _expected(ledger):
    """The JAX pass on the engine's mirrors and the ledger's baselines, as
    the next sample takes them (resized to the capacity first, as the
    sample resizes them)."""
    st = ledger.engine.state
    ledger._sync_capacity(st.capacity)
    arrays = [st.role, st.match_index, st.commit_index, st.applied_index,
              st.conf_cur, st.conf_old, st.self_mask, st.last_ack_ms,
              st.peer_index, ledger._prev_commit.copy(),
              ledger._prev_gen == st.alloc_gen]
    return _jax(arrays, (ledger.engine.clock.now_ms(), ledger.lag_threshold,
                         ledger.up_window_ms), ledger._table_width())


def _sample_equals(ledger, want):
    s = ledger.sample()
    g, w = s.capacity, len(s.peer_max_lag)
    sl = tl.pack_slices(g, w)
    got = np.concatenate([s.gap, s.delta, s.worst_lag, s.worst_peer,
                          s.hist.ravel(), s.peer_links, s.peer_up,
                          s.peer_laggy, s.peer_active, s.peer_laggy_active,
                          s.peer_max_lag, [s.leading, s.gap_total]])
    _same(got.astype(np.int32), want, g, w)
    assert s.gap_total == int(want[sl["scalars"]][1])
    return s


def test_engine_samples_across_table_and_capacity_growth():
    """A CPU engine's samples through the plan, each equal to the JAX pass
    on the same mirrors: with 8 peers interned, then 12 (the table widens
    to 16), then after the capacity doubles (the plan is remade), the
    delta baselines carried across."""
    eng = _engine(64)
    ledger = eng.ledger
    rng = np.random.default_rng(11)
    for i in range(8):
        ledger.peer_for(f"p{i}")
    gen = np.ones(64, np.int32)
    for step in range(5):
        if step == 2:
            for i in range(8, 12):
                ledger.peer_for(f"p{i}")
        if step == 3:
            eng.state._grow()
            gen = np.ones(128, np.int32)
        g = eng.state.capacity
        arrays, _ = cases.ledger_inputs(rng, g, P, ledger._table_width())
        _write_mirrors(eng, arrays, gen)
        _sample_equals(ledger, _expected(ledger))
        eng.clock.t += 1000
        assert ledger._ledger_plan.capacity == g
        assert ledger._ledger_plan.width >= ledger._table_width()
    assert ledger._table_width() == 16 and eng.state.capacity == 128
    assert ledger.samples.count == 5


def test_a_sample_keeps_its_arrays_after_the_next():
    eng = _engine(64)
    ledger = eng.ledger
    rng = np.random.default_rng(12)
    arrays, _ = cases.ledger_inputs(rng, 64, P, 8)
    _write_mirrors(eng, arrays, np.ones(64, np.int32))
    first = _sample_equals(ledger, _expected(ledger))
    kept = {k: np.array(v, copy=True) for k, v in vars(first).items()
            if isinstance(v, np.ndarray)}
    arrays, _ = cases.ledger_inputs(rng, 64, P, 8)
    _write_mirrors(eng, arrays, np.ones(64, np.int32))
    eng.clock.t += 500
    second = _sample_equals(ledger, _expected(ledger))
    for k, v in kept.items():
        np.testing.assert_array_equal(getattr(first, k), v, err_msg=k)
    assert not np.array_equal(first.worst_lag, second.worst_lag)


@pytest.mark.parametrize("n_slices", [2, 8])
def test_mesh_engine_samples_as_the_flat_engine(n_slices):
    """A mesh engine's ledger (the same ``LedgerPlan`` over its
    contiguous slices) against a flat engine's on the same mirrors, two samples each (the
    second with delta baselines), and both against JAX."""
    flat = _engine(256)
    mesh = _engine(256, make_group_mesh(n_slices, device="cpu"))
    assert mesh.state.n_slices == n_slices
    rng = np.random.default_rng(n_slices)
    for i in range(8):
        flat.ledger.peer_for(f"p{i}")
        mesh.ledger.peer_for(f"p{i}")
    for _ in range(2):
        arrays, _ = cases.ledger_inputs(rng, 256, P, 8)
        for eng in (flat, mesh):
            _write_mirrors(eng, arrays, np.ones(256, np.int32))
        want = _expected(flat.ledger)
        a = _sample_equals(flat.ledger, want)
        b = _sample_equals(mesh.ledger, _expected(mesh.ledger))
        for k, v in vars(a).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(b, k), v, err_msg=k)
        for eng in (flat, mesh):
            eng.clock.t += 700
