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


@pytest.mark.parametrize("g,e", [(1024, 256), (10240, 4096)])
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_step_kernel_matches_plain(card, g, e, seed):
    rng = np.random.default_rng(seed)
    _step_both(tq.engine_step_args_from_numpy(
        cases.step_args(rng, g, P, e, NOW), card))
    _step_both(tq.engine_step_args_from_numpy(
        bench._example_batch(g, P, e, seed), card))


def test_engine_step_kernel_counts_its_launches(card):
    fn, args = bench.entry(card)
    n = tq.K6.launches
    fn(*args)
    assert tq.K6.launches == n + 1


def test_tally_kernel_matches_plain(card):
    args = _cuda(cases.tally_inputs(np.random.default_rng(2), 10240, P))
    assert torch.equal(tq.tally_votes_packed(*args), tq._tally_plain(*args))


@pytest.mark.parametrize("big_cell", [False, True])
def test_ledger_kernel_matches_plain(card, big_cell):
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(3), 1024, P,
                                          8, big_cell=big_cell)
    dev = _cuda(arrays)
    got = tl.ledger_pass(*dev, *scalars, num_peers=8)
    assert torch.equal(got, tl._ledger_plain(*dev, *scalars, 8))


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
