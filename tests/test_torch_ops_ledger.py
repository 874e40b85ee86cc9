"""The port's ledger pass against the JAX package's, section by section.

Same seeded numpy inputs through the jitted JAX ``ledger_pass`` on the CPU
and the port's plain-torch ``ledger_pass`` on CPU tensors; the packed int32
vectors must be EQUAL in every section.  The inputs carry duplicate dense
peer ids, unmapped columns (-1), ids past the table width, argmax ties,
wrapping int32 differences, and one (peer, bucket) cell above 2048 links
(a float count would round there; the port counts in int32).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ratis_tpu.ops import ledger as jl
from ratis_tpu_torch.ops import ledger as tl
from ratis_tpu_torch.tools import cases


@functools.lru_cache(maxsize=None)
def _jpass(width):
    return jax.jit(functools.partial(jl.ledger_pass, num_peers=width))


def _both(arrays, scalars, width):
    now, thr, window = scalars
    want = np.asarray(_jpass(width)(*arrays, np.int32(now), np.int32(thr),
                                    np.int32(window)))
    got = tl.ledger_pass(*(torch.from_numpy(a) for a in arrays), now, thr,
                         window, num_peers=width).numpy()
    g = arrays[0].shape[0]
    assert got.shape == (tl.packed_size(g, width),)
    for name, sl in tl.pack_slices(g, width).items():
        np.testing.assert_array_equal(got[sl], want[sl], err_msg=name)
    return got


@pytest.mark.parametrize("g,p,width", [(64, 8, 8), (300, 8, 16),
                                       (128, 5, 8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_matches_jax(seed, g, p, width):
    rng = np.random.default_rng(seed)
    arrays, scalars = cases.ledger_inputs(rng, g, p, width)
    _both(arrays, scalars, width)


def test_ledger_counts_a_cell_above_2048_links_exactly():
    g, p, width = 800, 8, 8
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(7), g, p,
                                          width, big_cell=True)
    got = _both(arrays, scalars, width)
    hist = got[tl.pack_slices(g, width)["hist"]].reshape(width,
                                                         tl.LAG_BUCKETS)
    assert hist[0, 0] >= 3 * g > 2048


def test_ledger_argmax_ties_take_the_first_column():
    g, p, width = 2, 4, 8
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(8), g, p,
                                          width)
    role, match, commit = arrays[0], arrays[1], arrays[2]
    cur, old, selfm, pidx = arrays[4], arrays[5], arrays[6], arrays[8]
    role[:] = 3
    cur[:] = True
    old[:] = False
    selfm[:] = False
    selfm[:, 0] = True
    commit[:] = 100
    match[:] = [10, 40, 40, 90]
    pidx[:] = [0, 5, 6, 7]
    got = _both(arrays, scalars, width)
    sl = tl.pack_slices(g, width)
    assert (got[sl["worst_lag"]] == 60).all()
    assert (got[sl["worst_peer"]] == 5).all()


def test_lag_buckets_are_exact_at_power_of_two_boundaries():
    lags = np.array([0, 1, 2, 3, 4, 7, 8, 1023, 1024, 2 ** 30 - 1, 2 ** 30,
                     2 ** 31 - 1], np.int32)
    got = tl.lag_buckets(torch.from_numpy(lags)).numpy()
    want = np.asarray(jl.lag_buckets(lags))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [int(x).bit_length() for x in lags])



@pytest.mark.parametrize("g,width", [(64, 8), (1024, 16)])
def test_plain_ledger_stays_on_row_sized_tensors(g, width):
    """The plain version counts links by index on [G, P] tensors: no
    operation of it takes or makes a tensor larger than the lag buckets'
    [G, P, LAG_BUCKETS - 1] compare.  A [G, P, W, LAG_BUCKETS] one-hot
    reduced on the CPU ran torch's intra-op thread pool, which stalled a
    server's event loop for seconds a sample beside busy processes (the
    chaos scenarios missed their re-election SLO there)."""
    from torch.profiler import ProfilerActivity, profile
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(5), g, 8,
                                          width)
    tensors = [torch.from_numpy(a) for a in arrays]
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        tl.ledger_pass(*tensors, *scalars, num_peers=width)
    largest = max(int(np.prod(shape)) for evt in prof.events()
                  for shape in evt.input_shapes if shape)
    assert largest <= g * 8 * (tl.LAG_BUCKETS - 1)
