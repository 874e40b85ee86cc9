"""The port's stateless fused tick (K6, ``engine_step``) against the JAX
package's.

The same numpy inputs go through the jitted JAX ``engine_step`` on the CPU
and through the port's plain-torch version on CPU tensors: the bench's own
batches (``tools.bench._example_batch``) and the seeded edge cases of
``tools.cases.step_args`` (invalid acks with garbage values, duplicates,
indices in ``[-n, -1]``, below ``-n`` and at or past ``n``, joint and
empty confs, a leader whose ``now - INT32_MIN`` wraps in int32).  Every
output must be EQUAL, and no input may change.  The CUDA kernel is held
against the same plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratis_tpu.ops import quorum as jq
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.tools import bench, cases

_jstep = jax.jit(jq.engine_step)


def _both(args):
    """Run both, check every output equal and the inputs unchanged."""
    jr = _jstep(*(jnp.asarray(a) for a in args))
    targs = tq.engine_step_args_from_numpy(args, "cpu")
    before = [t.clone() for t in targs[:15]]
    tr = tq.engine_step(*targs)
    assert tq.EngineStep._fields == jq.EngineStep._fields
    for name, t, j in zip(tq.EngineStep._fields, tr, jr):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    for (name, _, _), t, b in zip(tq.ENGINE_STEP_ARRAYS, targs, before):
        assert torch.equal(t, b), f"{name} was written"
    for a, t in zip(args, targs):
        np.testing.assert_array_equal(np.asarray(t), a)
    return tr


@pytest.mark.parametrize("g,e", [(64, 32), (1024, 256), (2048, 4096)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_example_batch_matches_jax(seed, g, e):
    tr = _both(bench._example_batch(g, 8, e, seed))
    assert tr.commit_changed.any() and tr.stale.any()


@pytest.mark.parametrize("g,e", [(4, 64), (96, 256), (512, 4096)])
@pytest.mark.parametrize("seed", range(4))
def test_edge_cases_match_jax(seed, g, e):
    _both(cases.step_args(np.random.default_rng(100 + seed), g, 8, e))


@pytest.mark.parametrize("p", [3, 5, 7, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_peer_counts_match_jax(seed, p):
    """K6 at the other peer counts the kernel takes (1 <= P <= 16): the
    bench's batch and the edge cases."""
    tr = _both(bench._example_batch(1024, p, 2048, seed))
    assert tr.commit_changed.any()
    _both(cases.step_args(np.random.default_rng(200 + seed), 512, p, 4096))


@pytest.mark.parametrize("g", [1, 1001, 1022, 1023, 1024])
def test_output_buffer_reads_as_int32_at_any_group_count(g):
    """On a card K6's four outputs are views of one byte buffer, read as
    int32 for match, ack and new_commit: its size is whole int32 words
    whatever G, with every section inside it and the int32 ones aligned."""
    p, e = 8, 64
    _, offs = tq._step_specs(g, p, e)
    assert offs[-1] % 4 == 0
    assert offs[1] == 4 * g * p and offs[2] == 8 * g * p
    assert offs[3] == offs[2] + 4 * g and offs[3] + 3 * g <= offs[-1] < \
        offs[3] + 3 * g + 4
    assert torch.empty(offs[-1], dtype=torch.uint8).view(
        torch.int32).numel() == offs[-1] // 4


def test_negative_indices_count_from_the_end():
    """XLA's index normalisation: (group, peer) = (-1, 0) lands on row
    G - 1 and (1, -1) on peer P - 1; (-G - 1, 0) and (0, -P - 1) are
    dropped, like (G, 0) and (0, P)."""
    g, p = 4, 3
    args = list(bench._example_batch(g, p, 6))
    args[0] = np.zeros((g, p), np.int32)
    args[1] = np.zeros((g, p), np.int32)
    args[2] = np.array([-1, 1, -g - 1, 0, g, 0], np.int32)
    args[3] = np.array([0, -1, 0, -p - 1, 0, p], np.int32)
    args[4] = np.array([7, 8, 9, 10, 11, 12], np.int32)
    args[5] = np.array([1, 2, 3, 4, 5, 6], np.int32)
    args[6] = np.ones(6, bool)
    tr = _both(args)
    want = np.zeros((g, p), np.int32)
    want[3, 0], want[1, 2] = 7, 8
    np.testing.assert_array_equal(tr.match_index.numpy(), want)


def test_invalid_events_at_zero_zero_write_nothing_but_valid_ones_land():
    """JAX sends invalid acks to (0, 0) with dtype-min values; the port
    skips them.  A valid ack at (0, 0) in the same batch must still land."""
    g, p = 8, 8
    args = list(bench._example_batch(g, p, 3))
    args[0] = np.full((g, p), 5, np.int32)
    args[1] = np.full((g, p), 5, np.int32)
    args[2] = np.array([0, 0, 0], np.int32)
    args[3] = np.array([0, 0, 0], np.int32)
    args[4] = np.array([2**31 - 1, 9, 2**31 - 1], np.int32)
    args[5] = np.array([2**31 - 1, 6, 2**31 - 1], np.int32)
    args[6] = np.array([False, True, False])
    tr = _both(args)
    assert int(tr.match_index[0, 0]) == 9 and int(tr.last_ack_ms[0, 0]) == 6


def test_quorum_ack_wraps_in_int32():
    """A leader with an empty conf has quorum_ack INT32_MIN; now - INT32_MIN
    wraps negative, so it is not stale (XLA's int32 arithmetic)."""
    g, p = 4, 8
    args = list(bench._example_batch(g, p, 1))
    args[9] = np.zeros((g, p), bool)       # conf_cur: empty
    args[13] = np.full(g, 3, np.int8)      # every row a leader
    tr = _both(args)
    assert not tr.stale.any()
    assert not tr.commit_changed.any()


def test_args_from_numpy_checks_dtypes_and_makes_fresh_tensors():
    args = bench._example_batch(16, 8, 8)
    t = tq.engine_step_args_from_numpy(args, "cpu")
    assert [x.dtype for x in t[:15]] == [
        torch.int32] * 6 + [torch.bool, torch.bool, torch.int32, torch.bool,
                            torch.bool, torch.int32, torch.int32, torch.int8,
                            torch.int32]
    assert t[15:] == (5000, 300) and all(type(x) is int for x in t[15:])
    t[0].fill_(-7)
    assert (args[0] != -7).all()
    bad = list(args)
    bad[13] = bad[13].astype(np.int32)
    with pytest.raises(TypeError, match="role"):
        tq.engine_step_args_from_numpy(bad, "cpu")
    with pytest.raises(ValueError):
        tq.engine_step_args_from_numpy(args[:16], "cpu")


def test_entry_is_the_graft_entry_counterpart():
    import __graft_entry__
    jfn, jargs = __graft_entry__.entry()
    fn, args = bench.entry("cpu")
    assert fn is tq.engine_step
    assert len(args) == len(jargs) == 17
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(j))
    out = fn(*args)
    want = jax.jit(jfn)(*jargs)
    for t, j in zip(out, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_wrapper_refuses_devices_without_a_kernel():
    args = tq.engine_step_args_from_numpy(bench._example_batch(4, 8, 4),
                                          "meta")
    with pytest.raises(ValueError, match="no kernel"):
        tq.engine_step(*args)
