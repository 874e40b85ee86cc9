"""K7 — the port's ``apply_vote_events`` (K7a), ``all_replicated_min``
(K7b) and ``lease_expiry`` (K7c) against the JAX package's.

The same seeded numpy inputs (``ratis_tpu_torch.tools.cases``) go through
the jitted JAX function on the CPU and through the port's plain-torch
version on CPU tensors; every output must be EQUAL (the math is int32 and
bool).  Peer widths 3, 5, 7, 8 and 16 (BASELINE configs 2-5 use 3, 5 and
7 peers; the kernels take up to 16 slots).  The CUDA kernels run only on
a card: ``test_torch_cuda.py`` and ``chip_smoke.py`` hold them against
these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratis_tpu.ops import quorum as jq
from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.ops import reference as ref
from ratis_tpu_torch.tools import cases

INT32_MIN, INT32_MAX = cases.INT32_MIN, cases.INT32_MAX
PEERS = (3, 5, 7, 8, 16)

_jvotes = jax.jit(jq.apply_vote_events)
_jrepl = jax.jit(jq.all_replicated_min)
_jlease = jax.jit(jq.lease_expiry)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _votes_both(arrays):
    jg, jr = _jvotes(*(jnp.asarray(a) for a in arrays))
    tg, tr = tq.apply_vote_events(*_t(arrays))
    for name, j, t in (("grants", jg, tg), ("rejects", jr, tr)):
        assert t.dtype == torch.bool, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    return tg.numpy(), tr.numpy()


def _repl_both(arrays):
    want = np.asarray(_jrepl(*(jnp.asarray(a) for a in arrays)))
    got = tq.all_replicated_min(*_t(arrays))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def _lease_both(arrays, timeout):
    want = np.asarray(_jlease(*(jnp.asarray(a) for a in arrays),
                              jnp.int32(timeout)))
    got = tq.lease_expiry(*_t(arrays), timeout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


# -- K7a ----------------------------------------------------------------------

@pytest.mark.parametrize("p", PEERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_vote_events_match_jax(seed, p):
    rng = np.random.default_rng(seed)
    arrays = cases.vote_events(rng, 64, p, 256)
    grants, rejects = _votes_both(arrays)
    # first reply wins: no peer that had replied changed its answer
    replied = arrays[0] | arrays[1]
    np.testing.assert_array_equal(grants[replied], arrays[0][replied])
    np.testing.assert_array_equal(rejects[replied], arrays[1][replied])


@pytest.mark.parametrize("g,p", [(4, 3), (2, 3), (16, 8), (8, 16)])
def test_vote_event_edges_match_jax(g, p):
    grants, rejects = _votes_both(cases.vote_event_edges(g, p))
    # a grant and a reject for (1, 2) in one batch: both pass the gate
    assert grants[1, 2] and rejects[1, 2]
    # group -1 is the last row; peer -1 the last slot
    assert grants[g - 1, 0] and rejects[0, p - 1]
    # g, g + 1, -g - 1, -2g and peer p are dropped; the invalid event too
    assert not grants[0, 0] and not rejects[0, 0]
    assert int(grants.sum()) == 2 and int(rejects.sum()) == 2


def test_vote_events_first_reply_wins_across_batches():
    g = np.zeros((2, 3), bool)
    r = np.zeros((2, 3), bool)
    one = lambda granted: [np.array([0], np.int32), np.array([1], np.int32),
                           np.array([granted]), np.array([True])]
    g, r = _votes_both([g, r, *one(True)])
    g, r = _votes_both([g, r, *one(False)])  # a stale reject: dropped
    assert g[0, 1] and not r[0, 1]


def test_vote_events_write_no_input():
    arrays = cases.vote_events(np.random.default_rng(3), 32, 8, 128)
    tensors = _t(arrays)
    before = [t.clone() for t in tensors]
    tq.apply_vote_events(*tensors)
    for t, b in zip(tensors, before):
        assert torch.equal(t, b)


# -- K7b ----------------------------------------------------------------------

@pytest.mark.parametrize("p", PEERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_all_replicated_min_matches_jax(seed, p):
    arrays = cases.replicated_inputs(np.random.default_rng(seed), 256, p)
    got = _repl_both(arrays)
    match, self_mask, flush, cur, old = arrays
    for i in range(0, 256, 17):
        want = ref.all_replicated_min(match[i], int(np.argmax(self_mask[i])),
                                      int(flush[i]), cur[i], old[i])
        assert int(got[i]) == want, i


def test_all_replicated_min_empty_union_is_int32_min():
    match = np.array([[5, 6, 7], [5, 6, 7]], np.int32)
    self_mask = np.array([[1, 0, 0], [1, 0, 0]], bool)
    flush = np.array([9, 2], np.int32)
    cur = np.array([[0, 0, 0], [1, 1, 1]], bool)
    old = np.array([[0, 0, 0], [0, 0, 0]], bool)
    got = _repl_both([match, self_mask, flush, cur, old])
    assert got.tolist() == [INT32_MIN, 2]


def test_all_replicated_min_joint_union():
    # conf_old adds slot 2 (match 1): the min over the union
    match = np.array([[5, 6, 1]], np.int32)
    self_mask = np.array([[1, 0, 0]], bool)
    got = _repl_both([match, self_mask, np.array([9], np.int32),
                      np.array([[1, 1, 0]], bool),
                      np.array([[0, 1, 1]], bool)])
    assert got.tolist() == [1]


# -- K7c ----------------------------------------------------------------------

@pytest.mark.parametrize("timeout", cases.LEASE_TIMEOUTS)
@pytest.mark.parametrize("p", PEERS)
def test_lease_expiry_matches_jax(p, timeout):
    arrays = cases.lease_inputs(np.random.default_rng(p), 256, p)
    got = _lease_both(arrays, timeout)
    if timeout >= 0:
        ack, self_mask, cur, old = arrays
        for i in range(0, 256, 17):
            want = ref.lease_expiry(ack[i], int(np.argmax(self_mask[i])),
                                    cur[i], old[i], timeout)
            assert int(got[i]) == want, i


def _three(cur_rows):
    """A 3-slot batch: leader in slot 0, acks 100, 200, 300."""
    n = len(cur_rows)
    ack = np.tile(np.array([100, 200, 300], np.int32), (n, 1))
    self_mask = np.zeros((n, 3), bool)
    self_mask[:, 0] = True
    return [ack, self_mask, np.array(cur_rows, bool), np.zeros((n, 3), bool)]


def test_lease_expiry_wraps_as_jax():
    # a full conf with a negative timeout: the cap and the sum both wrap
    assert _lease_both(_three([[1, 1, 1]]), -5).tolist() == [INT32_MAX]
    # a single-member conf: the leader alone, a lease forever
    assert _lease_both(_three([[1, 0, 0]]), 1000).tolist() == [INT32_MAX]
    # an empty conf: INT32_MIN + the timeout
    assert _lease_both(_three([[0, 0, 0]]), 1000).tolist() == [
        INT32_MIN + 1000]
    # full conf: the majority-min of (MAX, 200, 300) is 300
    assert _lease_both(_three([[1, 1, 1]]), 1000).tolist() == [1300]


def test_lease_expiry_joint_conf_takes_the_min():
    ack, self_mask, cur, _ = _three([[1, 1, 0]])
    old = np.array([[0, 1, 1]], bool)   # majority-min 200 vs 300 -> 200
    assert _lease_both([ack, self_mask, cur, old], 50).tolist() == [250]


def test_lease_timeout_must_be_int32():
    arrays = _t(_three([[1, 1, 1]]))
    with pytest.raises(ValueError, match="int32"):
        tq.lease_expiry(*arrays, INT32_MAX + 1)
