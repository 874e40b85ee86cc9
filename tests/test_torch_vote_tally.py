"""K3's public [G, P] tally — the port's ``tally_votes`` /
``tally_votes_packed`` against the JAX package's ``tally_votes`` and the
scalar reference, at every peer count the kernels take a row of 8 lanes
for (one slot a lane up to 8 peers, two from 9).

The same seeded numpy inputs (``ratis_tpu_torch.tools.cases``) go through
the jitted JAX function on the CPU and through the port's plain-torch
version on CPU tensors; every output must be EQUAL (the tally is bool).
The CUDA kernel runs only on a card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold it against this plain version there.
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
PEERS = (1, 2, 3, 5, 7, 8, 9, 16)

_jtally = jax.jit(jq.tally_votes)


def _tally_both(arrays) -> np.ndarray:
    """The port's packed tally against JAX's and, row by row, the scalar
    reference; returns bool [4, G]."""
    want = _jtally(*(jnp.asarray(a) for a in arrays))
    got = tq.tally_votes_packed(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in arrays))
    assert got.dtype == torch.bool and got.shape == (4, len(arrays[5]))
    for k, f in enumerate(tq.VoteTally._fields):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    got = got.numpy()
    grants, rejects, cur, old, prio, self_prio = arrays
    for i in range(len(self_prio)):
        passed, on_timeout, rejected = ref.tally_votes(
            grants[i].tolist(), rejects[i].tolist(), cur[i].tolist(),
            old[i].tolist(), prio[i].tolist(), int(self_prio[i]))
        assert tuple(got[:, i]) == (passed, on_timeout, rejected,
                                    passed or rejected), i
    return got


@pytest.mark.parametrize("p", PEERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_public_tally_matches_jax(seed, p):
    _tally_both(cases.tally_inputs(np.random.default_rng(seed), 128, p))


@pytest.mark.parametrize("p", PEERS)
def test_public_tally_edges_match_jax(p):
    """Priorities at INT32_MIN / INT32_MAX, empty current confs, joint
    rounds, rows where every member or none replied."""
    arrays = cases.tally_edges(np.random.default_rng(100 + p), 256, p)
    grants, rejects, cur, old, prio, self_prio = arrays
    # the generator reached every edge at this size
    assert (prio == INT32_MIN).any() and (prio == INT32_MAX).any()
    assert (self_prio == INT32_MIN).any() and (self_prio == INT32_MAX).any()
    assert (~cur.any(axis=1)).any() and old.any(axis=1).any()
    assert ((grants | rejects) == (cur | old)).all(axis=1).any()
    assert (~(grants | rejects).any(axis=1)).any()
    _tally_both(arrays)


def _row(p, cur, old=(), grants=(), rejects=(), prio=None, self_prio=0):
    """One tally row over ``p`` slots from the slot lists given."""
    def mask(slots):
        m = np.zeros((1, p), bool)
        m[0, list(slots)] = True
        return m
    pr = np.zeros((1, p), np.int32) if prio is None else \
        np.array([prio], np.int32)
    return [mask(grants), mask(rejects), mask(cur), mask(old), pr,
            np.array([self_prio], np.int32)]


def test_public_tally_empty_conf_never_passes():
    # no member: no majority (0 >= 1 fails), no reject majority
    assert _tally_both(_row(3, cur=()))[:, 0].tolist() == [False] * 4


def test_public_tally_veto_at_extreme_priorities():
    # slot 2 rejects at INT32_MAX above a candidate at INT32_MIN: a veto
    # although slots 0 and 1 grant a majority of 3
    row = _row(3, cur=(0, 1, 2), grants=(0, 1), rejects=(2,),
               prio=[0, 0, INT32_MAX], self_prio=INT32_MIN)
    assert _tally_both(row)[:, 0].tolist() == [False, False, True, True]
    # at INT32_MAX the candidate is never below anyone: no veto, passes
    row[5][:] = INT32_MAX
    assert _tally_both(row)[:, 0].tolist() == [True, True, False, True]


def test_public_tally_waits_on_a_silent_higher_peer():
    # a grant majority, but slot 2 (priority above the candidate's) has
    # not replied: only the timeout pass holds
    row = _row(3, cur=(0, 1, 2), grants=(0, 1), prio=[0, 0, 5])
    assert _tally_both(row)[:, 0].tolist() == [False, True, False, False]


def test_public_tally_joint_round_needs_both_confs():
    # 16 slots: conf_cur 0-8 granted by 0-4 (5 of 9), conf_old 8-15
    # granted by none: no majority there, so no pass
    p = 16
    row = _row(p, cur=range(9), old=range(8, 16), grants=range(5))
    assert _tally_both(row)[:, 0].tolist() == [False] * 4
    # slots 8-12 grant too: 5 of conf_old's 8, a majority in both
    row = _row(p, cur=range(9), old=range(8, 16),
               grants=[*range(5), *range(8, 13)])
    assert _tally_both(row)[:, 0].tolist() == [True, True, False, True]
    # 4 of conf_old's 8 reject: a reject majority there rejects the round
    row = _row(p, cur=range(9), old=range(8, 16), grants=range(5),
               rejects=range(12, 16))
    assert _tally_both(row)[:, 0].tolist() == [False, False, True, True]


def test_public_tally_tuple_is_the_packed_rows():
    arrays = cases.tally_edges(np.random.default_rng(7), 64, 9)
    tensors = [torch.from_numpy(a) for a in arrays]
    packed = tq.tally_votes_packed(*tensors)
    tally = tq.tally_votes(*tensors)
    for k, f in enumerate(tq.VoteTally._fields):
        assert torch.equal(getattr(tally, f), packed[k]), f
