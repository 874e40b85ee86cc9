"""The port's quorum ops against the JAX package's.

The same seeded numpy inputs (``ratis_tpu_torch.tools.cases``) go through
the jitted JAX function on the CPU and through the port's plain-torch
version on CPU tensors; every output and the whole resident state after
the in-place update must be EQUAL (all kernel math is int32/int8/bool).
The CUDA kernels run only on a card: the ``cuda``-marked tests hold them
against the plain versions there, and ``chip_smoke.py`` does so at the
main path's shapes.
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

P = 8
NOW = 100_000
TIMEOUT = 300

_jfast = jax.jit(jq.engine_step_resident_fast)
_jrefresh = jax.jit(jq.engine_step_resident)
_jtally = jax.jit(jq.tally_votes)


def _jstate(arrays):
    return jq.DeviceState(*(jnp.asarray(a) for a in arrays))


def _tstate(arrays):
    return tq.device_state_from_numpy(arrays, "cpu")


def _assert_state_equal(jstate, tstate):
    for name, j, t in zip(tq.DeviceState._fields, jstate, tstate):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def _fast_both(state, ev, now=NOW, timeout=TIMEOUT):
    meta = np.array([now, timeout], np.int32)
    jr = _jfast(_jstate(state), jnp.asarray(ev), jnp.asarray(meta))
    tr = tq.engine_step_resident_fast(_tstate(state), torch.from_numpy(ev),
                                      torch.from_numpy(meta))
    np.testing.assert_array_equal(tr.out.numpy(), np.asarray(jr.out))
    _assert_state_equal(jr.state, tr.state)
    return jr, tr


# every event bucket the engine pads to (64 * 4^k up to the chunk cap)
@pytest.mark.parametrize("e", [64, 256, 1024, 4096, 16384])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_step_matches_jax(seed, e):
    rng = np.random.default_rng(seed)
    g = 96
    _fast_both(cases.resident_state(rng, g, P, NOW),
               cases.fast_events(rng, g, P, e, NOW))


def test_fast_step_sentinel_columns_change_nothing_but_the_row_pass():
    rng = np.random.default_rng(3)
    g = 32
    st = cases.resident_state(rng, g, P, NOW)
    ev = np.full((7, 64), tq.PACK_SENTINEL, np.int32)
    ev[0], ev[1], ev[4] = 0, 0, 0
    jr, tr = _fast_both(st, ev)
    for name in ("match_index", "last_ack_ms", "flush_index"):
        np.testing.assert_array_equal(
            getattr(tr.state, name).numpy(),
            st[tq.DeviceState._fields.index(name)])


def test_duplicate_acks_take_the_max():
    g = 4
    st = cases.resident_state(np.random.default_rng(4), g, P, NOW)
    st[0][:] = -1
    st[1][:] = 0
    ev = np.full((7, 64), tq.PACK_SENTINEL, np.int32)
    ev[0], ev[1], ev[4] = 0, 0, 0
    for col, (m, t) in enumerate([(5, 10), (9, 7), (3, 30)]):
        ev[:5, col] = (2, 1, m, t, 1)
    _, tr = _fast_both(st, ev)
    assert int(tr.state.match_index[2, 1]) == 9
    assert int(tr.state.last_ack_ms[2, 1]) == 30


def test_capacity_index_columns_are_dropped():
    g = 8
    st = cases.resident_state(np.random.default_rng(5), g, P, NOW)
    ev = np.full((7, 64), tq.PACK_SENTINEL, np.int32)
    ev[0], ev[1], ev[4] = 0, 0, 0
    ev[:5, 0] = (g, 1, 10**6, NOW, 1)          # ack at row capacity
    ev[0, 1], ev[5, 1], ev[6, 1] = g, 10**6, 1  # update at row capacity
    ev[0, 2], ev[4, 2] = 3, 0                   # invalid ack on a real row
    ev[2, 2], ev[3, 2] = 10**6, NOW
    _, tr = _fast_both(st, ev)
    np.testing.assert_array_equal(tr.state.match_index.numpy(), st[0])
    np.testing.assert_array_equal(tr.state.flush_index.numpy(), st[6])


def _row_state(g, role, cur, old, match, ack, flush=0, commit=-1, first=0):
    st = cases.resident_state(np.random.default_rng(6), g, P, NOW)
    st[5][:] = role
    st[3][:] = False
    st[4][:] = False
    st[3][:, :len(cur)] = cur
    st[4][:, :len(old)] = old
    st[2][:] = False
    st[2][:, 0] = True
    st[0][:] = -1
    st[0][:, :len(match)] = match
    st[1][:] = 0
    st[1][:, :len(ack)] = ack
    st[6][:] = flush
    st[7][:] = commit
    st[8][:] = first
    return st


@pytest.mark.parametrize("name,kw", [
    # joint conf: the commit is the min of both majorities
    ("joint", dict(role=3, cur=[1, 1, 1, 0, 0], old=[1, 0, 0, 1, 1],
                   match=[0, 9, 9, 2, 2], ack=[0, NOW, NOW, NOW, NOW],
                   flush=9)),
    # empty conf: majority-min is INT32_MIN, the commit never moves
    ("empty", dict(role=3, cur=[0] * 4, old=[0] * 4, match=[5, 5, 5, 5],
                   ack=[NOW] * 4, flush=5)),
    # empty conf on a leader: now - INT32_MIN wraps negative in int32, so
    # the leader is NOT stale (XLA's wrap, reproduced explicitly)
    ("int32_min_wrap", dict(role=3, cur=[0] * 3, old=[0] * 3,
                            match=[1, 1, 1], ack=[0, 0, 0])),
    # stale leader: no quorum ack within the timeout
    ("stale", dict(role=3, cur=[1, 1, 1], old=[], match=[1, 1, 1],
                   ack=[0, NOW - 5000, NOW - 5000])),
])
def test_edge_rows_match_jax(name, kw):
    st = _row_state(4, **kw)
    ev = np.full((7, 64), tq.PACK_SENTINEL, np.int32)
    ev[0], ev[1], ev[4] = 0, 0, 0
    jr, tr = _fast_both(st, ev)
    out = tr.out.numpy()
    if name == "joint":
        assert (out[0] == 2).all() and (out[1] == 1).all()
    if name == "empty":
        assert (out[1] == 0).all()
    if name == "int32_min_wrap":
        assert (out[3] == 0).all()
    if name == "stale":
        assert (out[3] == 1).all()


@pytest.mark.parametrize("d,e", [(64, 64), (256, 1024), (64, 16384)])
@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_step_matches_jax(seed, d, e):
    rng = np.random.default_rng(10 + seed)
    g = 128
    st = cases.resident_state(rng, g, P, NOW)
    rf_idx, rf, acks = cases.refresh(rng, g, P, d, e, NOW)
    jr = _jrefresh(_jstate(st), jnp.asarray(rf_idx),
                   *(jnp.asarray(a) for a in rf),
                   *(jnp.asarray(a) for a in acks),
                   jnp.int32(NOW), jnp.int32(TIMEOUT))
    tr = tq.engine_step_resident(
        _tstate(st), torch.from_numpy(rf_idx),
        *(torch.from_numpy(a) for a in rf),
        *(torch.from_numpy(a) for a in acks), NOW, TIMEOUT)
    _assert_state_equal(jr.state, tr.state)
    np.testing.assert_array_equal(tr.new_commit.numpy(),
                                  np.asarray(jr.new_commit))
    for f in ("commit_changed", "timeouts", "stale"):
        np.testing.assert_array_equal(getattr(tr, f).numpy() != 0,
                                      np.asarray(getattr(jr, f)), err_msg=f)


# negative indices: XLA's scatters count [-n, -1] from the end of each
# dimension and drop only what lies below -n
@pytest.mark.parametrize("e", [64, 1024, 16384])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_step_negative_indices_match_jax(seed, e):
    rng = np.random.default_rng(40 + seed)
    g = 96
    st = cases.resident_state(rng, g, P, NOW)
    ev = cases.fast_events(rng, g, P, e, NOW, negative=True)
    assert (ev[0] < 0).any() and (ev[1] < 0).any()
    _fast_both(st, ev)


@pytest.mark.parametrize("d,e", [(64, 64), (256, 1024)])
@pytest.mark.parametrize("seed", [0, 1])
def test_refresh_step_negative_indices_match_jax(seed, d, e):
    rng = np.random.default_rng(50 + seed)
    g = 128
    st = cases.resident_state(rng, g, P, NOW)
    rf_idx, rf, acks = cases.refresh(rng, g, P, d, e, NOW, negative=True)
    assert (rf_idx < 0).any() and (acks[0] < 0).any()
    jr = _jrefresh(_jstate(st), jnp.asarray(rf_idx),
                   *(jnp.asarray(a) for a in rf),
                   *(jnp.asarray(a) for a in acks),
                   jnp.int32(NOW), jnp.int32(TIMEOUT))
    tr = tq.engine_step_resident(
        _tstate(st), torch.from_numpy(rf_idx),
        *(torch.from_numpy(a) for a in rf),
        *(torch.from_numpy(a) for a in acks), NOW, TIMEOUT)
    _assert_state_equal(jr.state, tr.state)
    np.testing.assert_array_equal(tr.new_commit.numpy(),
                                  np.asarray(jr.new_commit))
    for f in ("commit_changed", "timeouts", "stale"):
        np.testing.assert_array_equal(getattr(tr, f).numpy() != 0,
                                      np.asarray(getattr(jr, f)), err_msg=f)


def test_apply_ack_events_wraps_group_and_peer_by_their_own_extent():
    """G, P = 4, 3: acks at (-1, 0) and (1, -1) land on (3, 0) and (1, 2);
    (-5, 0) and (0, -4) lie below -n and are dropped."""
    g, p = 4, 3
    grp = np.array([-1, 1, -5, 0, -4], np.int32)
    peer = np.array([0, -1, 0, -4, -3], np.int32)
    match = np.array([7, 8, 9, 10, 11], np.int32)
    t = np.array([1, 2, 3, 4, 5], np.int32)
    valid = np.ones(5, bool)
    zeros = np.zeros((g, p), np.int32)
    jm, ja = jax.jit(jq.apply_ack_events)(
        jnp.asarray(zeros), jnp.asarray(zeros), *(jnp.asarray(a) for a in
                                                  (grp, peer, match, t, valid)))
    tm, ta = tq.apply_ack_events(
        torch.zeros((g, p), dtype=torch.int32),
        torch.zeros((g, p), dtype=torch.int32),
        *(torch.from_numpy(a) for a in (grp, peer, match, t, valid)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(tm[3, 0]) == 7 and int(tm[1, 2]) == 8 and int(tm[0, 0]) == 11


@pytest.mark.parametrize("seed", range(4))
def test_tally_matches_jax_and_reference(seed):
    rng = np.random.default_rng(20 + seed)
    g = 256
    args = cases.tally_inputs(rng, g, P)
    jr = _jtally(*(jnp.asarray(a) for a in args))
    tr = tq.tally_votes(*(torch.from_numpy(a) for a in args))
    for f in tq.VoteTally._fields:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    grants, rejects, cur, old, prio, self_prio = args
    for i in range(g):
        want = ref.tally_votes(grants[i].tolist(), rejects[i].tolist(),
                               cur[i].tolist(), old[i].tolist(),
                               prio[i].tolist(), int(self_prio[i]))
        got = (bool(tr.passed[i]), bool(tr.passed_on_timeout[i]),
               bool(tr.rejected[i]))
        assert got == tuple(want), i


def test_device_state_from_numpy_round_trips_dtypes():
    rng = np.random.default_rng(30)
    st = cases.resident_state(rng, 16, P, NOW)
    # from the JAX package's own DeviceState, fetched to the host
    fetched = jax.device_get(_jstate(st))
    t = tq.device_state_from_numpy(fetched, "cpu")
    want = {"match_index": torch.int32, "last_ack_ms": torch.int32,
            "self_mask": torch.bool, "conf_cur": torch.bool,
            "conf_old": torch.bool, "role": torch.int8,
            "flush_index": torch.int32, "commit_index": torch.int32,
            "first_leader_index": torch.int32,
            "election_deadline_ms": torch.int32}
    for name, a, x in zip(tq.DeviceState._fields, st, t):
        assert x.dtype == want[name], name
        np.testing.assert_array_equal(x.numpy(), a)
    # fresh tensors: an in-place kernel never writes through to the mirror
    t.match_index.fill_(7)
    assert (st[0] != 7).any()
    bad = list(st)
    bad[5] = bad[5].astype(np.int32)
    with pytest.raises(TypeError):
        tq.device_state_from_numpy(bad, "cpu")


def test_wrappers_refuse_devices_without_a_kernel():
    st = tq.DeviceState(*(torch.empty(x.shape, dtype=x.dtype, device="meta")
                          for x in _tstate(cases.resident_state(
                              np.random.default_rng(31), 4, P, NOW))))
    ev = torch.zeros((7, 64), dtype=torch.int32, device="meta")
    meta = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tq.engine_step_resident_fast(st, ev, meta)

