"""The host side of K7a's, K7b's, K7c's and the public K3's launches, on
the CPU: the rows a block of K7a's design (a) owns, K7a's choice between
its two designs, its one output buffer, the peer slots a lane of a row of
8 lanes holds (K7b, K7c, K3 public), the blocks of K7b's and K3's rows of
8 lanes, the wrappers' cached specs and their one-pass checks.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``);
these functions decide what each launch gets, so an error in them would
show there only at some shapes.
"""

import numpy as np
import pytest
import torch

from ratis_tpu_torch.ops import quorum as tq
from ratis_tpu_torch.tools import cases

ROWS = (1, 2, 15, 16, 17, 1001, 1023, 1024, 4096, 4097, 10240, 102400)


@pytest.mark.parametrize("g", ROWS)
def test_block_rows_cover_every_row_in_about_vote_blocks(g):
    rows = tq.vote_block_rows(g)
    blocks = -(-g // rows)
    # a multiple of 16, so a block's bytes of either mask start 16-byte
    # aligned, and the fewest such rows that keep to VOTE_BLOCKS blocks
    assert rows % tq.VOTE_ROW_ALIGN == 0 and rows > 0
    assert blocks * rows >= g and blocks <= tq.VOTE_BLOCKS
    assert rows == tq.VOTE_ROW_ALIGN or \
        -(-g // (rows - tq.VOTE_ROW_ALIGN)) > tq.VOTE_BLOCKS


@pytest.mark.parametrize("g", ROWS)
@pytest.mark.parametrize("p", (3, 8, 16))
def test_vote_design_follows_the_event_count(g, p):
    """Design (a) exactly up to VOTE_ROWS_MAX_EVENTS events, at any G;
    the peer count never changes it."""
    cap = tq.VOTE_ROWS_MAX_EVENTS
    for e in (0, 1, g // 4, g, 2 * g, cap, cap + 1, 204800):
        want = tq.vote_block_rows(g) if e <= cap else 0
        assert tq.vote_rows(g, p, e) == want == tq.vote_rows(g, 8, e)


@pytest.mark.parametrize("g,e,design", [
    (1024, 256, "rows"), (1024, 2048, "rows"), (10240, 20480, "grid"),
    (102400, 204800, "grid"), (1024, 8192, "grid"), (4096, 4096, "rows"),
    (4096, 8192, "grid"), (102400, 1024, "rows"), (102400, 4096, "rows"),
    (1, 0, "rows"), (1, 2, "rows")])
def test_vote_design_at_the_timed_shapes(g, e, design):
    """The design each shape of ``tools/fast_tick_timing.py`` takes:
    the faster of the two there on an H100 (PERF.md, PR 8)."""
    assert (tq.vote_rows(g, 8, e) > 0) == (design == "rows")


@pytest.mark.parametrize("g", ROWS)
@pytest.mark.parametrize("p", (3, 5, 7, 8, 16))
def test_vote_buffer_holds_both_masks_apart_and_aligned(g, p):
    specs, off, size = tq._vote_specs(g, p, 4)
    assert off % 16 == 0 and g * p <= off < g * p + 16
    assert size == off + g * p
    assert [s for _, s in specs] == [(g, p)] * 2 + [(4,)] * 4
    assert [d for d, _ in specs] == [torch.bool] * 2 + [torch.int32] * 2 \
        + [torch.bool] * 2
    # the views the wrapper takes: contiguous, [G, P], disjoint
    buf = torch.zeros(size, dtype=torch.bool)
    grants = buf.as_strided((g, p), (p, 1), 0)
    rejects = buf.as_strided((g, p), (p, 1), off)
    assert grants.is_contiguous() and rejects.is_contiguous()
    rejects.fill_(True)
    assert not grants.any() and int(buf.sum()) == g * p


@pytest.mark.parametrize("p", range(1, 17))
def test_lease_slots_hold_every_peer_slot(p):
    """K7c's rows of 8 lanes hold every peer slot: one a lane up to 8,
    two from 9."""
    slots = tq.lease_slots(p)
    assert slots in (1, 2) and 8 * slots >= p and (slots == 1) == (p <= 8)


def test_lease_specs():
    assert tq._lease_specs(5, 3) == ((torch.int32, (5, 3)),
                                     (torch.bool, (5, 3)),
                                     (torch.bool, (5, 3)),
                                     (torch.bool, (5, 3)))


def _votes(g=8, p=3, e=6):
    return [torch.from_numpy(a) for a in
            cases.vote_events(np.random.default_rng(1), g, p, e)]


@pytest.mark.parametrize("which,bad,err", [
    (0, lambda t: t.to(torch.uint8), TypeError),
    (3, lambda t: t[:-1], ValueError),
    (1, lambda t: t.t().contiguous().t(), ValueError),
    (4, lambda t: t.to(torch.int32), TypeError)])
def test_one_pass_checks_name_the_argument_at_fault(which, bad, err):
    """``_check_all``, the wrappers' one-pass check, raises what the
    per-argument checks raised: a wrong dtype, shape or layout."""
    args = _votes()
    specs, _, _ = tq._vote_specs(8, 3, 6)
    tq._check_all(args, specs, torch.device("cpu"))  # all good
    args[which] = bad(args[which])
    with pytest.raises(err):
        tq._check_all(args, specs, torch.device("cpu"))


def test_one_pass_checks_refuse_mixed_devices():
    args = _votes()
    args[2] = args[2].to("meta")
    specs, _, _ = tq._vote_specs(8, 3, 6)
    with pytest.raises(ValueError, match="arguments on"):
        tq._check_all(args, specs, torch.device("cpu"))
    with pytest.raises(ValueError, match="arguments on"):
        tq.apply_vote_events(*args)
    lease = [torch.from_numpy(a) for a in
             cases.lease_inputs(np.random.default_rng(2), 8, 3)]
    lease[1] = lease[1].to("meta")
    with pytest.raises(ValueError, match="arguments on"):
        tq.lease_expiry(*lease, 1000)


@pytest.mark.parametrize("g", (0, 1, 2, 3, 4, 31, 32, 33, 1001, 1023, 1024,
                               10240, 102400))
def test_lane_blocks_cover_every_row(g):
    """K7b's and the public K3's grid: rows of ROW_LANES lanes, so every
    row lies in a block, and no block is without a row."""
    blocks = tq.lane_blocks(g)
    lanes = g * tq.ROW_LANES
    assert blocks * tq.KERNEL_THREADS >= lanes
    assert blocks == 0 or (blocks - 1) * tq.KERNEL_THREADS < lanes
    # the last row's 8 lanes lie in the last block
    if g:
        assert (g - 1) * tq.ROW_LANES // tq.KERNEL_THREADS == blocks - 1


@pytest.mark.parametrize("g,blocks", [(1, 1), (1001, 32), (1023, 32),
                                      (1024, 32), (102400, 3200)])
def test_lane_blocks_at_the_timed_shapes(g, blocks):
    assert tq.lane_blocks(g) == blocks


@pytest.mark.parametrize("p", range(1, 17))
def test_lane_slots_hold_every_peer_slot_of_a_row(p):
    """The slots lane l of a row holds (l, and l + 8 where it holds two)
    are every slot 0..P-1 once, and slots past P only in the last lanes."""
    slots = tq.lease_slots(p)
    held = sorted(lane + tq.ROW_LANES * s for lane in range(tq.ROW_LANES)
                  for s in range(slots))
    assert held == list(range(tq.ROW_LANES * slots))
    assert [h for h in held if h < p] == list(range(p))


def test_replicated_and_tally_specs():
    gp, g = torch.Size((5, 3)), torch.Size((5,))
    assert tq._replicated_specs(5, 3) == (
        (torch.int32, gp), (torch.bool, gp), (torch.int32, g),
        (torch.bool, gp), (torch.bool, gp))
    assert tq._tally_specs(5, 3) == ((torch.bool, gp),) * 4 + (
        (torch.int32, gp), (torch.int32, g))


@pytest.mark.parametrize("specs", ["_replicated_specs", "_tally_specs",
                                   "_lease_specs"])
def test_specs_are_cached(specs):
    fn = getattr(tq, specs)
    first = fn(1001, 9)
    hits = fn.cache_info().hits
    assert fn(1001, 9) is first and fn.cache_info().hits == hits + 1


def _wrapper_args(which):
    rng = np.random.default_rng(3)
    if which == "replicated":
        arrays = cases.replicated_inputs(rng, 8, 3)
        return [torch.from_numpy(a) for a in arrays], tq._replicated_specs(
            8, 3), tq.all_replicated_min
    arrays = cases.tally_inputs(rng, 8, 3)
    return [torch.from_numpy(a) for a in arrays], tq._tally_specs(8, 3), \
        tq.tally_votes_packed


# (wrapper, its number of arrays, the positions of its [G] arrays)
_ARRAYS = {"replicated": (5, (2,)), "tally": (6, (5,))}
_FAULTS = [(which, at, fault) for which, (n, rows) in _ARRAYS.items()
           for at in range(n) for fault in ("dtype", "shape", "layout")
           if fault != "layout" or at not in rows]


@pytest.mark.parametrize("which,at,fault", _FAULTS)
def test_one_pass_checks_of_k7b_and_k3_name_the_argument(which, at, fault):
    """A wrong dtype, shape or (for a [G, P] array) layout in any argument
    raises with that argument's position."""
    args, specs, _ = _wrapper_args(which)
    tq._check_all(args, specs, torch.device("cpu"))  # all good
    t = args[at]
    args[at], err = {"dtype": (t.to(torch.uint8), TypeError),
                     "shape": (t[:-1], ValueError),
                     "layout": (t.t().contiguous().t(), ValueError)}[fault]
    with pytest.raises(err, match=f"argument {at}:"):
        tq._check_all(args, specs, torch.device("cpu"))


@pytest.mark.parametrize("which", ["replicated", "tally"])
@pytest.mark.parametrize("at", [0, 1, 2, 4])
def test_k7b_and_k3_wrappers_refuse_mixed_devices(which, at):
    args, specs, wrapper = _wrapper_args(which)
    args[at] = args[at].to("meta")
    with pytest.raises(ValueError, match="arguments on"):
        tq._check_all(args, specs, torch.device("cpu"))
    with pytest.raises(ValueError, match="arguments on"):
        wrapper(*args)


@pytest.mark.parametrize("g", ROWS + (0, 20480, 24575, 24576, 40960))
def test_tally_blocks_cover_every_row_by_either_design(g):
    """The public K3's grid by its rule and by each design: rows of 8
    lanes (32 rows a block of KERNEL_THREADS) or tiles of TALLY_TILE rows;
    every row in a block, no block without a row."""
    rule = tq.tally_tile(g)
    assert rule == (tq.TALLY_TILE if g >= tq.TALLY_TILE_FROM else 0)
    for tile in (0, tq.TALLY_TILE):
        rows = tile or tq.KERNEL_THREADS // tq.ROW_LANES
        blocks = tq.tally_blocks(g, tile)
        assert blocks * rows >= g and (blocks == 0 or (blocks - 1) * rows
                                       < g)
    assert tq.tally_blocks(g, 0) == tq.lane_blocks(g)


@pytest.mark.parametrize("g,design", [
    (1, "lanes"), (1024, "lanes"), (10240, "lanes"), (20480, "lanes"),
    (40960, "tile"), (102400, "tile")])
def test_tally_design_at_the_timed_shapes(g, design):
    """The design each shape of ``tools/fast_tick_timing.py`` takes: the
    faster of the two there on an H100 (PERF.md; a tie at 20480)."""
    assert (tq.tally_tile(g) > 0) == (design == "tile")
