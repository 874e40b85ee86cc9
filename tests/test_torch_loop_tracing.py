"""The port's tracing of its host loops (``trace/tracer.py``): the three
waits that tile ``server.replicate``, the loops' units of work, the
pause monitor's loop lag, the collector's pauses, and the window counts
the tracer's snapshot carries, on small in-process TCP clusters on the
CPU; and the ``torch.profiler`` ranges each unit opens while a session
is active and tracing is on (none with tracing off)."""

import asyncio
import contextlib
import gc
import json
import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from ratis_tpu_torch.conf import RaftProperties
from ratis_tpu_torch.metrics import hops
from ratis_tpu_torch.server.pause_monitor import PauseMonitor
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties
from ratis_tpu_torch.trace import export
from ratis_tpu_torch.trace.tracer import (STAGE_APPLY_WAIT, STAGE_COUNTER,
                                          STAGE_GC_PAUSE, STAGE_LOOP_LAG,
                                          STAGE_NAMES, STAGE_QUORUM,
                                          STAGE_REPLICATE, STAGE_SEND_WAIT,
                                          TRACER)

GROUPS = 4
WRITES = 6
SWEEP_S = 1.2  # past the sweep cadence: leadership timeout / 4
UNITS = ("follower.append", "leader.ack_intake", "transport.flush",
         "engine.dispatch", "engine_tick", "gc.pause")


@pytest.fixture
def tracer_off_after():
    yield
    # the process tracer stays on once a server enabled it
    TRACER.configure(enabled=False)


async def _write_on_tcp(trace: bool, collect=None):
    """A 3 x GROUPS TCP cluster writes WRITES a group, the tracer reset
    after bring-up, then idles past an engine sweep (the batched engine
    dispatches on sweeps: commits advance at ack intake); ``collect`` runs
    inside, at the end."""
    # the servers configure the process tracer only if it is off: start
    # from off, whatever an earlier test in this process left behind
    TRACER.configure(enabled=False)
    p = cluster_properties(GROUPS, 3, "cpu", "tcp", trace=trace,
                           trace_sample=1)
    cluster = Cluster(GROUPS, 3, device="cpu", transport="tcp",
                      properties=p)
    try:
        await cluster.start(timeout=60)
        with _no_collection():
            TRACER.reset()
            before = hops.snapshot()
        stats = await cluster.write_all(WRITES)
        assert stats["commits"] == GROUPS * WRITES
        await asyncio.sleep(SWEEP_S)
        if collect is not None:
            collect()
        with _no_collection():
            return before, TRACER.snapshot(), hops.snapshot()
    finally:
        await cluster.close()


@contextlib.contextmanager
def _no_collection():
    """No automatic collection in the block (its time would count)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@pytest.fixture(scope="module")
def traced_run():
    """(hops at the reset, snapshot, hops at the snapshot) of one traced
    TCP run."""
    try:
        return asyncio.run(_write_on_tcp(True))
    finally:
        TRACER.configure(enabled=False)


def _by_trace(records, stage):
    return {r[0]: r for r in records if r[1] == stage and r[0]}


def test_replicate_waits_tile_each_replicate_span(traced_run):
    _, records, _ = traced_run
    replicate = _by_trace(records, STAGE_REPLICATE)
    waits = [_by_trace(records, s)
             for s in (STAGE_SEND_WAIT, STAGE_QUORUM, STAGE_APPLY_WAIT)]
    # every write is traced (sample 1), and each leader applies its own
    assert len(replicate) >= GROUPS * WRITES
    for tid, (_, _, t0, dur, _, _) in replicate.items():
        send, quorum, apply = (w[tid] for w in waits)
        # in order, end to end, and summing to the span within 1 us
        assert send[2] == t0
        assert send[2] + send[3] == quorum[2]
        assert quorum[2] + quorum[3] == apply[2]
        assert apply[2] + apply[3] == t0 + dur
        assert min(send[3], quorum[3], apply[3]) >= 0
        assert abs(send[3] + quorum[3] + apply[3] - dur) <= 1000
    # a commit needs a follower's ack: the quorum wait is never empty
    assert all(q[3] > 0 for q in waits[1].values())


def test_replicate_waits_stay_out_of_the_coverage(traced_run):
    _, records, _ = traced_run
    waits = {STAGE_SEND_WAIT, STAGE_QUORUM, STAGE_APPLY_WAIT}
    table = export.host_path_decomposition(records)
    without = export.host_path_decomposition(
        [r for r in records if r[1] not in waits])
    assert table["coverage"] == without["coverage"]
    assert table["covered_ms_total"] == without["covered_ms_total"]
    for s in waits:
        assert table["stages"][STAGE_NAMES[s]]["overlap"]


@pytest.mark.parametrize("site", hops.HOP_SITES)
def test_snapshot_counts_are_the_hops_since_reset(traced_run, site):
    before, records, after = traced_run
    counts = {hops.HOP_SITES[r[5]]: r for r in records
              if r[1] == STAGE_COUNTER}
    assert set(counts) == set(hops.HOP_SITES)
    tid, _, _, dur, tag, _ = counts[site]
    assert tid == 0 and dur == 0
    # the counts since the reset after bring-up
    assert tag == after[site] - before[site]
    if site in ("transport_flush", "transport_frame", "reply_batch"):
        assert tag > 0
    assert export.host_path_decomposition(records)["counters"][site] == tag


def test_a_hops_reset_after_the_tracer_reset_starts_the_counts_anew(
        tracer_off_after):
    TRACER.configure(enabled=True)
    hops.hop("transport_flush", 7)
    TRACER.reset()
    hops.hop("reply_batch", 3)
    hops.reset()  # as a bench rung does after the tracer's reset
    hops.hop("transport_flush", 2)
    hops.hop("sender_wake")
    counts = {hops.HOP_SITES[r[5]]: r[4] for r in TRACER.snapshot()
              if r[1] == STAGE_COUNTER and hops.HOP_SITES[r[5]] != "gc_ns"}
    assert counts == {s: {"transport_flush": 2, "sender_wake": 1}.get(s, 0)
                      for s in hops.HOP_SITES if s != "gc_ns"}


def test_new_count_sites_leave_the_reply_plane_alone():
    assert hops.REPLY_SITES == ("reply_future", "reply_window",
                                "reply_send", "reply_flush")
    assert set(hops.REPLY_SITES) <= set(hops.SCHEDULING_SITES)
    reply, total = hops.reply_plane_hops(), hops.total_hops()
    hops.hop("transport_flush")
    hops.hop("transport_frame", 5)
    hops.hop("gc_ns", 10 ** 6)
    assert hops.reply_plane_hops() == reply
    assert hops.total_hops() == total


def test_the_units_of_the_loops_record_spans(traced_run):
    _, records, _ = traced_run
    units = {STAGE_NAMES[r[1]]: r for r in records if r[1] != STAGE_COUNTER
             and r[0] == 0 and r[3] > 0}
    for name in ("follower.append", "leader.ack_intake",
                 "transport.flush", "engine.dispatch"):
        assert name in units, sorted(units)
        assert units[name][4] >= 0


def test_a_forced_full_collection_is_one_gc_pause(tracer_off_after):
    TRACER.configure(enabled=True)
    TRACER.reset()
    gc.collect(2)
    records = TRACER.snapshot()
    full = [r for r in records if r[1] == STAGE_GC_PAUSE and r[4] == 2]
    assert len(full) == 1 and full[0][3] > 0
    gc_ns = next(r[4] for r in records if r[1] == STAGE_COUNTER
                 and hops.HOP_SITES[r[5]] == "gc_ns")
    assert gc_ns >= full[0][3]


def test_the_collector_hook_leaves_with_the_tracer(tracer_off_after):
    TRACER.configure(enabled=True)
    TRACER.configure(enabled=True)
    assert gc.callbacks.count(TRACER._on_gc) == 1
    TRACER.configure(enabled=False)
    assert TRACER._on_gc not in gc.callbacks
    before = hops.snapshot()["gc_ns"]
    gc.collect()
    assert hops.snapshot()["gc_ns"] == before


def test_a_blocked_loop_is_a_loop_lag_span(tracer_off_after):
    TRACER.configure(enabled=True)
    server = types.SimpleNamespace(properties=RaftProperties(),
                                   peer_id="lag-probe", divisions={})
    block_s = 0.3

    async def body():
        monitor = PauseMonitor(server, interval_s=0.02, warn_s=10.0)
        monitor.start()
        await asyncio.sleep(0.1)
        TRACER.reset()
        t_end = time.monotonic() + block_s
        while time.monotonic() < t_end:  # busy: the CPU tag sees it
            pass
        await asyncio.sleep(0.1)
        await monitor.close()

    asyncio.run(body())
    lags = [r for r in TRACER.snapshot() if r[1] == STAGE_LOOP_LAG]
    assert len(lags) >= 3
    worst = max(lags, key=lambda r: r[3])
    assert 0.8 * block_s <= worst[3] / 1e9 <= block_s + 0.5
    # its tag: the process CPU since the wake before, the busy block in it
    # (a share of it on a loaded host)
    assert worst[4] >= 0.25 * block_s * 1e6


@pytest.mark.parametrize("trace", [True, False])
def test_profiler_ranges_name_the_loops_units(tmp_path, tracer_off_after,
                                              trace):
    session = profile(activities=[ProfilerActivity.CPU])
    session.start()
    try:
        run = asyncio.run(_write_on_tcp(trace,
                                        collect=lambda: gc.collect(1)))
    finally:
        session.stop()
    path = tmp_path / "trace.json"
    session.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") in UNITS]
    found = {e["name"]: e.get("cat") for e in events}
    if trace:
        assert found == {name: "user_annotation" for name in UNITS}
    else:
        assert found == {}
        before, _, after = run
        # the flush counts are the traced run's alone
        assert after["transport_flush"] == before["transport_flush"]
        assert after["transport_frame"] == before["transport_frame"]
    # a unit holds no await that parks: on each thread the ranges nest,
    # and none outlives a range that opened inside it
    by_thread: dict = {}
    for e in events:
        by_thread.setdefault(e["tid"], []).append(
            (e["ts"], e["ts"] + e["dur"], e["name"]))
    for spans in by_thread.values():
        spans.sort(key=lambda x: (x[0], -x[1]))
        open_ends: list = []
        for t0, t1, name in spans:
            while open_ends and open_ends[-1][0] <= t0:
                open_ends.pop()
            assert not open_ends or t1 <= open_ends[-1][0], (
                name, "interleaves with", open_ends[-1][1])
            open_ends.append((t1, name))


def test_counter_records_are_chrome_counter_events():
    records = [(0, STAGE_COUNTER, 5_000, 0, 7, 0),
               (3, STAGE_REPLICATE, 1_000, 2_000, 0, 0)]
    events = export.to_chrome_trace(records)["traceEvents"]
    assert events[0]["ph"] == "C"
    assert events[0]["name"] == hops.HOP_SITES[0]
    assert events[0]["args"] == {hops.HOP_SITES[0]: 7}
    assert events[1]["ph"] == "X" and events[1]["name"] == "server.replicate"
