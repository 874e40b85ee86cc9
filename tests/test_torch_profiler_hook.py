"""The engine's profiler hook (``raft.tpu.engine.profile-dir``) on the port,
as ``tests/test_profiler_hook.py`` holds the JAX engine's: the first
profiled engine of the process owns one ``torch.profiler`` session (CPU
activity; CUDA too on a card: ``tests/test_torch_cuda.py``), wraps each
of its ticks in an ``engine_tick`` range, and at close writes a Chrome
trace into the directory and releases ownership.  Co-hosted engines start
no session of their own; a second profiled cluster in the same process
takes ownership afresh and writes a trace of its own; an engine that finds
another session already active in the process (``tools/
profile_main_path.py`` holds one) takes no ownership and leaves that
session running.
"""

import asyncio
import json

import torch

from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.engine.engine import QuorumEngine
from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

GROUPS = 4


def _profiled(trace_dir) -> Cluster:
    p = cluster_properties(GROUPS, 3, "cpu", "sim")
    p.set(RaftServerConfigKeys.Engine.PROFILE_DIR_KEY, str(trace_dir))
    return Cluster(GROUPS, 3, device="cpu", properties=p)


async def _run(cluster) -> dict:
    try:
        await cluster.start(timeout=60)
        owner = QuorumEngine._profiling_owner
        owners = [s.engine is owner for s in cluster.servers]
        sessions = [s.engine._profiler is not None for s in cluster.servers]
        stats = await cluster.write_all(2)
        await asyncio.sleep(0.2)  # a few ticks inside the trace
        return {"owners": owners, "sessions": sessions,
                "commits": stats["commits"]}
    finally:
        await cluster.close()


def _events(path) -> list:
    return json.loads(path.read_text())["traceEvents"]


def test_profile_dir_produces_a_torch_trace(tmp_path):
    trace_dir = tmp_path / "prof"
    cluster = _profiled(trace_dir)
    res = asyncio.run(_run(cluster))
    assert res["commits"] == GROUPS * 2
    # one owner: the first server's engine started the session
    assert res["owners"] == [True, False, False]
    assert res["sessions"] == [True, False, False]
    assert QuorumEngine._profiling_owner is None, "ownership not released"
    assert all(s.engine._profiler is None for s in cluster.servers)
    traces = sorted(trace_dir.iterdir())
    assert len(traces) == 1
    assert str(traces[0]) == cluster.servers[0].engine.trace_file
    names = [e.get("name") for e in _events(traces[0])]
    assert names.count("engine_tick") > 0


def test_a_second_profiled_cluster_in_the_process_works(tmp_path):
    trace_dir = tmp_path / "prof"
    for _ in range(2):
        res = asyncio.run(_run(_profiled(trace_dir)))
        assert res["owners"] == [True, False, False]
        assert QuorumEngine._profiling_owner is None
    traces = sorted(trace_dir.iterdir())
    assert len(traces) == 2
    for t in traces:
        assert any(e.get("name") == "engine_tick" for e in _events(t)), t


def test_no_ownership_inside_another_session(tmp_path):
    trace_dir = tmp_path / "prof"
    from torch.profiler import ProfilerActivity, profile
    outer = profile(activities=[ProfilerActivity.CPU])
    outer.start()
    try:
        res = asyncio.run(_run(_profiled(trace_dir)))
        # the engine refused to start a session over the active one
        assert res["owners"] == [False, False, False]
        assert res["sessions"] == [False, False, False]
        assert torch.autograd.profiler._is_profiler_enabled
    finally:
        outer.stop()
    assert not trace_dir.exists() or not any(trace_dir.iterdir())
    assert QuorumEngine._profiling_owner is None


def test_an_unprofiled_cluster_starts_no_session():
    cluster = Cluster(GROUPS, 3, device="cpu")
    res = asyncio.run(_run(cluster))
    assert res["sessions"] == [False, False, False]
    assert all(s.engine.trace_file is None for s in cluster.servers)
