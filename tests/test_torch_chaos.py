"""The chaos campaign, the port against the JAX package.

The port's ``chaos/cluster.py``, ``chaos/campaign.py`` and
``tools/chaos_replay.py`` are changed copies: the engines' device reaches
every server through ``chaos_properties(device=...)`` (the servers a
crash rebuilds take the same properties), the 1024-group shape takes the
port harness's ``cluster_properties`` (the JAX bench's
``bench_properties`` key for key), and the replay tool takes
``--device``.  Here:

- ``build_scenario`` gives the same steps in both packages for every
  scenario name at 3 seeds, on the small and on the 1024-group campaign
  config;
- ``partition_leader`` and ``crash_restart_leader`` on a 3 x 8
  ``ChaosCluster`` per package, ``rebalance_storm`` on the port's (its
  JAX run on this seed and config is ``tests/test_placement.py``'s): each
  passes its SLOs, with one injected-fault event per scenario step (the
  steps equal across packages), every engine on the CPU, the servers a
  crash rebuilds too;
- the JAX package's mesh campaign subset (``partition_leader``,
  ``crash_restart_leader`` with ``mesh-devices=2``) on the port, its fast
  ticks through K5's plain version;
- the port's ``chaos_replay`` replays an artifact the port recorded with
  ``--device cpu`` and refuses one whose schedule drifted;
- ``chaos_properties`` equals the JAX package's key for key apart from the
  device key, at 1, 8 and 1024 groups;
- a follower append cancelled while it waits for its flush (its RPC
  deadline ran out behind a slow fsync) keeps the flush the worker still
  performs, on the shared and the per-group durable log: the port's
  ``flush_index`` reaches the entry, where the JAX reference's stays one
  behind for good (``shared_log_tail_loss`` at 3 x 1024 on 9p stalled
  there: the last entry of a few groups never counted as flushed).
"""

import asyncio
import importlib
import json
import pathlib
import subprocess
import sys

import pytest

from ratis_tpu.chaos import cluster as jax_cluster
from ratis_tpu.chaos import scenarios as jax_scenarios
from ratis_tpu.chaos.scenario import run_scenario as jax_run_scenario
from ratis_tpu_torch.chaos import cluster as port_cluster
from ratis_tpu_torch.chaos import scenarios as port_scenarios
from ratis_tpu_torch.chaos.campaign import DEFAULT_CAMPAIGN, DURABLE_EXTRA
from ratis_tpu_torch.chaos.scenario import run_scenario, write_artifact
from ratis_tpu_torch.conf import RaftServerConfigKeys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"servers": 3, "groups": 8, "writers": 4, "active_groups": 8,
         "sm": "counter", "convergence_s": 30.0, "recovery_s": 60.0,
         "min_acked": 20}
# run_chaos_1024's config (chaos/campaign.py)
CAMPAIGN_1024 = {"servers": 3, "groups": 1024, "sm": "counter",
                 "transport": "sim", "writers": 4, "durable": True,
                 "active_groups": 64, "convergence_s": 120.0,
                 "recovery_s": 240.0, "min_acked": 50,
                 "recovery_window_s": 8.0, "hold_scale": 6.0}
DEVICE_KEY = RaftServerConfigKeys.Engine.DEVICE_KEY
PACKAGES = {"port": (port_cluster, port_scenarios, run_scenario),
            "jax": (jax_cluster, jax_scenarios, jax_run_scenario)}


def test_every_scenario_builds_the_same_steps():
    names = port_scenarios.scenario_names()
    assert names == jax_scenarios.scenario_names()
    assert set(DEFAULT_CAMPAIGN + DURABLE_EXTRA) <= set(names)
    for name in names:
        for seed in (0, 1, 23):
            for cfg in (SMALL, CAMPAIGN_1024):
                port = port_scenarios.build_scenario(name, seed, cfg)
                jax = jax_scenarios.build_scenario(name, seed, cfg)
                assert port.to_json() == jax.to_json(), (name, seed)
                assert port.steps, (name, seed)


async def _scenario(pkg: str, name: str) -> dict:
    """``name`` on a 3 x 8 counter cluster of package ``pkg`` (seed 7;
    the port's engines on the CPU)."""
    cluster_mod, scenarios_mod, run = PACKAGES[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    cluster = cluster_mod.ChaosCluster(
        3, 8, properties=cluster_mod.chaos_properties(8, seed=7, **kw),
        sm="counter", seed=7)
    await cluster.start()
    try:
        result = await run(cluster,
                           scenarios_mod.build_scenario(name, 7, SMALL))
        # the port's engines, the servers a crash rebuilt included
        devices = sorted({str(s.engine.device)
                          for s in cluster.servers.values()}) \
            if pkg == "port" else None
        return {"passed": result.passed, "error": result.error,
                "acked": result.acked, "checks": result.checks,
                "faults": sum(1 for e in result.journal
                              if e["kind"] == "injected-fault"),
                "devices": devices}
    finally:
        await cluster.close()


@pytest.mark.chaos
@pytest.mark.parametrize("name", ["partition_leader", "crash_restart_leader",
                                  "rebalance_storm"])
def test_scenario_passes_in_both_packages(name):
    runs = {"port": asyncio.run(_scenario("port", name))}
    # rebalance_storm's JAX half on this seed and config is
    # tests/test_placement.py::test_rebalance_storm_scenario; a second
    # JAX run here only doubled the wall-clock windows' exposure to a
    # loaded host (its first ledger samples compile for seconds there)
    if name != "rebalance_storm":
        runs["jax"] = asyncio.run(_scenario("jax", name))
    for which, run in runs.items():
        assert run["passed"], (which, run["error"])
        assert run["acked"] > SMALL["min_acked"], which
        assert run["checks"]["lost_ack_groups"] == 0, which
        assert run["checks"]["diverged_groups"] == 0, which
        if name == "rebalance_storm":
            assert run["checks"]["rebalance_events"] >= 1, which
            assert run["checks"]["rebalance_done"] \
                >= run["checks"]["rebalance_events"], which
    # one injected-fault event per step, the steps equal in both packages
    # (test_every_scenario_builds_the_same_steps)
    steps = port_scenarios.build_scenario(name, 7, dict(SMALL)).steps
    assert {w: r["faults"] for w, r in runs.items()} == \
        {w: len(steps) for w in runs}
    assert len(steps) > 0
    assert runs["port"]["devices"] == ["cpu"]


@pytest.mark.chaos
def test_chaos_campaign_subset_mesh():
    """The JAX package's mesh gate on the port: two slices per engine,
    divisions pinned to their slices, the counter oracle exactly once."""

    async def main():
        p = port_cluster.chaos_properties(8, seed=19, device="cpu")
        p.set("raft.tpu.engine.mesh-devices", "2")
        p.set("raft.tpu.engine.scalar-fallback-threshold", "0")
        cluster = port_cluster.ChaosCluster(3, 8, properties=p,
                                            sm="counter", seed=19)
        await cluster.start()
        try:
            for s in cluster.servers.values():
                assert s.engine.mesh is not None
                assert s.engine.state.n_slices == 2
            cfg = dict(SMALL)
            for name in ("partition_leader", "crash_restart_leader"):
                scenario = port_scenarios.build_scenario(name, 19, cfg)
                result = await run_scenario(cluster, scenario)
                assert result.passed, (name, result.error, result.journal)
            for s in cluster.servers.values():
                assert s.engine.metrics["fast_ticks"] > 0
                assert s.engine.state.n_slices == 2
                assert s.engine.device.type == "cpu"
        finally:
            await cluster.close()

    asyncio.run(main())


def _replay(*args):
    return subprocess.run([sys.executable, "-m",
                           "ratis_tpu_torch.tools.chaos_replay", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=240)


@pytest.mark.chaos
def test_replay_of_a_port_artifact(tmp_path):
    cfg = {"servers": 3, "groups": 1, "writers": 3, "active_groups": 1,
           "convergence_s": 30.0, "recovery_s": 60.0}

    async def record():
        scenario = port_scenarios.build_scenario("crash_restart_follower",
                                                 5, cfg)
        cluster = port_cluster.ChaosCluster(
            3, 1, properties=port_cluster.chaos_properties(1, seed=5,
                                                           device="cpu"),
            seed=5)
        await cluster.start()
        try:
            result = await run_scenario(cluster, scenario)
        finally:
            await cluster.close()
        assert result.passed, result.error
        return write_artifact(result, scenario, tmp_path)

    path = asyncio.run(record())
    proc = _replay(str(path), "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "schedule matches artifact" in proc.stdout
    assert "replayed: passed=True" in proc.stdout
    # without a card the default device is refused, never replaced
    if not __import__("torch").cuda.is_available():
        proc = _replay(str(path))
        assert proc.returncode != 0
        assert "replayed:" not in proc.stdout
    # a drifted schedule: the replay refuses to run
    artifact = json.loads(path.read_text())
    artifact["scenario"]["steps"][0]["at_s"] += 0.5
    drifted = tmp_path / "drifted.json"
    drifted.write_text(json.dumps(artifact))
    proc = _replay(str(drifted), "--device", "cpu")
    assert proc.returncode != 0
    assert "schedule drift" in proc.stderr
    assert "replayed:" not in proc.stdout


@pytest.mark.parametrize("groups", [1, 8, 1024])
def test_chaos_properties_are_the_jax_package_s(groups):
    port = dict(port_cluster.chaos_properties(groups, seed=3,
                                              device="cpu").items())
    jax = dict(jax_cluster.chaos_properties(groups, seed=3).items())
    assert port.pop(DEVICE_KEY) == "cpu"
    assert port == jax
    assert dict(port_cluster.chaos_properties(groups).items())[DEVICE_KEY] \
        == "cuda"


async def _cancelled_follower_append(pkg: str, kind: str, tmp) -> tuple:
    """Append entry 0, then entry 1 through the follower path under a
    10 ms deadline while every flush takes 300 ms; wait until the worker
    has written and synced entry 1's batch (its flush count, the wait
    bounded at 30 s: how long the sync takes is the disk's) and its
    callbacks have run; the log's (next index, flush index)."""
    seg = importlib.import_module(f"{pkg}.server.log.segmented")
    shared = importlib.import_module(f"{pkg}.server.log.shared")
    injection = importlib.import_module(f"{pkg}.util.injection")
    logentry = importlib.import_module(f"{pkg}.protocol.logentry")
    ids = importlib.import_module(f"{pkg}.protocol.ids")
    worker = seg.LogWorker(f"{pkg}-w")
    if kind == "shared":
        log = shared.SharedGroupLog("g", b"A" * 16, shared.SharedLogStore(
            tmp, worker, name=f"{pkg}-s"))
    else:
        log = seg.SegmentedRaftLog("g", tmp / "current", worker=worker)
    await log.open()
    flushes = worker.registry_metrics.flush_count

    def entry(i):
        return logentry.make_transaction_entry(1, i, ids.ClientId.random_id(),
                                               i, b"x")

    async def slow_sync(*_):
        await asyncio.sleep(0.3)
    await log.append_entries_follower([entry(0)])
    synced = flushes.count
    injection.put(injection.LOG_SYNC, slow_sync)
    try:
        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(log.append_entries_follower([entry(1)]),
                                   0.01)
        deadline = asyncio.get_running_loop().time() + 30.0
        while flushes.count == synced \
                and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.05)
    finally:
        injection.remove(injection.LOG_SYNC)
    out = (log.next_index, log.flush_index)
    await log.close()
    return out


@pytest.mark.parametrize("kind", ["shared", "segmented"])
def test_cancelled_follower_append_keeps_its_flush(tmp_path, kind):
    got = {}
    for pkg in ("ratis_tpu_torch", "ratis_tpu"):
        (tmp_path / pkg).mkdir()
        got[pkg] = asyncio.run(_cancelled_follower_append(pkg, kind,
                                                          tmp_path / pkg))
    assert got["ratis_tpu_torch"] == (2, 1)
    # the reference drops it: its flush index stays one behind
    assert got["ratis_tpu"] == (2, 0)
