"""The scalar controls and the rest of the JAX bench ladder, the port
against the JAX package.

- ``cluster_properties(batched=False)`` is the JAX bench's
  ``bench_properties(batched=False)`` key for key (plus the port's engine
  device) at every timeout tier, over the simulated transport and TCP, at
  3 and 5 servers, hibernation asked for or not (the scalar deployment
  never hibernates);
- a 3 x 16 scalar cluster over the simulated transport on the port's
  harness and on the JAX package (the harness renamed,
  ``tests/jax_mirror.py``): equal counters, every one read back from all
  three replicas, and in both packages no engine makes a fast or a
  refresh tick after its prewarm (the scalar path never dispatches);
- ``e2e_rung`` with a window depth in ``props`` reports every key the JAX
  harness's ``run_bench`` reports at the same load, and the window keys
  are computed as ``run_bench`` computes them;
- the new rungs tiny through ``tools/bench.py --device cpu``: the scalar
  headline, the window sweep, the sim ladder and the upkeep dip pair
  (their shapes the JAX children's), and ``bench.py``'s upkeep triple
  from the three rungs' lines;
- the harness clients' retry budgets: attempts for the batched
  deployment, the JAX harness's wall-clock write budget for the scalar
  control;
- the retry cache: an entry ages from its reply, a write held past the
  expiry is applied once by the port (twice by the JAX package), and a
  leader stepping down with a write pending fails its entry, after which
  the client's retry succeeds.
"""

import asyncio
import json
import pathlib
import subprocess
import sys

import pytest

from ratis_tpu.tools.bench_cluster import bench_properties, run_bench
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.tools import bench
from ratis_tpu_torch.tools.cluster import (Cluster, cluster_properties,
                                           is_batched)

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUPS = 16
WRITES = 3


# channel counts below and at each timeout tier
@pytest.mark.parametrize("groups", [16, 1024, 2048, 8192, 10240])
@pytest.mark.parametrize("transport,servers",
                         [("sim", 3), ("tcp", 3), ("tcp", 5)])
@pytest.mark.parametrize("hibernate", [False, True])
def test_scalar_properties_are_the_jax_bench_properties(groups, transport,
                                                        servers, hibernate):
    port = dict(cluster_properties(groups, servers, "cuda", transport,
                                   hibernate=hibernate,
                                   batched=False).items())
    jax_p = dict(bench_properties(False, groups, num_servers=servers,
                                  transport=transport,
                                  hibernate=hibernate).items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax_p
    assert port["raft.tpu.engine.tick-interval"] == "2ms"
    assert port["raft.tpu.engine.scalar-fallback-threshold"] == "1000000000"
    assert port["raft.tpu.replication.sweep"] == "0"
    assert not any(k.startswith(("raft.tpu.tcp.", "raft.tpu.grpc."))
                   for k in port)
    assert RaftServerConfigKeys.Hibernate.ENABLED_KEY not in port


def test_is_batched_tells_the_two_deployments_apart():
    assert is_batched(cluster_properties(8, 3, "cpu"))
    assert not is_batched(cluster_properties(8, 3, "cpu", batched=False))


def _device_ticks(cluster) -> list:
    return [s.engine.metrics["fast_ticks"] + s.engine.metrics["refresh_ticks"]
            for s in cluster.servers]


async def _scalar(cluster) -> dict:
    try:
        cluster.prewarm()
        ticks = _device_ticks(cluster)
        await cluster.start(timeout=60)
        stats = await cluster.write_all(WRITES)
        counters = await cluster.read_counters()
        return {"commits": stats["commits"],
                "counters": [counters[g.group_id] for g in cluster.groups],
                "device_ticks": [b - a for a, b in
                                 zip(ticks, _device_ticks(cluster))],
                "scalar_ticks": min(s.engine.metrics["ticks"]
                                    for s in cluster.servers) > 0}
    finally:
        await cluster.close()


def test_scalar_cluster_matches_jax():
    props = cluster_properties(GROUPS, 3, "cpu", "sim", batched=False)
    port = Cluster(GROUPS, 3, device="cpu", properties=props)
    jax_c = jax_cluster_module().Cluster(
        GROUPS, 3, device="cpu", properties=jax_properties(props))
    prewarm_small(jax_c)
    runs = {"port": asyncio.run(_scalar(port)),
            "jax": asyncio.run(_scalar(jax_c))}
    for name, res in runs.items():
        assert res["commits"] == GROUPS * WRITES, name
        assert res["counters"] == [[WRITES] * 3] * GROUPS, name
        # the scalar path never dispatches: no fast or refresh tick after
        # the prewarm, on any server, in either package
        assert res["device_ticks"] == [0, 0, 0], name
        assert res["scalar_ticks"], name
    assert runs["port"] == runs["jax"]


# -- the window-depth sweep: run_bench's keys -------------------------------

WINDOW_LOAD = {"groups": 8, "writes": 2, "concurrency": 32}
# keys of run_bench's result that depend on the JAX harness's own parts
# (its gRPC block, loop shards, the sparse shape)
CONDITIONAL = {"grpc_dispatch", "loop_shards", "active_groups", "hibernate",
               "hibernated_groups"}


def _jax_run_bench(depth: int) -> dict:
    return asyncio.run(run_bench(
        WINDOW_LOAD["groups"], WINDOW_LOAD["writes"],
        concurrency=WINDOW_LOAD["concurrency"], transport="sim",
        extra_props={bench.WINDOW_DEPTH_KEY: str(depth)}))


def _port_rung(depth: int) -> dict:
    cluster = bench.e2e_cluster("cpu", WINDOW_LOAD["groups"], "sim",
                                props={bench.WINDOW_DEPTH_KEY: str(depth)})
    return asyncio.run(bench.e2e_rung(
        cluster, WINDOW_LOAD["writes"],
        concurrency=WINDOW_LOAD["concurrency"]))


@pytest.mark.parametrize("depth", [1, 16])
def test_window_depth_rung_reports_run_bench_keys(depth):
    jax_res = _jax_run_bench(depth)
    port = _port_rung(depth)
    missing = set(jax_res) - set(port) - CONDITIONAL
    assert not missing, sorted(missing)
    assert port["mode"] == jax_res["mode"] == "batched"
    assert port["peers"] == jax_res["peers"] == 3
    assert port["commits"] == jax_res["commits"] \
        == WINDOW_LOAD["groups"] * WINDOW_LOAD["writes"]
    for res in (port, jax_res):
        assert 0.0 < res["window_occupancy"] <= 1.0
        assert res["window_rewinds"] >= 0 and res["lane_resets"] >= 0
        assert res["reply_hops_per_commit"] >= 0
        assert set(res["codec"]) == set(jax_res["codec"])


def test_window_keys_are_run_benchs_over_the_servers():
    """``run_bench_keys``'s window keys from made-up replication counters:
    the worst server's peak frames over its envelope slots, the sums of
    the rewinds and resets."""

    class Rep:
        def __init__(self, hwm, slots, rew, resets):
            self.metrics = {"win_hwm": hwm, "windowed_rewinds": rew,
                            "lane_resets": resets, "rewinds": rew + 1}
            self.lane_slots = slots

    class Server:
        def __init__(self, rep):
            self.replication = rep
            self.watchdog = None

    class FakeCluster:
        servers = [Server(Rep(3, 8, 1, 0)), Server(Rep(6, 8, 2, 1)),
                   Server(Rep(0, 0, 0, 0))]

    out = bench.run_bench_keys(FakeCluster(), [])
    assert out["window_occupancy"] == 6 / 8
    assert out["window_rewinds"] == 3 and out["lane_resets"] == 1
    assert out["append_rewinds"] == 2 + 3 + 1
    assert out["engine_occupancy"] == 0 and out["watchdog_events"] == 0


# -- the rungs through the bench's command line -----------------------------

def _bench(*args, timeout=300):
    proc = subprocess.run([sys.executable, "-m", "ratis_tpu_torch.tools.bench",
                           "--device", "cpu", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_scalar_rung_is_the_headlines_scalar_control():
    out = _bench("--rungs", "scalar", "--groups", "8", "--writes", "2")
    r = out["scalar"]
    assert r["mode"] == "scalar" and r["transport"] == "tcp"
    assert r["servers"] == 3 and r["warmup"] == bench.WARMUP_WRITES
    assert r["concurrency"] == bench.CONCURRENCY
    assert r["acked"] == 8 * (1 + 2) and r["replicas_read_back"] == 8 * 3
    assert r["pack_ms"] is None
    # no batched dispatch in the measured writes
    assert all(d["dispatches"] == 0 for d in r["dispatch"])
    assert out["value"] is None  # the headline's value is the e2e rung's


@pytest.mark.parametrize("rung,depth", [("win1", 1), ("win16", 16)])
def test_window_rungs_report_their_sweep_entry(rung, depth):
    r = _bench("--rungs", rung, "--groups", "4", "--writes", "2")[rung]
    assert r["mode"] == "batched" and r["transport"] == "tcp"
    assert r["sweep_entry"] == [r["commits_per_sec"], r["p99_ms"],
                                r["window_occupancy"]]
    assert bench.WINDOW_DEPTHS[rung] == depth


@pytest.mark.parametrize("rung", ["sim_1", "sim_64", "upk_64"])
def test_ladder_rungs_run_the_jax_childrens_shapes(rung):
    r = _bench("--rungs", rung, "--groups", "2", "--writes", "3")[rung]
    g, w, conc = {**bench.SIM_LADDER,
                  **{k: (g, w, bench.CONCURRENCY)
                     for k, (g, w) in bench.UPKEEP_LADDER.items()}}[rung]
    assert r["transport"] == "sim" and r["mode"] == "batched"
    assert r["concurrency"] == conc and r["warmup"] == 1
    assert r["acked"] == 2 * (1 + 3)
    assert bench.SIM_LADDER["sim_1"] == (1, 256, 32)
    assert bench.SIM_LADDER["sim_64"] == (64, 128, 128)
    assert bench.UPKEEP_LADDER == {"upk_64": (64, 128), "upk_1024": (1024, 8)}


def test_upkeep_rungs_turn_the_plane_on_and_the_triple_is_bench_pys(
        tmp_path):
    c = bench.e2e_cluster("cpu", 4, "sim", props=bench.UPKEEP_PROPS)
    assert RaftServerConfigKeys.Upkeep.enabled(c.properties)
    lines = {"upkeep": {"sweep_ms_64": 0.25, "sweep_ms_1024": 1.5},
             "upk_64": {"commits_per_sec": 1000.0},
             "upk_1024": {"commits_per_sec": 600.0}}
    paths = []
    for rung, res in lines.items():
        p = tmp_path / f"{rung}.json"
        p.write_text("noise\n" + json.dumps({rung: res}) + "\n")
        paths.append(str(p))
    out = _bench("--upkeep-triple", ",".join(paths))
    assert out == {"upkeep": [0.25, 1.5, 1.0 - 600.0 / 1000.0]}


# -- the harness clients' retry budget ---------------------------------------

@pytest.mark.parametrize("tier,attempts", [({}, 50), (bench.DURABLE_TIER, 160)])
def test_batched_clients_retry_two_election_timeouts(tier, attempts):
    """The batched deployment's clients keep their attempt budget: two of
    the longest election timeouts at 100 ms, at least 50."""
    from ratis_tpu_torch.retry.policies import RetryLimited
    from ratis_tpu_torch.tools.cluster import client_retry_policy
    p = cluster_properties(16, 3, "cpu", "tcp")
    for k, v in tier.items():
        p.set(k, v)
    policy = client_retry_policy(p, 16)
    assert isinstance(policy, RetryLimited)
    assert policy.max_attempts == attempts
    assert policy.sleep_time.seconds == 0.1


@pytest.mark.parametrize("groups,budget_s", [(1024, 60.0), (10240, 240.0)])
def test_scalar_clients_retry_for_the_jax_write_budget(monkeypatch, groups,
                                                       budget_s):
    """The scalar control's clients retry a call every 100 ms until the
    JAX harness's write budget has passed on the wall clock since its
    first failed attempt, however many attempts that is; another call
    starts its own budget."""
    from ratis_tpu_torch.retry.policies import ClientRetryEvent
    from ratis_tpu_torch.tools import cluster as harness
    policy = harness.client_retry_policy(
        cluster_properties(groups, 3, "cpu", "tcp", batched=False), groups)
    assert isinstance(policy, harness.RetryForDuration)
    now = [100.0]
    monkeypatch.setattr(harness.time, "monotonic", lambda: now[0])

    class Req:
        def __init__(self, call_id):
            self.call_id = call_id

    def attempt(n, call_id=1):
        return policy.handle_attempt_failure(
            ClientRetryEvent(n, None, Req(call_id)))
    first = attempt(1)
    assert first.should_retry and first.sleep_time.seconds == 0.1
    now[0] += budget_s - 1
    assert attempt(10_000).should_retry
    assert attempt(1, call_id=2).should_retry
    now[0] += 2
    assert not attempt(10_001).should_retry
    assert attempt(2, call_id=2).should_retry


# -- a write pending past the retry cache's expiry ---------------------------

def test_retry_cache_entry_ages_from_its_reply():
    """A pending entry never expires (a retry waits on it however long the
    write takes); a completed one expires ``expiry_s`` after its reply; a
    failed one at once."""
    import time

    from ratis_tpu_torch.server.retrycache import RetryCache

    async def run():
        cache = RetryCache(expiry_s=0.05)
        pending, new = cache.get_or_create(b"c", 1)
        done, _ = cache.get_or_create(b"c", 2)
        failed, _ = cache.get_or_create(b"c", 3)
        failed.fail()
        await asyncio.sleep(0.1)
        done.complete(object())
        t_reply = time.monotonic()
        assert new and cache.get_or_create(b"c", 1) == (pending, False)
        assert cache.get_or_create(b"c", 2) == (done, False)
        assert cache.get_or_create(b"c", 3)[1]  # re-executes
        assert cache.next_expiry_s() == done.replied + 0.05 <= t_reply + 0.05
        await asyncio.sleep(0.1)
        assert cache.get_or_create(b"c", 2)[1]
        assert cache.sweep() == 0 and len(cache) == 3
    asyncio.run(run())


@pytest.mark.parametrize("batched", [False, True])
def test_a_pending_write_whose_leader_steps_down_is_failed_and_retried(
        batched):
    """A leader that steps down with a write pending fails the write's
    retry-cache entry (so no retry of the call waits on it), and the
    client's retry of the same call re-runs the write or gets its cached
    reply under the next leader: it succeeds, not hangs.  The held entry
    may also commit under the next leader beside the retried call's own
    (the client was told NotLeader, not that the write was lost), so each
    replica reads 2 or 3, all alike.  Both deployments: the scalar
    control answers through the write's future, the batched one through
    the deferred reply path."""
    from ratis_tpu_torch.util import injection

    async def run():
        cluster = Cluster(1, 3, device="cpu", transport="tcp",
                          properties=cluster_properties(1, 3, "cpu", "tcp",
                                                        batched=batched))
        release = asyncio.Event()

        async def hold(*_):
            await release.wait()
        try:
            await cluster.start(timeout=60)
            await cluster.write_all(1)
            g = cluster.groups[0]
            div = cluster.leader_of(g).divisions[g.group_id]
            injection.put(injection.APPEND_ENTRIES, hold)
            write = asyncio.ensure_future(
                cluster.client(g).io().send(b"INCREMENT"))
            while not (div.leader_ctx and div.leader_ctx.pending.requests()):
                await asyncio.sleep(0.005)
            req = div.leader_ctx.pending.requests()[0]
            entry = div.retry_cache.get(req.client_id.to_bytes(),
                                        req.call_id)
            assert entry is not None and not entry.done
            await div.change_to_follower(div.state.current_term + 1, None,
                                         reason="test: pending write")
            # the write's handler resumes on its failed pending request
            for _ in range(500):
                if entry.done:
                    break
                await asyncio.sleep(0.01)
            assert entry.future.cancelled()
            assert div.retry_cache.get(req.client_id.to_bytes(),
                                       req.call_id) is None
            release.set()
            injection.remove(injection.APPEND_ENTRIES)
            reply = await asyncio.wait_for(write, 60)
            assert reply.success, reply.exception
            cluster.last_index[g.group_id] = reply.log_index
            return list((await cluster.read_counters()).values())
        finally:
            release.set()
            injection.remove(injection.APPEND_ENTRIES)
            await cluster.close()
    [counters] = asyncio.run(run())
    assert counters in ([2] * 3, [3] * 3), counters


STALL_S = 5.0


async def _stalled_write(cluster, injection) -> list:
    """3 x 1 over TCP with retry-cache entries of 1 s: one write, then a
    second whose replication the followers hold for ``STALL_S`` (their
    append handler sleeps; the 8 s / 16 s tier keeps the leader), past the
    client's 3 s attempt timeout: the client retries the same call at the
    live leader while the write is pending, after the entry's first
    second.  Returns the group's counters."""
    try:
        await cluster.start(timeout=60)
        await cluster.write_all(1)
        held = {"on": True}

        async def hold(_local, _remote, *_):
            if held["on"]:
                await asyncio.sleep(STALL_S)

        async def release():
            await asyncio.sleep(STALL_S * 0.9)
            held["on"] = False
        injection.put(injection.APPEND_ENTRIES, hold)
        try:
            await asyncio.gather(cluster.write_all(1), release())
        finally:
            injection.remove(injection.APPEND_ENTRIES)
        return list((await cluster.read_counters()).values())
    finally:
        await cluster.close()


def _stall_properties():
    p = cluster_properties(1, 3, "cpu", "tcp", batched=False)
    p.set("raft.server.retrycache.expiry-time", "1s")
    # no election while the appends are held
    p.set("raft.server.rpc.timeout.min", "8s")
    p.set("raft.server.rpc.timeout.max", "16s")
    return p


def test_a_write_pending_past_the_retry_cache_expiry_is_applied_once():
    """The port applies the held write once; the JAX package's retry cache
    ages the pending entry out and appends the retried call again (the
    scalar rung's duplicate on the card: a group read 10 for 9
    acknowledged writes)."""
    from ratis_tpu.util import injection as jax_injection
    from ratis_tpu_torch.util import injection
    port = Cluster(1, 3, device="cpu", transport="tcp",
                   properties=_stall_properties())
    assert asyncio.run(_stalled_write(port, injection)) == [[2, 2, 2]]
    jax_c = jax_cluster_module().Cluster(
        1, 3, device="cpu", transport="tcp",
        properties=jax_properties(_stall_properties()))
    prewarm_small(jax_c)
    counters = asyncio.run(_stalled_write(jax_c, jax_injection))
    assert counters[0][0] > 2, counters
