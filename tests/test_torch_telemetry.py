"""The telemetry plane, the port against the JAX package.

The port's server names ``metrics/timeseries``, ``metrics/flight`` and
``metrics/prometheus`` behind ``raft.tpu.telemetry.enabled`` and
``raft.tpu.metrics.http-port``; they are verbatim copies now (with
``metrics/aggregate.py`` and ``trace/export.py``).  Here:

- 3 servers x 16 groups over localhost TCP per package (the port's
  harness and the JAX package's through ``tests/jax_mirror.py``), telemetry
  on (one sample a second) and every server's HTTP endpoint on a port it
  bound (``http-port=0``): after the same writes settle, every route is
  fetched over HTTP from every server and must answer 200 and parse; the
  route set and each JSON route's key set are the same in both packages;
  ``/timeseries`` holds samples; each row a server leads has, in the
  ledger sample its ``/lag`` request took, the leading division's own
  commit index; and the groups' commit indexes there are equal between
  the packages;
- ``metrics/aggregate.py``'s merges, the Prometheus rendering and
  ``trace/export.py``'s fold give equal outputs in both packages on the
  same seeded inputs;
- the bench's ``telemetry`` and ``traced`` rungs run tiny on the CPU.
"""

import asyncio
import importlib
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from ratis_tpu_torch.tools import bench
from ratis_tpu_torch.tools.cluster import (HTTP_ROUTES, Cluster,
                                           cluster_properties)
from ratis_tpu_torch.trace import get_tracer

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

GROUPS = 16
WRITES = 3
TIMEOUT = 60.0
PACKAGES = ("ratis_tpu_torch", "ratis_tpu")


def _props():
    p = cluster_properties(GROUPS, 3, "cpu", "tcp")
    for k, v in bench.TELEMETRY.items():
        p.set(k, v)
    p.set("raft.tpu.metrics.http-port", "0")
    return p


def _keys(bodies) -> list:
    """The JSON keys of a route's bodies (of a list's items: the union,
    leaders and followers name different keys)."""
    keys = set()
    for body in bodies:
        for item in (body if isinstance(body, list) else [body]):
            keys.update(item)
    return sorted(keys)


async def _telemetry_script(cluster) -> dict:
    try:
        await cluster.start(timeout=TIMEOUT)
        seen = cluster.watch_lag()
        await cluster.write_all(WRITES)
        await cluster.read_counters(timeout=TIMEOUT)
        # a sampler pass after the writes on every server
        await asyncio.sleep(1.5)
        routes = await cluster.fetch_routes()
        position = {g.group_id: i for i, g in enumerate(cluster.groups)}
        commits, mismatched = {}, []
        for peer, rows, _ in seen:
            for gid, (ledger, own) in rows.items():
                commits[position[gid]] = ledger
                if ledger != own:
                    mismatched.append((peer, str(gid), ledger, own))
        return {"routes": routes, "commits": commits,
                "mismatched": mismatched, "lag_gets": len(seen),
                "samples": [s.telemetry._samples_taken.count
                            for s in cluster.servers]}
    finally:
        await cluster.close()


def test_telemetry_routes_match_jax():
    port = Cluster(GROUPS, device="cpu", transport="tcp", properties=_props())
    jmod = jax_cluster_module()
    jax = jmod.Cluster(GROUPS, device="cpu", transport="tcp",
                       properties=jax_properties(_props()))
    prewarm_small(jax)
    runs = {"port": asyncio.run(_telemetry_script(port)),
            "jax": asyncio.run(_telemetry_script(jax))}
    shapes = {}
    for name, run in runs.items():
        assert sorted(run["routes"]) == ["s0", "s1", "s2"], name
        for peer, got in run["routes"].items():
            assert tuple(got) == HTTP_ROUTES, (name, peer)
            assert got["/metrics"], (name, peer)
            assert len(got["/divisions"]) == GROUPS, (name, peer)
            assert got["/timeseries"]["count"] >= 1, (name, peer)
            assert got["/timeseries"]["peer"] == peer, (name, peer)
        # one /lag request a server, each row it leads as its division's
        assert run["lag_gets"] == 3 and run["mismatched"] == [], name
        assert sorted(run["commits"]) == list(range(GROUPS)), name
        assert min(run["commits"].values()) >= WRITES, name
        assert min(run["samples"]) >= 1, name
        shapes[name] = {r: _keys(got[r] for got in run["routes"].values())
                        for r in HTTP_ROUTES[1:]}
    assert shapes["port"] == shapes["jax"]
    assert runs["port"]["commits"] == runs["jax"]["commits"]


def _same_in_both(fn):
    """``fn(package)`` for each package; returns the port's result after
    checking the JAX package's equals it."""
    port, jax = (fn(pkg) for pkg in PACKAGES)
    assert port == jax
    return port


def _payloads(seed: int) -> tuple[list, list]:
    """Seeded /timeseries and /hotgroups payloads of 3 servers."""
    rng = np.random.default_rng(seed)
    ts, hot = [], []
    for i in range(3):
        samples = [{"seq": k, "rates": {
            "commits_per_s": float(rng.integers(0, 5000)),
            "acks_per_s": float(rng.integers(0, 9000))}}
            for k in range(int(rng.integers(0, 5)))]
        ts.append({"pid": 100 + i % 2, "peer": f"s{i}", "seq": len(samples),
                   "interval_s": 1.0, "samples": samples,
                   "latency": {"count": int(rng.integers(0, 100)),
                               "buckets": {str(b): int(rng.integers(1, 9))
                                           for b in rng.choice(20, 4)}}})
        hot.append({"total_commits": int(rng.integers(100, 1000)),
                    "groups": [{"group": f"g{int(g)}",
                                "commits": int(rng.integers(0, 100)),
                                "err": int(rng.integers(0, 5)),
                                "pending": int(rng.integers(0, 3))}
                               for g in rng.choice(12, 6, replace=False)]})
    return ts, hot


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_merges_match_jax(seed):
    ts, hot = _payloads(seed)

    def merges(pkg):
        agg = importlib.import_module(f"{pkg}.metrics.aggregate")
        scrapes = [{"address": f"127.0.0.1:{9000 + i}",
                    "health": {"pid": p["pid"], "peer": p["peer"],
                               "status": "ok"},
                    "divisions": [{"role": "LEADER", "pendingRequests": 1}],
                    "events": {"count": i, "events": []},
                    "metrics": {"ratis_x_total": float(i + seed),
                                "ratis_y": 2.0}}
                   for i, p in enumerate(ts)]
        return (agg.merge_timeseries(ts), agg.merge_hotgroups(hot, n=4),
                agg.merge_cluster_snapshot(scrapes))
    merged_ts, merged_hot, snap = _same_in_both(merges)
    assert merged_hot["groups"] and snap["servers"] == 3


def test_prometheus_rendering_matches_jax():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 10 ** 10, 4).tolist()
    times = rng.random(50).tolist()

    def render(pkg):
        reg_mod = importlib.import_module(f"{pkg}.metrics.registry")
        prom = importlib.import_module(f"{pkg}.metrics.prometheus")
        agg = importlib.import_module(f"{pkg}.metrics.aggregate")
        regs = reg_mod.MetricRegistries()
        reg = regs.create(reg_mod.MetricRegistryInfo(
            prefix="s0@group-1", application="ratis", component="server",
            name="seeded"))
        for i, n in enumerate(counts):
            reg.counter(f"count{i}").inc(int(n))
        t = reg.timer("latency")
        for x in times:
            t.update(x)
        reg.gauge("gauge", lambda: 2.5)
        text = prom.render_text(regs)
        return text, agg.parse_prometheus_text(text)
    text, parsed = _same_in_both(render)
    assert str(counts[0]) in text and len(parsed) > 6


def test_trace_export_fold_matches_jax():
    rng = np.random.default_rng(9)
    n = 400
    records = list(zip(rng.integers(0, 40, n).tolist(),
                       rng.integers(0, 13, n).tolist(),
                       rng.integers(0, 10 ** 12, n).tolist(),
                       rng.integers(1, 10 ** 7, n).tolist(),
                       rng.integers(0, 4, n).tolist(),
                       rng.integers(0, 3, n).tolist()))

    def fold(pkg):
        export = importlib.import_module(f"{pkg}.trace.export")
        tracer = importlib.import_module(f"{pkg}.trace.tracer")
        assert tracer.NUM_STAGES > 12
        return (export.host_path_decomposition(records),
                export.to_chrome_trace(records))
    table, chrome = _same_in_both(fold)
    assert table["traced_requests"] > 0
    assert len(chrome["traceEvents"]) == n


@pytest.mark.parametrize("rung", ["telemetry", "traced"])
def test_telemetry_and_traced_rungs_tiny_on_cpu(tmp_path, rung):
    argv = ["--device", "cpu", "--rungs", rung, "--groups", "8",
            "--writes", "2"]
    if rung == "traced":
        argv += ["--trace-out", str(tmp_path / "trace.json")]
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            assert bench.main(argv) == 0
    finally:
        # the process tracer stays on once a server enabled it
        get_tracer().configure(enabled=False)
    res = json.loads(out.getvalue().strip().splitlines()[-1])[rung]
    assert res["commits"] == 8 * 2 and res["replicas_read_back"] == 8 * 3
    if rung == "telemetry":
        tel = res["telemetry"]
        # run_bench's keys, and the two passes on the wall clock
        assert set(tel) == {"samples", "sample_cost_p99_ms", "hot_share",
                            "hot_group", "sampler_pass_ms", "walk_pass_ms",
                            "ledger_fetch_ms", "sampler_pass_wall_ms",
                            "walk_pass_wall_ms"}
        assert tel["samples"] >= 3 and tel["sampler_pass_wall_ms"] > 0
        assert res["transport"] == "tcp"
    else:
        table = res["host_path_decomposition"]
        assert table["traced_requests"] >= 1 and table["stages"]
        trace = json.loads((tmp_path / "trace.json").read_text())
        assert trace["traceEvents"]
        assert res["transport"] == "sim"
