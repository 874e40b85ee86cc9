"""Cross-process metrics aggregation for the observability plane.

PR 3 split the bench cluster into one process per peer; each child owns
its own metric registries, tracer rings, and engine counters, and nothing
merged them back into one cluster view.  This module is the merge point:
a dependency-free async HTTP scraper for the per-server introspection
endpoint (:class:`~ratis_tpu_torch.metrics.prometheus.MetricsHttpServer`) and a
snapshot merger that folds every child's scrape into ONE cluster snapshot
— per-process summaries keyed by pid plus cluster-wide totals.  The
multi-process bench embeds the merged snapshot in its per-process
decomposition report; ``python -m ratis_tpu_torch.shell health`` pretty-prints
the same scrapes for an operator.
"""

from __future__ import annotations

import asyncio
import re
from typing import Optional

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def _split_address(address: str) -> tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)


async def http_get(address: str, path: str, timeout_s: float = 10.0) -> bytes:
    """Tiny HTTP/1.1 GET against the introspection endpoint (close-delim
    bodies; the endpoint always sends Connection: close)."""
    host, port = _split_address(address)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout_s)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                     f"Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout_s)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass
    head, _, body = raw.partition(b"\r\n\r\n")
    status_line = head.split(b"\r\n", 1)[0]
    status = status_line.split()
    if len(status) < 2 or status[1] != b"200":
        raise RuntimeError(f"GET {address}{path}: "
                           f"{status_line.decode('latin-1', 'replace')}")
    return body


async def fetch_json(address: str, path: str,
                     timeout_s: float = 10.0) -> object:
    import json
    return json.loads(await http_get(address, path, timeout_s))


async def fetch_text(address: str, path: str,
                     timeout_s: float = 10.0) -> str:
    return (await http_get(address, path, timeout_s)).decode()


def parse_prometheus_text(text: str) -> dict:
    """{'name{labels}': float} over every sample line (TYPE/HELP lines
    skipped) — enough structure to merge counters across processes."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group(1) + (m.group(2) or "")
        try:
            out[name] = float(m.group(3))
        except ValueError:
            continue
    return out


async def scrape_server(address: str, timeout_s: float = 10.0) -> dict:
    """One child's full introspection scrape: health + divisions + events
    + parsed /metrics samples, plus the scrape address for re-scraping.

    Partial-failure tolerant: each route is fetched independently
    (an earlier bare ``asyncio.gather`` let ONE failing route poison the
    whole server's scrape).  A route that fails lands in ``errors``
    with empty data of the right shape; only when EVERY route fails —
    the endpoint is actually dead — does the scrape raise, so
    :func:`scrape_cluster` classifies the server unreachable."""
    results = await asyncio.gather(
        fetch_json(address, "/health", timeout_s),
        fetch_json(address, "/divisions", timeout_s),
        fetch_json(address, "/events", timeout_s),
        fetch_text(address, "/metrics", timeout_s),
        return_exceptions=True)
    paths = ("/health", "/divisions", "/events", "/metrics")
    empties = ({}, [], {}, "")
    errors = {}
    clean = []
    for path, res, empty in zip(paths, results, empties):
        if isinstance(res, BaseException):
            errors[path] = str(res) or type(res).__name__
            clean.append(empty)
        else:
            clean.append(res)
    if len(errors) == len(paths):
        raise RuntimeError(f"all routes failed: {errors['/health']}")
    health, divisions, events, metrics_text = clean
    out = {
        "address": address,
        "health": health,
        "divisions": divisions,
        "events": events,
        "metrics": parse_prometheus_text(metrics_text),
    }
    if errors:
        out["errors"] = errors
    return out


def _summarize_proc(scrape: dict) -> dict:
    """Compact per-process block of a merged snapshot (the full division
    list and raw samples stay out of the bench artifact)."""
    health = scrape.get("health", {})
    divisions = scrape.get("divisions", [])
    events = scrape.get("events", {})
    roles: dict = {}
    lag_max = 0
    pending = 0
    for d in divisions:
        roles[d.get("role", "?")] = roles.get(d.get("role", "?"), 0) + 1
        pending += d.get("pendingRequests", 0)
        for f in (d.get("followers") or {}).values():
            lag_max = max(lag_max, f.get("lag", 0))
    metrics = scrape.get("metrics", {})

    def g(name: str, default=0.0):
        return metrics.get(name, default)

    chaos = health.get("chaos") or {}
    active_faults = (len(chaos.get("activeLinkFaults", []))
                     + len(chaos.get("activeInjections", [])))
    return {
        "chaosActiveFaults": active_faults,
        "chaosInjections": chaos.get("activeInjections", []),
        "address": scrape.get("address"),
        # a half-dead server (some routes down) keeps its address as the
        # display name and reads degraded, never "ok"
        "peer": health.get("peer") or scrape.get("address"),
        "status": ("degraded" if scrape.get("errors")
                   else health.get("status")),
        "routeErrors": scrape.get("errors") or {},
        "divisions": len(divisions),
        "roles": roles,
        "pendingRequests": pending,
        "followerLagMax": lag_max,
        "engineTicks": (health.get("engine") or {}).get("ticks", 0),
        "laneOccupancyGroups": g("ratis_engine_laneOccupancyGroups"),
        "watchdogEvents": events.get("count", 0),
        "eventKinds": sorted({e.get("kind")
                              for e in events.get("events", [])}),
        "shedRequests": (health.get("serving") or {}).get("shedTotal", 0),
    }


def merge_cluster_snapshot(scrapes: list[dict]) -> dict:
    """Fold per-child scrapes into one cluster snapshot: a per-pid
    summary map + cluster totals (counter families summed across
    processes, gauges left per-process)."""
    procs: dict = {}
    totals: dict = {}
    events = 0
    unhealthy = []
    for scrape in scrapes:
        health = scrape.get("health", {})
        pid = str(health.get("pid", f"unknown-{len(procs)}"))
        if pid in procs:
            # co-hosted servers share a pid (in-process clusters): keep
            # every server visible instead of last-writer-wins
            pid = f"{pid}:{health.get('peer')}"
        procs[pid] = _summarize_proc(scrape)
        if procs[pid]["status"] != "ok":
            unhealthy.append(procs[pid]["peer"])
        events += procs[pid]["watchdogEvents"]
        for name, value in scrape.get("metrics", {}).items():
            if name.split("{", 1)[0].endswith("_total"):
                totals[name.split("{", 1)[0]] = \
                    totals.get(name.split("{", 1)[0], 0.0) + value
    return {
        "procs": procs,
        "servers": len(scrapes),
        "healthy": len(scrapes) - len(unhealthy),
        "unhealthy_peers": unhealthy,
        "watchdog_events": events,
        "counter_totals": {k: totals[k] for k in sorted(totals)},
    }


async def scrape_cluster(addresses: list[str],
                         timeout_s: float = 10.0) -> dict:
    """Scrape every address concurrently and merge; a dead endpoint
    becomes an ``unreachable`` proc entry instead of failing the merge
    (the parent must report a half-dead cluster, not crash on it)."""
    results = await asyncio.gather(
        *(scrape_server(a, timeout_s) for a in addresses),
        return_exceptions=True)
    scrapes = []
    unreachable = []
    for address, res in zip(addresses, results):
        if isinstance(res, BaseException):
            # e.g. asyncio.TimeoutError stringifies empty: keep the type
            unreachable.append({"address": address,
                                "error": str(res) or type(res).__name__})
        else:
            scrapes.append(res)
    merged = merge_cluster_snapshot(scrapes)
    if unreachable:
        merged["unreachable"] = unreachable
    return merged


# ------------------------------------------------- continuous telemetry

def merge_timeseries(payloads: list[dict]) -> dict:
    """Fold per-process ``/timeseries`` payloads into one pid-keyed view
    (the way chrome traces already merge): per-pid latest sample + series
    length, cluster-wide rates as the element-wise sum of each process's
    newest sample, and the log2 latency buckets summed across processes
    (the bucket encoding exists exactly so this merge is a plain add)."""
    procs: dict = {}
    rate_totals: dict = {}
    lat_buckets: dict = {}
    lat_total = 0
    for p in payloads:
        pid = str(p.get("pid", f"unknown-{len(procs)}"))
        if pid in procs:  # co-hosted servers share a pid
            pid = f"{pid}:{p.get('peer')}"
        samples = p.get("samples", [])
        last = samples[-1] if samples else {}
        procs[pid] = {
            "peer": p.get("peer"),
            "seq": p.get("seq", -1),
            "count": len(samples),
            "interval_s": p.get("interval_s"),
            "last": last,
        }
        for k, v in (last.get("rates") or {}).items():
            rate_totals[k] = round(rate_totals.get(k, 0.0) + v, 3)
        lat = p.get("latency") or {}
        lat_total += lat.get("count", 0)
        for b, c in (lat.get("buckets") or {}).items():
            lat_buckets[b] = lat_buckets.get(b, 0) + c
    return {"procs": procs, "rates": rate_totals,
            "latency": {"count": lat_total, "buckets": lat_buckets}}


def merge_hotgroups(payloads: list[dict], n: int = 16) -> dict:
    """Fold per-process ``/hotgroups`` payloads into one cluster top-n:
    per-group commits/err/pending summed across processes (each process
    accounts its own replicas; the leader's commits dominate), ranked by
    merged commit count."""
    by_group: dict = {}
    total = 0
    for p in payloads:
        total += p.get("total_commits", 0)
        for g in p.get("groups", []):
            e = by_group.setdefault(g["group"],
                                    {"commits": 0, "err": 0, "pending": 0})
            e["commits"] += g.get("commits", 0)
            e["err"] += g.get("err", 0)
            e["pending"] += g.get("pending", 0)
    ranked = sorted(by_group.items(), key=lambda kv: -kv[1]["commits"])[:n]
    return {
        "total_commits": total,
        "groups": [{"group": k, **v,
                    "share": round(v["commits"] / max(1, total), 4),
                    "share_min": round(
                        max(0, v["commits"] - v["err"]) / max(1, total), 4)}
                   for k, v in ranked],
    }


async def scrape_cluster_timeseries(addresses: list[str],
                                    timeout_s: float = 10.0,
                                    since: "dict | None" = None) -> dict:
    """Scrape ``/timeseries`` + ``/hotgroups`` from every address and
    merge (``since``: address -> last-seen seq for incremental polls).
    Unreachable or telemetry-less endpoints degrade to an
    ``unreachable`` entry, never an exception — same contract as
    :func:`scrape_cluster`."""
    async def one(addr: str):
        path = "/timeseries"
        if since and since.get(addr) is not None:
            path += f"?since={since[addr]}"
        ts = await fetch_json(addr, path, timeout_s)
        hot = await fetch_json(addr, "/hotgroups", timeout_s)
        return ts, hot

    results = await asyncio.gather(*(one(a) for a in addresses),
                                   return_exceptions=True)
    ts_payloads, hot_payloads, unreachable = [], [], []
    addr_of: dict = {}
    for addr, res in zip(addresses, results):
        if isinstance(res, BaseException):
            unreachable.append({"address": addr,
                                "error": str(res) or type(res).__name__})
            continue
        ts, hot = res
        addr_of[str(ts.get("pid"))] = addr
        ts_payloads.append(ts)
        hot_payloads.append(hot)
    merged = merge_timeseries(ts_payloads)
    merged["hotgroups"] = merge_hotgroups(hot_payloads)
    merged["addresses"] = addr_of
    if unreachable:
        merged["unreachable"] = unreachable
    return merged


async def scrape_cluster_lag(addresses: list[str],
                             timeout_s: float = 10.0) -> dict:
    """Scrape ``GET /lag`` from every address: one ledger payload per
    live server (`shell lag` renders the peers x servers heatmap from
    them), unreachable endpoints degrade to an ``unreachable`` entry —
    same contract as :func:`scrape_cluster`."""
    results = await asyncio.gather(
        *(fetch_json(a, "/lag", timeout_s) for a in addresses),
        return_exceptions=True)
    servers, unreachable = [], []
    for addr, res in zip(addresses, results):
        if isinstance(res, BaseException):
            unreachable.append({"address": addr,
                                "error": str(res) or type(res).__name__})
            continue
        res["address"] = addr
        servers.append(res)
    out = {"servers": servers}
    if unreachable:
        out["unreachable"] = unreachable
    return out
