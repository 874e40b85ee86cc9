"""Aggregation and export for host-path traces.

Two consumers of :meth:`Tracer.snapshot`:

- :func:`host_path_decomposition` — the compact per-stage percentile table
  the bench embeds (``host_path_decomposition`` block): where each commit's
  wall-clock goes, stage by stage, with a coverage fraction proving the
  stages account for the measured latency instead of hand-waving at "the
  host runtime".
- :func:`to_chrome_trace` / :func:`write_chrome_trace` — Chrome
  trace-event JSON (the ``traceEvents`` array format), loadable in
  Perfetto (ui.perfetto.dev) or chrome://tracing: one complete-event
  ("ph": "X") per span, one track per trace id.
"""

from __future__ import annotations

import json

import numpy as np

from ratis_tpu_torch.metrics.hops import HOP_SITES
from ratis_tpu_torch.trace.tracer import (NUM_STAGES, STAGE_CLIENT,
                                          STAGE_COUNTER, STAGE_NAMES,
                                          TILING_STAGES)

# Stages whose spans OVERLAP others (client total, transport rtt, engine
# dispatch): reported in the table, excluded from the coverage sum.
_TILING = set(TILING_STAGES)


def _percentile(sorted_ns: list[int], q: float) -> float:
    n = len(sorted_ns)
    return sorted_ns[min(n - 1, int(n * q))] / 1e3  # -> microseconds


def host_path_decomposition(records) -> dict:
    """Per-stage decomposition of the traced request path.

    ``records`` is a ``Tracer.snapshot()`` list of
    (trace_id, stage, t0_ns, dur_ns, tag).

    Coverage is computed per-trace: for every trace id that has a
    ``client.send`` span (the wall-clock denominator), sum the durations of
    its TILING stages (encode/decode/route/txn_start/append/replicate/
    apply — non-overlapping by construction) and divide by the client
    wall.  A coverage near 1.0 means the table explains where the latency
    goes; the residual is event-loop scheduling plus (over real sockets)
    wire time.  ``server.replicate``'s sub-stages (``replicate.*``) tile
    it, so they stay out of the sum.  Counter records, where the snapshot
    has them, become a ``counters`` table (site -> count)."""
    by_stage: dict[int, list[int]] = {s: [] for s in range(NUM_STAGES)}
    client_wall: dict[int, int] = {}
    covered: dict[int, int] = {}
    counters: dict[str, int] = {}
    for rec in records:
        tid, stage, _t0, dur = rec[0], rec[1], rec[2], rec[3]
        if stage == STAGE_COUNTER:
            site = HOP_SITES[rec[5]]
            counters[site] = counters.get(site, 0) + rec[4]
            continue
        by_stage[stage].append(dur)
        if stage == STAGE_CLIENT and tid:
            client_wall[tid] = client_wall.get(tid, 0) + dur
        elif stage in _TILING and tid:
            covered[tid] = covered.get(tid, 0) + dur

    stages = {}
    for stage in range(NUM_STAGES):
        durs = by_stage[stage]
        if not durs:
            continue
        durs.sort()
        stages[STAGE_NAMES[stage]] = {
            "count": len(durs),
            "p50_us": round(_percentile(durs, 0.50), 1),
            "p90_us": round(_percentile(durs, 0.90), 1),
            "p99_us": round(_percentile(durs, 0.99), 1),
            "mean_us": round(sum(durs) / len(durs) / 1e3, 1),
            "total_ms": round(sum(durs) / 1e6, 2),
            "overlap": stage not in _TILING and stage != STAGE_CLIENT,
        }

    wall_ns = sum(client_wall.values())
    covered_ns = sum(covered.get(tid, 0) for tid in client_wall)
    out = {
        "traced_requests": len(client_wall),
        "wall_ms_total": round(wall_ns / 1e6, 2),
        "covered_ms_total": round(covered_ns / 1e6, 2),
        "coverage": round(covered_ns / wall_ns, 3) if wall_ns else 0.0,
        "stages": stages,
    }
    if counters:
        out["counters"] = counters
    return out


def to_chrome_trace(records) -> dict:
    """Chrome trace-event JSON object (Perfetto-loadable).

    One complete event per span; per-request spans land on a track (tid)
    per trace id so a request's stages read as one lane, process-level
    spans (trace id 0) on track 0.  Every event carries the recording
    process id and — when the runtime runs sharded event loops
    (raft.tpu.server.loop-shards) — the origin loop thread, compressed to
    a small per-process shard ordinal, so a cross-shard/cross-process
    merge stays attributable.  A counter record is a counter event
    (``"ph": "C"``) named by its site, its value the count."""
    import os
    pid = os.getpid()
    events = []
    shard_of: dict[int, int] = {}
    for rec in records:
        tid, stage, t0, dur, tag = rec[0], rec[1], rec[2], rec[3], rec[4]
        origin = rec[5] if len(rec) > 5 else 0
        if stage == STAGE_COUNTER:
            site = HOP_SITES[origin]
            events.append({"name": site, "cat": "hostpath", "ph": "C",
                           "ts": t0 / 1e3, "pid": pid,
                           "args": {site: tag}})
            continue
        shard = shard_of.setdefault(origin, len(shard_of)) if origin else 0
        events.append({
            "name": STAGE_NAMES[stage],
            "cat": "hostpath",
            "ph": "X",
            "ts": t0 / 1e3,         # microseconds since monotonic epoch
            "dur": max(dur, 1) / 1e3,
            "pid": pid,
            "tid": tid,
            "args": {"trace_id": tid, "tag": tag, "loop_shard": shard},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, records) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records), f)
    return path


def merge_chrome_traces(traces: "list[dict]") -> dict:
    """Fold per-process Chrome trace exports into ONE cluster trace.

    Every event already carries the recording process id (``pid``), so a
    merge is a concatenation: Perfetto renders one process group per pid
    with that process's per-request tracks inside it.  Malformed inputs
    (a child that crashed mid-write) contribute nothing rather than
    poisoning the merged artifact."""
    events: list = []
    for trace in traces:
        if isinstance(trace, dict):
            evs = trace.get("traceEvents")
            if isinstance(evs, list):
                events.extend(evs)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_chrome_trace_files(paths: "list[str]", out_path: str) -> dict:
    """Read per-process trace files (skipping unreadable ones), merge,
    write the cluster trace to ``out_path``, and return the merged dict."""
    traces = []
    for path in paths:
        try:
            with open(path) as f:
                traces.append(json.load(f))
        except (OSError, ValueError):
            continue
    merged = merge_chrome_traces(traces)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged
