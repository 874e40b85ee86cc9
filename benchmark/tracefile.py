"""Reading the server processes' ``torch.profiler`` traces.

Each server of a traced run writes one Chrome trace of its own session,
which covers the measured window.  Event times there are microseconds
from the trace's ``baseTimeNanoseconds``, on the wall clock; the window is
on the monotonic clock, and each server's report carries the offset
between the two (``clock_offset_s``), so every interval below is clipped
to the window.
"""

from __future__ import annotations

import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver", "python_function")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def events(records: dict, categories) -> list[tuple[float, float, str, int]]:
    """Every complete event of ``categories`` in every server's trace, as
    (start s, end s, name, server index) on the monotonic clock, clipped
    to the window; servers that wrote no trace add nothing."""
    w0, w1 = records["window"]
    out = []
    for rep in records["servers"]:
        path = rep.get("profile_path")
        if not path:
            continue
        trace = load(path)
        base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
        shift = base_us / 1e6 - rep["clock_offset_s"]
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X" or e.get("cat") not in categories:
                continue
            t0 = e["ts"] / 1e6 + shift
            t1 = t0 + e.get("dur", 0) / 1e6
            t0, t1 = max(t0, w0), min(t1, w1)
            if t1 > t0:
                out.append((t0, t1, e.get("name", "?"), rep["index"]))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    merged: list[list[float]] = []
    for t0, t1 in sorted((i[0], i[1]) for i in intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def device_busy_s(records: dict) -> float | None:
    """Seconds of the window in which some operation ran on the card, in
    any server process; None where no server wrote a trace."""
    if not any(rep.get("profile_path") for rep in records["servers"]):
        return None
    return sum(b - a for a, b in union(events(records, DEVICE_CATEGORIES)))


def breakdown(records: dict, top: int = 10) -> dict:
    """The device operations that took most time (name, seconds summed
    over every server) and the longest idle gaps of the card, each named
    by the innermost host-side profiler event that spans its middle in
    some server, or by the Python the servers' loops ran outside any."""
    dev = events(records, DEVICE_CATEGORIES)
    by_name: dict[str, float] = {}
    for t0, t1, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = records["window"]
    busy = union(dev)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)), reverse=True)[:top]
    host = events(records, HOST_CATEGORIES)
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inside = [(t1 - t0, name) for t0, t1, name, _ in host
                  if t0 <= mid <= t1]
        label = (f"host: {min(inside)[1]}" if inside
                 else "host: Python on the servers' loops, no torch call")
        named.append([label, length])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
