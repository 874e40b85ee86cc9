"""The 99th percentile (nearest rank) of ``loop.lag`` over every server's
window, in ms: how late each wake of the pause monitor's sentinel
(``server/pause_monitor.py``, every 100 ms) came, the loop's lag.  None
where no server recorded the stage."""

import json

from benchmark.window import percentile

LOOP_LAG = 19  # trace/tracer.py STAGE_LOOP_LAG


def read(records: dict, config: dict):
    lags_ns = []
    for r in records["servers"]:
        if r.get("spans_path"):
            with open(r["spans_path"]) as f:
                lags_ns += [rec[3] for rec in json.load(f)
                            if rec[1] == LOOP_LAG]
    if not lags_ns:
        return None
    return percentile(lags_ns, 0.99) / 1e6
