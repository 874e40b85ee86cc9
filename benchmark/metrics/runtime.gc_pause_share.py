"""The largest share of the window that one server process spent in the
collector, in percent: its ``gc_ns`` count (``metrics/hops.py``, every
collection's time by the tracer's ``gc.callbacks`` hook, carried as a
counter record in the server's window spans) over the window.  None
where no server recorded the count."""

import json

from benchmark.window import window_s

COUNTER = 21  # trace/tracer.py STAGE_COUNTER
GC_NS = 9  # its index in metrics/hops.py HOP_SITES


def read(records: dict, config: dict):
    spent_ns = []
    for r in records["servers"]:
        if r.get("spans_path"):
            with open(r["spans_path"]) as f:
                spent_ns += [rec[4] for rec in json.load(f)
                             if rec[1] == COUNTER and rec[5] == GC_NS]
    if not spent_ns:
        return None
    return 100.0 * max(spent_ns) / 1e9 / window_s(records)
