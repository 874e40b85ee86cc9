"""Coalesced socket writes per commit advance over the window: every
server's ``transport_flush`` count (``metrics/hops.py``, one a flush of
``transport/coalesce.py``, carried as a counter record in the server's
window spans) summed, over the engines' ``commit_advances`` summed.  None
where no server recorded the count, or nothing committed."""

import json

from benchmark.window import total

COUNTER = 21  # trace/tracer.py STAGE_COUNTER
TRANSPORT_FLUSH = 7  # its index in metrics/hops.py HOP_SITES


def read(records: dict, config: dict):
    flushes = None
    for r in records["servers"]:
        if r.get("spans_path"):
            with open(r["spans_path"]) as f:
                for rec in json.load(f):
                    if rec[1] == COUNTER and rec[5] == TRANSPORT_FLUSH:
                        flushes = (flushes or 0) + rec[4]
    commits = total(records, "commit_advances")
    if flushes is None or commits <= 0:
        return None
    return flushes / commits
