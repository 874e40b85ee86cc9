"""The ``server.replicate`` stage's median (append done to apply start on
the leader, ``trace/``, every 16th request's spans in every server's
window) over the median write of the window (send to answer in the client
processes), in percent: how much of a write's time waits on replication.
None where no server recorded the stage."""

import json

from benchmark.generator import WRITE
from benchmark.window import latencies_ms, percentile

REPLICATE = 7  # trace/tracer.py STAGE_REPLICATE


def read(records: dict, config: dict):
    replicate_ns = []
    for r in records["servers"]:
        if r.get("spans_path"):
            with open(r["spans_path"]) as f:
                replicate_ns += [rec[3] for rec in json.load(f)
                                 if rec[1] == REPLICATE]
    writes = latencies_ms(records, WRITE)
    if not replicate_ns or not writes:
        return None
    return 100.0 * percentile(replicate_ns, 0.5) / 1e6 / percentile(writes,
                                                                    0.5)
