"""The median of ``replicate.quorum`` over every server's window, in ms:
from the entry's hand-off to the transport to the leader seeing it
committed (the ack intake whose inline commit advance covers it, or the
tick's commit event).  One of the three waits that tile
``server.replicate`` (``trace/``, every 16th write's spans in each
server's window).  None where no server recorded the stage."""

import json

from benchmark.window import percentile

QUORUM = 14  # trace/tracer.py STAGE_QUORUM


def read(records: dict, config: dict):
    durations_ns = []
    for r in records["servers"]:
        if r.get("spans_path"):
            with open(r["spans_path"]) as f:
                durations_ns += [rec[3] for rec in json.load(f)
                                 if rec[1] == QUORUM]
    if not durations_ns:
        return None
    return percentile(durations_ns, 0.5) / 1e6
