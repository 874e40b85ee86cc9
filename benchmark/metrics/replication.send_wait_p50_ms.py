"""The median of ``replicate.send_wait`` over every server's window, in
ms: from the entry's append on the leader to the first envelope (or
unary AppendEntries) that carries it being handed to the transport.  One
of the three waits that tile ``server.replicate`` (``trace/``, every
16th write's spans in each server's window).  None where no server
recorded the stage."""

import json

from benchmark.window import percentile

SEND_WAIT = 13  # trace/tracer.py STAGE_SEND_WAIT


def read(records: dict, config: dict):
    durations_ns = []
    for r in records["servers"]:
        if r.get("spans_path"):
            with open(r["spans_path"]) as f:
                durations_ns += [rec[3] for rec in json.load(f)
                                 if rec[1] == SEND_WAIT]
    if not durations_ns:
        return None
    return percentile(durations_ns, 0.5) / 1e6
