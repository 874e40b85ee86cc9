"""The median ack batch an engine dispatch carried in the window
(``ackBatchSize``, a fresh histogram opened at the window's start on each
server), over every server's samples pooled; None without a dispatch."""

from benchmark.window import percentile


def read(records: dict, config: dict):
    samples = [x for r in records["servers"] for x in r["ack_batches"]]
    return percentile(samples, 0.5) if samples else None
