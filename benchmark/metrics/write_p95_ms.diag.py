"""The 95th percentile (nearest rank) of send to answer over every write
sent in the traced run's window, in ms; a write without a successful
answer counts as its wait to the end of the drain.  A per-layer metric:
its spread between runs on the card host is too wide for a bound (PERF.md
section 2)."""

from benchmark.generator import WRITE
from benchmark.window import latencies_ms, percentile


def read(records: dict, config: dict):
    writes = latencies_ms(records, WRITE)
    return percentile(writes, 0.95) if writes else None
