"""A run's window: its length, the servers' counters over it (each
server's report holds its counters at the window's start and at its
end), the client operations sent and answered in it, and percentiles."""


def delta(report: dict, key: str) -> float:
    w = report["window"]
    return w["end"][key] - w["start"][key]


def total(records: dict, key: str) -> float:
    return sum(delta(r, key) for r in records["servers"])


def window_s(records: dict) -> float:
    w0, w1 = records["window"]
    return w1 - w0


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (q in (0, 1]) of ``values``."""
    import math
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def operations(records: dict) -> list:
    """Every client operation's record: [kind, group, send, reply, ok,
    answer], times on the host's monotonic clock."""
    return [rec for res in records["clients"]
            for recs in res["ops"].values() for rec in recs]


def latencies_ms(records: dict, kind: str) -> list[float]:
    """Send to answer of every ``kind`` operation sent in the window; an
    operation without a successful answer counts as its wait to the end
    of the drain, which is above every answered one."""
    w0, w1 = records["window"]
    drain_end = w1 + records["drain_s"]
    return [((reply if ok else drain_end) - send) * 1e3
            for k, _, send, reply, ok, _ in operations(records)
            if k == kind and w0 <= send < w1]
