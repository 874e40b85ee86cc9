"""Election timeouts fired in the window, summed over every division of
every server (``Division.election_metrics.timeout_count``).  Appointed
leaders under steady load should fire none; each one is a group that
stopped serving until its election ended."""

from benchmark.window import total


def read(records: dict, config: dict):
    return total(records, "election_timeouts")
