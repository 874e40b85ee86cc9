"""The share of the window in which no operation ran on the card, in
percent: one minus the union of every server process's device intervals
(kernels, copies, sets) in its window-long ``torch.profiler`` trace, over
the window."""

from benchmark.window import window_s
from benchmark.tracefile import device_busy_s


def read(records: dict, config: dict):
    busy = device_busy_s(records)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / window_s(records))
