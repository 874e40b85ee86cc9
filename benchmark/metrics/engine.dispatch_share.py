"""The busiest server's share of the window spent in engine dispatches
(the ``dispatchLatency`` timer's seconds: pack, upload, the kernel, the
output's download, on the host's clock), in percent."""

from benchmark.window import delta, window_s


def read(records: dict, config: dict):
    spent = [delta(r, "dispatch_s") for r in records["servers"]]
    return 100.0 * max(spent) / window_s(records)
