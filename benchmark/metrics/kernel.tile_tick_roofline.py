"""``tile_tick``'s share of its roofline over the window, in percent: the
least time its launches' work could take on the card over the time they
took (every ``tile_tick`` kernel event in every server's window-long
``torch.profiler`` trace).

The work is counted from what the window's ticks had to do, the same
whatever implements them: on each server every launch reads each hosted
group's row once (its members' match, ack and three membership masks:
11 bytes a member; role, flush, commit, first index and deadline: 17
bytes a row), the launch's 8 bytes of time and timeout, and writes the
[4, G] output for those rows (16 bytes a row); every ack event the engine
landed in the window is read once (7 int32 columns: 28 bytes), and every
refreshed row once more (its row again, and its 4-byte index).  Integer
operations: a member's rank among its row's members (4 m^2 a row) and 64
for the row's commit, timeout and leadership arithmetic, 10 an event.
The bound is the larger of the bytes over the card's HBM bandwidth and
the operations over its int32 rate (``benchmark/peaks.py``); changed
state written back is not counted, so the bound is a floor.  None where
no server traced a ``tile_tick``."""

from benchmark import peaks
from benchmark.window import delta
from benchmark.tracefile import DEVICE_CATEGORIES, events


def read(records: dict, config: dict):
    ticks = [e for e in events(records, DEVICE_CATEGORIES)
             if "tile_tick" in e[2]]
    if not ticks:
        return None
    m = config["peers_per_group"]
    row = 11 * m + 17
    nbytes = ops = 0.0
    for r in records["servers"]:
        launches = sum(1 for e in ticks if e[3] == r["index"])
        rows = r["engine"]["live_rows"]
        acks = delta(r, "acks")
        nbytes += (launches * (rows * (row + 16) + 8) + 28 * acks
                   + delta(r, "refresh_rows") * (row + 4))
        ops += launches * rows * (4 * m * m + 64) + 10 * acks
    bound_s = max(nbytes / peaks.HBM_BYTES_PER_S,
                  ops / peaks.INT32_OPS_PER_S)
    return 100.0 * bound_s / sum(e[1] - e[0] for e in ticks)
