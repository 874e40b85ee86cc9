"""Reply-plane scheduling hops per commit advance over the window
(``metrics/hops.py`` ``reply_plane_hops``, process-wide, over the engine's
``commit_advances``), summed over the servers: one server a process, so
each process's hops are its server's."""

from benchmark.window import total


def read(records: dict, config: dict):
    commits = total(records, "commit_advances")
    if commits <= 0:
        return None
    return total(records, "reply_hops") / commits
