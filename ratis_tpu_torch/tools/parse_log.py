"""Segment-file dumper (reference ratis-tools ParseRatisLog.java:33):
decode a ``log_<s>-<e>`` / ``log_inprogress_<s>`` file and print each
entry's term/index/kind + a payload preview; also verifies record CRCs.

Usage: python -m ratis_tpu_torch.tools.parse_log <segment-file> [...]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from ratis_tpu_torch.protocol.logentry import LogEntry, LogEntryKind
from ratis_tpu_torch.server.log.segmented import read_records


def dump_segment(path: str, out: Callable[[str], None] = print,
                 sm_format: Optional[Callable[[bytes], str]] = None) -> int:
    """Print every entry in one segment file; returns the entry count."""
    import os
    import pathlib
    payloads, good_len = read_records(pathlib.Path(path))
    file_size = os.path.getsize(path)
    out(f"# {path}: {len(payloads)} entries, {good_len}/{file_size} "
        f"valid bytes{' (TRUNCATED TAIL)' if good_len < file_size else ''}")
    count = 0
    for raw in payloads:
        entry = LogEntry.from_bytes(raw)
        if entry.kind == LogEntryKind.STATE_MACHINE and entry.smlog is not None:
            data = entry.smlog.log_data
            body = (sm_format(data) if sm_format is not None
                    else repr(data[:64]) + ("..." if len(data) > 64 else ""))
            detail = f"client={entry.smlog.client_id.hex()[:8]} " \
                     f"call={entry.smlog.call_id} data={body}"
        elif entry.kind == LogEntryKind.CONFIGURATION and entry.conf is not None:
            detail = "peers=[" + ", ".join(
                str(p.id) for p in entry.conf.peers) + "]"
            if entry.conf.old_peers:
                detail += " old=[" + ", ".join(
                    str(p.id) for p in entry.conf.old_peers) + "]"
        elif entry.kind == LogEntryKind.METADATA:
            detail = f"commitIndex={entry.commit_index}"
        else:
            detail = ""
        out(f"(t:{entry.term}, i:{entry.index}) {entry.kind.name} {detail}")
        count += 1
    return count


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    total = 0
    for path in argv:
        try:
            total += dump_segment(path)
        except Exception as e:
            print(f"error reading {path}: {e}", file=sys.stderr)
            return 1
    print(f"# total {total} entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
