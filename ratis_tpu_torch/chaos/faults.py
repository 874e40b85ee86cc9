"""Typed fault-step vocabulary shared by scenarios, the runner, and
replay artifacts.

A scenario is a SCHEDULE: a tuple of :class:`Step` records, each an
``(at_s, op, target, args)`` quadruple resolved deterministically from
the scenario seed at BUILD time.  Targets are symbolic (``"leader"``,
``"follower:0"``, ``"server:2"``) because the concrete leader is runtime
state; the schedule itself — what fault, against which role, when, with
which parameters — is a pure function of ``(scenario name, seed,
config)``, which is what makes a recorded campaign artifact replayable
bit-for-bit (``tools/chaos_replay.py`` re-derives the schedule and
asserts equality before re-running it).

Ops (applied by :class:`ratis_tpu_torch.chaos.scenario.ScenarioRunner`):

========================  ====================================================
``partition``             full bidirectional partition; ``args["side"]`` is a
                          symbolic peer set (``"leader"`` / ``"minority"``)
``block``                 directed blackhole target -> ``args["dst"]``
                          (either side may be ``"*"``)
``link``                  degrade target's inbound links:
                          ``latency_ms`` / ``jitter_ms`` / ``drop_rate``
``kill``                  close the target server (crash)
``restart``               restart the most recently killed server;
                          ``args["truncate_tail"]`` drops that many entries
                          off every group's durable log tail first
``slow_disk``             delay the LOG_SYNC injection point on the target
                          server by ``args["delay_ms"]`` per flush batch
``slow_follower``         delay the APPEND_ENTRIES injection point on the
                          target server by ``args["delay_ms"]`` per append
``heal``                  clear every link fault and injection delay
========================  ====================================================
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Optional

OPS = ("partition", "block", "link", "kill", "restart", "slow_disk",
       "slow_follower", "heal")


@dataclasses.dataclass(frozen=True)
class Step:
    at_s: float  # offset from scenario start (deterministic from seed)
    op: str
    target: str = ""       # symbolic: leader / follower:<k> / server:<k>
    args: tuple = ()       # sorted (key, value) pairs — hashable + JSON-safe

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default

    def to_json(self) -> dict:
        return {"at_s": self.at_s, "op": self.op, "target": self.target,
                "args": dict(self.args)}

    @staticmethod
    def from_json(d: dict) -> "Step":
        return Step(float(d["at_s"]), d["op"], d.get("target", ""),
                    tuple(sorted(d.get("args", {}).items())))


def make_step(at_s: float, op: str, target: str = "", **args) -> Step:
    if op not in OPS:
        raise ValueError(f"unknown chaos op {op!r}; known: {OPS}")
    return Step(round(float(at_s), 4), op, target,
                tuple(sorted(args.items())))


# --------------------------------------------------- tail log truncation

_CLOSED_RE = re.compile(r"^log_(\d+)-(\d+)$")
_OPEN_RE = re.compile(r"^log_inprogress_(\d+)$")


def truncate_log_tail(current_dir: "pathlib.Path | str",
                      entries: int) -> int:
    """Drop the last ``entries`` records off a CLOSED server's segmented
    log on disk (the crash-with-lost-tail fault: the process died before
    its final appends became durable, or the disk lost its write-back
    cache).  Operates on the ``current/`` storage directory of one group;
    returns how many records were actually removed.  Only whole records
    go — the file stays structurally valid, so recovery treats it as a
    short log, not a corrupt one (the INCONSISTENCY/rewind path, not the
    checksum path)."""
    from ratis_tpu_torch.server.log.segmented import read_records
    d = pathlib.Path(current_dir)
    segs = []
    for f in d.iterdir():
        m = _CLOSED_RE.match(f.name) or _OPEN_RE.match(f.name)
        if m:
            segs.append((int(m.group(1)), f))
    segs.sort()
    removed = 0
    for _start, path in reversed(segs):
        if removed >= entries:
            break
        payloads, _good = read_records(path)
        keep = max(0, len(payloads) - (entries - removed))
        removed += len(payloads) - keep
        if keep == 0:
            path.unlink()
            continue
        # rebuild the file up to the kept prefix (records are
        # length-prefixed; re-walk to the keep'th record boundary)
        from ratis_tpu_torch.server.log.segmented import (MAGIC, _REC_HDR)
        data = path.read_bytes()
        off = len(MAGIC)
        for _ in range(keep):
            ln, _crc = _REC_HDR.unpack_from(data, off)
            off += _REC_HDR.size + ln
        new_path = path
        m = _CLOSED_RE.match(path.name)
        if m:
            # a truncated closed segment's name must match its new end
            # index or recovery rejects it; reopen it as inprogress (the
            # shape a crashed writer leaves behind)
            new_path = path.with_name(f"log_inprogress_{m.group(1)}")
            path.rename(new_path)
        with open(new_path, "r+b") as fh:
            fh.truncate(off)
    return removed


def find_group_current_dirs(storage_root: "pathlib.Path | str"
                            ) -> list[pathlib.Path]:
    """Every group's ``current/`` log directory under one server's
    storage root (the truncation fan-out for multi-group servers)."""
    root = pathlib.Path(storage_root)
    if not root.exists():
        return []
    return sorted(p for p in root.glob("*/current") if p.is_dir())


# ------------------------------------------ shared log plane truncation

_SH_SEALED_RE = re.compile(r"^shared_(\d+)$")
_SH_OPEN_RE = re.compile(r"^shared_inprogress_(\d+)$")


def find_shared_shard_dirs(storage_root: "pathlib.Path | str"
                           ) -> list[pathlib.Path]:
    """Every per-shard interleaved segment directory under one server's
    storage root (``_sharedlog/shard-<k>``; raft.tpu.log.shared mode)."""
    root = pathlib.Path(storage_root)
    if not root.exists():
        return []
    return sorted(p for p in root.glob("_sharedlog/shard-*") if p.is_dir())


def truncate_shared_log_tail(shard_dir: "pathlib.Path | str",
                             records: int) -> int:
    """Drop the last ``records`` records off a CLOSED server's shared
    (interleaved) log shard on disk — the same lost-write-back-cache
    crash as :func:`truncate_log_tail`, but against the one per-shard
    segment sequence every co-located group appends into.  The chopped
    tail interleaves MANY groups' entries and control records, so one
    fault rewinds an arbitrary subset of the shard's groups at once.
    Only whole records go — recovery sees a short stream, not a torn
    one."""
    from ratis_tpu_torch.server.log.segmented import MAGIC, _REC_HDR, read_records
    d = pathlib.Path(shard_dir)
    segs = []
    for f in d.iterdir():
        m = _SH_SEALED_RE.match(f.name) or _SH_OPEN_RE.match(f.name)
        if m:
            segs.append((int(m.group(1)), f))
    segs.sort()
    removed = 0
    for _n, path in reversed(segs):
        if removed >= records:
            break
        payloads, _good = read_records(path)
        keep = max(0, len(payloads) - (records - removed))
        removed += len(payloads) - keep
        if keep == 0:
            path.unlink()
            continue
        data = path.read_bytes()
        off = len(MAGIC)
        for _ in range(keep):
            ln, _crc = _REC_HDR.unpack_from(data, off)
            off += _REC_HDR.size + ln
        with open(path, "r+b") as fh:
            fh.truncate(off)
    return removed
