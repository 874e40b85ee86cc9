"""Shared multi-group segmented log: one per-shard segment sequence.

Per-group durability (segmented.py) gives every division its own segment
files, so one replication sweep over N groups costs N buffered writes and
— because the shared LogWorker fsyncs once per *distinct file* per drain —
N fsyncs.  At 1024 groups the mixed filestore rung is syscall-bound, not
hardware-bound (ROADMAP item 3).

This store interleaves ALL divisions pinned to one loop shard into a
single sequence of append-only segment files.  Every record carries its
owning group and group-local index, so a sweep's appends from any number
of groups land in ONE file: the per-device LogWorker issues one buffered
write + one fsync per drain regardless of group count (fsyncs/commit
~1/groups instead of ~1).

Layout (under the peer's storage root, sibling of the per-group dirs —
``scan_group_dirs`` skips it because the name is not a group uuid)::

    <root>/_sharedlog/shard-<k>/
        shared_<n>              sealed segments, n monotonic
        shared_inprogress_<n>   the open segment (at most one)

Record format — the segmented store's CRC frame with a shared header::

    file    := MAGIC record*
    record  := u32_le payload_len | u32_le crc32(payload) | payload
    payload := group_id[16] | group_index i64 | term i64 | rtype u8 | body

    rtype 0 ENTRY      body = LogEntry msgpack (sm-data excluded)
    rtype 1 TOMBSTONE  logical truncate: group drops entries >= group_index
    rtype 2 PURGE      group drops entries <= group_index (term records the
                       boundary so recovery can restore the below-start
                       TermIndex after a full purge)

A follower rewind (the windowed-rewind path) therefore never rewrites
shared bytes: truncate appends a tombstone and drops in-memory tail state;
the dead records stay on disk until compaction.  Recovery rebuilds every
group's index in ONE forward scan of the shard's segments, replaying
records in file order: an entry at an already-held index implies
truncate-then-append (the follower conflict rule), tombstones and purges
apply as above, and a torn tail of the open segment is truncated away.

Each division's :class:`SharedGroupLog` keeps a dense in-memory index
(term + (segment, offset, len) per entry) serving the RaftLog read/term/
truncate API unchanged; entry payloads are cached until applied+flushed
and re-read from the shard file via ``os.pread`` afterwards (record-sized
reads, no whole-segment faulting, thread-safe for off-loop prefetch).

Compaction: tombstones/purges/overwrites mark the victim records' bytes
dead per segment.  When a sealed segment's dead ratio crosses the
configured threshold it is rewritten in place (tmp + rename) keeping live
entries and all control records — dropping a tombstone would let the
stale entries it killed in an *earlier* segment resurrect on replay, so
control records (a few dozen bytes each) are retained until their segment
retires entirely.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pathlib
import re
import struct
from typing import Optional

LOG = logging.getLogger(__name__)

from ratis_tpu_torch.protocol.exceptions import (ChecksumException,
                                           RaftLogIOException)
from ratis_tpu_torch.protocol.logentry import LogEntry
from ratis_tpu_torch.protocol.termindex import INVALID_LOG_INDEX, TermIndex
from ratis_tpu_torch.server.log.base import RaftLog
from ratis_tpu_torch.server.log.segmented import (MAGIC, _REC_HDR, LogWorker,
                                            encode_record, read_records)

_SH_HDR = struct.Struct("<16sqqB")

REC_ENTRY = 0
REC_TOMBSTONE = 1
REC_PURGE = 2

_SEALED_RE = re.compile(r"^shared_(\d+)$")
_OPEN_RE = re.compile(r"^shared_inprogress_(\d+)$")

SHARED_DIR = "_sharedlog"


def shard_dir(storage_root: "str | pathlib.Path", shard: int) -> pathlib.Path:
    return pathlib.Path(storage_root) / SHARED_DIR / f"shard-{shard}"


def encode_shared(gid: bytes, index: int, term: int, rtype: int,
                  body: bytes = b"") -> bytes:
    return encode_record(_SH_HDR.pack(gid, index, term, rtype) + body)


def decode_shared(payload: bytes) -> tuple[bytes, int, int, int, bytes]:
    gid, index, term, rtype = _SH_HDR.unpack_from(payload, 0)
    return gid, index, term, rtype, payload[_SH_HDR.size:]


class _GroupState:
    """Dense per-group index: term + file location of each entry from
    ``first``.  Entry payloads live in the owning SharedGroupLog's cache."""

    __slots__ = ("first", "terms", "locs", "below_start")

    def __init__(self) -> None:
        self.first = 0
        self.terms: list[int] = []
        # (segment_number, record_offset, record_len) per entry
        self.locs: list[tuple[int, int, int]] = []
        self.below_start: Optional[TermIndex] = None

    @property
    def count(self) -> int:
        return len(self.terms)

    @property
    def last(self) -> int:
        return self.first + len(self.terms) - 1


class _ScanState:
    """Boot-scan working state: index -> (term, loc), hole-tolerant.

    Compaction can remove a dead record before the control record that
    killed it appears in scan order, so mid-scan the recovered index may
    have transient holes; they must all be closed by the time the stream
    ends (see ``SharedLogStore._finalize_group``)."""

    __slots__ = ("entries", "below_start")

    def __init__(self) -> None:
        self.entries: dict[int, tuple[int, tuple[int, int, int]]] = {}
        self.below_start: Optional[TermIndex] = None


class SharedLogStore:
    """One interleaved segment sequence per (server, loop shard).

    All file appends funnel through the shard's LogWorker into the single
    open segment, so one worker drain = one buffered write + one fsync for
    every division on the shard.  Divisions acquire/release the store; the
    first acquire runs the recovery scan, the last release drains and
    closes.  All mutating methods run on the shard's event loop (every
    division of a shard lives there); only ``read_record`` is
    thread-safe for off-loop reads.
    """

    def __init__(self, directory: "str | pathlib.Path", worker: LogWorker,
                 segment_size_max: int = 32 << 20,
                 compaction_dead_ratio: float = 0.5,
                 name: str = "shared", on_final_release=None):
        self.dir = pathlib.Path(directory)
        self.worker = worker
        self.segment_size_max = segment_size_max
        self.compaction_dead_ratio = compaction_dead_ratio
        self.name = name
        # invoked once the last division releases and the store has closed
        # (the owning server drops its registry entry; a re-added group
        # then gets a FRESH store instead of this closed one)
        self._on_final_release = on_final_release
        self._opened = False
        self._refs = 0
        self._open_file = None
        self._open_path: Optional[pathlib.Path] = None
        self._open_seg = -1
        self._open_size = 0
        self._next_seg = 0
        self._sealed: dict[int, pathlib.Path] = {}
        self._sizes: dict[int, int] = {}      # sealed segment byte sizes
        self._dead: dict[int, int] = {}       # dead ENTRY bytes per segment
        self._sealing_seg = -1                # mid-seal: compaction keep-out
        self._recovered: dict[bytes, _GroupState] = {}
        self._groups: dict[bytes, "SharedGroupLog"] = {}
        self._roll_lock = asyncio.Lock()
        self._compact_task: Optional[asyncio.Task] = None
        import threading
        self._fd_lock = threading.Lock()
        self._fds: dict[int, int] = {}
        from ratis_tpu_torch.metrics import SharedLogMetrics
        self.metrics = SharedLogMetrics(name)
        self.metrics.add_store_gauges(
            lambda: self.total_bytes,
            lambda: len(self.worker._queue))

    # ------------------------------------------------------------ lifecycle

    def acquire(self, glog: "SharedGroupLog") -> None:
        self._refs += 1
        self._groups[glog.gid] = glog
        if not self._opened:
            self._opened = True
            self.worker.acquire()
            self._recover()

    async def release(self, glog: "SharedGroupLog") -> None:
        self._groups.pop(glog.gid, None)
        self._refs -= 1
        if self._refs > 0 or not self._opened:
            return
        self._opened = False
        if self._compact_task is not None:
            self._compact_task.cancel()
            try:
                await self._compact_task
            except BaseException:
                pass
            self._compact_task = None
        await self.worker.drain()
        if self._open_file is not None:
            self._open_file.close()
            self._open_file = None
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()
        await self.worker.release()
        self.metrics.unregister()
        if self._on_final_release is not None:
            self._on_final_release()

    @property
    def total_bytes(self) -> int:
        return sum(self._sizes.values()) + (
            self._open_size if self._open_file is not None else 0)

    # ------------------------------------------------------------- recovery

    def take_recovered(self, gid: bytes) -> _GroupState:
        return self._recovered.pop(gid, None) or _GroupState()

    def _recover(self) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        found: list[tuple[int, bool, pathlib.Path]] = []
        for f in self.dir.iterdir():
            m = _SEALED_RE.match(f.name)
            if m:
                found.append((int(m.group(1)), False, f))
                continue
            m = _OPEN_RE.match(f.name)
            if m:
                found.append((int(m.group(1)), True, f))
        found.sort(key=lambda x: x[0])

        states: dict[bytes, _ScanState] = {}
        for pos, (n, was_open, path) in enumerate(found):
            payloads, good_len = read_records(path)
            file_size = path.stat().st_size
            if good_len < file_size:
                if not was_open:
                    raise ChecksumException(
                        f"{self.name}: corrupt sealed segment {path.name}",
                        good_len)
                with open(path, "r+b") as fh:
                    fh.truncate(good_len)
                file_size = good_len
            off = len(MAGIC)
            for p in payloads:
                self._replay(states, n, off, _REC_HDR.size + len(p), p)
                off += _REC_HDR.size + len(p)
            last = pos == len(found) - 1
            if was_open and last:
                self._open_path = path
                self._open_file = open(path, "ab")
                self._open_seg = n
                self._open_size = file_size
            else:
                if was_open:
                    # defensive: only the newest segment may stay open
                    sealed = path.with_name(f"shared_{n}")
                    os.replace(path, sealed)
                    path = sealed
                self._sealed[n] = path
                self._sizes[n] = file_size
            self._next_seg = max(self._next_seg, n + 1)

        for gid, rst in states.items():
            self._recovered[gid] = self._finalize_group(gid, rst)

    def _replay(self, states: dict, seg_n: int, off: int, rec_len: int,
                payload: bytes) -> None:
        """Hole-tolerant replay of one record into the scan-time state.

        Compaction removes dead ENTRY records but keeps every control
        record, so the scan can meet a forward gap whose missing middle is
        killed only by a LATER tombstone/purge/overwrite.  The scan state
        is therefore an index->(term, loc) dict that tolerates transient
        holes; ``_finalize_group`` demands contiguity once the whole
        stream has been applied.
        """
        gid, index, term, rtype, body = decode_shared(payload)
        st = states.get(gid)
        if st is None:
            st = states[gid] = _ScanState()
        entries = st.entries
        if rtype == REC_ENTRY:
            if st.below_start is not None and index <= st.below_start.index:
                self._dead[seg_n] = self._dead.get(seg_n, 0) + rec_len
                return
            # an append at index means nothing above it survived the write
            self._scan_kill_from(st, index)
            entries[index] = (term, (seg_n, off, rec_len))
        elif rtype == REC_TOMBSTONE:
            self._scan_kill_from(st, index)
        elif rtype == REC_PURGE:
            if st.below_start is not None and index <= st.below_start.index:
                return  # stale marker must not regress the boundary
            for i in list(entries):
                if i <= index:
                    _, (sn, _o, rl) = entries.pop(i)
                    self._dead[sn] = self._dead.get(sn, 0) + rl
            st.below_start = TermIndex(term, index)

    def _scan_kill_from(self, st: "_ScanState", index: int) -> None:
        """Drop scan-state entries >= index, charging their bytes dead."""
        for i in list(st.entries):
            if i >= index:
                _, (sn, _o, rl) = st.entries.pop(i)
                self._dead[sn] = self._dead.get(sn, 0) + rl

    def _finalize_group(self, gid: bytes, rst: "_ScanState") -> _GroupState:
        """Collapse the hole-tolerant scan state into the dense runtime
        index; a hole that survived the whole stream is real loss."""
        st = _GroupState()
        st.below_start = rst.below_start
        if not rst.entries:
            st.first = (rst.below_start.index + 1
                        if rst.below_start is not None else 0)
            return st
        lo, hi = min(rst.entries), max(rst.entries)
        if hi - lo + 1 != len(rst.entries):
            missing = next(i for i in range(lo, hi + 1)
                           if i not in rst.entries)
            raise ChecksumException(
                f"{self.name}: group {gid.hex()} lost record {missing} "
                f"(recovered range {lo}..{hi} has holes)", missing)
        st.first = lo
        for i in range(lo, hi + 1):
            term, loc = rst.entries[i]
            st.terms.append(term)
            st.locs.append(loc)
        return st

    def _kill_tail(self, st: _GroupState, index: int) -> None:
        """Drop st's entries >= index, charging their bytes dead."""
        i = max(0, index - st.first)
        for seg_n, _, rec_len in st.locs[i:]:
            self._dead[seg_n] = self._dead.get(seg_n, 0) + rec_len
        del st.terms[i:]
        del st.locs[i:]

    def _kill_head(self, st: _GroupState, index: int) -> None:
        """Drop st's entries <= index, charging their bytes dead."""
        if not st.count:
            return
        k = min(index - st.first + 1, st.count)
        if k <= 0:
            return
        for seg_n, _, rec_len in st.locs[:k]:
            self._dead[seg_n] = self._dead.get(seg_n, 0) + rec_len
        del st.terms[:k]
        del st.locs[:k]
        st.first += k

    # --------------------------------------------------------------- append

    def _ensure_open(self) -> None:
        if self._open_file is not None:
            return
        n = self._next_seg
        self._next_seg += 1
        path = self.dir / f"shared_inprogress_{n}"
        path.write_bytes(MAGIC)
        self._open_file = open(path, "ab")
        self._open_path = path
        self._open_seg = n
        self._open_size = len(MAGIC)

    async def _seal_open_segment(self) -> None:
        if self._open_file is None:
            return
        # Detach FIRST: submissions racing the drain below (e.g. another
        # group's snapshot-boundary marker) must open the next segment, not
        # queue a write the sealed file will never see.  Register the
        # segment for reads immediately (under its pre-rename path) and
        # keep compaction off it until its queued writes land.
        f, n, path = self._open_file, self._open_seg, self._open_path
        self._open_file = None
        self._open_path = None
        self._sealing_seg = n
        self._sealed[n] = path
        self._sizes[n] = self._open_size
        await self.worker.drain()
        f.close()
        sealed = path.with_name(f"shared_{n}")
        os.replace(path, sealed)
        self._sealed[n] = sealed
        self._sealing_seg = -1
        # the fd cache keyed the inode, which rename preserves — keep it

    def submit_record(self, gid: bytes, index: int, term: int, rtype: int,
                      body: bytes = b"") -> tuple[asyncio.Future, int, int, int]:
        """Queue one record on the open segment WITHOUT rolling — the
        synchronous path for control records from non-async callers; size
        overshoot is corrected by the next append_record."""
        self._ensure_open()
        rec = encode_shared(gid, index, term, rtype, body)
        off = self._open_size
        fut = self.worker.submit(self._open_file, rec)
        self._open_size += len(rec)
        return fut, self._open_seg, off, len(rec)

    async def append_record(self, gid: bytes, index: int, term: int,
                            rtype: int, body: bytes = b"") \
            -> tuple[asyncio.Future, int, int, int]:
        if self._open_file is not None \
                and self._open_size > self.segment_size_max:
            async with self._roll_lock:
                # re-check: a concurrent appender may have rolled already.
                # While someone holds this lock awaiting the drain, every
                # other group's append blocks HERE (the size check stays
                # true until the roll resets it), so no new write can be
                # queued against the file being sealed.
                if self._open_file is not None \
                        and self._open_size > self.segment_size_max:
                    await self._seal_open_segment()
        return self.submit_record(gid, index, term, rtype, body)

    # ---------------------------------------------------------------- reads

    def _fd(self, seg_n: int) -> int:
        with self._fd_lock:
            fd = self._fds.get(seg_n)
            if fd is not None:
                return fd
        path = self._sealed.get(seg_n)
        if path is None:
            if seg_n == self._open_seg and self._open_path is not None:
                path = self._open_path
            else:
                raise RaftLogIOException(
                    f"{self.name}: no segment {seg_n}")
        fd = os.open(path, os.O_RDONLY)
        with self._fd_lock:
            prior = self._fds.setdefault(seg_n, fd)
        if prior is not fd:
            os.close(fd)
            return prior
        return fd

    def _drop_fd(self, seg_n: int) -> None:
        with self._fd_lock:
            fd = self._fds.pop(seg_n, None)
        if fd is not None:
            os.close(fd)

    def read_record(self, seg_n: int, offset: int, rec_len: int) -> bytes:
        """Read one record's payload (thread-safe, pread-based)."""
        import zlib
        buf = os.pread(self._fd(seg_n), rec_len, offset)
        if len(buf) < _REC_HDR.size:
            raise ChecksumException(
                f"{self.name}: short read at {seg_n}:{offset}", offset)
        ln, crc = _REC_HDR.unpack_from(buf, 0)
        payload = buf[_REC_HDR.size:_REC_HDR.size + ln]
        if len(payload) != ln or zlib.crc32(payload) != crc:
            raise ChecksumException(
                f"{self.name}: corrupt record at {seg_n}:{offset}", offset)
        return payload

    # ----------------------------------------------------------- compaction

    def maybe_compact(self) -> None:
        """Kick background compaction of the worst sealed segment when its
        dead ratio crosses the threshold (one compaction at a time)."""
        if not self._opened:
            return
        if self._compact_task is not None and not self._compact_task.done():
            return
        target, worst = -1, self.compaction_dead_ratio
        for n, size in self._sizes.items():
            if size <= len(MAGIC) or n == self._sealing_seg:
                continue
            ratio = self._dead.get(n, 0) / size
            if ratio >= worst:
                target, worst = n, ratio
        if target < 0:
            return
        self._compact_task = asyncio.create_task(
            self._compact(target), name=f"shared-log-compact-{self.name}")

    async def _compact(self, seg_n: int) -> None:
        try:
            await self._compact_impl(seg_n)
        except asyncio.CancelledError:
            raise
        except Exception:
            LOG.exception("%s: compaction of segment %d failed",
                          self.name, seg_n)

    async def _compact_impl(self, seg_n: int) -> None:
        """Rewrite sealed segment ``seg_n`` keeping live entries and all
        control records.  Appends continue concurrently (they only touch
        the open segment); liveness is re-validated on the loop after the
        off-loop file read, and relocation double-checks each entry still
        points at its old offset before moving it."""
        path = self._sealed.get(seg_n)
        if path is None:
            return
        # the control records that killed this segment's dead entries may
        # still sit unflushed in the open segment; they must hit the disk
        # BEFORE the rewrite does, or a crash could persist the compaction
        # while losing its justification (an unrecoverable boot-scan hole)
        await self.worker.drain()
        data = await asyncio.to_thread(path.read_bytes)
        out = bytearray(MAGIC)
        moves: list[tuple[bytes, int, int, int, int]] = []
        off = len(MAGIC)
        while off + _REC_HDR.size <= len(data):
            ln, _ = _REC_HDR.unpack_from(data, off)
            end = off + _REC_HDR.size + ln
            if end > len(data):
                break
            rec = data[off:end]
            gid, index, _, rtype, _ = decode_shared(rec[_REC_HDR.size:])
            keep = True
            if rtype == REC_ENTRY:
                glog = self._groups.get(gid)
                keep = glog is None or glog.loc_at(index) == (seg_n, off)
            if keep:
                new_off = len(out)
                out += rec
                if rtype == REC_ENTRY:
                    moves.append((gid, index, off, new_off, len(rec)))
            off = end

        old_size = self._sizes.get(seg_n, len(data))
        if len(out) >= old_size:
            return  # nothing reclaimable (raced with resurrection)
        tmp = path.with_name(path.name + ".compact")

        def _write():
            with open(tmp, "wb") as f:
                f.write(out)
                f.flush()
                os.fsync(f.fileno())

        await asyncio.to_thread(_write)
        os.replace(tmp, path)
        self._drop_fd(seg_n)
        self._sizes[seg_n] = len(out)
        dead = 0
        for gid, index, old_off, new_off, rec_len in moves:
            glog = self._groups.get(gid)
            if glog is not None and glog.relocate(index, seg_n, old_off,
                                                  new_off, rec_len):
                continue
            dead += rec_len  # died while we were rewriting
        self._dead[seg_n] = dead
        self.metrics.compaction_count.inc()
        self.metrics.compaction_reclaimed.inc(old_size - len(out))


class SharedGroupLog(RaftLog):
    """One division's RaftLog view over a SharedLogStore.

    The full (term, location) index stays in memory; payloads are cached
    from append until applied+flushed, then served by record-sized preads.
    Truncate appends a durable tombstone (shared bytes are never
    rewritten); purge/snapshot-boundary append a durable purge marker so
    the one-pass boot scan reconstructs the same state.
    """

    def __init__(self, name: str, gid: bytes, store: SharedLogStore):
        super().__init__(name)
        self.store = store
        self.gid = gid
        self._st = _GroupState()
        self._entries: dict[int, LogEntry] = {}
        self._flush_index = INVALID_LOG_INDEX
        self._failed: Optional[Exception] = None
        from ratis_tpu_torch.metrics import SegmentedRaftLogMetrics
        self.metrics = SegmentedRaftLogMetrics(name)

    @property
    def failed(self) -> bool:
        return self._failed is not None

    # ------------------------------------------------------------ open/close

    async def open(self, last_index_on_snapshot: int = INVALID_LOG_INDEX) -> None:
        await super().open(last_index_on_snapshot)
        self.store.acquire(self)
        self._st = self.store.take_recovered(self.gid)
        self._flush_index = self.next_index - 1

    async def close(self) -> None:
        await self.store.release(self)
        self.metrics.unregister()
        await super().close()

    # --------------------------------------------------------------- indices

    @property
    def start_index(self) -> int:
        st = self._st
        if st.count:
            return st.first
        if st.below_start is not None:
            return st.below_start.index + 1
        return 0

    @property
    def flush_index(self) -> int:
        return self._flush_index

    def get_last_entry_term_index(self) -> Optional[TermIndex]:
        st = self._st
        if st.count:
            return TermIndex(st.terms[-1], st.last)
        return st.below_start

    def get_term_index(self, index: int) -> Optional[TermIndex]:
        st = self._st
        i = index - st.first
        if st.count and 0 <= i < st.count:
            return TermIndex(st.terms[i], index)
        if st.below_start is not None and index == st.below_start.index:
            return st.below_start
        return None

    def loc_at(self, index: int) -> Optional[tuple[int, int]]:
        """(segment, offset) of a live entry, for compaction liveness."""
        st = self._st
        i = index - st.first
        if st.count and 0 <= i < st.count:
            seg_n, off, _ = st.locs[i]
            return seg_n, off
        return None

    def relocate(self, index: int, seg_n: int, old_off: int, new_off: int,
                 rec_len: int) -> bool:
        """Post-compaction pointer fixup; False if the entry died."""
        st = self._st
        i = index - st.first
        if st.count and 0 <= i < st.count \
                and st.locs[i] == (seg_n, old_off, rec_len):
            st.locs[i] = (seg_n, new_off, rec_len)
            return True
        return False

    # ----------------------------------------------------------------- reads

    def get(self, index: int) -> Optional[LogEntry]:
        st = self._st
        i = index - st.first
        if not st.count or not (0 <= i < st.count):
            return None
        e = self._entries.get(index)
        if e is None:
            self.metrics.cache_miss_count.inc()
            payload = self.store.read_record(*st.locs[i])
            _, ridx, _, rtype, body = decode_shared(payload)
            if ridx != index or rtype != REC_ENTRY:
                raise ChecksumException(
                    f"{self.name}: index {index} points at record "
                    f"({ridx}, rtype={rtype})", index)
            e = LogEntry.from_bytes(body)
        else:
            self.metrics.cache_hit_count.inc()
        return e

    # Record-sized preads make cold reads cheap enough to serve inline —
    # no whole-segment faulting, so the resident/prefault machinery the
    # segmented store needs (multi-MB synchronous loads) does not apply.
    def is_resident(self, index: int) -> bool:
        return True

    def prefault(self, index: int) -> None:
        pass

    def evict_cache(self, applied_index: int) -> int:
        """Drop payload cache at or below the applied frontier (the applier
        reads each entry once); only flushed entries are evictable — until
        the fsync their bytes may not be readable from the file."""
        limit = min(applied_index, self._flush_index)
        victims = [i for i in self._entries if i <= limit]
        for i in victims:
            del self._entries[i]
        if victims:
            self.metrics.cache_evict_count.inc(len(victims))
        return len(victims)

    # ---------------------------------------------------------------- append

    def _watch_control(self, fut: asyncio.Future) -> None:
        """Latch the failure latch if a control record's write fails."""
        def _done(f: asyncio.Future) -> None:
            if f.cancelled():
                return
            exc = f.exception()
            if exc is not None:
                first = self._failed is None
                self._failed = self._failed or exc
                if first and self._flush_err_cb is not None:
                    self._flush_err_cb(exc)
        fut.add_done_callback(_done)

    async def append_entry(self, entry: LogEntry, wait_flush: bool = True) -> int:
        with self.metrics.append_timer.time():
            return await self._append_entry_impl(entry, wait_flush)

    async def _append_entry_impl(self, entry: LogEntry,
                                 wait_flush: bool) -> int:
        if self._failed is not None:
            raise RaftLogIOException(
                f"{self.name}: log failed permanently") from self._failed
        expected = self.next_index
        if entry.index != expected:
            raise ValueError(f"{self.name}: appending index {entry.index}, "
                             f"expected {expected}")
        fut, seg_n, off, rec_len = await self.store.append_record(
            self.gid, entry.index, entry.term, REC_ENTRY,
            entry.to_bytes(include_sm_data=False))
        st = self._st
        if not st.count:
            st.first = entry.index
        st.terms.append(entry.term)
        st.locs.append((seg_n, off, rec_len))
        self._entries[entry.index] = entry
        index = entry.index

        # identical advance discipline to the per-group store: the worker
        # resolves a batch's futures in submit order, so flush_index stays
        # contiguous whether or not the caller awaits
        def _on_flush(f: asyncio.Future) -> None:
            if f.cancelled():
                return
            exc = f.exception()
            if exc is not None:
                first = self._failed is None
                self._failed = self._failed or exc
                if first and self._flush_err_cb is not None:
                    self._flush_err_cb(exc)
                return
            if self._failed is None and index > self._flush_index:
                self._flush_index = index
                if self._flush_cb is not None:
                    self._flush_cb(self._flush_index)

        fut.add_done_callback(_on_flush)
        if wait_flush:
            # shielded: a caller cancelled mid-wait (a follower append whose
            # RPC deadline ran out behind a slow fsync) must not cancel the
            # future, or _on_flush would drop the flush the worker still
            # performs and flush_index would stall below the last entry
            await asyncio.shield(fut)
        return index

    # -------------------------------------------------------------- truncate

    async def truncate(self, index: int) -> None:
        """Logical truncate: durable tombstone + in-memory tail drop.  The
        shared file is append-only — a follower rewind never rewrites
        other groups' bytes."""
        self.metrics.truncate_count.inc()
        st = self._st
        if not st.count or index > st.last:
            return
        index = max(index, st.first)
        # settle in-flight appends first: a late-resolving future for a
        # truncated index must not advance flush_index past the new tail
        await self.store.worker.drain()
        fut, *_ = await self.store.append_record(
            self.gid, index, 0, REC_TOMBSTONE)
        self._watch_control(fut)
        i = index - st.first
        for j in range(i, st.count):
            self._entries.pop(st.first + j, None)
        self.store._kill_tail(st, index)
        self._flush_index = min(self._flush_index, self.next_index - 1)
        self.store.maybe_compact()
        await fut  # tombstone durable before the caller re-appends

    async def purge(self, index: int) -> int:
        """Exact-prefix purge behind a durable marker (the per-group store
        purges at segment granularity; here space comes back via
        compaction instead of file unlinks)."""
        ti = self.get_term_index(index)
        self.metrics.purge_count.inc()
        st = self._st
        if ti is None or not st.count or index < st.first:
            return self.start_index - 1
        fut, *_ = await self.store.append_record(
            self.gid, index, ti.term, REC_PURGE)
        self._watch_control(fut)
        limit = min(index, st.last)
        for j in range(st.first, limit + 1):
            self._entries.pop(j, None)
        self.store._kill_head(st, index)
        st.below_start = ti
        if not st.count:
            st.first = index + 1
        self.store.maybe_compact()
        return self.start_index - 1

    def set_snapshot_boundary(self, ti: TermIndex) -> None:
        """After snapshot install/restore: everything <= ti is covered.
        Durable via a purge marker (submitted, not awaited — callers are
        synchronous; a lost marker just replays covered entries)."""
        st = self._st
        if not st.count and st.below_start == ti:
            return  # boot-time re-assert of an already-recovered boundary
        fut, *_ = self.store.submit_record(
            self.gid, ti.index, ti.term, REC_PURGE)
        self._watch_control(fut)
        self._entries.clear()
        self.store._kill_tail(st, st.first)  # charge everything dead
        st.first = ti.index + 1
        st.below_start = ti
        self._flush_index = ti.index
        self.store.maybe_compact()
