"""Durable segmented Raft log with shared flush-batching worker.

Capability parity with the reference segmented log stack
(ratis-server/.../raftlog/segmented/SegmentedRaftLog.java:86,
SegmentedRaftLogWorker.java, LogSegment.java, SegmentedRaftLogFormat):

- segment files ``log_<start>-<end>`` (closed) / ``log_inprogress_<start>``
  (open) under ``current/`` (LogSegmentStartEnd.java:41-58);
- CRC-checked records, corrupt-tail truncation on recovery;
- a single I/O worker per *storage device* batching fsyncs across ALL
  divisions sharing that device (the reference runs one worker thread per
  division — SegmentedRaftLogWorker.java:302 — which is exactly the
  thread-per-group scaling wall this design removes, cf. SURVEY §7 step 5);
- flush_index advances only after fsync and feeds the leader's own slot in
  the batched commit kernel.

Record format (original to this implementation):
    file   := MAGIC record*
    record := u32_le payload_len | u32_le crc32(payload) | payload
    payload = LogEntry msgpack bytes
"""

from __future__ import annotations

import asyncio
import os
import pathlib
import re
import struct
import time
import zlib
from typing import Optional

from ratis_tpu_torch.protocol.exceptions import (ChecksumException,
                                           RaftLogIOException)
from ratis_tpu_torch.protocol.logentry import LogEntry
from ratis_tpu_torch.protocol.termindex import INVALID_LOG_INDEX, TermIndex
from ratis_tpu_torch.server.log.base import RaftLog

MAGIC = b"RTPULOG\x01"
_REC_HDR = struct.Struct("<II")

_CLOSED_RE = re.compile(r"^log_(\d+)-(\d+)$")
_OPEN_RE = re.compile(r"^log_inprogress_(\d+)$")


def encode_record(payload: bytes) -> bytes:
    return _REC_HDR.pack(len(payload), zlib.crc32(payload)) + payload


def read_records(path: pathlib.Path) -> tuple[list[bytes], int]:
    """Read records; returns (payloads, good_byte_length).  Stops at the
    first corrupt/truncated record — recovery truncates the file there
    (reference SegmentedRaftLogReader corrupt-tail handling)."""
    data = path.read_bytes()
    if not data.startswith(MAGIC):
        return [], len(MAGIC) if not data else 0
    payloads = []
    off = len(MAGIC)
    while off + _REC_HDR.size <= len(data):
        ln, crc = _REC_HDR.unpack_from(data, off)
        start = off + _REC_HDR.size
        end = start + ln
        if end > len(data):
            break
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            break
        payloads.append(payload)
        off = end
    return payloads, off


class LogWorker:
    """One fsync-batching writer per storage device.

    Tasks are (file, bytes, future) appends; each drain writes every queued
    task then issues ONE fsync per distinct file, resolving all futures —
    group commit like the reference's flushIfNecessary/forceSyncNum
    (SegmentedRaftLogWorker.java:368) but across divisions.
    """

    _instances: dict[str, "LogWorker"] = {}

    def __init__(self, name: str = "default"):
        self.name = name
        self._queue: list[tuple[object, bytes, asyncio.Future]] = []
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._refs = 0
        # single metric source (reference log_worker catalog: flushTime/
        # flushCount/syncTime over the shared per-device worker)
        from ratis_tpu_torch.metrics import LogWorkerMetrics
        self.registry_metrics = LogWorkerMetrics(f"device-{name}")
        self.registry_metrics.add_queue_gauges(lambda: len(self._queue))
        self.registry_metrics.add_sweep_gauge(lambda: self._sync_ewma)
        self._writes = self.registry_metrics.registry.counter("writeCount")
        self._batches = self.registry_metrics.registry.counter("batchCount")
        # decayed fsyncs-per-drain-sweep: ~1.0 on a shared log plane,
        # ~open-file-count with per-group segment files
        self._sync_ewma = 0.0

    @property
    def metrics(self) -> dict:
        """Snapshot view kept for tests/tools."""
        return {"flushes": self.registry_metrics.flush_count.count,
                "writes": self._writes.count,
                "batched": self._batches.count}

    @property
    def sync_count(self) -> int:
        """Cumulative fsyncs issued by this worker."""
        return self.registry_metrics.sync_count.count

    @classmethod
    def shared(cls, device_key: str) -> "LogWorker":
        w = cls._instances.get(device_key)
        if w is None:
            w = cls(device_key)
            cls._instances[device_key] = w
        return w

    def acquire(self) -> None:
        self._refs += 1
        if self._task is None:
            self._wake = asyncio.Event()
            self._task = asyncio.create_task(self._run(),
                                             name=f"log-worker-{self.name}")

    async def release(self) -> None:
        if self._refs <= 0:
            return  # tolerate close-without-open (failed startup cleanup)
        self._refs -= 1
        if self._refs <= 0 and self._task is not None:
            task, self._task = self._task, None
            self._wake.set()
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            self._instances.pop(self.name, None)
            self.registry_metrics.unregister()

    def submit(self, fileobj, data: bytes) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self._queue.append((fileobj, data, fut))
        if self._wake is not None:
            self._wake.set()
        return fut

    async def drain(self) -> None:
        """Wait until previously submitted writes are flushed."""
        if not self._queue:
            return
        fut = self._queue[-1][2]
        await asyncio.shield(fut)

    async def _run(self) -> None:
        from ratis_tpu_torch.util import injection
        # worker-start injection point (reference
        # SegmentedRaftLogWorker.java:70 runs CodeInjectionForTesting at
        # the top of its run loop): lets the chaos suite stall a device's
        # whole log worker before it drains anything
        await injection.execute(injection.RUN_LOG_WORKER, self.name)
        while True:
            if not self._queue:
                self._wake.clear()
                await self._wake.wait()
            batch, self._queue = self._queue, []
            if not batch:
                continue
            self._writes.inc(len(batch))
            self._batches.inc()
            # per-flush-batch sync injection point (reference
            # RaftServerImpl.java:1620's LOG_SYNC): a registered delay
            # here is the slow-disk fault — every group sharing this
            # device pays it, exactly like a real degraded disk.  The
            # extra arg is the batch's distinct-file count, so a handler
            # can charge per FSYNC (per-group segments pay N, the shared
            # plane pays 1) rather than per sweep.
            files_n = len({id(fileobj) for fileobj, _, _ in batch})
            await injection.execute(injection.LOG_SYNC, self.name, None,
                                    files_n)

            def _do_io():
                files = []
                for fileobj, data, _ in batch:
                    fileobj.write(data)
                    if fileobj not in files:
                        files.append(fileobj)
                t_sync = time.perf_counter()
                for f in files:
                    f.flush()
                    os.fsync(f.fileno())
                self.registry_metrics.sync_timer.update(
                    time.perf_counter() - t_sync)
                self.registry_metrics.sync_count.inc(len(files))
                self._sync_ewma = (0.9 * self._sync_ewma + 0.1 * len(files)
                                   if self._sync_ewma else float(len(files)))

            try:
                with self.registry_metrics.flush_timer.time():
                    await asyncio.to_thread(_do_io)
                self.registry_metrics.flush_count.inc()
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_result(None)
            except Exception as e:
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


class _Segment:
    """One segment: its file, per-entry (term, offset) metadata, and — while
    cached — the decoded entries.

    Mirrors the reference LogSegment (LogSegment.java): the compact LogRecord
    list (term + file position per entry) always stays in memory so
    consistency checks (get_term_index / previous-entry validation) never
    touch disk, while the entry payloads can be evicted
    (SegmentedRaftLogCache.java evictCache) and read back through the file on
    demand for lagging followers."""

    def __init__(self, start: int, path: pathlib.Path, is_open: bool):
        self.start = start
        self.path = path
        self.is_open = is_open
        # None = evicted (payloads live only in the file)
        self.entries: Optional[list[LogEntry]] = []
        # always-resident metadata: term + byte offset of each record
        self.terms: list[int] = []
        self.offsets: list[int] = []
        self.size = len(MAGIC)

    def append(self, entry: LogEntry, offset: int, record_len: int) -> None:
        assert self.entries is not None, "append to evicted segment"
        self.entries.append(entry)
        self.terms.append(entry.term)
        self.offsets.append(offset)
        self.size = offset + record_len

    @property
    def count(self) -> int:
        return len(self.terms)

    @property
    def end(self) -> int:
        return self.start + len(self.terms) - 1

    @property
    def cached(self) -> bool:
        return self.entries is not None

    def evict(self) -> None:
        assert not self.is_open
        self.entries = None

    def term_at(self, index: int) -> Optional[int]:
        i = index - self.start
        if 0 <= i < len(self.terms):
            return self.terms[i]
        return None

    def get(self, index: int) -> Optional[LogEntry]:
        i = index - self.start
        if 0 <= i < len(self.terms) and self.entries is not None:
            return self.entries[i]
        return None

    def load(self) -> list[LogEntry]:
        """Read the whole segment back from disk (read-through miss)."""
        payloads, _ = read_records(self.path)
        return [LogEntry.from_bytes(p) for p in payloads]


class SegmentedRaftLog(RaftLog):
    def __init__(self, name: str, directory: pathlib.Path,
                 worker: Optional[LogWorker] = None,
                 segment_size_max: int = 8 << 20,
                 cache_segments_max: int = 6):
        super().__init__(name)
        self.dir = pathlib.Path(directory)
        self.worker = worker or LogWorker.shared(str(self.dir.anchor or "default"))
        self.segment_size_max = segment_size_max
        # Closed segments beyond this many keep only (term, offset) metadata
        # in RAM; payloads are re-read from the file on demand (reference
        # SegmentedRaftLogCache.java default 6 cached segments).
        self.cache_segments_max = cache_segments_max
        self._segments: list[_Segment] = []
        # read-through cache: seg.start -> entries, tiny LRU (a couple of
        # lagging followers scanning different segments shouldn't thrash).
        # Guarded by a threading lock: prefault() runs in to_thread workers
        # concurrently with event-loop readers.
        self._rt_cache: "dict[int, list[LogEntry]]" = {}
        self._rt_cache_max = 3
        self._rt_version = 0  # bumped on truncate/purge/snapshot invalidation
        import threading
        self._rt_lock = threading.Lock()
        self._open_file = None
        self._flush_index = INVALID_LOG_INDEX
        self._below_start: Optional[TermIndex] = None
        # Latched on the first failed write: flush_index must never advance
        # past a hole (a later successful fsync does NOT make earlier failed
        # bytes durable), and further appends are refused — the reference's
        # log worker terminates on IO failure the same way.
        self._failed: Optional[Exception] = None
        from ratis_tpu_torch.metrics import SegmentedRaftLogMetrics
        self.metrics = SegmentedRaftLogMetrics(name)

    @property
    def failed(self) -> bool:
        return self._failed is not None

    # ------------------------------------------------------------- recovery

    async def open(self, last_index_on_snapshot: int = INVALID_LOG_INDEX) -> None:
        await super().open(last_index_on_snapshot)
        self.worker.acquire()
        self.dir.mkdir(parents=True, exist_ok=True)
        found: list[tuple[int, Optional[int], pathlib.Path]] = []
        for f in self.dir.iterdir():
            m = _CLOSED_RE.match(f.name)
            if m:
                found.append((int(m.group(1)), int(m.group(2)), f))
                continue
            m = _OPEN_RE.match(f.name)
            if m:
                found.append((int(m.group(1)), None, f))
        found.sort(key=lambda x: x[0])

        for start, end, path in found:
            seg = _Segment(start, path, end is None)
            payloads, good_len = read_records(path)
            file_size = path.stat().st_size
            if good_len < file_size:
                if end is not None:
                    raise ChecksumException(
                        f"{self.name}: corrupt closed segment {path.name}",
                        good_len)
                # corrupt tail of the open segment: truncate it away
                with open(path, "r+b") as fh:
                    fh.truncate(good_len)
            off = len(MAGIC)
            for p in payloads:
                e = LogEntry.from_bytes(p)
                seg.append(e, off, _REC_HDR.size + len(p))
                off += _REC_HDR.size + len(p)
            if seg.count or seg.is_open:
                self._segments.append(seg)

        # Only the last segment may be open; close others defensively.
        for seg in self._segments[:-1]:
            if seg.is_open:
                self._close_segment_file(seg)
        if self._segments and self._segments[-1].is_open:
            seg = self._segments[-1]
            self._open_file = open(seg.path, "ab")
        # NOTE: when the log is empty and a snapshot exists, the caller must
        # follow open() with set_snapshot_boundary(snapshot.term_index) — the
        # term is not recoverable from the index argument alone.
        self._flush_index = self.next_index - 1

    async def close(self) -> None:
        if self._open_file is not None:
            await self.worker.drain()
            self._open_file.close()
            self._open_file = None
        await self.worker.release()
        self.metrics.unregister()
        await super().close()

    def _close_segment_file(self, seg: _Segment) -> None:
        if not seg.count:
            seg.path.unlink(missing_ok=True)
            return
        new_path = seg.path.with_name(f"log_{seg.start}-{seg.end}")
        os.replace(seg.path, new_path)
        seg.path = new_path
        seg.is_open = False

    # ------------------------------------------------------------- indices

    @property
    def start_index(self) -> int:
        if self._segments:
            return self._segments[0].start
        if self._below_start is not None:
            return self._below_start.index + 1
        return 0

    @property
    def flush_index(self) -> int:
        return self._flush_index

    def get_last_entry_term_index(self) -> Optional[TermIndex]:
        for seg in reversed(self._segments):
            if seg.count:
                return TermIndex(seg.terms[-1], seg.end)
        return self._below_start

    def _fault_in(self, seg: _Segment) -> list[LogEntry]:
        with self._rt_lock:
            entries = self._rt_cache.get(seg.start)
            version = self._rt_version
        if entries is None:
            self.metrics.cache_miss_count.inc()
            entries = seg.load()  # file IO outside the lock
            with self._rt_lock:
                if self._rt_version == version:
                    # don't cache across an invalidation (a truncate may
                    # have rewritten the file while we were reading it)
                    self._rt_cache[seg.start] = entries
                    while len(self._rt_cache) > self._rt_cache_max:
                        self._rt_cache.pop(next(iter(self._rt_cache)))
        else:
            self.metrics.cache_hit_count.inc()
        return entries

    def _invalidate_rt_cache(self) -> None:
        with self._rt_lock:
            self._rt_version += 1
            self._rt_cache.clear()

    def _read_through(self, seg: _Segment, index: int) -> Optional[LogEntry]:
        """Serve an evicted segment from its file (one whole-segment read,
        held in a small LRU for the sequential scans a catching-up follower
        produces).  Synchronous: async hot paths should check is_resident()
        first and prefault() off-loop (LogAppender does)."""
        entries = self._fault_in(seg)
        i = index - seg.start
        if 0 <= i < len(entries):
            return entries[i]
        return None

    def _covering_segment(self, index: int) -> Optional[_Segment]:
        for seg in reversed(self._segments):
            if seg.start <= index:
                return seg if index <= seg.end else None
        return None

    def is_resident(self, index: int) -> bool:
        seg = self._covering_segment(index)
        if seg is None or seg.cached:
            return True
        # _rt_cache is mutated from prefault worker threads; the lock is
        # uncontended and keeps this membership check from racing an LRU
        # eviction into a synchronous whole-segment load on the event loop
        with self._rt_lock:
            return seg.start in self._rt_cache

    def prefault(self, index: int) -> None:
        """Blocking load of the segment covering ``index`` into the
        read-through cache; call via asyncio.to_thread from async paths."""
        seg = self._covering_segment(index)
        if seg is not None and not seg.cached:
            self._fault_in(seg)

    def get(self, index: int) -> Optional[LogEntry]:
        for seg in reversed(self._segments):
            if seg.start <= index:
                if index > seg.end:
                    return None
                if seg.cached:
                    return seg.get(index)
                return self._read_through(seg, index)
        return None

    def get_term_index(self, index: int) -> Optional[TermIndex]:
        # metadata-only: never faults an evicted segment in
        for seg in reversed(self._segments):
            if seg.start <= index:
                t = seg.term_at(index)
                return TermIndex(t, index) if t is not None else None
        if self._below_start is not None and index == self._below_start.index:
            return self._below_start
        return None

    # ------------------------------------------------------------- eviction

    @property
    def cached_segments(self) -> int:
        return sum(1 for s in self._segments if not s.is_open and s.cached)

    def evict_cache(self, applied_index: int) -> int:
        """Bound entry memory (reference SegmentedRaftLogCache.evictCache):
        keep at most cache_segments_max closed segments' payloads resident,
        evicting oldest-first but only below the applied frontier (the
        applier reads every entry exactly once; evicting ahead of it would
        thrash).  Lagging followers are served from disk via read-through.
        Returns the number of segments evicted."""
        # cheap guard: runs on every apply batch, almost always a no-op
        if len(self._segments) <= self.cache_segments_max + 1:
            return 0
        closed_cached = [s for s in self._segments
                         if not s.is_open and s.cached]
        excess = len(closed_cached) - self.cache_segments_max
        evicted = 0
        for seg in closed_cached:
            if evicted >= excess:
                break
            if seg.end <= applied_index:
                seg.evict()
                self.metrics.cache_evict_count.inc()
                evicted += 1
        return evicted

    # ------------------------------------------------------------- append

    def _ensure_open_segment(self, start: int) -> _Segment:
        if self._segments and self._segments[-1].is_open:
            return self._segments[-1]
        seg = _Segment(start, self.dir / f"log_inprogress_{start}", True)
        seg.path.write_bytes(MAGIC)
        self._segments.append(seg)
        self._open_file = open(seg.path, "ab")
        return seg

    async def _roll_segment(self) -> None:
        await self.worker.drain()
        seg = self._segments[-1]
        self._open_file.close()
        self._open_file = None
        self._close_segment_file(seg)

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
        seg = self._ensure_open_segment(entry.index)
        if seg.size > self.segment_size_max:
            await self._roll_segment()
            seg = self._ensure_open_segment(entry.index)

        payload = entry.to_bytes(include_sm_data=False)
        record = encode_record(payload)
        seg.append(entry, seg.size, len(record))
        fut = self.worker.submit(self._open_file, record)
        index = entry.index

        # flush_index advances from the worker's completion, in submit order
        # (the worker resolves a batch's futures in order, and done-callbacks
        # run before any awaiter resumes), so it stays contiguous whether or
        # not the caller awaits (SegmentedRaftLogWorker flushIfNecessary:368).
        def _on_flush(f: "asyncio.Future") -> None:
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

    # ------------------------------------------------------------ truncate

    async def truncate(self, index: int) -> None:
        self.metrics.truncate_count.inc()
        self._invalidate_rt_cache()
        await self.worker.drain()
        while self._segments and self._segments[-1].start >= index:
            seg = self._segments.pop()
            if seg.is_open and self._open_file is not None:
                self._open_file.close()
                self._open_file = None
            seg.path.unlink(missing_ok=True)
        if not self._segments:
            self._flush_index = min(self._flush_index, index - 1)
            return
        seg = self._segments[-1]
        if index <= seg.end:
            if not seg.cached:
                seg.entries = seg.load()  # truncation rewrites the tail
            keep = index - seg.start
            byte_len = seg.offsets[keep] if keep < len(seg.offsets) else seg.size
            if seg.is_open and self._open_file is not None:
                self._open_file.close()
                self._open_file = None
            del seg.entries[keep:]
            del seg.terms[keep:]
            del seg.offsets[keep:]
            with open(seg.path, "r+b") as fh:
                fh.truncate(byte_len)
            seg.size = byte_len
            if not seg.is_open:
                # reopen as inprogress for future appends
                new_path = seg.path.with_name(f"log_inprogress_{seg.start}")
                os.replace(seg.path, new_path)
                seg.path = new_path
                seg.is_open = True
            self._open_file = open(seg.path, "ab")
        self._flush_index = min(self._flush_index, self.next_index - 1)

    async def purge(self, index: int) -> int:
        """Drop whole segments with end <= index (snapshot-covered); the
        reference purges at segment granularity too (purgeImpl)."""
        ti = self.get_term_index(index)
        self.metrics.purge_count.inc()
        self._invalidate_rt_cache()
        # Roll the open segment first when the snapshot fully covers it, so
        # purge can reclaim it too (otherwise a single-open-segment log would
        # never shrink after snapshotting).
        if self._segments and self._segments[-1].is_open \
                and self._segments[-1].count \
                and self._segments[-1].end <= index:
            await self._roll_segment()
        dropped = False
        while self._segments and not self._segments[0].is_open \
                and self._segments[0].end <= index:
            seg = self._segments.pop(0)
            seg.path.unlink(missing_ok=True)
            dropped = True
        if dropped and ti is not None and (not self._segments
                                           or self._segments[0].start > index):
            self._below_start = ti
        return self.start_index - 1

    def set_snapshot_boundary(self, ti: TermIndex) -> None:
        """After snapshot install: discard the local log below/at ti."""
        self._invalidate_rt_cache()
        for seg in self._segments:
            seg.path.unlink(missing_ok=True)
        self._segments.clear()
        if self._open_file is not None:
            self._open_file.close()
            self._open_file = None
        self._below_start = ti
        self._flush_index = ti.index
