"""Send-side write coalescing for the real-socket transports.

Round-5 tracing (BENCH_r05 host_path_decomposition + docs/perf.md) put the
north-star residual in the host wire path, not in consensus: the same host
does 3205.8 commits/s over the sim transport but 1025 over TCP at 5-peer x
10240 groups.  A dominant share of that gap is the per-frame
``write() + await drain()`` pattern — every frame pays a drain await (a
task switch + flow-control check) and, under a send lock, serializes every
concurrent caller on the connection through it.

:class:`WriteCoalescer` replaces the pattern with a per-connection send
queue: frames accumulate while one buffered flush is pending, and the whole
batch goes to the transport as a single writev-style write + ONE drain.
Policy (``raft.tpu.tcp.*`` / ``raft.tpu.grpc.*`` keys, conf/keys.py):

- ``flush_bytes`` > 0: flush as soon as that many bytes are pending.
- ``flush_micros`` > 0: wait at most that long for more frames before
  flushing; 0 flushes at the *next event-loop pass*, which batches every
  frame enqueued in the current pass at zero added latency.
- both 0 (the default): coalescing OFF — each ``send`` performs the exact
  write+drain of the per-frame path, serialized, byte-identical on the
  wire (asserted in tests/test_wire_fastpath.py).

Failure contract: a flush error fails every send awaiting that batch and
POISONS the coalescer — some frames of the batch may be half-written, so
the connection is unusable and later sends fail fast; the error never
escapes into the flusher task or the event loop (a partial-batch failure
poisons the connection, not the loop).
"""

from __future__ import annotations

import asyncio
from typing import Optional

__all__ = ["WriteCoalescer"]


class WriteCoalescer:
    """Batches outbound frames into single transport flushes.

    Generic over the flush primitive: subclasses implement
    :meth:`_flush_batch` (the TCP transport joins frame bytes and performs
    one ``write+drain``; the gRPC transport packs chunks into one stream
    message).  ``max_frames`` additionally caps frames per flush (0 =
    unbounded) — the gRPC framing uses it so one stream message never
    carries an unbounded chunk list.
    """

    def __init__(self, flush_bytes: int = 0, flush_micros: int = 0,
                 max_frames: int = 0):
        self.flush_bytes = int(flush_bytes)
        self.flush_micros = int(flush_micros)
        self.max_frames = int(max_frames)
        self._pending: list = []
        self._pending_bytes = 0
        self._waiters: list[asyncio.Future] = []
        self._flusher: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()
        self._dead: Optional[Exception] = None
        self.metrics = {"flushes": 0, "frames": 0, "coalesced_frames": 0}

    @property
    def coalescing(self) -> bool:
        return self.flush_bytes > 0 or self.flush_micros > 0

    @property
    def poisoned(self) -> bool:
        return self._dead is not None

    async def _flush_batch(self, frames: list) -> None:
        raise NotImplementedError

    async def send(self, frame, nbytes: int) -> None:
        """Queue ``frame`` and return once the flush carrying it drained
        (backpressure: callers wait out the transport's flow control
        exactly as the per-frame path did)."""
        if self._dead is not None:
            raise self._dead
        if not self.coalescing:
            # the exact legacy path: one write+drain per frame, serialized
            async with self._lock:
                if self._dead is not None:
                    raise self._dead
                await self._flush_batch([frame])
                self.metrics["flushes"] += 1
                self.metrics["frames"] += 1
            return
        fut = asyncio.get_running_loop().create_future()
        self._pending.append(frame)
        self._pending_bytes += nbytes
        self._waiters.append(fut)
        if (0 < self.flush_bytes <= self._pending_bytes
                or (self.max_frames
                    and len(self._pending) >= self.max_frames)):
            await self._flush_now()
        elif self._flusher is None:
            self._flusher = asyncio.create_task(self._flush_after_delay())
        await fut

    def send_nowait(self, frame, nbytes: int) -> None:
        """Fire-and-forget enqueue: the frame joins the pending batch and
        the flusher (armed at most once per batch) writes it out on the
        next pass — REGARDLESS of the flush thresholds, so deferred-reply
        fan-out batches coalesce even on a connection configured for the
        per-frame path.  No backpressure: callers are reply producers
        whose volume is bounded by the connection's in-flight requests; a
        dead coalescer drops the frame (the connection is gone and its
        client will retry/timeout exactly as with a torn socket)."""
        if self._dead is not None:
            return
        self._pending.append(frame)
        self._pending_bytes += nbytes
        if self._flusher is None:
            self._flusher = asyncio.get_running_loop().create_task(
                self._flush_after_delay())

    async def _flush_after_delay(self) -> None:
        try:
            while self._pending and self._dead is None:
                if self.flush_micros:
                    await asyncio.sleep(self.flush_micros / 1e6)
                else:
                    await asyncio.sleep(0)  # batch the current loop pass
                await self._flush_now()
        finally:
            self._flusher = None

    async def _flush_now(self) -> None:
        async with self._lock:
            if not self._pending or self._dead is not None:
                return
            frames = self._pending
            waiters = self._waiters
            self._pending, self._waiters = [], []
            self._pending_bytes = 0
            try:
                await self._flush_batch(frames)
            except asyncio.CancelledError:
                self._poison(ConnectionError("flush cancelled mid-batch"),
                             waiters)
                raise
            except Exception as e:
                self._poison(e, waiters)
                return
            self.metrics["flushes"] += 1
            self.metrics["frames"] += len(frames)
            if len(frames) > 1:
                self.metrics["coalesced_frames"] += len(frames)
            for f in waiters:
                if not f.done():
                    f.set_result(None)

    def _poison(self, exc: Exception, waiters=()) -> None:
        if self._dead is None:
            self._dead = exc
        # abandoned waiters (caller's await was cancelled) are already done
        for f in (*waiters, *self._waiters):
            if not f.done():
                f.set_exception(exc)
        self._waiters.clear()
        self._pending.clear()
        self._pending_bytes = 0

    async def aclose(self) -> None:
        """Flush anything still pending (flush-on-close), then retire the
        flusher.  Safe on a poisoned coalescer (no-op flush)."""
        try:
            await self._flush_now()
        finally:
            t = self._flusher
            if t is not None and t is not asyncio.current_task():
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
