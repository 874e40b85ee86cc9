"""Per-server event-loop sharding (``raft.tpu.server.loop-shards``).

The traced host-path decomposition (docs/perf.md, round 6) located the
dominant north-star residual in single-event-loop queueing: at 5-peer x
10240 groups the server-side stage tiling sums to ~25-30ms of a 138ms
client p50 — the rest is ready-callback backlog on ONE saturated loop.
That made loop count a deployment shape; this module makes the shape
real: a :class:`LoopShardPool` runs N worker event loops (shard 0 is the
loop the server started on; shards 1..N-1 run in daemon threads), and the
server hash-pins every Division — and with it that division's request
handling, appenders, heartbeat sweep share, upkeep-plane slot
(server/upkeep.py: the packed deadline arrays the shard's sweep scans
are owned by the shard's loop, so registration, arming, and the
vectorized due-scan never cross threads), and outbound transport
connections — to one shard.

No reference analog maps 1:1 (the reference is thread-per-division on a
shared Netty event-loop group); the closest shape is Netty's
``NioEventLoopGroup``: a fixed pool of loops with channels pinned at
registration.  Cross-shard handoff uses ``run_coroutine_threadsafe``
wrapped back into the calling loop; with ``loop-shards=1`` (the default)
the pool is never constructed and every code path is the unsharded one.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import zlib
from typing import Optional

LOG = logging.getLogger(__name__)


def loop_ready_depth(loop: Optional[asyncio.AbstractEventLoop]) -> int:
    """Best-effort ready-callback backlog of ``loop`` — the queueing the
    traced decomposition blamed for the north-star residual, now a live
    introspection signal (/divisions shardQueueDepth).  CPython's event
    loop keeps its ready queue in ``_ready``; a loop implementation
    without one reports -1 (unknown), never raises."""
    if loop is None:
        return -1
    ready = getattr(loop, "_ready", None)
    if ready is None:
        return -1
    try:
        return len(ready)
    except Exception:
        return -1


class LoopShardPool:
    """N event loops; shard 0 is the caller's (primary) loop, the rest run
    ``run_forever`` on daemon threads until :meth:`close`."""

    def __init__(self, name: str, shards: int):
        self.name = name
        self.n = max(1, int(shards))
        self._loops: list[asyncio.AbstractEventLoop] = []
        self._threads: list[threading.Thread] = []
        self.started = False

    def start(self) -> None:
        """Spawn the worker loops.  Must run inside the primary loop (it
        becomes shard 0)."""
        if self.started:
            return
        self._loops = [asyncio.get_running_loop()]
        for i in range(1, self.n):
            ready = threading.Event()
            holder: dict = {}

            def _run(holder=holder, ready=ready) -> None:
                loop = asyncio.new_event_loop()
                holder["loop"] = loop
                asyncio.set_event_loop(loop)
                ready.set()
                try:
                    loop.run_forever()
                finally:
                    # cancel whatever close() could not unwind, then close
                    for task in asyncio.all_tasks(loop):
                        task.cancel()
                    try:
                        loop.run_until_complete(loop.shutdown_asyncgens())
                    except Exception:
                        pass
                    loop.close()

            t = threading.Thread(target=_run, name=f"{self.name}-shard{i}",
                                 daemon=True)
            t.start()
            ready.wait()
            self._loops.append(holder["loop"])
            self._threads.append(t)
        self.started = True

    # -- placement -----------------------------------------------------------

    def shard_of(self, key: bytes) -> int:
        """Stable hash-pin for a group id: same key -> same shard for the
        server's lifetime (division state is loop-affine)."""
        return zlib.crc32(key) % self.n

    def loop(self, idx: int) -> asyncio.AbstractEventLoop:
        return self._loops[idx]

    def queue_depth(self, idx: int) -> int:
        """Ready-callback backlog of shard ``idx``'s loop (-1 unknown)."""
        if not self.started or idx >= len(self._loops):
            return -1
        return loop_ready_depth(self._loops[idx])

    def queue_depths(self) -> list[int]:
        return [self.queue_depth(i) for i in range(self.n)]

    def loop_index(self, loop: Optional[asyncio.AbstractEventLoop] = None
                   ) -> int:
        """Shard index of ``loop`` (default: the running loop); -1 when the
        loop is not one of the pool's."""
        if loop is None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return -1
        for i, lp in enumerate(self._loops):
            if lp is loop:
                return i
        return -1

    # -- cross-loop execution ------------------------------------------------

    async def run_on(self, idx: int, coro):
        """Await ``coro`` on shard ``idx``'s loop from ANY pool loop.  On
        the owning loop this is a plain await (zero indirection — the
        unsharded fast path)."""
        target = self._loops[idx]
        try:
            current = asyncio.get_running_loop()
        except RuntimeError:
            current = None
        if target is current:
            return await coro
        cf = asyncio.run_coroutine_threadsafe(coro, target)
        return await asyncio.wrap_future(cf)

    def call_soon(self, idx: int, fn, *args) -> None:
        target = self._loops[idx]
        try:
            current = asyncio.get_running_loop()
        except RuntimeError:
            current = None
        if target is current:
            fn(*args)
        else:
            target.call_soon_threadsafe(fn, *args)

    # -- lifecycle -----------------------------------------------------------

    async def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop the worker loops and join their threads.  Callers must have
        already unwound shard-pinned work (divisions, senders): stopping a
        loop strands whatever is still scheduled on it."""
        if not self.started:
            return
        for loop in self._loops[1:]:
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass  # already stopped
        for t in self._threads:
            await asyncio.to_thread(t.join, join_timeout_s)
            if t.is_alive():
                LOG.warning("%s: shard thread %s did not join in %.0fs",
                            self.name, t.name, join_timeout_s)
        self._threads.clear()
        self._loops = self._loops[:1]
        self.started = False
