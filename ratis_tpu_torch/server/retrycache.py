"""Retry cache: (clientId, callId) -> reply dedupe for retried writes.

Capability parity with the reference RetryCacheImpl
(ratis-server/.../impl/RetryCacheImpl.java:42): an expiring cache keyed by
(clientId, callId) whose entries hold the reply future; a retried request —
including one retried against a NEW leader after failover — returns the
cached reply instead of re-executing.  Entries are created when a request
enters the write path and completed at apply time, which is what makes the
failover case work: followers populate the cache while applying replicated
entries.  Client-piggybacked replied-call-ids GC entries early (reference
RaftClientImpl.RepliedCallIds).

An entry expires ``expiry_s`` after its reply, never while its write is
pending.  The reference (and the JAX package's copy) ages an entry from its
creation, so a retry that reaches a live leader more than ``expiry_s``
after the original request, while the original is still uncommitted,
found the entry gone and appended the write a second time: both entries
committed, and an acknowledged write was applied twice.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ratis_tpu_torch.protocol.requests import RaftClientReply

CacheKey = tuple[bytes, int]


class CacheEntry:
    def __init__(self, key: CacheKey):
        self.key = key
        self.future: asyncio.Future = asyncio.get_running_loop().create_future()
        self.created = time.monotonic()
        # when the reply landed: the entry's age counts from here
        self.replied: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.future.done()

    def complete(self, reply: RaftClientReply) -> None:
        if not self.future.done():
            self.future.set_result(reply)
            self.replied = time.monotonic()

    def fail(self) -> None:
        """Invalidate (e.g. leadership lost before apply): the retry must
        re-execute rather than receive a bogus cached failure."""
        if not self.future.done():
            self.future.cancel()


class RetryCache:
    def __init__(self, expiry_s: float = 60.0):
        self._map: dict[CacheKey, CacheEntry] = {}
        self.expiry_s = expiry_s
        self.stats = {"hits": 0, "misses": 0}

    def _expiry(self, e: CacheEntry, now: float) -> float:
        """When ``e`` expires: at once if cancelled, ``expiry_s`` after its
        reply, and while pending no sooner than ``expiry_s`` from ``now``."""
        if e.future.cancelled():
            return now
        if e.replied is not None:
            return e.replied + self.expiry_s
        return now + self.expiry_s

    def _expired(self, e: CacheEntry, now: float) -> bool:
        return e.future.cancelled() or (e.replied is not None
                                        and now - e.replied > self.expiry_s)

    def get_or_create(self, client_id: bytes, call_id: int
                      ) -> tuple[CacheEntry, bool]:
        """Returns (entry, is_new)."""
        key = (client_id, call_id)
        now = time.monotonic()
        e = self._map.get(key)
        if e is not None and not self._expired(e, now):
            self.stats["hits"] += 1
            return e, False
        self.stats["misses"] += 1
        e = CacheEntry(key)
        self._map[key] = e
        return e, True

    def get(self, client_id: bytes, call_id: int) -> Optional[CacheEntry]:
        e = self._map.get((client_id, call_id))
        if e is not None and self._expired(e, time.monotonic()):
            return None
        return e

    def get_or_create_on_apply(self, client_id: bytes, call_id: int) -> CacheEntry:
        """Apply path (any role): ensure an entry exists so post-failover
        retries hit the cache on the new leader."""
        e, _ = self.get_or_create(client_id, call_id)
        return e

    def evict_replied(self, client_id: bytes, call_ids) -> None:
        for cid in call_ids:
            self._map.pop((client_id, cid), None)

    def sweep(self) -> int:
        """Drop expired entries; called opportunistically by the apply loop
        (or, in upkeep-plane mode, when the expiry waterline fires)."""
        now = time.monotonic()
        dead = [k for k, e in self._map.items() if self._expired(e, now)]
        for k in dead:
            del self._map[k]
        return len(dead)

    def next_expiry_s(self) -> float:
        """Oldest entry's expiry time — the upkeep plane's CH_CACHE
        waterline.  +inf when empty, so an idle division arms nothing.
        O(n), but only paid when the waterline actually fires (at most
        once per expiry window per division holding entries), never on
        the per-sweep tick."""
        if not self._map:
            return float("inf")
        now = time.monotonic()
        return min(self._expiry(e, now) for e in self._map.values())

    def __len__(self) -> int:
        return len(self._map)
