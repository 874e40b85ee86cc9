"""Transport link-fault shim: partitions and degraded links on EVERY
transport, not just the simulated hub's block matrix.

The simulated transport always had per-direction blocking
(SimulatedNetwork.block, cf. the reference's
MiniRaftCluster.RpcBase.setBlockRequestsFrom) — but nothing could
partition or degrade a link over the real TCP/gRPC sockets, so the chaos
suite could never run at the shapes where the pipelined-window and
packed-ack paths actually live.  This module is the transport-agnostic
fault plane: a process-wide table of directed ``(src, dst)`` link faults
(blackhole, latency+jitter, probabilistic drop) that every server
transport consults at its server-RPC send point when the server runs
with ``raft.tpu.chaos.enabled`` (unset — the default — no transport ever
touches this module; one bool test per send when set).

Determinism: latency jitter and drops draw from ONE seeded
``random.Random`` (:meth:`LinkFaultTable.reseed`), so a scenario's fault
behavior replays exactly for a given seed on the deterministic in-process
harness.  In-process test clusters share the table the way they share
the tracer and the injection registry.
"""

from __future__ import annotations

import asyncio
import random
from typing import NamedTuple, Optional

from ratis_tpu_torch.protocol.exceptions import TimeoutIOException


class LinkFault(NamedTuple):
    """Fault state of one DIRECTED link (``None`` endpoint = wildcard)."""

    blocked: bool = False
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    drop_rate: float = 0.0

    def degraded(self) -> bool:
        return (self.blocked or self.latency_ms > 0 or self.jitter_ms > 0
                or self.drop_rate > 0)


def _norm(peer) -> Optional[str]:
    return None if peer is None else str(peer)


class LinkFaultTable:
    """Directed link faults keyed by ``(src, dst)`` peer-id strings.

    ``None`` acts as a wildcard on either side (matching the simulated
    hub's block semantics); the most specific entry wins:
    ``(src, dst)`` > ``(src, None)`` > ``(None, dst)`` > ``(None, None)``.
    """

    def __init__(self, seed: int = 0):
        self._faults: dict[tuple[Optional[str], Optional[str]], LinkFault] = {}
        self._rng = random.Random(seed)
        self.metrics = {"gated": 0, "dropped": 0, "blocked": 0,
                        "delayed": 0}

    # ----------------------------------------------------------- mutation

    def reseed(self, seed: int) -> None:
        """Reset the drop/jitter RNG — scenario replay determinism."""
        self._rng = random.Random(seed)

    def block(self, src=None, dst=None) -> None:
        """Blackhole src->dst (None = wildcard)."""
        self.set_link(src, dst, blocked=True)

    def set_link(self, src=None, dst=None, *, blocked: bool = False,
                 latency_ms: float = 0.0, jitter_ms: float = 0.0,
                 drop_rate: float = 0.0) -> None:
        self._faults[(_norm(src), _norm(dst))] = LinkFault(
            blocked, latency_ms, jitter_ms, drop_rate)

    def partition(self, side_a, side_b) -> None:
        """Full bidirectional partition between two peer sets."""
        for a in side_a:
            for b in side_b:
                self.block(a, b)
                self.block(b, a)

    def isolate(self, peer) -> None:
        """Blackhole everything to AND from ``peer``."""
        self.block(peer, None)
        self.block(None, peer)

    def heal(self, src=None, dst=None) -> None:
        self._faults.pop((_norm(src), _norm(dst)), None)

    def heal_all(self) -> None:
        self._faults.clear()

    # ------------------------------------------------------------ queries

    def __bool__(self) -> bool:
        return bool(self._faults)

    def lookup(self, src, dst) -> Optional[LinkFault]:
        if not self._faults:
            return None
        s, d = _norm(src), _norm(dst)
        for key in ((s, d), (s, None), (None, d), (None, None)):
            f = self._faults.get(key)
            if f is not None:
                return f
        return None

    def is_blocked(self, src, dst) -> bool:
        f = self.lookup(src, dst)
        return f is not None and f.blocked

    def active(self) -> list[dict]:
        """Active fault descriptors (the /health ``chaos`` payload)."""
        return [{"src": k[0], "dst": k[1], "blocked": f.blocked,
                 "latency_ms": f.latency_ms, "jitter_ms": f.jitter_ms,
                 "drop_rate": f.drop_rate}
                for k, f in sorted(self._faults.items(),
                                   key=lambda kv: (kv[0][0] or "",
                                                   kv[0][1] or ""))]

    # --------------------------------------------------------------- gate

    async def gate(self, src, dst) -> None:
        """Apply the directed link's fault to one RPC hop: raise
        :class:`TimeoutIOException` for a blackholed or dropped hop, sleep
        out the configured latency(+jitter) otherwise.  A no-op dict
        lookup when no fault covers the link."""
        f = self.lookup(src, dst)
        if f is None:
            return
        self.metrics["gated"] += 1
        if f.blocked:
            self.metrics["blocked"] += 1
            raise TimeoutIOException(f"chaos: link {src}->{dst} blackholed")
        if f.drop_rate > 0 and self._rng.random() < f.drop_rate:
            self.metrics["dropped"] += 1
            raise TimeoutIOException(f"chaos: link {src}->{dst} dropped")
        d = f.latency_ms
        if f.jitter_ms:
            d += self._rng.uniform(0, f.jitter_ms)
        if d > 0:
            self.metrics["delayed"] += 1
            await asyncio.sleep(d / 1e3)


# The process-wide table (shared by co-hosted in-process servers, like the
# tracer and the injection registry).  Transports consult it only when
# their server was built with raft.tpu.chaos.enabled.
_TABLE = LinkFaultTable()


def link_faults() -> LinkFaultTable:
    return _TABLE
