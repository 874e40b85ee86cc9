"""Scheduling-hop accounting for the replication/reply plane.

The round-6/7 traced decomposition located the commit wall in event-loop
scheduling hops (`server.route`/`server.reply`/`server.respond`, ~100µs
each under load), not in serialization (docs/perf.md).  The round-8
batching work collapses those hops; this module makes the collapse a
standing measured artifact instead of a one-off trace read: every site
the batching targets counts the scheduling operations it issues, and
``hops-per-commit`` (reply-plane hops / engine commit advances) rides the
bench line (``secondary.obs``) and the per-server registry.

Process-wide by design, like :data:`ratis_tpu_torch.trace.tracer.TRACER` and
the codec's ``FANOUT_STATS``: co-hosted servers in one process share the
counters, and the bench's cluster-wide hops line up with its
cluster-wide commit count.  Sites:

- ``sender_wake``  — a PeerSender flush-loop wakeup (legacy) or one armed
  cross-group sweep pass (sweep mode) in the replication scheduler.
- ``engine_wake``  — an engine tick wake actually scheduled
  (``call_soon_threadsafe`` issued / event set); the intake-lock dedupe
  collapses ack bursts to one.
- ``reply_future`` — one per-request pending-reply future resolution
  waking the parked write-handler task (the legacy commit->reply wakeup
  the waterline fan-out removes).
- ``reply_window`` — one per-request ordered-window future resolution
  carrying a real reply (second wakeup of the legacy chain; absent when
  the client skips the sliding window).
- ``reply_send``   — one per-request reply handed to the transport's
  per-request send/drain path (the handler task suspends for the
  flush/drain; third wakeup of the legacy chain on socket transports).
- ``reply_flush``  — one per-connection reply-drain callback armed by
  the transport's deferred-reply batcher (sweep mode's replacement for
  ALL of the above: one scheduled callback per connection per burst).
- ``reply_batch``  — one waterline fan-out pass resolving a whole batch
  of committed requests.  NOT a hop (the pass is a synchronous call the
  apply loop was running anyway); counted for batch-size observability
  (deliveries / passes = the average fan-out batch).

The reply-plane metric counts the SCHEDULED operations between a commit
advancing and its reply reaching the wire; the final client-waiter
wakeup (transport reply hand-back) exists identically in both modes and
is excluded as common cost, as is the connection coalescer's flush task
(identical per-batch cost both modes).

Three more counts share the store, none of them a scheduling hop:

- ``transport_flush`` — one coalesced socket write
  (``transport/coalesce.py``), and ``transport_frame`` the frames it
  carried, both counted while tracing is on;
- ``gc_ns`` — nanoseconds the collector ran, counted by the tracer's
  ``gc.callbacks`` hook while tracing is on (``trace/tracer.py``).

The tracer's window snapshot carries every site's count since its reset
(or since :func:`reset`, if that came later: see :func:`epoch`).
"""

from __future__ import annotations

SCHEDULING_SITES = ("sender_wake", "engine_wake", "reply_future",
                    "reply_window", "reply_send", "reply_batch",
                    "reply_flush")
HOP_SITES = SCHEDULING_SITES + ("transport_flush", "transport_frame",
                                "gc_ns")

# reply-plane subset: the SCHEDULED hops between a commit advancing and
# its reply reaching the transport — the surface the fan-out collapse
# targets (reply_batch is a synchronous pass, not a hop; see above)
REPLY_SITES = ("reply_future", "reply_window", "reply_send", "reply_flush")

_counts: dict[str, int] = {s: 0 for s in HOP_SITES}
# bumped by every reset(): a baseline snapshot taken before it is void
_epoch = 0


def hop(site: str, n: int = 1) -> None:
    """Count ``n`` at ``site``: one scheduling operation by default (hot
    path: one dict increment; sites are fixed, an unknown site is a
    programming error)."""
    _counts[site] += n


def snapshot() -> dict[str, int]:
    return dict(_counts)


def reply_plane_hops() -> int:
    return sum(_counts[s] for s in REPLY_SITES)


def total_hops() -> int:
    return sum(_counts[s] for s in SCHEDULING_SITES)


def epoch() -> int:
    """How many times :func:`reset` has zeroed the store."""
    return _epoch


def reset() -> None:
    global _epoch
    for s in HOP_SITES:
        _counts[s] = 0
    _epoch += 1
