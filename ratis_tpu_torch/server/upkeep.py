"""UpkeepPlane: per-loop-shard vectorized host bookkeeping.

One plane per loop shard holds the packed ``[capacity, N_CHANNELS]``
deadline array (ops/upkeep.py) with one dense slot per registered
division.  The shard's heartbeat sweep then does ONE ``deadlines <= now``
compare + ``nonzero`` scan and dispatches only the due groups, instead of
walking every division it owns:

- CH_HEARTBEAT — the leader's next heartbeat due-time, min over appenders
  of max(last_ack + 0.9*hb, last_send + 0.45*hb); non-leaders hold +inf
  and cost nothing.  Armed conservatively EARLY: an early dispatch runs
  ``heartbeat_item`` which declines exactly as the legacy loop would, so
  an early deadline can never change behavior, only cost.
- CH_HIBERNATE — an asleep leader's backstop refresh clock (backstop/4);
  while asleep CH_HEARTBEAT is cleared, so the slot is touched a handful
  of times per minute instead of every sweep.
- CH_CACHE — oldest-expiry waterline over the division's retry cache and
  WriteIndexCache; an idle shard with empty caches does zero expiry work.
- CH_WINDOW — client-window idle sweep, armed only while windows exist.
- CH_WATCH — a dirty mark (0.0) set by ack paths; the sweep folds the
  per-ack ``_update_watch_frontiers`` calls into one per dirty slot.

Slot lifecycle reuses the engine ledger's generation-guard pattern
(engine/ledger.py): every (re)allocation bumps ``gen[slot]``, and every
write/clear validates the caller's generation, so a division removed and
replaced by another cannot fire stale deadlines into the new tenant.

Threading: a plane is owned by its shard's event loop — division
start/close and the sweep all run there (divisions are loop-affine), so
like the rest of the server there are no locks.  The ack paths that mark
CH_WATCH dirty also run on the division's own loop.

Everything here is gated behind ``raft.tpu.upkeep.enabled``; unset, no
plane exists and every caller falls through to the per-group legacy path
bit-for-bit.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Optional

import numpy as np

from ratis_tpu_torch.ops import upkeep as ops
from ratis_tpu_torch.ops.upkeep import (CH_CACHE, CH_HEARTBEAT, CH_HIBERNATE,
                                  CH_WATCH, CH_WINDOW, N_CHANNELS,
                                  NO_DEADLINE)

if TYPE_CHECKING:
    from ratis_tpu_torch.server.division import Division

LOG = logging.getLogger(__name__)

_INITIAL_CAPACITY = 64


class UpkeepPlane:
    """Dense per-group deadline slots for one loop shard."""

    def __init__(self, server, shard: int = 0):
        self.server = server
        self.shard = shard
        self._cap = _INITIAL_CAPACITY
        self.deadlines = ops.new_deadlines(self._cap)
        # per-slot min over channels, kept current on every write: the
        # sweep scans THIS [cap] vector, not the [cap, 5] matrix, so the
        # per-tick cost is dominated by fixed numpy overhead (ops/upkeep
        # due_scan_min), not by element count
        self.row_min = np.full(self._cap, NO_DEADLINE, dtype=np.float64)
        # generation guard (engine/ledger.py pattern): bumped on every
        # allocation; stale (slot, gen) writes are dropped.
        self.gen = np.zeros(self._cap, dtype=np.int64)
        self._divisions: list[Optional["Division"]] = [None] * self._cap
        self._free: list[int] = list(range(self._cap - 1, -1, -1))
        self.registered = 0
        # sweep-cost observability (metrics registered by the server once
        # per plane under the `upkeep_plane` registry)
        self.sweeps = 0
        self.idle_skips = 0
        self.last_due = 0
        self._timer = None
        self._idle_counter = None

    # ------------------------------------------------------------ lifecycle

    def _grow(self) -> None:
        new_cap = self._cap * 2
        grown = ops.new_deadlines(new_cap)
        grown[:self._cap] = self.deadlines
        self.deadlines = grown
        row_min = np.full(new_cap, NO_DEADLINE, dtype=np.float64)
        row_min[:self._cap] = self.row_min
        self.row_min = row_min
        gen = np.zeros(new_cap, dtype=np.int64)
        gen[:self._cap] = self.gen
        self.gen = gen
        self._divisions.extend([None] * (new_cap - self._cap))
        self._free.extend(range(new_cap - 1, self._cap - 1, -1))
        self._cap = new_cap

    def register(self, div: "Division") -> tuple[int, int]:
        """Allocate a slot for a starting division; all channels unarmed."""
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.gen[slot] += 1
        self.deadlines[slot, :] = NO_DEADLINE
        self.row_min[slot] = NO_DEADLINE
        self._divisions[slot] = div
        self.registered += 1
        return slot, int(self.gen[slot])

    def unregister(self, slot: int, gen: int) -> None:
        if not self._valid(slot, gen):
            return
        self.gen[slot] += 1  # invalidate outstanding (slot, gen) handles
        self.deadlines[slot, :] = NO_DEADLINE
        self.row_min[slot] = NO_DEADLINE
        self._divisions[slot] = None
        self._free.append(slot)
        self.registered -= 1

    def _valid(self, slot: int, gen: int) -> bool:
        return 0 <= slot < self._cap and self.gen[slot] == gen \
            and self._divisions[slot] is not None

    def division_at(self, slot: int) -> Optional["Division"]:
        return self._divisions[slot]

    # ------------------------------------------------------------- deadlines

    def set_deadline(self, slot: int, gen: int, channel: int,
                     when: float) -> None:
        if self._valid(slot, gen):
            self.deadlines[slot, channel] = when
            self.row_min[slot] = self.deadlines[slot].min()

    def clear(self, slot: int, gen: int, channel: int) -> None:
        if self._valid(slot, gen):
            self.deadlines[slot, channel] = NO_DEADLINE
            self.row_min[slot] = self.deadlines[slot].min()

    def mark_watch_dirty(self, slot: int, gen: int) -> None:
        """O(1) store from the ack paths; folded into the next sweep."""
        if self._valid(slot, gen):
            self.deadlines[slot, CH_WATCH] = 0.0
            self.row_min[slot] = self.deadlines[slot].min()

    def is_armed(self, slot: int, gen: int, channel: int) -> bool:
        return self._valid(slot, gen) \
            and self.deadlines[slot, channel] != NO_DEADLINE

    # ----------------------------------------------------------------- sweep

    def sweep(self, now: float) -> tuple[np.ndarray, np.ndarray]:
        """One vectorized scan: returns (due_slots, due_mask) where
        due_mask is [len(due_slots), N_CHANNELS].  The caller dispatches;
        the caller also re-arms (dispatch outcomes decide the next due)."""
        self.sweeps += 1
        slots = ops.due_scan_min(self.row_min, now)
        self.last_due = len(slots)
        if len(slots) == 0:
            self.idle_skips += 1
            if self._idle_counter is not None:
                self._idle_counter.inc()
            return slots, np.zeros((0, N_CHANNELS), dtype=bool)
        return slots, ops.due_channels(self.deadlines, slots, now)


def create_planes(server) -> list[UpkeepPlane]:
    """One plane per loop shard (a single plane when unsharded)."""
    n = server.loop_shards if server.shards is not None else 1
    return [UpkeepPlane(server, shard=i) for i in range(n)]
