"""The placement actuator: rate-limited execution of a PlacementPlan.

Transfers ride the EXISTING admin path — an in-process
TransferLeadership RaftClientRequest submitted on the group's owning
loop, exactly the frames the shell/client transfer sends — so every
guard on that path (leader check, hibernation wake, voting-member
validation, the match-then-StartLeaderElection handshake) applies to
controller-initiated moves too.  Steering writes the server's
ReadSteering table (server/read.py), which the batched readIndex sweep
consults.

Rate limiting and anti-ping-pong:
- the per-round transfer cap is applied in the PLAN (policy.plan), so
  the dry-run and the executed round agree;
- every transferred group enters a per-group ``cooldown`` window here;
  the controller feeds the live cooldown set back into the next plan's
  ``exclude``;
- steering renewals inside an active TTL are silent (one journal pair
  per episode, not one per policy round).

Every actuation is journaled through the watchdog as a KIND_REBALANCE
event paired with a KIND_REBALANCE_DONE close (same fault-correlation
id, outcome in the detail) — emitted in a finally-like discipline so
even a shutdown mid-transfer leaves a paired ``aborted`` close, never a
dangling actuation.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Optional

LOG = logging.getLogger(__name__)


class PlacementActuator:
    """Executes plans against the local server (controller frontend
    only; the shell executes through a real admin client instead)."""

    def __init__(self, server, *, cooldown_s: float,
                 steer_ttl_s: float, transfer_timeout_s: float):
        from ratis_tpu_torch.protocol.ids import ClientId
        self.server = server
        self.cooldown_s = cooldown_s
        self.steer_ttl_s = steer_ttl_s
        self.transfer_timeout_s = transfer_timeout_s
        self._cooldown: dict[str, float] = {}  # group -> monotonic expiry
        self._client_id = ClientId.random_id()
        self._call_ids = itertools.count(1)
        self._seq = 0
        self.transfers_ok = 0
        self.transfers_failed = 0
        self.steers = 0
        self.skipped = 0

    def cooldown_groups(self, now: Optional[float] = None) -> set:
        """Groups still inside their post-transfer cooldown (pruned);
        the controller passes this as the next plan's ``exclude``."""
        if now is None:
            now = time.monotonic()
        dead = [g for g, t in self._cooldown.items() if t <= now]
        for g in dead:
            del self._cooldown[g]
        return set(self._cooldown)

    # ------------------------------------------------------------ journal

    def _emit(self, kind: str, group: Optional[str], detail: str,
              fault: str) -> None:
        wd = self.server.watchdog
        if wd is not None:
            wd.emit(kind, group, detail, fault=fault)

    def _fault_id(self) -> str:
        self._seq += 1
        return f"rebalance-{self.server.peer_id}-{self._seq}"

    # ------------------------------------------------------------ execute

    async def execute(self, plan) -> dict:
        """Run one plan; returns the round's outcome counts.  Repins are
        advisory and never executed."""
        from ratis_tpu_torch.server.watchdog import (KIND_REBALANCE,
                                               KIND_REBALANCE_DONE)
        out = {"transfers_ok": 0, "transfers_failed": 0, "steers": 0,
               "skipped": 0}
        steering = self.server.read_steering
        for a in plan.steers():
            if not steering.steer(a.away_from, self.steer_ttl_s):
                continue  # renewal inside an active episode
            fid = self._fault_id()
            self._emit(KIND_REBALANCE, None,
                       f"steer reads away from {a.away_from}: {a.reason}",
                       fid)
            # steering is a table write: it converges the moment it
            # lands, so the episode's done pair closes immediately
            self._emit(KIND_REBALANCE_DONE, None,
                       f"steering {a.away_from} active "
                       f"({self.steer_ttl_s:g}s ttl): success", fid)
            out["steers"] += 1
            self.steers += 1

        now = time.monotonic()
        cooling = self.cooldown_groups(now)
        for a in plan.transfers():
            if a.group in cooling:
                out["skipped"] += 1
                self.skipped += 1
                continue
            div = (self.server.divisions.get(a.gid)
                   if a.gid is not None else None)
            if div is None or not div.is_leader():
                # leadership moved (or the plan came from a stale/foreign
                # view) between scoring and actuation — not an error
                out["skipped"] += 1
                self.skipped += 1
                continue
            self._cooldown[a.group] = now + self.cooldown_s
            fid = self._fault_id()
            self._emit(KIND_REBALANCE, a.group,
                       f"transfer leadership -> {a.to_peer}: {a.reason}",
                       fid)
            outcome, err = "failed", ""
            try:
                reply = await self._transfer(div, a.to_peer)
                if reply is not None and reply.success:
                    outcome = "success"
                    out["transfers_ok"] += 1
                    self.transfers_ok += 1
                else:
                    exc = getattr(reply, "exception", None)
                    err = str(exc or "no reply")[:120]
                    out["transfers_failed"] += 1
                    self.transfers_failed += 1
            except asyncio.CancelledError:
                self._emit(KIND_REBALANCE_DONE, a.group,
                           f"transfer -> {a.to_peer}: aborted (shutdown)",
                           fid)
                raise
            except Exception as e:
                err = f"{type(e).__name__}: {e}"[:120]
                out["transfers_failed"] += 1
                self.transfers_failed += 1
            self._emit(KIND_REBALANCE_DONE, a.group,
                       f"transfer -> {a.to_peer}: {outcome}"
                       + (f" ({err})" if err else ""), fid)
        return out

    async def _transfer(self, div, target: str):
        """Submit the admin TransferLeadership request in-process on the
        division's owning loop (the same request the shell/client path
        builds — bench_cluster.run_churn_bench drives it over a real
        transport)."""
        from ratis_tpu_torch.protocol.admin import TransferLeadershipArguments
        from ratis_tpu_torch.protocol.message import Message
        from ratis_tpu_torch.protocol.requests import (RaftClientRequest,
                                                 RequestType,
                                                 admin_request_type)
        timeout_ms = self.transfer_timeout_s * 1000.0
        args = TransferLeadershipArguments(str(target), timeout_ms)
        req = RaftClientRequest(
            self._client_id, self.server.peer_id, div.group_id,
            next(self._call_ids), Message(args.to_payload()),
            type=admin_request_type(RequestType.TRANSFER_LEADERSHIP),
            timeout_ms=timeout_ms + 2000.0)
        return await self.server._run_on_division_loop(
            div.group_id, div.submit_client_request(req))
