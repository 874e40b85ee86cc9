"""The in-server placement policy loop (``raft.tpu.placement.enabled``).

Opt-in and zero-cost when off: the server only constructs this when the
key is set, so the default request/read paths are bit-identical to a
build without the subsystem.  When on, one scoring pass per interval
over data the host ALREADY collects — the lag & health ledger sample
(one fused device pass), the hot-group sketch's top-k, the admission
controller's shed counter, the watchdog's grey set — O(servers + k)
python, never a divisions walk (tools/check_hot_loops.py enforces it).

The loop builds the same ServerView shape the shell builds from scraped
endpoints, runs the same PlacementPolicy, and hands the plan to the
PlacementActuator, which feeds its live cooldown set back into the next
plan's exclude — so ``shell rebalance --dry-run`` against this server
prints exactly the plan the loop is executing, with the same reasons.

Observability: the ``placement_plane`` registry (plansComputed,
transfersIssued{reason=...}, steeredReads, lastImbalance) and the
``GET /placement`` route serving the last computed plan, explained.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ratis_tpu_torch.metrics.registry import (MetricRegistries, MetricRegistryInfo,
                                        labeled)
from ratis_tpu_torch.placement.actuate import PlacementActuator
from ratis_tpu_torch.placement.policy import (ClusterSnapshot, HotGroup,
                                        PlacementPolicy, view_from_payloads)

LOG = logging.getLogger(__name__)


class PlacementController:
    """One per server.  Constructor kwargs override the raft.tpu.placement.*
    properties (the StallWatchdog idiom — tests and the chaos harness
    retune without rebuilding RaftProperties)."""

    def __init__(self, server, interval_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 max_per_round: Optional[int] = None,
                 hot_share: Optional[float] = None,
                 grey_score: Optional[float] = None,
                 hysteresis: Optional[float] = None,
                 steer_ttl_s: Optional[float] = None,
                 transfer_timeout_s: Optional[float] = None):
        from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
        keys = RaftServerConfigKeys.Placement
        p = server.properties
        self.server = server
        self.interval_s = (interval_s if interval_s is not None
                           else keys.interval(p).seconds)
        self.policy = PlacementPolicy(
            hot_share=(hot_share if hot_share is not None
                       else keys.hot_share(p)),
            grey_score=(grey_score if grey_score is not None
                        else keys.grey_score(p)),
            hysteresis=(hysteresis if hysteresis is not None
                        else keys.hysteresis(p)),
            max_transfers_per_round=(max_per_round
                                     if max_per_round is not None
                                     else keys.max_transfers(p)))
        self.actuator = PlacementActuator(
            server,
            cooldown_s=(cooldown_s if cooldown_s is not None
                        else keys.cooldown(p).seconds),
            steer_ttl_s=(steer_ttl_s if steer_ttl_s is not None
                         else keys.steer_ttl(p).seconds),
            transfer_timeout_s=(transfer_timeout_s
                                if transfer_timeout_s is not None
                                else keys.transfer_timeout(p).seconds))
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self.rounds = 0
        self.last_plan = None
        self.last_imbalance = 0.0
        self._last_shed: Optional[int] = None
        self._last_shed_t: Optional[float] = None
        info = MetricRegistryInfo(prefix=str(server.peer_id),
                                  application="ratis", component="server",
                                  name="placement_plane")
        self.registry = MetricRegistries.global_registries().create(info)
        self.plans_computed = self.registry.counter("plansComputed")
        self._transfer_counters: dict = {}
        self.registry.gauge("steeredReads",
                            lambda: server.read_steering.steered)
        self.registry.gauge("lastImbalance", lambda: self.last_imbalance)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._running = True
        self._task = asyncio.create_task(
            self._run(), name=f"placement-{self.server.peer_id}")

    async def close(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        MetricRegistries.global_registries().remove(self.registry.info)

    # ------------------------------------------------------------- the loop

    async def _run(self) -> None:
        while self._running:
            await asyncio.sleep(self.interval_s)
            try:
                await self.round()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the controller must never take the server down with it
                LOG.exception("%s placement round failed",
                              self.server.peer_id)

    async def round(self) -> None:
        """One sense -> plan -> actuate pass.  Public so tests and the
        chaos harness can force a round."""
        snapshot = ClusterSnapshot(views=(self._local_view(),))
        plan = self.policy.plan(snapshot,
                                exclude=self.actuator.cooldown_groups())
        self.rounds += 1
        self.plans_computed.inc()
        self.last_plan = plan
        self.last_imbalance = plan.imbalance
        for t in plan.transfers():
            c = self._transfer_counters.get(t.category)
            if c is None:
                c = self.registry.counter(
                    labeled("transfersIssued", reason=t.category))
                self._transfer_counters[t.category] = c
            c.inc()
        await self.actuator.execute(plan)

    def _local_view(self):
        """This server's ServerView from already-collected sensor state:
        the lag payload (one ledger pass), the sketch's top-k with gid
        objects for the actuator, the watchdog's live grey set, and the
        admission shed rate over the last round."""
        srv = self.server
        lag = srv.lag_info()
        grey = (set(srv.watchdog._grey)
                if srv.watchdog is not None else set())
        shed = (srv.serving.admission.shed_total
                if getattr(srv, "serving", None) is not None else 0)
        now = time.monotonic()
        rate = 0.0
        if self._last_shed is not None and self._last_shed_t is not None:
            rate = max(0, shed - self._last_shed) \
                / max(1e-9, now - self._last_shed_t)
        self._last_shed, self._last_shed_t = shed, now
        view = view_from_payloads(peer=str(srv.peer_id), lag=lag,
                                  grey=grey, shed_rate=rate)
        view.shed_total = shed
        view.divisions = len(srv.divisions)
        tel = srv.telemetry
        if tel is not None:
            tel.maybe_sample()
            total = max(1, tel.sketch.total)
            hot = []
            for e in tel.sketch.top(None):
                gid = e["key"]
                div = srv.divisions.get(gid)
                hot.append(HotGroup(
                    group=str(gid),
                    share=round(e["count"] / total, 4),
                    share_min=round(
                        max(0, e["count"] - e["err"]) / total, 4),
                    pending=e["aux"] or 0,
                    led=div is not None and div.is_leader(),
                    shard=srv.shard_of_group(gid), gid=gid))
            view.hot_groups = tuple(hot)
        return view

    # ------------------------------------------------------------- payloads

    def placement_info(self, query=None) -> dict:
        """``GET /placement``: the last computed plan (explained), the
        actuator's tallies, and what is currently steered/cooling."""
        a = self.actuator
        return {
            "enabled": True,
            "peer": str(self.server.peer_id),
            "interval_s": self.interval_s,
            "rounds": self.rounds,
            "lastImbalance": self.last_imbalance,
            "lastPlan": (self.last_plan.to_dict()
                         if self.last_plan is not None else None),
            "steeredPeers": sorted(self.server.read_steering.avoided()),
            "steeredReads": self.server.read_steering.steered,
            "cooldownGroups": sorted(a.cooldown_groups()),
            "transfersOk": a.transfers_ok,
            "transfersFailed": a.transfers_failed,
            "steerEpisodes": a.steers,
            "skipped": a.skipped,
        }
