"""The placement plan engine: cluster snapshot in, explainable plan out.

Pure scoring — no I/O, no server references — so the in-server policy
loop (controller.py, fed from the already-fetched ledger/sketch data)
and the ``shell rebalance`` frontend (fed from scraped ``/divisions``
``/lag`` ``/hotgroups`` ``/health`` payloads) compute the SAME plan from
the same facts.  O(servers + k) python per pass: the inputs are the
per-server rollups and the top-k sketch entries, never a divisions walk
(tools/check_hot_loops.py scans this package to keep it that way).

Scoring model (docs/placement.md):

- A group is **hot** when its sketch ``share_min`` (the guaranteed
  lower bound on its share of tracked commit load) is at least
  ``hot-share``.
- Each server's **fair share** of the hot set is ``ceil(hot /
  servers)``; a server leading more than ``fair + hysteresis`` hot
  groups sheds its hottest excess to the healthiest least-loaded peer.
  ``hysteresis`` is the anti-ping-pong band: after a transfer lands the
  source is AT fair share and the recipient is below the band, so the
  reverse move never plans.
- In the single-view in-server loop, hot-group shedding additionally
  requires live admission pressure (``shed_rate > 0``): sketch shares
  are relative to each server's OWN traffic, so the recipient of the
  fleet's hottest group sees it dominate a small local denominator and
  would otherwise bounce it straight back.  A server that isn't
  shedding requests has nothing for a transfer to relieve.
- A peer inside a watchdog grey episode, or scoring under
  ``grey-score`` on the lag ledger's health score, is steered away from
  as a readIndex confirmation target (and never picked as a transfer
  target).
- With a multi-server snapshot (the shell), a raw leadership-count
  spread beyond the hysteresis band plans one corrective transfer per
  round even when nothing crosses the hot-share floor.
- Shard-occupancy skew inside one server emits an ADVISORY
  ``RepinShard`` (printed with the plan; no repin actuator exists yet).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TransferLeadership:
    """Move ``group``'s leadership to ``to_peer``.  ``gid`` carries the
    RaftGroupId object on locally-built snapshots (the in-server
    actuator needs it; ``str(gid)`` is display-only and not parseable
    back); scraped snapshots leave it None and the shell resolves the
    display string through group_list."""
    group: str
    to_peer: str
    reason: str
    category: str = "hot-group"   # short slug for transfersIssued{reason=}
    gid: object = None

    kind = "transfer"


@dataclasses.dataclass(frozen=True)
class SteerReads:
    """Deprioritize ``away_from`` as a readIndex confirmation target
    (group "*": steering is a per-peer decision — the sweep applies it
    to every group that can still reach majority without the peer)."""
    away_from: str
    reason: str
    group: str = "*"
    category: str = "grey-steer"

    kind = "steer"


@dataclasses.dataclass(frozen=True)
class RepinShard:
    """ADVISORY: ``group`` would be better placed on loop shard
    ``shard``.  No repin actuator exists; the action is planned and
    printed so the skew is visible, never executed."""
    group: str
    shard: int
    reason: str
    category: str = "shard-skew"

    kind = "repin"


@dataclasses.dataclass(frozen=True)
class HotGroup:
    """One sketch entry as the policy sees it (from ``/hotgroups`` or
    straight off the sketch)."""
    group: str
    share: float = 0.0
    share_min: float = 0.0
    pending: int = 0
    led: bool = False            # does the viewing server lead it?
    shard: Optional[int] = None  # loop shard on the viewing server
    gid: object = None           # RaftGroupId object (local views only)


@dataclasses.dataclass
class ServerView:
    """One server's sensor rollup: everything the policy may consult,
    all O(peers + k) to build."""
    peer: str
    leading: int = 0
    pending_total: int = 0
    shed_total: int = 0
    shed_rate: float = 0.0
    divisions: int = 0
    shard_counts: tuple = ()         # divisions per loop shard (rollup)
    peer_scores: dict = dataclasses.field(default_factory=dict)
    grey_peers: frozenset = frozenset()
    hot_groups: tuple = ()           # HotGroup records, hottest first
    laggard_groups: tuple = ()       # /lag "groups" payload rows


@dataclasses.dataclass(frozen=True)
class ClusterSnapshot:
    """The policy input: one view per scraped server (the in-server loop
    runs on its own single view; the shell aggregates all of them)."""
    views: tuple

    def view(self, peer: str) -> Optional[ServerView]:
        for v in self.views:
            if v.peer == peer:
                return v
        return None


def view_from_payloads(peer: Optional[str] = None,
                       health: Optional[dict] = None,
                       lag: Optional[dict] = None,
                       hotgroups: Optional[dict] = None,
                       rollup: Optional[dict] = None,
                       grey=(), shed_rate: float = 0.0) -> ServerView:
    """Build one ServerView from the introspection payloads (any subset;
    the shell tolerates e.g. a 404 ``/hotgroups`` on a telemetry-off
    server).  The controller's local view takes the same shape, so both
    frontends score identical facts."""
    for src in (lag, rollup, health, hotgroups):
        if peer is None and src:
            peer = src.get("peer")
    v = ServerView(peer=str(peer or "?"), grey_peers=frozenset(grey),
                   shed_rate=shed_rate)
    if lag:
        v.leading = int(lag.get("leading", 0))
        v.peer_scores = {p["peer"]: float(p.get("score", 1.0))
                         for p in lag.get("peers", ())}
        v.laggard_groups = tuple(lag.get("groups", ()))
    if rollup:
        v.leading = int(rollup.get("leading", v.leading))
        v.pending_total = int(rollup.get("pendingTotal", 0))
        v.divisions = int(rollup.get("divisions", 0))
        v.shard_counts = tuple(rollup.get("shards", ()))
    if health:
        serving = health.get("serving", {})
        v.shed_total = int(serving.get("shedTotal", 0))
        if not v.pending_total:
            v.pending_total = int(serving.get("pendingCount", 0))
        if not v.divisions:
            v.divisions = int(health.get("divisions", 0))
    if hotgroups:
        v.hot_groups = tuple(
            HotGroup(group=g["group"], share=float(g.get("share", 0.0)),
                     share_min=float(g.get("share_min", 0.0)),
                     pending=int(g.get("pending", 0)),
                     led=bool(g.get("led", False)), shard=g.get("shard"))
            for g in hotgroups.get("groups", ()))
    return v


@dataclasses.dataclass
class PlacementPlan:
    """A typed, explainable round of actions.  ``imbalance`` is the
    round's headline gauge: max(hot-lead excess over fair share as a
    fraction of fair, multi-server leadership spread / mean); 0.0 = the
    policy sees nothing to move."""
    actions: list = dataclasses.field(default_factory=list)
    imbalance: float = 0.0
    notes: list = dataclasses.field(default_factory=list)

    def transfers(self) -> list:
        return [a for a in self.actions if a.kind == "transfer"]

    def steers(self) -> list:
        return [a for a in self.actions if a.kind == "steer"]

    def repins(self) -> list:
        return [a for a in self.actions if a.kind == "repin"]

    def explain(self) -> list:
        """Human lines, one per action + one per note — what the shell
        prints and ``GET /placement`` serves."""
        lines = []
        for a in self.actions:
            if a.kind == "transfer":
                lines.append(f"TRANSFER {a.group} -> {a.to_peer}: "
                             f"{a.reason}")
            elif a.kind == "steer":
                lines.append(f"STEER reads away from {a.away_from}: "
                             f"{a.reason}")
            else:
                lines.append(f"REPIN (advisory) {a.group} -> shard "
                             f"{a.shard}: {a.reason}")
        lines.extend(f"note: {n}" for n in self.notes)
        return lines

    def to_dict(self) -> dict:
        return {
            "imbalance": self.imbalance,
            "actions": [dataclasses.asdict(
                a, dict_factory=lambda kv: {k: v for k, v in kv
                                            if k != "gid"})
                        | {"kind": a.kind} for a in self.actions],
            "notes": list(self.notes),
            "explain": self.explain(),
        }


class PlacementPolicy:
    """The scoring pass.  Thresholds mirror ``raft.tpu.placement.*``;
    both frontends construct it from the same defaults so dry-run and
    the loop agree."""

    def __init__(self, *, hot_share: float = 0.2, grey_score: float = 0.5,
                 hysteresis: float = 1.0, max_transfers_per_round: int = 2):
        self.hot_share = hot_share
        self.grey_score = grey_score
        self.hysteresis = hysteresis
        self.max_transfers_per_round = max_transfers_per_round

    # ------------------------------------------------------------- scoring

    def _steer_targets(self, snapshot: ClusterSnapshot) -> list:
        """(peer, reason) for every peer the round should steer away
        from, deduped across views (grey episodes first — they carry the
        sharper diagnosis)."""
        out, seen = [], set()
        for v in snapshot.views:
            for name in sorted(v.grey_peers):
                if name not in seen:
                    seen.add(name)
                    out.append((name, f"grey-follower episode observed "
                                      f"by {v.peer}"))
        for v in snapshot.views:
            for name in sorted(v.peer_scores):
                score = v.peer_scores[name]
                if name in seen or name == v.peer:
                    continue
                if score < self.grey_score:
                    seen.add(name)
                    out.append((name, f"health score {score:.2f} < "
                                      f"{self.grey_score:.2f} "
                                      f"(view of {v.peer})"))
        return out

    def _candidates(self, snapshot: ClusterSnapshot, view: ServerView,
                    steered: set) -> list:
        """Transfer targets from ``view``, best first: healthy (not
        steered/grey, score >= grey-score), least-loaded when the
        snapshot knows other servers' leadership counts."""
        if len(snapshot.views) > 1:
            ranked = []
            for other in snapshot.views:
                name = other.peer
                if name == view.peer or name in steered \
                        or name in view.grey_peers:
                    continue
                score = view.peer_scores.get(name, 1.0)
                if score < self.grey_score:
                    continue
                ranked.append((other.leading, -score, name))
            return [r[2] for r in sorted(ranked)]
        ranked = []
        for name in sorted(view.peer_scores):
            score = view.peer_scores[name]
            if name == view.peer or name in steered \
                    or name in view.grey_peers or score < self.grey_score:
                continue
            ranked.append((-score, name))
        return [r[1] for r in sorted(ranked)]

    def plan(self, snapshot: ClusterSnapshot,
             exclude=()) -> PlacementPlan:
        """One scoring pass.  ``exclude`` is the actuator's cooldown set
        (group display strings): excluded groups are skipped WITH a
        note, and the per-round transfer cap is applied HERE so a
        dry-run prints exactly the plan the loop would execute."""
        plan = PlacementPlan()
        exclude = set(exclude)
        steered = set()
        for name, reason in self._steer_targets(snapshot):
            steered.add(name)
            plan.actions.append(SteerReads(away_from=name, reason=reason))

        # the cluster-wide hot set and each server's fair share of it
        hot_names = {g.group for v in snapshot.views for g in v.hot_groups
                     if g.share_min >= self.hot_share}
        n_servers = len(snapshot.views)
        if n_servers == 1:
            v = snapshot.views[0]
            n_servers = 1 + len([p for p in v.peer_scores if p != v.peer])
        fair = math.ceil(len(hot_names) / max(1, n_servers))
        hot_excess = 0
        transfers: list = []
        for v in snapshot.views:
            led_hot = sorted(
                (g for g in v.hot_groups
                 if g.led and g.share_min >= self.hot_share),
                key=lambda g: -g.share_min)
            excess = len(led_hot) - fair
            hot_excess = max(hot_excess, excess)
            if excess <= 0 or len(led_hot) <= fair + self.hysteresis:
                continue
            if len(snapshot.views) == 1 and v.shed_rate <= 0.0:
                # single-view guard against transfer ping-pong: each
                # server's sketch shares are relative to ITS OWN traffic,
                # so the server that just RECEIVED the fleet's hottest
                # group sees it dominate a small local denominator and
                # would bounce it straight back.  Shed leaderships only
                # while admission is actually shedding requests — the
                # pressure signal the transfer exists to relieve.  The
                # multi-view shell compares like with like and needs no
                # gate.
                plan.notes.append(
                    f"{v.peer} leads {len(led_hot)} hot group(s) (fair "
                    f"{fair}) but sheds no requests; holding until "
                    f"admission pressure shows")
                continue
            targets = self._candidates(snapshot, v, steered)
            if not targets:
                plan.notes.append(
                    f"{v.peer} leads {len(led_hot)} hot group(s) (fair "
                    f"{fair}) but no healthy transfer target exists")
                continue
            for i, g in enumerate(led_hot[:excess]):
                transfers.append(TransferLeadership(
                    group=g.group, to_peer=targets[i % len(targets)],
                    reason=(f"{v.peer} leads {len(led_hot)} hot groups "
                            f"(fair share {fair}); {g.group} share_min "
                            f"{g.share_min:.2f} >= {self.hot_share:.2f}"),
                    category="hot-group", gid=g.gid))

        # raw leadership-count spread (multi-server snapshots only): one
        # corrective move per round when nothing crossed hot-share
        lead_spread = 0.0
        if len(snapshot.views) > 1:
            leads = [v.leading for v in snapshot.views]
            mean = sum(leads) / len(leads)
            spread = max(leads) - min(leads)
            lead_spread = spread / max(1.0, mean)
            if not transfers and spread > max(1.0, self.hysteresis):
                src = max(snapshot.views, key=lambda v: v.leading)
                led_any = sorted((g for g in src.hot_groups if g.led),
                                 key=lambda g: -g.share_min)
                targets = self._candidates(snapshot, src, steered)
                if led_any and targets:
                    g = led_any[0]
                    transfers.append(TransferLeadership(
                        group=g.group, to_peer=targets[0],
                        reason=(f"leadership spread {max(leads)}-"
                                f"{min(leads)} > hysteresis "
                                f"{self.hysteresis:g}; moving "
                                f"{src.peer}'s busiest led group"),
                        category="leader-imbalance", gid=g.gid))

        kept = 0
        for t in transfers:
            if t.group in exclude:
                plan.notes.append(f"{t.group}: in cooldown, skipped")
                continue
            if kept >= self.max_transfers_per_round:
                plan.notes.append(
                    f"{t.group}: over max-transfers-per-round "
                    f"({self.max_transfers_per_round}), deferred")
                continue
            kept += 1
            plan.actions.append(t)

        # shard-occupancy skew -> advisory repin (never actuated)
        for v in snapshot.views:
            if len(v.shard_counts) > 1:
                hi = max(range(len(v.shard_counts)),
                         key=lambda i: v.shard_counts[i])
                lo = min(range(len(v.shard_counts)),
                         key=lambda i: v.shard_counts[i])
                if v.shard_counts[hi] - v.shard_counts[lo] <= 1:
                    continue
                on_hi = [g for g in v.hot_groups if g.shard == hi]
                if on_hi:
                    plan.actions.append(RepinShard(
                        group=on_hi[0].group, shard=lo,
                        reason=(f"{v.peer} shard occupancy "
                                f"{list(v.shard_counts)}: shard {hi} "
                                f"carries {v.shard_counts[hi]} divisions "
                                f"vs {v.shard_counts[lo]}")))

        plan.imbalance = round(max(
            hot_excess / max(1, fair) if hot_excess > 0 else 0.0,
            lead_spread), 4)
        return plan
