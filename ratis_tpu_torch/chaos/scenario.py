"""Scenario runner: execute a seed-deterministic fault schedule under
write load, journal every fault and its observed recovery through the
watchdog ``/events`` plane, and assert the recovery SLOs.

A scenario is ``(name, seed, config, steps, slos)`` where ``steps`` is a
pure function of ``(name, seed, config)`` (see
:mod:`ratis_tpu_torch.chaos.scenarios`) — which is what makes a failing run's
``(seed, scenario, journal)`` artifact replayable bit-for-bit by
``python -m ratis_tpu_torch.tools.chaos_replay``.

SLOs asserted on every run:

- **re-election convergence**: after the last fault heals, every group
  has a READY leader within ``slos["convergence_s"]``
  (``raft.tpu.chaos.convergence-timeout`` supplies the campaign default);
- **zero lost acks**: every write the client saw ACKED is applied on
  every live replica — exactly once (the INCONSISTENCY/windowed-rewind
  guard is what this catches regressing);
- **exactly-once apply**: no payload applied twice anywhere (retry-cache
  dedupe across failover), and all replicas applied identical sequences;
- **catch-up under load**: replication + apply drain to the leader's
  commit on every replica within ``slos["recovery_s"]`` while writers
  are still running through the recovery window.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import pathlib
import time
from typing import Optional

from ratis_tpu_torch.chaos.faults import Step
from ratis_tpu_torch.chaos.link import link_faults
from ratis_tpu_torch.protocol.exceptions import (RaftRetryFailureException,
                                           ResourceUnavailableException)
from ratis_tpu_torch.server.watchdog import (KIND_FAULT_RECOVERED,
                                       KIND_INJECTED_FAULT)
from ratis_tpu_torch.util import injection

LOG = logging.getLogger(__name__)

ARTIFACT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    seed: int
    config: dict           # cluster + load shape (JSON-safe)
    steps: tuple           # tuple[Step, ...] — deterministic from seed
    slos: dict             # {"convergence_s": .., "recovery_s": ..}

    def to_json(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "config": dict(self.config),
                "steps": [s.to_json() for s in self.steps],
                "slos": dict(self.slos)}


@dataclasses.dataclass
class ScenarioResult:
    name: str
    seed: int
    passed: bool = False
    error: Optional[str] = None
    slos: dict = dataclasses.field(default_factory=dict)    # measured
    checks: dict = dataclasses.field(default_factory=dict)  # invariants
    journal: list = dataclasses.field(default_factory=list)
    acked: int = 0
    attempts: int = 0
    baseline_cps: float = 0.0
    recovery_cps: float = 0.0
    # flight-recorder windows (one per telemetry-enabled server),
    # attached on failure: the samples + watchdog events spanning the
    # fault window ride inside the replay artifact
    flight: list = dataclasses.field(default_factory=list)

    @property
    def recovery_frac(self) -> float:
        """Recovery-window throughput as a fraction of the pre-fault
        baseline (1.0 = the fault cost nothing once healed)."""
        if self.baseline_cps <= 0:
            return 0.0
        return round(self.recovery_cps / self.baseline_cps, 3)

    def to_artifact(self, scenario: Scenario) -> dict:
        """Self-contained replay artifact: everything chaos_replay needs
        to re-run this scenario exactly and compare outcomes."""
        out = {"version": ARTIFACT_VERSION,
               "scenario": scenario.to_json(),
               "passed": self.passed, "error": self.error,
               "slos": self.slos, "checks": self.checks,
               "acked": self.acked, "attempts": self.attempts,
               "recovery_frac": self.recovery_frac,
               "journal": self.journal}
        if self.flight:
            out["flight"] = self.flight
        return out


def write_artifact(result: ScenarioResult, scenario: Scenario,
                   artifact_dir: "str | pathlib.Path") -> pathlib.Path:
    d = pathlib.Path(artifact_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"chaos-{scenario.name}-seed{scenario.seed}.json"
    path.write_text(json.dumps(result.to_artifact(scenario), indent=1,
                               sort_keys=True))
    return path


_RUN_IDS = __import__("itertools").count(1)


class _Writers:
    """The scenario's background write load: per-writer RaftClients with
    uniquely tagged payloads (recording mode) or counter INCREMENTs over
    a group sample (counter mode), every ack timestamped so the runner
    can report baseline vs recovery-window throughput.  Payloads carry a
    per-RUN tag so back-to-back scenarios on one long-lived cluster never
    collide in the recording oracle."""

    def __init__(self, cluster, config: dict, tag: str = ""):
        self.cluster = cluster
        self.tag = f"{tag}r{next(_RUN_IDS)}:"
        self.mode = config.get("sm", "recording")
        self.n_writers = int(config.get("writers", 3))
        self.active_groups = int(config.get("active_groups",
                                            min(cluster.num_groups, 8)))
        self.acked: list[bytes] = []
        self.ack_times: list[float] = []
        self.acked_per_group: dict = {}
        self.attempts_per_group: dict = {}
        self.attempts = 0
        # overload accounting (recording mode): a shed write surfaces as
        # a typed ResourceUnavailableException (possibly wrapped in a
        # retry-failure after the policy gives up) — a TIMEOUT means a
        # request was silently dropped, which the overload SLO forbids
        self.timeouts = 0
        self.shed_surfaced = 0
        # counter-oracle baseline: per-(gid, replica) counter value at run
        # start, so back-to-back scenarios on one cluster verify DELTAS
        self.counter_base: dict = {}
        self._stop = asyncio.Event()
        self._tasks: list[asyncio.Task] = []

    def snapshot_counters(self) -> None:
        if self.mode != "counter":
            return
        for g in self.cluster.groups[:self.active_groups]:
            for d in self.cluster.divisions(g.group_id):
                self.counter_base[(g.group_id,
                                   str(d.member_id.peer_id))] = \
                    d.state_machine.counter

    async def _recording_writer(self, wid: int) -> None:
        i = 0
        async with self.cluster.new_client() as client:
            while not self._stop.is_set():
                payload = f"{self.tag}w{wid}-{i}".encode()
                i += 1
                self.attempts += 1
                try:
                    reply = await asyncio.wait_for(
                        client.io().send(payload), 10.0)
                    if reply.success:
                        self.acked.append(payload)
                        self.ack_times.append(time.monotonic())
                    elif isinstance(reply.exception,
                                    ResourceUnavailableException):
                        self.shed_surfaced += 1
                except asyncio.TimeoutError:
                    self.timeouts += 1
                except RaftRetryFailureException as e:
                    if isinstance(e.cause, ResourceUnavailableException):
                        self.shed_surfaced += 1
                except Exception:
                    pass  # unacked: may or may not have committed
                await asyncio.sleep(0.002)

    async def _counter_writer(self, wid: int) -> None:
        from ratis_tpu_torch.protocol.ids import ClientId
        client = self.cluster.factory.new_client_transport(
            self.cluster.properties)
        client_id = ClientId.random_id()
        gids = [g.group_id for g in
                self.cluster.groups[:self.active_groups]]
        j = wid
        try:
            while not self._stop.is_set():
                gid = gids[j % len(gids)]
                j += self.n_writers
                self.attempts += 1
                self.attempts_per_group[gid] = \
                    self.attempts_per_group.get(gid, 0) + 1
                ok = await self.cluster.write(gid, client=client,
                                              client_id=client_id,
                                              timeout=10.0)
                if ok:
                    self.acked_per_group[gid] = \
                        self.acked_per_group.get(gid, 0) + 1
                    self.ack_times.append(time.monotonic())
        finally:
            try:
                await client.close()
            except Exception:
                pass

    def start(self) -> None:
        writer = (self._counter_writer if self.mode == "counter"
                  else self._recording_writer)
        self._tasks = [asyncio.create_task(writer(w),
                                           name=f"chaos-writer-{w}")
                       for w in range(self.n_writers)]

    async def stop(self) -> None:
        self._stop.set()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    def rate_in(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 0.0
        n = sum(1 for t in self.ack_times if t0 <= t < t1)
        return round(n / (t1 - t0), 2)

    @property
    def total_acked(self) -> int:
        return (len(self.acked) if self.mode != "counter"
                else sum(self.acked_per_group.values()))


class ScenarioRunner:
    """Drives one cluster through one scenario.  The runner owns the
    fault plane (link table + injection delays) and ALWAYS heals it —
    a crashed scenario must never leak faults into the next one."""

    def __init__(self, cluster, scenario: Scenario):
        self.cluster = cluster
        self.scenario = scenario
        self.result = ScenarioResult(scenario.name, scenario.seed)
        self._t0 = 0.0
        self._killed: list = []       # kill order (restart targets)
        self._slow_followers: dict[str, float] = {}
        self._slow_disks: dict[str, float] = {}
        self._fault_seq = 0

    # ----------------------------------------------------------- journal

    def _journal(self, kind: str, step: Optional[Step], detail: str,
                 fault_id: Optional[str] = None) -> str:
        fid = fault_id
        if fid is None:
            fid = (f"{self.scenario.name}/{self.scenario.seed}"
                   f"/{self._fault_seq}")
            self._fault_seq += 1
        record = {"t": round(time.monotonic() - self._t0, 3),
                  "kind": kind, "fault": fid, "detail": detail}
        if step is not None:
            record["op"] = step.op
            record["target"] = step.target
        self.result.journal.append(record)
        self.cluster.emit_fault_event(kind, detail, fid)
        return fid

    # ---------------------------------------------------- target resolve

    async def _resolve_peer(self, target: str):
        live = self.cluster.live_peer_ids()
        if target.startswith("server:"):
            return self.cluster.all_peer_ids()[int(target.split(":")[1])]
        if target == "leader" or target.startswith("follower:"):
            if self.cluster.num_groups > 1:
                # multi-group shape: roles are per GROUP, so "leader"
                # means the server CARRYING the leaderships (faulting it
                # deposes the fleet — the real leader-fault blast radius)
                # and "follower:k" a server carrying few or none —
                # resolving against group 0 alone once picked the
                # 1023-leadership server as a "follower" and turned a
                # follower-crash scenario into a full-fleet deposal
                counts = {p: sum(1 for d in s.divisions.values()
                                 if d.is_leader())
                          for p, s in self.cluster.servers.items()}
                ranked = sorted(counts, key=lambda p: (counts[p], str(p)))
                if target == "leader":
                    return ranked[-1]
                k = int(target.split(":")[1])
                followers = ranked[:-1] or ranked
                return followers[k % len(followers)]
            try:
                leader = await self.cluster.wait_for_leader(timeout=10.0)
                lead_id = leader.member_id.peer_id
            except TimeoutError:
                lead_id = live[0] if live else self.cluster.all_peer_ids()[0]
            if target == "leader":
                return lead_id
            k = int(target.split(":")[1])
            followers = [p for p in live if p != lead_id]
            return followers[k % len(followers)] if followers else lead_id
        from ratis_tpu_torch.protocol.ids import RaftPeerId
        return RaftPeerId.value_of(target)

    # -------------------------------------------------------- injections

    def _arm_injections(self) -> None:
        slow_f, slow_d = self._slow_followers, self._slow_disks

        async def on_append(local_id, _remote_id, *_args):
            d = slow_f.get(str(local_id).split("@")[0])
            if d:
                await asyncio.sleep(d)

        async def on_sync(local_id, _remote_id, *_args):
            name = str(local_id)
            for victim, d in slow_d.items():
                if name.startswith(f"{victim}:") or name == victim:
                    await asyncio.sleep(d)
                    return

        injection.put(injection.APPEND_ENTRIES, on_append)
        injection.put(injection.LOG_SYNC, on_sync)

    def _disarm_injections(self) -> None:
        self._slow_followers.clear()
        self._slow_disks.clear()
        injection.remove(injection.APPEND_ENTRIES)
        injection.remove(injection.LOG_SYNC)

    # -------------------------------------------------------------- ops

    async def _apply_step(self, step: Step) -> None:
        faults = link_faults()
        if step.op == "partition":
            victim = await self._resolve_peer(step.target)
            side = [victim]
            extra = step.arg("extra_followers", 0)
            if extra:
                side += [p for p in self.cluster.live_peer_ids()
                         if p != victim][:extra]
            others = [p for p in self.cluster.all_peer_ids()
                      if p not in side]
            faults.partition(side, others)
            self._journal(KIND_INJECTED_FAULT, step,
                          f"partition {sorted(map(str, side))} | "
                          f"{sorted(map(str, others))}")
        elif step.op == "block":
            victim = await self._resolve_peer(step.target)
            dst = step.arg("dst", "*")
            dst_id = None if dst == "*" else await self._resolve_peer(dst)
            faults.block(victim, dst_id)
            self._journal(KIND_INJECTED_FAULT, step,
                          f"blackhole {victim}->{dst_id or '*'}")
        elif step.op == "link":
            victim = await self._resolve_peer(step.target)
            kw = dict(latency_ms=step.arg("latency_ms", 0.0),
                      jitter_ms=step.arg("jitter_ms", 0.0),
                      drop_rate=step.arg("drop_rate", 0.0))
            faults.set_link(None, victim, **kw)
            if step.arg("both", 1):
                faults.set_link(victim, None, **kw)
            self._journal(KIND_INJECTED_FAULT, step,
                          f"degrade links of {victim}: {kw}")
        elif step.op == "kill":
            victim = await self._resolve_peer(step.target)
            if victim in self.cluster.servers:
                await self.cluster.kill(victim)
                self._killed.append(victim)
                self._journal(KIND_INJECTED_FAULT, step, f"crash {victim}")
        elif step.op == "restart":
            if not self._killed:
                return
            victim = self._killed.pop(0)
            tail = step.arg("truncate_tail", 0)
            await self.cluster.restart(victim, truncate_tail=tail)
            self._journal(KIND_INJECTED_FAULT, step,
                          f"restart {victim}"
                          + (f" (tail -{tail} entries)" if tail else ""))
        elif step.op == "slow_disk":
            victim = await self._resolve_peer(step.target)
            self._slow_disks[str(victim)] = step.arg("delay_ms", 50) / 1e3
            self._journal(KIND_INJECTED_FAULT, step,
                          f"slow disk on {victim} "
                          f"(+{step.arg('delay_ms', 50)}ms/flush)")
        elif step.op == "slow_follower":
            victim = await self._resolve_peer(step.target)
            self._slow_followers[str(victim)] = \
                step.arg("delay_ms", 50) / 1e3
            self._journal(KIND_INJECTED_FAULT, step,
                          f"slow follower {victim} "
                          f"(+{step.arg('delay_ms', 50)}ms/append)")
        elif step.op == "heal":
            faults.heal_all()
            self._slow_followers.clear()
            self._slow_disks.clear()
            self._journal(KIND_INJECTED_FAULT, step, "heal all links")
        else:
            raise ValueError(f"unknown chaos op {step.op!r}")

    # -------------------------------------------------------------- run

    async def run(self) -> ScenarioResult:
        sc = self.scenario
        res = self.result
        link_faults().reseed(sc.seed)
        self._arm_injections()
        self._arm_grey()
        self._arm_rebalance()
        writers = _Writers(self.cluster, sc.config,
                           tag=f"{sc.name}.{sc.seed}.")
        # a quiesced start anchors the counter-delta oracle (and keeps a
        # previous scenario's in-flight tail out of this one's baseline)
        try:
            await self.cluster.wait_quiesced(timeout=sc.slos["recovery_s"])
        except TimeoutError:
            pass  # verified again (and enforced) after the heal
        writers.snapshot_counters()
        # shed baseline: back-to-back scenarios on one long-lived
        # cluster must assert THIS run's shedding, not the campaign's
        self._shed_base = self._shed_now()
        self._t0 = time.monotonic()
        writers.start()
        try:
            first_fault_at = min((s.at_s for s in sc.steps), default=0.0)
            for step in sorted(sc.steps, key=lambda s: s.at_s):
                delay = self._t0 + step.at_s - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                await self._apply_step(step)
            t_fault = self._t0 + first_fault_at

            # ------------------------------------------------------ heal
            t_heal = time.monotonic()
            link_faults().heal_all()
            self._disarm_injections()
            if self.cluster.network is not None:
                self.cluster.network.unblock_all()
            for victim in list(self._killed):
                self._killed.remove(victim)
                await self.cluster.restart(victim)
            # the storm's controllers go down WITH the faults: closing
            # here lets any in-flight actuation finish (or journal its
            # aborted pair) before the pairing SLO is checked
            await self._disarm_rebalance()

            # ---------------------------------- recovery SLOs under load
            try:
                reelect_s = await self.cluster.wait_all_leaders(
                    timeout=sc.slos["convergence_s"])
            except TimeoutError as e:
                res.slos["reelect_s"] = None
                raise AssertionError(
                    f"[seed {sc.seed}] re-election convergence SLO "
                    f"missed ({sc.slos['convergence_s']}s): {e}") from None
            res.slos["reelect_s"] = round(reelect_s, 3)
            res.slos["convergence_bound_s"] = sc.slos["convergence_s"]
            # keep load flowing through a fixed post-convergence window:
            # the recovery-throughput fraction compares it to the
            # pre-fault baseline (writers mid-retry at heal time need a
            # couple of client timeouts to drain back to steady state)
            t_rec = time.monotonic()
            window = float(sc.config.get("recovery_window_s", 2.0))
            await asyncio.sleep(window)
            t_stop = time.monotonic()
            await writers.stop()
            try:
                await self.cluster.wait_quiesced(
                    timeout=sc.slos["recovery_s"])
            except TimeoutError as e:
                raise AssertionError(
                    f"[seed {sc.seed}] catch-up SLO missed "
                    f"({sc.slos['recovery_s']}s): {e}") from None
            res.baseline_cps = writers.rate_in(self._t0, t_fault)
            res.recovery_cps = writers.rate_in(t_rec, t_stop)
            res.acked = writers.total_acked
            res.attempts = writers.attempts

            # Recovery pairing BEFORE the invariant checks: by this point
            # the faults healed and the recovery SLOs (convergence +
            # catch-up) were observed, so a run that then fails a DATA
            # invariant still journals its fault-recovered pairs — the
            # flight recorder attached to the failure artifact must show
            # the fault window closed, not dangling.
            for rec in [r for r in res.journal
                        if r["kind"] == KIND_INJECTED_FAULT]:
                self._journal(KIND_FAULT_RECOVERED, None,
                              f"recovered: {rec['detail']} "
                              f"(reelect {res.slos['reelect_s']}s)",
                              fault_id=rec["fault"])
            # ------------------------------------------------ invariants
            await self._settle_replicas()
            self._verify(writers)
            res.passed = True
        except Exception as e:  # CancelledError (BaseException) propagates
            res.error = f"{type(e).__name__}: {e}"
        finally:
            link_faults().heal_all()
            self._disarm_injections()
            self._disarm_grey()
            await self._disarm_rebalance()
            await writers.stop()
            for victim in list(self._killed):
                self._killed.remove(victim)
                try:
                    await self.cluster.restart(victim)
                except Exception:
                    LOG.exception("post-scenario restart of %s failed",
                                  victim)
        return res

    async def _settle_replicas(self, timeout: float = 10.0) -> None:
        """Writers are stopped and faults healed, but wait_quiesced samples
        the leader's commit once — a commit landing after its settled pass
        leaves a follower's apply a few entries behind at snapshot time.
        That gap is in-flight apply work, not divergence: wait it out
        bounded (a true divergence never closes, so _verify still fires)."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            if all(len({d.applied_index
                        for d in self.cluster.divisions(g.group_id)}) <= 1
                   for g in self.cluster.groups):
                return
            await asyncio.sleep(0.05)

    def _shed_now(self) -> int:
        return sum(s.serving.admission.shed_total
                   for s in self.cluster.servers.values()
                   if getattr(s, "serving", None) is not None)

    def _verify(self, writers: _Writers) -> None:
        sc, res = self.scenario, self.result
        seed = sc.seed
        if writers.mode == "counter":
            # counter oracle at the many-group shape: per group,
            # acked <= counter <= attempts (zero lost acks; retry-cache
            # dedupe bounds above), all replicas agree
            lost, diverged = 0, 0
            for gid, acked in writers.acked_per_group.items():
                deltas = [d.state_machine.counter
                          - writers.counter_base.get(
                              (gid, str(d.member_id.peer_id)), 0)
                          for d in self.cluster.divisions(gid)]
                if len(set(deltas)) > 1:
                    diverged += 1
                if min(deltas, default=0) < acked:
                    lost += 1
                if max(deltas, default=0) > \
                        writers.attempts_per_group.get(gid, 0):
                    res.checks.setdefault("over_applied_groups", 0)
                    res.checks["over_applied_groups"] += 1
            res.checks.update({"lost_ack_groups": lost,
                               "diverged_groups": diverged,
                               "groups_checked":
                                   len(writers.acked_per_group)})
            assert diverged == 0, \
                f"[seed {seed}] {diverged} group(s) diverged across replicas"
            assert lost == 0, \
                f"[seed {seed}] {lost} group(s) lost acked writes"
            assert not res.checks.get("over_applied_groups"), \
                (f"[seed {seed}] duplicate applies on "
                 f"{res.checks['over_applied_groups']} group(s)")
        else:
            seqs = {str(d.member_id.peer_id): list(d.state_machine.applied)
                    for d in self.cluster.divisions()}
            first = next(iter(seqs.values()), [])
            for member, seq in seqs.items():
                assert seq == first, \
                    (f"[seed {seed}] replica divergence at {member}: "
                     f"{len(seq)} vs {len(first)} applied")
            # dedupe/loss oracle over THIS run's tagged payloads only —
            # a long-lived campaign cluster accumulates every scenario's
            # history in the recording SMs
            tag = writers.tag.encode()
            counts: dict = {}
            for p in first:
                if p.startswith(tag):
                    counts[p] = counts.get(p, 0) + 1
            dupes = {p: c for p, c in counts.items() if c > 1}
            assert not dupes, \
                f"[seed {seed}] duplicated applies: {dict(list(dupes.items())[:5])}"
            missing = [p for p in writers.acked if counts.get(p, 0) != 1]
            assert not missing, \
                (f"[seed {seed}] lost acked writes "
                 f"({len(missing)}): {missing[:10]}")
            res.checks.update({"applied": sum(counts.values()),
                               "acked": len(writers.acked),
                               "dupes": 0, "lost": 0})
        min_acked = int(sc.config.get("min_acked", 10))
        assert res.acked >= min_acked, \
            (f"[seed {seed}] scenario acked only {res.acked} writes "
             f"(< {min_acked}): load never got through")
        # Overload SLO (serving plane): shedding must have actually
        # happened (the budget was crossed), every shed attempt must
        # have surfaced as a TYPED overload reply — a client timeout is
        # a silent drop, exactly what bounded pending exists to prevent.
        shed_total = self._shed_now() - getattr(self, "_shed_base", 0)
        res.checks["shed_total"] = shed_total
        res.checks["client_timeouts"] = writers.timeouts
        res.checks["shed_surfaced"] = writers.shed_surfaced
        if sc.config.get("expect_shed"):
            assert shed_total > 0, \
                (f"[seed {seed}] overload scenario never crossed the "
                 f"pending budget: nothing was shed")
            assert writers.timeouts == 0, \
                (f"[seed {seed}] {writers.timeouts} client timeout(s) "
                 f"under overload: shed requests must get typed replies, "
                 f"not silent drops")
        if sc.config.get("expect_grey"):
            self._verify_grey()
        if sc.config.get("expect_rebalance"):
            self._verify_rebalance()

    # ------------------------------------------------- grey-follower SLO

    def _arm_grey(self) -> None:
        """Retune the lag ledger + grey detector for the scenario's write
        rates (a latency fault of a few hundred ms puts a follower a
        handful of entries behind, not the production default of 64) and
        capture per-server event baselines; restored in _disarm_grey."""
        cfg = self.scenario.config
        if not cfg.get("expect_grey"):
            return
        self._grey_saved: dict = {}
        self._grey_base: dict = {}
        for name, srv in self.cluster.servers.items():
            wd = srv.watchdog
            if wd is None:
                continue
            led = srv.engine.ledger
            self._grey_saved[name] = (
                led.lag_threshold, led.up_window_ms, wd.grey_fraction,
                wd.grey_min_groups, wd.grey_rounds)
            led.lag_threshold = int(cfg.get("grey_lag_entries", 2))
            led.up_window_ms = int(cfg.get("grey_up_window_ms", 8000))
            wd.grey_fraction = float(cfg.get("grey_fraction", 0.5))
            wd.grey_min_groups = int(cfg.get("grey_min_groups", 2))
            wd.grey_rounds = int(cfg.get("grey_rounds", 1))
            self._grey_base[name] = wd.last_seq

    def _disarm_grey(self) -> None:
        for name, saved in getattr(self, "_grey_saved", {}).items():
            srv = self.cluster.servers.get(name)
            if srv is None or srv.watchdog is None:
                continue
            led = srv.engine.ledger
            (led.lag_threshold, led.up_window_ms,
             srv.watchdog.grey_fraction, srv.watchdog.grey_min_groups,
             srv.watchdog.grey_rounds) = saved
        self._grey_saved = {}

    def _verify_grey(self) -> None:
        """The grey SLO: at least one grey-follower event during the
        fault window, every one paired with a grey-recovered close.  A
        forced watchdog pass per server first — writers are stopped and
        links healed, so the pass deterministically closes any episode
        still open instead of racing the background cadence."""
        from ratis_tpu_torch.server.watchdog import (KIND_GREY_FOLLOWER,
                                               KIND_GREY_RECOVERED)
        seed = self.scenario.seed
        grey, recovered = [], []
        for name, srv in self.cluster.servers.items():
            wd = srv.watchdog
            if wd is None:
                continue
            try:
                wd.sample()
            except Exception:
                LOG.exception("forced watchdog pass on %s failed", name)
            base = self._grey_base.get(name, -1)
            for e in wd.events(since=base):
                if e["kind"] == KIND_GREY_FOLLOWER:
                    grey.append(e)
                elif e["kind"] == KIND_GREY_RECOVERED:
                    recovered.append(e)
        self.result.checks["grey_events"] = len(grey)
        self.result.checks["grey_recovered"] = len(recovered)
        assert grey, \
            (f"[seed {seed}] grey scenario raised no grey-follower "
             f"event: the ledger detector missed a slow-but-alive peer")
        rec_ids = {e.get("fault") for e in recovered}
        unpaired = [e for e in grey if e.get("fault") not in rec_ids]
        assert not unpaired, \
            (f"[seed {seed}] {len(unpaired)} grey episode(s) never "
             f"closed: {[e['fault'] for e in unpaired]}")


    # ---------------------------------------------- rebalance-storm SLO

    def _arm_rebalance(self) -> None:
        """Start a PlacementController on every server (armed thresholds:
        short interval, zero hysteresis, a near-zero hot-share floor) and
        retune the lag ledger so the scenario's slow follower actually
        scores low — the storm asserts the controller keeps actuating,
        and pairing every actuation, WHILE the faults are live.  Torn
        down in _disarm_rebalance (called at heal and again in the
        finally, idempotently)."""
        cfg = self.scenario.config
        if not cfg.get("expect_rebalance"):
            return
        from ratis_tpu_torch.placement import PlacementController
        self._rebalance_ctrls: dict = {}
        self._rebalance_saved: dict = {}
        self._rebalance_base: dict = {}
        for name, srv in self.cluster.servers.items():
            wd = srv.watchdog
            if wd is None:
                continue
            led = srv.engine.ledger
            self._rebalance_saved[name] = (led.lag_threshold,
                                           led.up_window_ms)
            led.lag_threshold = int(cfg.get("rebalance_lag_entries", 2))
            led.up_window_ms = int(cfg.get("rebalance_up_window_ms", 8000))
            self._rebalance_base[name] = wd.last_seq
            ctrl = PlacementController(
                srv,
                interval_s=float(cfg.get("rebalance_interval_s", 0.3)),
                cooldown_s=float(cfg.get("rebalance_cooldown_s", 1.0)),
                max_per_round=int(cfg.get("rebalance_max_per_round", 2)),
                hot_share=float(cfg.get("rebalance_hot_share", 0.01)),
                hysteresis=0.0, steer_ttl_s=2.0, transfer_timeout_s=2.0)
            ctrl.start()
            srv.placement = ctrl
            self._rebalance_ctrls[name] = ctrl

    async def _disarm_rebalance(self) -> None:
        """Close every storm controller (idempotent: a killed server's
        close() already shut its controller down; re-closing is a no-op)
        and restore the retuned ledger thresholds on surviving servers."""
        for name, ctrl in list(getattr(self,
                                       "_rebalance_ctrls", {}).items()):
            try:
                await ctrl.close()
            except Exception:
                LOG.exception("closing storm controller on %s failed",
                              name)
            srv = self.cluster.servers.get(name)
            if srv is not None and srv.placement is ctrl:
                srv.placement = None
        self._rebalance_ctrls = {}
        for name, saved in getattr(self,
                                   "_rebalance_saved", {}).items():
            srv = self.cluster.servers.get(name)
            if srv is None:
                continue
            (srv.engine.ledger.lag_threshold,
             srv.engine.ledger.up_window_ms) = saved
        self._rebalance_saved = {}

    def _verify_rebalance(self) -> None:
        """The storm SLO: the controller actuated at least once during
        the fault window, and EVERY rebalance event has its
        rebalance-done pair (a dangling actuation means the actuator
        dropped an outcome on the floor).  Journals live on the servers
        that emitted them: a killed server's journal died with it, so
        pairing is asserted per surviving journal — both halves of a
        pair always land in the same ring."""
        from ratis_tpu_torch.server.watchdog import (KIND_REBALANCE,
                                               KIND_REBALANCE_DONE)
        seed = self.scenario.seed
        opened, closed = [], []
        for name, srv in self.cluster.servers.items():
            wd = srv.watchdog
            if wd is None:
                continue
            base = self._rebalance_base.get(name, -1)
            for e in wd.events(since=base):
                if e["kind"] == KIND_REBALANCE:
                    opened.append(e)
                elif e["kind"] == KIND_REBALANCE_DONE:
                    closed.append(e)
        self.result.checks["rebalance_events"] = len(opened)
        self.result.checks["rebalance_done"] = len(closed)
        assert opened, \
            (f"[seed {seed}] rebalance storm drove no actuations: the "
             f"controller never steered or transferred under the faults")
        done_ids = {e.get("fault") for e in closed}
        unpaired = [e for e in opened if e.get("fault") not in done_ids]
        assert not unpaired, \
            (f"[seed {seed}] {len(unpaired)} rebalance actuation(s) "
             f"never converged: {[e['fault'] for e in unpaired]}")


async def run_scenario(cluster, scenario: Scenario,
                       artifact_dir: Optional[str] = None) -> ScenarioResult:
    """Run one scenario on ``cluster``; on failure, write the replay
    artifact (``artifact_dir`` falls back to the cluster's
    ``raft.tpu.chaos.artifact-dir``)."""
    runner = ScenarioRunner(cluster, scenario)
    result = await runner.run()
    if not result.passed:
        from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
        snap = getattr(cluster, "flight_snapshots", None)
        if snap is not None:
            # the telemetry window across the fault rides in the replay
            # artifact: rates/occupancy/hot-groups + the paired
            # injected-fault journal, not just the end state
            result.flight = snap(
                f"chaos-{scenario.name}-seed{scenario.seed}")
        d = artifact_dir or RaftServerConfigKeys.Chaos.artifact_dir(
            cluster.properties)
        if d:
            path = write_artifact(result, scenario, d)
            LOG.warning("chaos scenario %s (seed %s) FAILED: %s — replay "
                        "artifact at %s", scenario.name, scenario.seed,
                        result.error, path)
    return result
