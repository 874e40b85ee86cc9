"""The standing scenario library: named, seed-deterministic fault
schedules.

Every builder is a pure function of ``(seed, config)`` — two builds with
the same inputs yield byte-identical step tuples (asserted by
``tools/chaos_replay.py`` before a replay run, and by the engine tests).
Times and parameters draw from one ``random.Random(seed)`` so campaigns
explore a little differently per seed while staying exactly replayable.

The library covers the fault classes the reference's correctness story
rests on (RaftExceptionBaseTest, the kill/restart suites, leader-election
churn tests) plus the degraded-link shapes only the chaos link shim can
produce on real sockets.
"""

from __future__ import annotations

import random
import zlib
from typing import Callable, Optional

from ratis_tpu_torch.chaos.faults import Step, make_step
from ratis_tpu_torch.chaos.scenario import Scenario

# name -> builder(rng, config) -> tuple[Step, ...]
_BUILDERS: dict[str, Callable] = {}


def _scenario(name: str):
    def register(fn):
        _BUILDERS[name] = fn
        return fn
    return register


def scenario_names() -> list[str]:
    return sorted(_BUILDERS)


def build_scenario(name: str, seed: int,
                   config: Optional[dict] = None) -> Scenario:
    """Resolve ``name`` to its deterministic step schedule.  ``config``
    carries the cluster/load shape (servers, groups, sm, writers,
    durable, active_groups) and the SLO bounds (``convergence_s``,
    ``recovery_s``); builders read what they need from it."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown chaos scenario {name!r}; "
                         f"known: {scenario_names()}")
    cfg = dict(config or {})
    cfg.setdefault("servers", 3)
    cfg.setdefault("groups", 1)
    cfg.setdefault("sm", "recording")
    cfg.setdefault("writers", 3)
    # crc32, not hash(): builtin str hashing is randomized per process,
    # and the whole point is that a replay in a NEW process derives the
    # byte-identical schedule from (name, seed, config)
    rng = random.Random((seed * 1_000_003) ^ zlib.crc32(name.encode()))
    steps = tuple(sorted(_BUILDERS[name](rng, cfg), key=lambda s: s.at_s))
    slos = {"convergence_s": float(cfg.get("convergence_s", 30.0)),
            "recovery_s": float(cfg.get("recovery_s", 60.0))}
    return Scenario(name=name, seed=seed, config=cfg, steps=steps,
                    slos=slos)


# The pre-fault window: every schedule leaves this much clean load up
# front so the recovery-throughput fraction has a baseline to divide by.
_WARM_S = 1.0


def _hold(cfg: dict, seconds: float) -> float:
    """Fault HOLD durations scale with the cluster's election-timeout
    tier (``hold_scale``): the small-cluster schedules assume 100-200ms
    election timeouts, and a campaign running the density-scaled 4s/8s
    tier must hold partitions PAST the timeout band or re-election never
    actually fires during the fault."""
    return round(seconds * float(cfg.get("hold_scale", 1.0)), 2)


@_scenario("partition_minority")
def _partition_minority(rng: random.Random, cfg: dict) -> tuple:
    """Partition a follower minority away, hold, heal: the healthy
    majority must keep committing throughout (no re-election at all) and
    the healed minority must catch up with zero lost acks."""
    hold = _hold(cfg, round(rng.uniform(1.0, 2.0), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    n = int(cfg.get("servers", 3))
    extra = max(0, (n - 1) // 2 - 1)  # minority = floor((n-1)/2) followers
    return (make_step(t, "partition", "follower:0",
                      extra_followers=extra),
            make_step(t + hold, "heal"))


@_scenario("partition_leader")
def _partition_leader(rng: random.Random, cfg: dict) -> tuple:
    """Isolate the leader completely: the rest must re-elect within the
    convergence bound, and writes acked by EITHER leader must survive
    exactly once (the classic split-brain probe)."""
    hold = _hold(cfg, round(rng.uniform(1.5, 2.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    return (make_step(t, "partition", "leader"),
            make_step(t + hold, "heal"))


@_scenario("asymmetric_partition")
def _asymmetric_partition(rng: random.Random, cfg: dict) -> tuple:
    """One-directional blackhole: the leader can send to a follower but
    never hears its acks (or vice versa) — the shape that distinguishes
    ack-loss handling from plain disconnection."""
    hold = _hold(cfg, round(rng.uniform(1.0, 2.0), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    steps = [make_step(t, "block", "follower:0", dst="leader")]
    if rng.random() < 0.5:
        steps.append(make_step(t + 0.2, "block", "leader",
                               dst="follower:1"))
    steps.append(make_step(t + hold, "heal"))
    return tuple(steps)


@_scenario("link_degraded")
def _link_degraded(rng: random.Random, cfg: dict) -> tuple:
    """Latency + jitter + probabilistic drop on one follower's links —
    the gray-failure shape: nothing is down, everything is slow and
    lossy, and the windowed-rewind path earns its keep."""
    hold = _hold(cfg, round(rng.uniform(1.5, 2.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    return (make_step(t, "link", "follower:0",
                      latency_ms=round(rng.uniform(5, 20), 1),
                      jitter_ms=round(rng.uniform(5, 15), 1),
                      drop_rate=round(rng.uniform(0.05, 0.2), 3)),
            make_step(t + hold, "heal"))


@_scenario("crash_restart_follower")
def _crash_restart_follower(rng: random.Random, cfg: dict) -> tuple:
    """Crash a follower mid-load and bring it back; with durable storage
    the restart loses a few tail entries (``truncate_tail``) so recovery
    exercises the INCONSISTENCY/rewind guard, not just a reconnect."""
    down = _hold(cfg, round(rng.uniform(0.8, 1.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    tail = int(cfg.get("truncate_tail",
                       rng.randint(1, 4) if cfg.get("durable") else 0))
    return (make_step(t, "kill", "follower:0"),
            make_step(t + down, "restart", truncate_tail=tail))


@_scenario("crash_restart_leader")
def _crash_restart_leader(rng: random.Random, cfg: dict) -> tuple:
    """Crash the LEADER mid-load: acked writes must survive the
    succession, the old leader rejoins as a follower and catches up."""
    down = _hold(cfg, round(rng.uniform(1.0, 1.8), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    return (make_step(t, "kill", "leader"),
            make_step(t + down, "restart"))


@_scenario("leader_churn_storm")
def _leader_churn_storm(rng: random.Random, cfg: dict) -> tuple:
    """Repeated brief leader isolations — the churn storm that deposed
    thousands of leaders in perf rounds 4-5.  Every isolation forces a
    succession; the SLO is that the LAST heal converges in bound with
    nothing lost across any of the handovers."""
    steps = []
    t = _WARM_S
    for _ in range(int(cfg.get("churn_rounds", 3))):
        t += rng.uniform(0.1, 0.4)
        steps.append(make_step(t, "partition", "leader"))
        t += _hold(cfg, rng.uniform(0.8, 1.5))
        steps.append(make_step(t, "heal"))
        t += _hold(cfg, rng.uniform(0.5, 1.0))  # successor settles
    return tuple(steps)


@_scenario("slow_follower")
def _slow_follower(rng: random.Random, cfg: dict) -> tuple:
    """Delay one follower's append handling (the APPEND_ENTRIES injection
    point): commits must keep flowing through the other majority and the
    laggard must drain its backlog after the heal."""
    hold = _hold(cfg, round(rng.uniform(1.5, 2.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    return (make_step(t, "slow_follower", "follower:0",
                      delay_ms=int(rng.uniform(30, 80))),
            make_step(t + hold, "heal"))


@_scenario("slow_disk")
def _slow_disk(rng: random.Random, cfg: dict) -> tuple:
    """Delay one server's log-sync batches (the LOG_SYNC injection point
    in the shared per-device LogWorker): every co-hosted group pays the
    degraded device, exactly like a real slow disk.  Durable logs only —
    memory-log clusters never reach the sync path."""
    hold = _hold(cfg, round(rng.uniform(1.5, 2.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    return (make_step(t, "slow_disk", "follower:0",
                      delay_ms=int(rng.uniform(20, 60))),
            make_step(t + hold, "heal"))


@_scenario("randomized_nemesis")
def _randomized_nemesis(rng: random.Random, cfg: dict) -> tuple:
    """The classic randomized nemesis (the old tests/test_chaos.py loop,
    now a deterministic SCHEDULE): kills/restarts, partitions, and
    asymmetric blackholes drawn from the seed over ``duration_s``.  The
    kill branch fires at EVERY cluster size (the old in-test nemesis
    silently no-opped its kill arm off 3 servers) but never takes a
    second server down before the first restarts — the nemesis probes
    recovery, it does not destroy quorum."""
    n = int(cfg.get("servers", 3))
    duration = float(cfg.get("duration_s", 6.0))
    steps = []
    t = _WARM_S
    while t < _WARM_S + duration:
        t += rng.uniform(0.4, 0.9)
        fault = rng.random()
        if fault < 0.4:
            victim = f"server:{rng.randrange(n)}"
            steps.append(make_step(t, "kill", victim))
            t += rng.uniform(0.4, 0.9)
            steps.append(make_step(t, "restart"))
        elif fault < 0.8:
            steps.append(make_step(t, "partition",
                                   f"server:{rng.randrange(n)}"))
            t += rng.uniform(0.3, 0.9)
            steps.append(make_step(t, "heal"))
        else:
            a = rng.randrange(n)
            b = (a + 1 + rng.randrange(n - 1)) % n
            steps.append(make_step(t, "block", f"server:{a}",
                                   dst=f"server:{b}"))
            t += rng.uniform(0.2, 0.5)
            steps.append(make_step(t, "heal"))
    return tuple(steps)


@_scenario("shared_log_tail_loss")
def _shared_log_tail_loss(rng: random.Random, cfg: dict) -> tuple:
    """Round-12 shared log plane: crash a follower and chop the tail of
    its per-shard INTERLEAVED segment sequence (raft.tpu.log.shared) —
    one lost write-back cache rewinds an arbitrary subset of the
    shard's groups at once, entries and control records alike.  The
    boot scan must rebuild every hosted group from the short stream and
    the leaders must rewind each one forward; zero acked writes lost,
    exactly-once apply."""
    down = _hold(cfg, round(rng.uniform(0.8, 1.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    # the chop interleaves many groups, so take a deeper tail than the
    # per-group scenarios — every record removed hits a different group
    tail = int(cfg.get("truncate_tail", rng.randint(8, 24)))
    return (make_step(t, "kill", "follower:0"),
            make_step(t + down, "restart", truncate_tail=tail))


@_scenario("overload_shed")
def _overload_shed(rng: random.Random, cfg: dict) -> tuple:
    """Serving-plane overload (round 12): degrade the follower links so
    commits slow to a crawl while writers keep pushing — the leader's
    intake backs past its per-shard pending budget
    (raft.tpu.serving.admission.*) and admission control must shed the
    overflow with TYPED overload replies.  SLO = the usual zero lost
    acks + exactly-once, plus (with ``expect_shed`` in the config) that
    shedding actually happened and every unacked attempt surfaced as a
    typed reply, not a silent client timeout — bounded pending, not p99
    collapse."""
    hold = _hold(cfg, round(rng.uniform(1.5, 2.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    # BOTH followers degraded: with one slow follower the other still
    # completes the majority at full speed and nothing ever queues
    return (make_step(t, "link", "follower:0",
                      latency_ms=round(rng.uniform(40, 80), 1),
                      jitter_ms=round(rng.uniform(5, 15), 1),
                      drop_rate=0.0),
            make_step(t + 0.1, "link", "follower:1",
                      latency_ms=round(rng.uniform(40, 80), 1),
                      jitter_ms=round(rng.uniform(5, 15), 1),
                      drop_rate=0.0),
            make_step(t + hold, "heal"))


@_scenario("grey_follower")
def _grey_follower(rng: random.Random, cfg: dict) -> tuple:
    """Grey failure (the lag-ledger detector's reason to exist): heavy
    latency + jitter on ONE follower's links, zero drop — every link
    stays up and acking, quorum commits through the other follower, and
    the victim silently falls behind on every group at once.  The run
    must raise KIND_GREY_FOLLOWER (paired with its grey-recovered close
    after the heal) on top of the usual zero-lost-acks / exactly-once
    oracle.  ``expect_grey`` arms the runner: detector thresholds are
    retuned live for the scenario's write rates (grey_lag_entries /
    grey_fraction / grey_min_groups / grey_rounds / grey_up_window_ms
    in the config override the armed values) and restored afterwards.
    Load is concentrated (``active_groups``) so per-group commit deltas
    stay visibly nonzero within each ledger pass — an idle group's links
    never count as active and can never vote grey."""
    cfg["expect_grey"] = True
    cfg["active_groups"] = min(int(cfg.get("active_groups", 8) or 8), 8)
    hold = _hold(cfg, round(rng.uniform(2.5, 3.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    return (make_step(t, "link", "follower:0",
                      latency_ms=round(rng.uniform(250, 400), 1),
                      jitter_ms=round(rng.uniform(40, 80), 1),
                      drop_rate=0.0),
            make_step(t + hold, "heal"))


@_scenario("rebalance_storm")
def _rebalance_storm(rng: random.Random, cfg: dict) -> tuple:
    """Placement controller under fire (``expect_rebalance`` arms a
    PlacementController per server with storm thresholds: zero
    hysteresis, near-zero hot-share, sub-second rounds): moderate
    latency on one follower's links makes it score grey/laggy (steering
    fires) while the skewed write load keeps the hot set moving (so
    transfer actuations race the faults), then a SECOND follower crashes
    and restarts mid-storm — quorum survives through the leader plus the
    slow follower, and every controller actuation (including any a dying
    transfer aborted) must land with its rebalance-done pair.  SLO = the
    usual zero lost acks + exactly-once + convergence, plus the pairing
    check.  Load stays concentrated so commit deltas register in every
    ledger pass, same as grey_follower."""
    cfg["expect_rebalance"] = True
    cfg["active_groups"] = min(int(cfg.get("active_groups", 8) or 8), 8)
    hold = _hold(cfg, round(rng.uniform(2.5, 3.5), 2))
    t = _WARM_S + rng.uniform(0, 0.3)
    down = _hold(cfg, round(rng.uniform(0.8, 1.4), 2))
    return (make_step(t, "link", "follower:0",
                      latency_ms=round(rng.uniform(150, 250), 1),
                      jitter_ms=round(rng.uniform(20, 50), 1),
                      drop_rate=0.0),
            make_step(t + 0.6, "kill", "follower:1"),
            make_step(t + 0.6 + down, "restart"),
            make_step(t + hold, "heal"))


@_scenario("window_crash")
def _window_crash(rng: random.Random, cfg: dict) -> tuple:
    """Round-9 window-protocol recovery: slow a follower so depth>1
    append frames pile onto its lanes, crash it mid-window, restart with
    a truncated durable tail — the sender must re-cut lanes
    (lane_resets), rewind through INCONSISTENCY (windowed_rewinds), and
    lose nothing."""
    t = _WARM_S + rng.uniform(0, 0.2)
    slow_ms = int(cfg.get("slow_ms", 25))
    down = _hold(cfg, round(rng.uniform(0.8, 1.2), 2))
    return (make_step(t, "slow_follower", "follower:0", delay_ms=slow_ms),
            make_step(t + 0.8, "kill", "follower:0"),
            make_step(t + 0.8 + down, "restart",
                      truncate_tail=int(cfg.get("truncate_tail", 3))),
            make_step(t + 1.0 + down, "heal"))
