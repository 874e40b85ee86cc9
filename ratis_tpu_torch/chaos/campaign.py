"""Chaos campaign driver: N scenarios on ONE cluster, sequentially, as a
standing gate — and the ``chaos_1024`` bench rung.

``run_campaign`` builds a single ChaosCluster, runs each scenario's
fault schedule + SLO verification on it (healing in between), and folds
the results into one summary: scenarios passed, the worst re-election
convergence observed, and the recovery-throughput fraction (the
campaign's "how much does a fault cost once healed" number).  Every
injected fault and its recovery is journaled through the live servers'
watchdog ``/events`` plane, so a scrape mid-campaign shows the faults
interleaved with whatever they organically triggered (commit-stall,
election-churn, follower-lag, stuck-lane).

``run_chaos_1024`` is the bench rung (ROADMAP open item 5): the default
campaign at the 1024-group batched shape — where the windowed-rewind and
packed-ack paths actually live — with durable logs so the
slow-disk fault bites a real fsync path (the 1024-group rung runs the
shared interleaved store, ``raft.tpu.log.shared``).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ratis_tpu_torch.chaos.cluster import ChaosCluster, chaos_properties
from ratis_tpu_torch.chaos.scenario import run_scenario
from ratis_tpu_torch.chaos.scenarios import build_scenario

LOG = logging.getLogger(__name__)

# The standing campaign: >= 6 distinct fault classes.  slow_disk is
# appended only on durable clusters (memory logs never reach the sync
# path, and a scenario that cannot bite must not count as passed).
DEFAULT_CAMPAIGN = ("partition_minority", "partition_leader",
                    "asymmetric_partition", "link_degraded",
                    "crash_restart_follower", "crash_restart_leader",
                    "leader_churn_storm", "slow_follower",
                    "grey_follower", "rebalance_storm")
DURABLE_EXTRA = ("slow_disk", "shared_log_tail_loss")


async def run_campaign(num_servers: int = 3, num_groups: int = 1,
                       seed: int = 0,
                       scenarios: Optional[tuple] = None,
                       transport: str = "sim", sm: str = "recording",
                       storage_root: Optional[str] = None,
                       writers: int = 3, active_groups: Optional[int] = None,
                       convergence_s: Optional[float] = None,
                       recovery_s: Optional[float] = None,
                       artifact_dir: Optional[str] = None,
                       extra_config: Optional[dict] = None,
                       extra_props: Optional[dict] = None,
                       device: str = "cuda") -> dict:
    """Run the scenario list on one cluster, every engine on ``device``;
    returns the campaign summary dict (JSON-safe, the bench rung's RESULT
    payload)."""
    from ratis_tpu_torch.conf.keys import RaftServerConfigKeys
    durable = storage_root is not None
    names = scenarios or (DEFAULT_CAMPAIGN
                          + (DURABLE_EXTRA if durable else ()))
    props = chaos_properties(num_groups, seed=seed, device=device)
    for k, v in (extra_props or {}).items():
        props.set(k, str(v))
    if convergence_s is None:
        convergence_s = RaftServerConfigKeys.Chaos.convergence_timeout(
            props).seconds
    if recovery_s is None:
        recovery_s = RaftServerConfigKeys.Chaos.recovery_timeout(
            props).seconds
    if artifact_dir:
        props.set(RaftServerConfigKeys.Chaos.ARTIFACT_DIR_KEY, artifact_dir)
    cluster = ChaosCluster(num_servers, num_groups, properties=props,
                           transport=transport, sm=sm,
                           storage_root=storage_root, seed=seed)
    config = {"servers": num_servers, "groups": num_groups, "sm": sm,
              "transport": transport, "writers": writers,
              "durable": durable,
              "active_groups": (active_groups
                                or min(num_groups, 8)),
              "convergence_s": convergence_s, "recovery_s": recovery_s}
    config.update(extra_config or {})
    t0 = time.monotonic()
    out: dict = {"seed": seed, "groups": num_groups,
                 "servers": num_servers, "transport": transport,
                 "scenarios": {}, "passed": 0, "total": len(names)}
    await cluster.start()
    bring_up_s = time.monotonic() - t0
    try:
        worst_reelect = 0.0
        fracs: list[float] = []
        for name in names:
            scenario = build_scenario(name, seed, config)
            t_s = time.monotonic()
            result = await run_scenario(cluster, scenario,
                                        artifact_dir=artifact_dir)
            entry = {"passed": result.passed,
                     "reelect_s": result.slos.get("reelect_s"),
                     "recovery_frac": result.recovery_frac,
                     "acked": result.acked,
                     "elapsed_s": round(time.monotonic() - t_s, 1)}
            if result.error:
                entry["error"] = result.error[:200]
            out["scenarios"][name] = entry
            if result.passed:
                out["passed"] += 1
                if result.slos.get("reelect_s"):
                    worst_reelect = max(worst_reelect,
                                        result.slos["reelect_s"])
                if result.recovery_frac:
                    fracs.append(result.recovery_frac)
            LOG.warning("chaos scenario %s seed=%s: %s (reelect %ss, "
                        "recovery x%s)", name, seed,
                        "PASS" if result.passed else
                        f"FAIL: {result.error}",
                        result.slos.get("reelect_s"), result.recovery_frac)
            # inter-scenario settle: the next schedule's baseline window
            # must not start inside this one's tail turbulence.  A
            # settle failure is DATA (the scenario already recorded its
            # own verdict) — one wedged scenario must not vaporize the
            # rest of the campaign's results
            try:
                await cluster.wait_all_leaders(timeout=convergence_s)
                await cluster.wait_quiesced(timeout=recovery_s)
            except TimeoutError as e:
                entry["settle_failed"] = str(e)[:200]
                LOG.warning("chaos campaign: cluster did not settle "
                            "after %s: %s", name, e)
        out["worst_reelect_s"] = round(worst_reelect, 3)
        out["recovery_frac"] = (round(min(fracs), 3) if fracs else 0.0)
        out["bring_up_s"] = round(bring_up_s, 1)
        out["elapsed_s"] = round(time.monotonic() - t0, 1)
        # the /events flight recorder: every injected fault must have
        # been journaled (and paired on success) on some live server
        events = [e for s in cluster.servers.values()
                  if s.watchdog is not None for e in s.watchdog.events()]
        out["fault_events"] = sum(1 for e in events
                                  if e["kind"] == "injected-fault")
        out["recovered_events"] = sum(1 for e in events
                                      if e["kind"] == "fault-recovered")
        out["organic_events"] = sum(
            1 for e in events
            if e["kind"] not in ("injected-fault", "fault-recovered",
                                 "rebalance", "rebalance-done"))
    finally:
        await cluster.close()
    return out


async def run_chaos_1024(seed: int = 0, num_groups: int = 1024,
                         transport: str = "sim",
                         storage_root: Optional[str] = None,
                         artifact_dir: Optional[str] = None,
                         device: str = "cuda") -> dict:
    """The ``chaos_1024`` bench rung: the default campaign at the
    1024-group batched shape with counter-oracle invariants (per group:
    ``acked <= counter <= attempts`` on every replica, replicas equal)
    and durable segmented logs so slow-disk is a real fsync fault.
    Density-scaled timeouts come from the bench cost model
    (tools/bench_cluster.bench_properties), so the campaign stresses
    exactly the configuration the perf rungs measure."""
    import tempfile
    own_tmp = None
    if storage_root is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ratis-chaos-")
        storage_root = own_tmp.name
    try:
        return await run_campaign(
            num_servers=3, num_groups=num_groups, seed=seed,
            transport=transport, sm="counter",
            storage_root=storage_root, writers=4,
            active_groups=min(num_groups, 64),
            artifact_dir=artifact_dir, device=device,
            # leader-targeted faults depose 1000+ leaderships at once
            # (the real blast radius of losing a leader-heavy server):
            # the bound covers the mass re-election plus drain
            convergence_s=120.0, recovery_s=240.0,
            # Storm containment at 2048 channels: 1s/2s election
            # timeouts were metastable under MASS deposal — the fault
            # surge re-fired timeouts faster than the vote storm could
            # drain (126 election-churn events, no quiesce in 240s) —
            # exactly the basin bench_properties documents for gRPC at
            # this density.  The campaign runs the same margin tier a
            # real deployment tunes; fault holds scale with it
            # (hold_scale) so partitions still outlast the timeout band
            # and re-election genuinely fires during the fault.
            # the chaos rung runs the SHARED log plane (round 12,
            # raft.tpu.log.shared): one interleaved segment sequence per
            # loop shard, so slow-disk and tail-loss faults hit the one
            # fsync stream every co-located group rides
            extra_props={"raft.server.rpc.timeout.min": "4s",
                         "raft.server.rpc.timeout.max": "8s",
                         "raft.tpu.log.shared": "1"},
            extra_config={"min_acked": 50, "recovery_window_s": 8.0,
                          "hold_scale": 6.0})
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
