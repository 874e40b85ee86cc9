"""The placement controller, the port against the JAX package.

The port's server names ``ratis_tpu_torch.placement`` behind
``raft.tpu.placement.enabled``; its four modules are verbatim copies now.
Here:

- ``placement.policy`` gives equal plans (actions, notes, imbalance, the
  explained lines) in both packages on the JAX package's hand-made
  snapshots (``tests/test_placement.py``: fair-share transfers, the
  hysteresis band, the single-view admission gate, grey and low-score
  steering, cooldown and the round cap, no healthy target, the leader-
  imbalance fallback, the advisory repin) and on seeded random ones, and
  equal views from the same introspection payloads;
- a port cluster (3 x 4 over TCP) with ``raft.tpu.placement.enabled=true``
  starts with a controller on every server, serves writes, runs a forced
  round per server and steers away from an injected grey peer, with the
  paired rebalance events journaled;
- the bench's ``placement`` rung runs tiny (4 x 8, 32 clients) through
  ``--device cpu``.
"""

import asyncio
import importlib
import json
import pathlib
import random
import subprocess
import sys

import pytest

from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("ratis_tpu_torch", "ratis_tpu")


def _policy(pkg: str):
    return importlib.import_module(f"{pkg}.placement.policy")


def _hot(pol, name, share_min, led=True, shard=None):
    return pol.HotGroup(group=name, share=share_min + 0.05,
                        share_min=share_min, led=led, shard=shard)


def _view(pol, peer, leading=0, hot=(), scores=None, grey=(),
          shed_rate=0.0, shards=()):
    return pol.ServerView(peer=peer, leading=leading, hot_groups=tuple(
        _hot(pol, *h) for h in hot), peer_scores=dict(scores or {}),
        grey_peers=frozenset(grey), shed_rate=shed_rate,
        shard_counts=tuple(shards))


# the JAX package's plan cases: (policy kwargs, views, exclude); a view
# is (peer, leading, hot groups (name, share_min[, led, shard]), peer
# scores, grey peers, shed rate, shard counts)
CASES = {
    "hot_fair_share_multi_view": (
        {"hot_share": 0.2, "hysteresis": 0.0, "max_transfers_per_round": 2},
        [("s0", 6, [("g1", 0.5), ("g2", 0.3), ("g3", 0.25)],
          {"s1": 1.0, "s2": 1.0}), ("s1", 1, [], {"s0": 1.0, "s2": 1.0}),
         ("s2", 2, [], {"s0": 1.0, "s1": 1.0})], ()),
    "hysteresis_band": (
        {"hot_share": 0.2, "hysteresis": 1.0},
        [("s0", 3, [("g1", 0.5), ("g2", 0.3)], {"s1": 1.0}, (), 5.0),
         ("s1", 2, [], {"s0": 1.0})], ()),
    "single_view_idle": (
        {"hot_share": 0.2, "hysteresis": 0.0},
        [("s0", 4, [("g1", 0.6), ("g2", 0.3)], {"s1": 1.0, "s2": 1.0},
          (), 0.0)], ()),
    "single_view_shedding": (
        {"hot_share": 0.2, "hysteresis": 0.0},
        [("s0", 4, [("g1", 0.6), ("g2", 0.3)], {"s1": 1.0, "s2": 1.0},
          (), 12.0)], ()),
    "steer_grey": (
        {"hot_share": 0.2, "grey_score": 0.5, "hysteresis": 0.0},
        [("s0", 4, [("g1", 0.5), ("g2", 0.4)],
          {"s1": 0.2, "s2": 1.0, "s3": 0.9}, ("s1",), 3.0)], ()),
    "steer_low_score": (
        {"hot_share": 0.2, "grey_score": 0.5, "hysteresis": 0.0},
        [("s0", 0, [], {"s1": 0.3, "s2": 1.0})], ()),
    "cooldown_and_cap": (
        {"hot_share": 0.1, "hysteresis": 0.0, "max_transfers_per_round": 1},
        [("s0", 6, [("g1", 0.4), ("g2", 0.3), ("g3", 0.2), ("g4", 0.15)],
          {"s1": 1.0, "s2": 1.0, "s3": 1.0}, (), 2.0)], ("g1",)),
    "no_healthy_target": (
        {"hot_share": 0.1, "grey_score": 0.5, "hysteresis": 0.0},
        [("s0", 3, [("g1", 0.6), ("g2", 0.3)], {"s1": 0.1, "s2": 0.2},
          (), 9.0)], ()),
    "leader_imbalance": (
        {"hot_share": 0.9, "hysteresis": 1.0},
        [("s0", 9, [("busy", 0.1)], {"s1": 1.0}),
         ("s1", 1, [], {"s0": 1.0})], ()),
    "leader_imbalance_solo": (
        {"hot_share": 0.9, "hysteresis": 1.0},
        [("s0", 9, [("busy", 0.1)], {"s1": 1.0})], ()),
    "shard_skew": (
        {}, [("s0", 0, [("g1", 0.5, True, 0)], {}, (), 0.0, (5, 1))], ()),
}


def _plan(pkg: str, kwargs: dict, views: list, exclude) -> dict:
    pol = _policy(pkg)
    snapshot = pol.ClusterSnapshot(views=tuple(_view(pol, *v)
                                               for v in views))
    plan = pol.PlacementPolicy(**kwargs).plan(snapshot, exclude=exclude)
    return {**plan.to_dict(), "notes": list(plan.notes),
            "explain": plan.explain()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_plans_match_jax(case):
    kwargs, views, exclude = CASES[case]
    port, jax = (_plan(pkg, kwargs, views, exclude) for pkg in PACKAGES)
    assert port == jax


def _random_case(rng: random.Random):
    """A seeded snapshot: 1-4 views, hot groups with shares and shards,
    peer scores, grey peers, shed rates, shard counts; a random policy
    and cooldown set."""
    peers = [f"s{i}" for i in range(rng.randint(2, 5))]
    groups = [f"g{i}" for i in range(rng.randint(1, 8))]
    views = []
    for peer in rng.sample(peers, rng.randint(1, min(4, len(peers)))):
        others = [p for p in peers if p != peer]
        hot = sorted(((g, round(rng.random() * 0.6, 3), rng.random() < 0.8,
                       rng.choice((None, 0, 1)))
                      for g in rng.sample(groups, rng.randint(0,
                                                              len(groups)))),
                     key=lambda h: -h[1])
        views.append((peer, rng.randint(0, 12), hot,
                      {p: round(rng.random(), 2) for p in others},
                      tuple(p for p in others if rng.random() < 0.2),
                      rng.choice((0.0, 0.0, 3.0, 12.0)),
                      tuple(rng.randint(0, 6) for _ in range(
                          rng.randint(0, 3)))))
    kwargs = {"hot_share": rng.choice((0.02, 0.1, 0.2, 0.5)),
              "grey_score": rng.choice((0.3, 0.5)),
              "hysteresis": rng.choice((0.0, 1.0, 2.0)),
              "max_transfers_per_round": rng.randint(0, 3)}
    exclude = tuple(g for g in groups if rng.random() < 0.15)
    return kwargs, views, exclude


@pytest.mark.parametrize("seed", range(4))
def test_policy_plans_match_jax_on_seeded_snapshots(seed):
    rng = random.Random(seed)
    acted = 0
    for _ in range(50):
        case = _random_case(rng)
        port, jax = (_plan(pkg, *case) for pkg in PACKAGES)
        assert port == jax, case
        acted += bool(port["actions"])
    assert acted > 0


def test_views_from_payloads_match_jax():
    lag = {"peer": "s0", "leading": 7,
           "peers": [{"peer": "s1", "score": 0.4},
                     {"peer": "s2", "score": 1.0}],
           "groups": [{"group": "g9", "lag": 100}]}
    rollup = {"peer": "s0", "leading": 7, "pendingTotal": 11,
              "divisions": 16, "shards": [8, 8]}
    health = {"peer": "s0", "divisions": 16,
              "serving": {"shedTotal": 42, "pendingCount": 11}}
    hotgroups = {"peer": "s0", "groups": [
        {"group": "g1", "share": 0.5, "share_min": 0.45, "led": True,
         "shard": 0}]}
    for kw in ({"health": health, "lag": lag, "hotgroups": hotgroups,
                "rollup": rollup}, {"lag": {"peer": "s1", "leading": 2}},
               {"rollup": rollup, "grey": ("s2",), "shed_rate": 3.0}):
        port, jax = (_policy(pkg).view_from_payloads(**kw)
                     for pkg in PACKAGES)
        assert repr(port) == repr(jax).replace("ratis_tpu.",
                                               "ratis_tpu_torch.")


def test_placement_enabled_server_starts_and_runs_a_round():
    """Before the port had ``placement/``, a server with the key set raised
    ModuleNotFoundError at start."""
    from ratis_tpu_torch.server.watchdog import (KIND_REBALANCE,
                                                 KIND_REBALANCE_DONE)
    p = cluster_properties(4, 3, "cpu", "tcp")
    p.set("raft.tpu.placement.enabled", "true")
    p.set("raft.tpu.placement.interval", "60s")  # rounds forced here

    async def body():
        cluster = Cluster(4, device="cpu", transport="tcp", properties=p)
        try:
            await cluster.start(timeout=60)
            stats = await cluster.write_all(2)
            counters = await cluster.read_counters(timeout=60)
            ctrls = [s.placement for s in cluster.servers]
            assert all(c is not None for c in ctrls)
            for c in ctrls:
                await c.round()
                assert c.rounds == 1 and c.last_plan is not None
                assert c.placement_info()["rounds"] == 1
            srv = cluster.leader_of(cluster.groups[0])
            grey = next(str(x.peer_id) for x in cluster.servers
                        if x is not srv)
            srv.watchdog._grey.add(grey)
            await srv.placement.round()
            events = srv.watchdog.events()
            opened = {e["fault"] for e in events
                      if e["kind"] == KIND_REBALANCE}
            closed = {e["fault"] for e in events
                      if e["kind"] == KIND_REBALANCE_DONE}
            return (stats["commits"], counters, grey,
                    srv.read_steering.avoided(), opened, closed)
        finally:
            await cluster.close()

    commits, counters, grey, avoided, opened, closed = asyncio.run(body())
    assert commits == 8 and all(v == [2, 2, 2] for v in counters.values())
    assert grey in avoided
    assert opened and opened == closed


def test_placement_rung_runs_tiny():
    proc = subprocess.run([sys.executable, "-m",
                           "ratis_tpu_torch.tools.bench", "--device", "cpu",
                           "--rungs", "placement", "--groups", "8",
                           "--clients", "32", "--settle", "2"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)["placement"]
    assert out["groups"] == 8 and out["peers"] == 4
    assert out["transport"] == "tcp" and out["engine_device"] == "cpu"
    assert out["failures"] == 0 and out["plans_computed"] > 0
    # every client's pairs in both phases (6 a client)
    assert out["writes_ok_off"] == out["writes_ok_on"] == 32 * 6
    assert out["reads_ok_off"] == out["reads_ok_on"] == 32 * 6
    # pinning is best effort, as in the JAX rung (a transfer may fail)
    assert out["hot_pins_requested"] == 8 and 0 <= out["hot_pins"] <= 8
    for key in ("hotspot_p99_before_ms", "hotspot_p99_after_ms",
                "hot_shed_off", "hot_shed_on", "transfers",
                "grey_confirm_frac_off", "grey_confirm_frac_on",
                "grey_steer_frac", "steered_reads",
                "election_convergence_s"):
        assert key in out, key
