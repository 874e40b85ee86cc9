"""The read rungs, the port against the JAX package.

The port's ``tools/read_bench.py`` ports ``run_read_write_bench``
(``readmix``) and ``run_zipf_fleet_bench`` (``zipf``) onto its own
``Cluster`` and adds what the JAX loads lack: every read value and, after
the load, every replica's counter held to the writes sent and
acknowledged.  Here:

- ``readmix`` tiny (3 x 8 over TCP, 2 writes a group, 3 reads a write) in
  both packages: every write committed, the per-path read counts equal,
  no failure; in the port no read or replica mismatch;
- a doctored read reply (the counter state machine's ``query`` off by
  one either way) is caught as read and replica mismatches, and
  ``ReadChecks`` holds hand-made read sequences to their bounds;
- ``zipf`` tiny (3 x 16, 256 clients, 64 in flight, element limit 16, 16
  unsaturated clients) in both packages: the same seeded home group for
  every client, the same analytic top share, every write and read served,
  the pending peak at or under the limit; in the port no mismatch;
- both rungs tiny through ``tools/bench.py --device cpu``;
- the rungs' properties equal the JAX loads' key for key (the JAX bench's
  ``bench_properties`` plus the loads' extra keys) at 1024 groups, apart
  from the port's device key.
"""

import asyncio
import bisect
import io
import json
from contextlib import redirect_stdout

import pytest

from ratis_tpu.tools import bench_cluster as jax_bench
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.models.counter import CounterStateMachine
from ratis_tpu_torch.tools import bench
from ratis_tpu_torch.tools import read_bench as rb

# the keys of run_read_write_bench's and run_zipf_fleet_bench's results
READMIX_KEYS = {"commits", "write_failures", "elapsed_s", "commits_per_sec",
                "reads_per_sec", "reads_ok", "read_failures",
                "reads_lease_leader", "reads_follower_linearizable",
                "reads_stale", "p50_ms", "p99_ms", "read_p50_ms",
                "read_p99_ms", "election_convergence_s", "groups", "mode",
                "transport", "peers"}
ZIPF_KEYS = {"clients", "groups", "zipf_s", "writes_ok", "reads_ok",
             "failures", "elapsed_s", "writes_per_sec", "reads_per_sec",
             "shed", "admitted", "shed_frac", "shed_seen_by_clients",
             "p99_ms", "read_p99_ms", "p99_unsat_ms", "overload_p99_ratio",
             "pending_peak", "pending_limit", "confirm_sweeps_per_read",
             "hot_share", "hot_group", "hot_group_expected",
             "expected_top_share", "election_convergence_s", "mode",
             "transport", "peers"}
TINY_ZIPF = {"clients": 256, "concurrency": 64, "element_limit": 16,
             "unsat_clients": 16}
# the extra keys run_read_write_bench and run_zipf_fleet_bench give
# BenchCluster (bench_cluster.py:1781-1784, 2072-2080)
READ_EXTRA = {"raft.server.read.option": "LINEARIZABLE",
              "raft.server.read.leader.lease.enabled": "true"}
ZIPF_EXTRA = {**READ_EXTRA,
              "raft.tpu.telemetry.enabled": "true",
              "raft.tpu.telemetry.interval": "250ms",
              "raft.tpu.serving.admission.enabled": "true",
              "raft.tpu.serving.admission.pending.element-limit": "192",
              "raft.tpu.serving.admission.retry-after": "40ms"}
_BISECT_LEFT = bisect.bisect_left


def _port_readmix(groups=8, writes=2):
    return asyncio.run(rb.readmix_rung(rb.read_cluster("cpu", groups),
                                       writes=writes))


def test_readmix_tiny_matches_jax():
    jax = asyncio.run(jax_bench.run_read_write_bench(
        8, 2, reads_per_write=3, concurrency=128, transport="tcp"))
    port = _port_readmix()
    assert READMIX_KEYS <= set(jax) and READMIX_KEYS <= set(port)
    for res in (jax, port):
        assert res["commits"] == 8 * 2
        assert (res["write_failures"], res["read_failures"]) == (0, 0)
        assert (res["groups"], res["peers"], res["transport"]) == \
            (8, 3, "tcp")
    for key in ("reads_ok", "reads_lease_leader",
                "reads_follower_linearizable", "reads_stale"):
        assert port[key] == jax[key], key
    assert port["reads_lease_leader"] == 8 * 2
    assert (port["read_mismatches"], port["replica_mismatches"]) == (0, 0)
    assert port["reads_checked"] == port["reads_ok"] == 8 * 2 * 3
    assert port["replicas_read_back"] == 8 * 3
    assert sum(port["reads_served"].values()) == port["reads_ok"]
    assert len(port["confirm_sweeps"]) == len(port["confirmed_reads"]) == 3
    assert port["engine_device"] == "cpu"


@pytest.mark.parametrize("offset", [1, -1])
def test_a_doctored_read_reply_is_caught(monkeypatch, offset):
    from ratis_tpu_torch.protocol.message import Message

    async def doctored(self, request):
        return Message.value_of(str(self.counter + offset))
    monkeypatch.setattr(CounterStateMachine, "query", doctored)
    res = _port_readmix(groups=4)
    assert res["read_mismatches"] > 0
    assert res["replica_mismatches"] == 4
    kind_of = {ex[1] for ex in res["read_mismatch_examples"]}
    assert kind_of <= set(rb.READ_KINDS)


@pytest.mark.parametrize("reads,bad", [
    # (kind, value, acked before the read, writes sent) -> mismatch?
    ([("lease_leader", 2, 2, 2)], False),
    ([("lease_leader", 1, 2, 2)], True),      # an acked write unseen
    ([("follower_lin", 3, 2, 2)], True),      # a write never sent
    ([("follower_lin", 3, 2, 3)], False),     # a failed write applied
    ([("stale", 0, 2, 2)], False),            # stale may lag
    ([("stale", 3, 2, 2)], True),
    ([("linearizable", 5, 4, 6), ("linearizable", 3, 4, 6)], True),
])
def test_read_checks_hold_reads_to_their_bounds(reads, bad):
    checks = rb.ReadChecks()
    for kind, value, acked, sent in reads:
        checks.sent["g"], checks.acked["g"] = sent, acked
        checks.read("g", kind, value, checks.before_read("g"))
    assert bool(checks.mismatches) == bad
    assert checks.reads == len(reads)


def test_replica_check_holds_counters_to_acked_and_sent():
    checks = rb.ReadChecks()
    checks.sent = {"a": 2, "b": 3, "c": 2}
    checks.acked = {"a": 2, "b": 2, "c": 2}
    bad = checks.replicas({"a": [2, 2, 2], "b": [2, 3, 3],
                           "c": [2, 1, 2], "d": [0, 0, 1]})
    assert [b[0] for b in bad] == ["c", "d"]


def _recorded_homes(monkeypatch, num_groups: int) -> list:
    """Record every home rank a zipf load draws (its ``bisect_left`` over
    a CDF of ``num_groups`` entries)."""
    homes = []

    def recording(a, x, *args, **kw):
        i = _BISECT_LEFT(a, x, *args, **kw)
        if isinstance(a, list) and len(a) == num_groups \
                and isinstance(x, float):
            homes.append(i)
        return i
    monkeypatch.setattr(bisect, "bisect_left", recording)
    return homes


def test_zipf_tiny_matches_jax(monkeypatch):
    jax_homes = _recorded_homes(monkeypatch, 16)
    jax = asyncio.run(jax_bench.run_zipf_fleet_bench(
        16, transport="tcp", **TINY_ZIPF))
    port_homes = _recorded_homes(monkeypatch, 16)
    port = asyncio.run(rb.zipf_rung(
        rb.read_cluster("cpu", 16, zipf=True, element_limit=16),
        **TINY_ZIPF))
    assert ZIPF_KEYS <= set(jax) and ZIPF_KEYS <= set(port)
    n = TINY_ZIPF["clients"] + TINY_ZIPF["unsat_clients"]
    assert len(jax_homes) == len(port_homes) == n
    assert port_homes == jax_homes
    counts = [0] * 16
    for h in port_homes:
        counts[h] += 1
    assert port["home_counts"] == counts
    assert port["expected_top_share"] == pytest.approx(
        jax["expected_top_share"], abs=5e-5)
    for res in (jax, port):
        assert res["writes_ok"] == res["reads_ok"] == TINY_ZIPF["clients"]
        assert res["failures"] == 0
        assert res["pending_peak"] <= res["pending_limit"] == 16
        assert (res["groups"], res["clients"], res["transport"]) == \
            (16, 256, "tcp")
    assert (port["read_mismatches"], port["replica_mismatches"]) == (0, 0)
    assert port["reads_checked"] == TINY_ZIPF["clients"] \
        + TINY_ZIPF["unsat_clients"]
    assert port["replicas_read_back"] == 16 * 3
    assert port["engine_device"] == "cpu"


@pytest.mark.parametrize("rung,args", [
    ("readmix", ["--groups", "8", "--writes", "2"]),
    ("zipf", ["--groups", "16", "--clients", "256", "--concurrency", "64",
              "--element-limit", "16", "--unsat-clients", "16"]),
])
def test_read_rungs_tiny_on_cpu(rung, args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--device", "cpu", "--rungs", rung, *args])
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])[rung]
    assert set(READMIX_KEYS if rung == "readmix" else ZIPF_KEYS) <= set(res)
    assert (res["read_mismatches"], res["replica_mismatches"]) == (0, 0)
    assert res["engine_device"] == "cpu" and res["transport"] == "tcp"
    if rung == "readmix":
        assert res["commits"] == 16 and res["reads_ok"] == 48
    else:
        assert res["writes_ok"] == res["reads_ok"] == 256
        assert res["pending_peak"] <= 16


def test_read_rung_with_a_mismatch_exits_1(monkeypatch):
    async def fake(cluster, **kw):
        await cluster.close()
        return {"read_mismatches": 1, "replica_mismatches": 0}
    monkeypatch.setattr(rb, "readmix_rung", fake)
    with redirect_stdout(io.StringIO()):
        assert bench.main(["--device", "cpu", "--rungs", "readmix",
                           "--groups", "4"]) == 1


@pytest.mark.parametrize("zipf", [False, True])
def test_read_properties_are_the_jax_loads(zipf):
    from ratis_tpu.tools.bench_cluster import bench_properties
    port = dict(rb.read_properties(1024, 3, "cuda", zipf).items())
    jax = dict(bench_properties(True, 1024, transport="tcp").items())
    jax.update(ZIPF_EXTRA if zipf else READ_EXTRA)
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    assert (port["raft.server.rpc.timeout.min"],
            port["raft.server.rpc.timeout.max"]) == ("1s", "2s")
