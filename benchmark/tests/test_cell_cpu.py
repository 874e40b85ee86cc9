"""A cell end to end on the CPU at a tiny size, with the kernels' plain
versions: the result line's keys, the answers checked, and ``correct``
false under each fault the harness can meet and under the control."""

import pytest

from benchmark import controls, manifest, run

SEED = 2 ** 31 + 29
GROUPS = 12
# The read-heavy cell and its two metrics, as their entries in
# BENCHMARK.json would read: the mix and the readers are in place, and the
# cell waits there until its runs' spread fits a bound (PERF.md, Open
# questions); here it runs the read path's checks.
READ95 = {"name": "arith3x1024-read95", "config": "arith3x1024",
          "traffic": "read95", "chips": 1}
READ_METRICS = [
    {"name": "read_p95_ms.diag", "unit": "ms", "better": "lower",
     "source": "host_clock", "layer": "client", "moves": "ops_per_s",
     "workloads": [READ95["name"]]},
    {"name": "reads.per_sweep", "unit": "reads/sweep", "better": "higher",
     "source": "program_counter", "layer": "read path",
     "moves": "ops_per_s", "workloads": [READ95["name"]]}]


def _bench() -> dict:
    bench = manifest.load()
    bench["workloads"].append(READ95)
    bench["per_layer"] += READ_METRICS
    return bench


def _tiny(cell_name: str, machine: str = None):
    bench = _bench()
    cell = manifest.cell(bench, cell_name)
    config = manifest.config(cell["config"])
    config["groups"] = GROUPS
    config["properties"]["raft.tpu.engine.max-groups"] = "64"
    if machine is not None:
        config = controls.with_machine(config, machine)
    mix = manifest.traffic(cell["traffic"])
    mix.update(clients=6, client_procs=2, warmup_s=0.5, drain_s=20.0)
    return bench, cell, config, mix


def _run(cell_name: str, machine: str = None, trace: bool = False):
    bench, cell, config, mix = _tiny(cell_name, machine)
    return bench, run.run_cell(bench, cell, SEED, 2.0, trace, "cpu",
                               config=config, mix=mix)


@pytest.mark.parametrize("cell_name", ["arith3x1024-write",
                                       "arith3x1024-read95"])
def test_a_tiny_cell_runs_end_to_end(cell_name):
    bench, out = _run(cell_name)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in manifest.metrics_of(bench, cell_name,
                                                   "end_to_end")}
    assert set(out["metrics"]) == want
    assert out["device"]["platform"] == "cpu"
    # no process of the run loaded JAX or the JAX package, and no client
    # process touched CUDA
    assert out["foreign_modules"] == [] and not out["cuda_in_clients"]


def test_a_traced_tiny_cell_reports_its_layers():
    bench, out = _run("arith3x1024-read95", trace=True)
    assert out["correct"], out["checks"]
    names = {m["name"] for m in manifest.metrics_of(
        bench, "arith3x1024-read95", "per_layer")}
    assert set(out["metrics"]) <= names
    # no card: the device's metrics read nothing, the host's read
    assert "kernel.tile_tick_roofline" not in out["metrics"]
    assert {"write_p95_ms.diag", "read_p95_ms.diag",
            "server.election_timeouts", "engine.ack_batch_p50",
            "hostpath.replicate_share"} <= set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    lags = out["diagnostics"]["each server's loop, worst lag ms in each "
                              "second"]
    assert len(lags) == 3 and all(len(x) == 2 for x in lags)


@pytest.mark.parametrize("cell_name,fault,caught_by", [
    # a variable whose assignment never took effect fails every later
    # write to it
    ("arith3x1024-write", "FrozenArithmetic", "failed_ops"),
    ("arith3x1024-write", "HalfArithmetic", "failed_ops"),
    ("arith3x1024-write", "AlteredArithmetic", "write_reply_mismatches"),
    ("arith3x1024-read95", "AlteredArithmetic", "read_mismatches"),
    ("arith3x1024-write", "LazyFollowerArithmetic", "replica_mismatches"),
    ("arith3x1024-read95", "LazyFollowerArithmetic", "replica_mismatches"),
    # one write of the whole run applied twice, or left out, where later
    # writes to the group follow it
    ("arith3x1024-write", "TwiceArithmetic", "replica_mismatches"),
    ("arith3x1024-read95", "TwiceArithmetic", "replica_mismatches"),
    ("arith3x1024-write", "DroppedArithmetic", "replica_mismatches"),
    ("arith3x1024-read95", "DroppedArithmetic", "replica_mismatches"),
])
def test_a_broken_timed_path_comes_out_not_correct(cell_name, fault,
                                                   caught_by):
    _, out = _run(cell_name, fault)
    assert not out["correct"]
    assert out["checks"][caught_by]["value"] > 0, out["checks"]
