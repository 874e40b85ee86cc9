"""The port's bench entry point (``python -m ratis_tpu_torch.tools.bench``).

With ``--device cpu`` at tiny sizes it runs all three rungs on the plain
versions and prints exactly one JSON line on stdout, with ``bench.py``'s
key names for the rungs: the kernel rung's ``group_updates_per_sec`` and
``vs_scalar_loop``, ``kernel_100k``'s ``group_updates_per_sec_100k``, and
the e2e rung's commits/s, p50, p99 and bring-up seconds over TCP, every
write read back from all three replicas, and the election timeouts of
bring-up, warm-up and measured writes.  Without a card the default
``--device cuda`` fails and prints no result.  The churn probe
(``tools/churn_probe.py``) runs the same rung at a tiny size.
"""

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--kernel", "64,8,32", "--kernel-100k", "128,8,64", "--iters", "3",
        "--scalar-groups", "16", "--groups", "4", "--writes", "2"]


def _bench(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "ratis_tpu_torch.tools.bench",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_bench_prints_one_json_line_with_the_rung_keys():
    proc = _bench("--device", "cpu", *TINY)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "aggregate_commits_per_sec"
    assert out["device"]["type"] == "cpu"
    k = out["kernel"]
    assert k["group_updates_per_sec"] > 0 and k["vs_scalar_loop"] > 0
    assert k["shape"] == [64, 8, 32]
    assert out["kernel_100k"]["group_updates_per_sec_100k"] > 0
    assert out["kernel_100k"]["shape"] == [128, 8, 64]
    e = out["e2e"]
    assert e["transport"] == "tcp" and e["servers"] == 3
    assert e["commits"] == 4 * 2 and e["write_failures"] == 0
    assert e["replicas_read_back"] == 4 * 3
    assert out["value"] == e["commits_per_sec"] > 0
    for key in ("p50_ms", "p99_ms", "election_convergence_s", "prewarm_s"):
        assert e[key] > 0, key
    assert e["batched_dispatches"] > 0 and min(e["ledger_samples"]) > 0
    # bring-up elects every group's leader after a timeout
    assert len(e["election_timeouts"]) == 3
    assert e["election_timeouts"][0] >= 4
    assert e["engine_device"] == "cpu"


def test_bench_rungs_can_be_chosen():
    proc = _bench("--device", "cpu", "--rungs", "kernel", *TINY)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    assert "kernel" in out and "e2e" not in out and out["value"] is None


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        return  # this machine has a card: the default runs the kernels
    proc = _bench("--rungs", "kernel", *TINY)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_churn_probe_counts_timeouts_per_window():
    proc = subprocess.run([sys.executable, "-m",
                           "ratis_tpu_torch.tools.churn_probe", "--device",
                           "cpu", "--groups", "4"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    assert len(out["election_timeouts"]) == 3
    assert out["election_timeouts"][0] >= 4
    assert 0 < out["warmup_end_s"] < out["writes_end_s"]
    assert out["seal_s"] >= 0 and out["bring_up_s"] > 0
    for key in ("lags_over_100ms", "gc_over_50ms", "timeline"):
        assert isinstance(out[key], list), key
