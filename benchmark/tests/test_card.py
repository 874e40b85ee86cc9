"""A cell as ``BENCHMARK.json``'s command runs it, on the card:
``benchmark/run.py`` in a process of its own, a short window, the last
line's keys and ``correct``.  Skips where there is no CUDA card.

    python -m pytest benchmark/tests/test_card.py -q    # on the card
"""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(cuda_card, trace):
    done = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "arith3x1024-write", "--seed", str(2 ** 31 + 41), "--seconds", "5",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == cuda_card
    assert list(out)[-1] == "checks"
    if trace:
        assert out["device"]["busy_s"] > 0
        assert "kernel.tile_tick_roofline" in out["metrics"]
