"""The last tools of ``ratis_tpu/tools`` on the port, and the durable mixed
pair.

- The three drift gates, pointed at ``ratis_tpu_torch/``
  (``check_conf_docs``, ``check_hot_loops``, ``check_metrics_docs``):
  each passes on the port's tree beside the JAX package's own gate on
  the JAX tree, and each fails on drift injected into a copy under
  ``tmp_path``: an undocumented key, an undocumented metric, a divisions
  walk that is not allowlisted, and a stale allowlist entry.  The conf
  gate reads ``docs/configurations.md`` and the README's port section,
  where the port's own ``raft.torch.engine.device`` has its row.
- ``profile_load`` at ``8 batched 2 sim 3`` and ``8 scalar 2 sim 3``
  (``--device cpu`` for the port): the port's ``RESULT`` line has every
  key of the JAX tool's at the same arguments, every write acknowledged,
  and the two ``pstats`` tables follow it.
- ``mix_fs`` (``filestore_bench.run_mix_fs``) at 3 x 8 on the CPU: in
  each of its four legs (per-group segment files, the shared plane, and
  both under a modeled 5 ms fsync) every stream is acknowledged and every
  file held on every replica, the fsyncs counted and each server's fsync
  seconds reported.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from ratis_tpu.tools import check_conf_docs as jax_conf
from ratis_tpu.tools import check_hot_loops as jax_loops
from ratis_tpu.tools import check_metrics_docs as jax_metrics
from ratis_tpu_torch.tools import check_conf_docs as conf
from ratis_tpu_torch.tools import check_hot_loops as loops
from ratis_tpu_torch.tools import check_metrics_docs as metrics

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("port,jax", [(conf, jax_conf), (loops, jax_loops),
                                      (metrics, jax_metrics)],
                         ids=["conf", "hot_loops", "metrics"])
def test_gate_passes_on_the_port_as_on_the_jax_package(port, jax):
    assert port.check() == []
    assert jax.check() == []


@pytest.mark.parametrize("module", ["check_conf_docs", "check_hot_loops",
                                    "check_metrics_docs"])
def test_gate_runs_from_the_command_line(module):
    proc = subprocess.run([sys.executable, "-m",
                           f"ratis_tpu_torch.tools.{module}"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok: ")


def test_gates_read_the_ports_sources():
    keys = conf.code_keys()
    assert "raft.torch.engine.device" in keys
    assert keys - {"raft.torch.engine.device"} == jax_conf.code_keys()
    rows = conf.doc_rows()
    default, meaning = rows["raft.torch.engine.device"]
    assert default == "`cuda`" and "plain versions" in meaning
    assert all(rel.startswith("ratis_tpu_torch/") for rel in loops.SCANNED)
    assert all(rel.startswith("ratis_tpu_torch/")
               for rel, _ in loops.ALLOWLIST)
    assert [r.replace("ratis_tpu_torch/", "ratis_tpu/")
            for r in loops.SCANNED] == list(jax_loops.SCANNED)
    names = metrics.code_metric_names()
    assert len(names) > 50 and "syncTime" in names
    assert all(f.startswith("ratis_tpu_torch/")
               for files in names.values() for f in files)


def test_conf_gate_fails_on_an_undocumented_key(tmp_path):
    keys_py = tmp_path / "keys.py"
    keys_py.write_text(pathlib.Path(conf.KEYS_PY).read_text()
                       + '\nDRIFT_KEY = "raft.torch.engine.drift"\n')
    problems = conf.check(keys_py=str(keys_py))
    assert problems == ["key not documented in docs/configurations.md or "
                        "the README's port section: "
                        "raft.torch.engine.drift"]


def test_conf_gate_fails_without_the_readme_row(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("\n".join(
        line for line in pathlib.Path(conf.README_MD).read_text()
        .splitlines() if not line.strip().startswith(
            "| `raft.torch.engine.device`")))
    problems = conf.check(readme_md=str(readme))
    assert len(problems) == 1 and "raft.torch.engine.device" in problems[0]


def test_metrics_gate_fails_on_an_undocumented_metric(tmp_path):
    pkg = tmp_path / "ratis_tpu_torch"
    shutil.copytree(metrics.PKG, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    (pkg / "server" / "drift.py").write_text(
        "def register(r):\n    r.counter(\"driftedSyncs\")\n")
    problems = metrics.check(root=str(pkg))
    assert len(problems) == 1
    assert "driftedSyncs" in problems[0] and "drift.py" in problems[0]


def test_hot_loop_gate_fails_on_a_walk_not_allowlisted(tmp_path):
    for rel in loops.SCANNED:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / rel, dst)
    assert loops.check(repo=str(tmp_path)) == []
    upkeep = tmp_path / "ratis_tpu_torch" / "server" / "upkeep.py"
    upkeep.write_text(upkeep.read_text() + (
        "\n\ndef drifted_sweep(server):\n"
        "    return [d.tick() for d in server.divisions.values()]\n"))
    problems = loops.check(repo=str(tmp_path))
    assert len(problems) == 1 and "drifted_sweep" in problems[0]


def test_hot_loop_gate_fails_on_a_stale_allowlist_entry():
    stale = {**loops.ALLOWLIST,
             ("ratis_tpu_torch/server/server.py", "RaftServer.gone"):
                 "no longer exists"}
    problems = loops.check(allowlist=stale)
    assert problems == ["stale allowlist entry (no matching loop): "
                        "ratis_tpu_torch/server/server.py (RaftServer.gone) "
                        "— remove it from check_hot_loops.ALLOWLIST"]


# -- profile_load ------------------------------------------------------------

def _profile_load(package: str, *args) -> tuple[dict, str]:
    proc = subprocess.run([sys.executable, "-m", f"{package}.tools."
                           f"profile_load", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), proc.stdout


@pytest.mark.parametrize("mode", ["batched", "scalar"])
def test_profile_load_reports_the_jax_tools_keys(mode):
    args = ["8", mode, "2", "sim", "3"]
    port, text = _profile_load("ratis_tpu_torch", *args, "--device", "cpu")
    jax, _ = _profile_load("ratis_tpu", *args)
    assert set(jax) <= set(port), set(jax) - set(port)
    assert port["acked"] == port["commits"] == jax["commits"] == 8 * 2
    assert port["write_failures"] == 0
    assert "Ordered by: cumulative time" in text
    assert "Ordered by: internal time" in text


# -- mix_fs ------------------------------------------------------------------

def test_mix_fs_holds_every_file_on_every_replica_in_each_leg(monkeypatch):
    from ratis_tpu_torch.tools import filestore_bench as fb
    monkeypatch.setitem(fb.LOADS, "mixed", {**fb.LOADS["mixed"],
                                            "streams": 4,
                                            "stream_bytes": 64 << 10})
    out = fb.run_mix_fs("cpu", 8, seed=3)
    assert list(out["legs"]) == [leg for leg, _, _ in fb.MIX_FS_LEGS]
    assert out["streams_failed"] == 0
    for leg, shared, delay_ms in fb.MIX_FS_LEGS:
        r = out["legs"][leg]
        assert r["fsync_delay_ms"] == delay_ms, leg
        assert r["streams_ok"] == 4 and r["streams_failed"] == 0, leg
        assert r["commits"] == 8 * 4, leg
        # every file on each of the 3 replicas: 4 writes a group and the
        # streams, held to their bytes
        assert r["replicas_checked"] == [8 * 3], leg
        assert r["files"] == 8 * 4 + 4, leg
        assert r["fsyncs"] > 0 and r["fsyncs_per_commit"] > 0, leg
        assert len(r["sync_time_s"]) == 3, leg
        assert all(t >= 0 for t in r["sync_time_s"]), leg
