"""The port's host modules are the JAX package's, renamed.

Every verbatim copy must equal a fresh rewrite of its ``ratis_tpu/`` source
(``ratis_tpu.`` -> ``ratis_tpu_torch.``) byte for byte, so a host fix made
in the JAX package reaches the port only through
``python -m ratis_tpu_torch.tools.sync_copies``.  The only other modules of
the port are the changed copies (device code, the device key, the package
docstring) and the port's own new modules.
"""

import pathlib

import pytest

from ratis_tpu_torch.tools import sync_copies

# the port's own modules: kernels' loader, bench entry point, harness,
# FileStore, upkeep, placement, read and snapshot loads, the
# multi-process deployment and its plan recorder, kernel inputs, main-path
# profile, fast-tick timing, copy script
NEW = ("ops/_build.py", "tools/__init__.py", "tools/bench.py",
       "tools/cases.py", "tools/churn_probe.py", "tools/cluster.py",
       "tools/fast_tick_timing.py", "tools/filestore_bench.py",
       "tools/multiproc_bench.py", "tools/plan_recorder.py",
       "tools/placement_bench.py", "tools/profile_main_path.py",
       "tools/read_bench.py", "tools/snapshot_bench.py",
       "tools/sync_copies.py", "tools/upkeep_bench.py")


@pytest.mark.parametrize("rel", sync_copies.VERBATIM)
def test_verbatim_copy_is_byte_identical(rel):
    src = (sync_copies.SRC / rel).read_text()
    dst = (sync_copies.DST / rel).read_text()
    assert dst == sync_copies.rewrite(src), \
        f"{rel} drifted: run python -m ratis_tpu_torch.tools.sync_copies"


@pytest.mark.parametrize("rel", sync_copies.CHANGED)
def test_changed_copy_really_changes_its_source(rel):
    src = (sync_copies.SRC / rel).read_text()
    dst = (sync_copies.DST / rel).read_text()
    assert dst != sync_copies.rewrite(src)


def test_every_port_module_is_accounted_for():
    root = sync_copies.DST
    found = {p.relative_to(root).as_posix() for p in root.rglob("*.py")}
    listed = set(sync_copies.VERBATIM) | set(sync_copies.CHANGED) | set(NEW)
    assert found == listed
    assert not set(sync_copies.VERBATIM) & set(sync_copies.CHANGED)


def test_copy_script_check_mode_is_clean(capsys):
    assert sync_copies.main(["--check"]) == 0
    assert capsys.readouterr().out == ""
