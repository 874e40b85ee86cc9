"""The port stands alone: it imports neither jax nor ``ratis_tpu``.

A fresh interpreter imports every module of ``ratis_tpu_torch``, runs a
tiny CPU cluster through the port's own harness over the simulated
transport and over TCP, the bench's kernel rung, the mesh engine's
``dryrun_multichip`` and the ``mesh_100k`` rung; nothing it loads may be
``jax`` or a ``ratis_tpu`` module (``ratis_tpu_torch`` itself shares the
prefix, so names are matched exactly).  On a machine without CUDA an
engine built without ``device=`` must raise rather than fall back to the
CPU.  A source scan backs this up for ``ratis_tpu_torch/`` and
``chip_smoke.py``.  (The multi-process harness's server and client
processes report what they loaded: ``tests/test_torch_multiproc.py``.)
"""

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import asyncio, importlib, json, pkgutil, sys
before = set(sys.modules)
import ratis_tpu_torch
# a package's __main__ runs its command line when imported
names = [m.name for m in pkgutil.walk_packages(ratis_tpu_torch.__path__,
                                               "ratis_tpu_torch.")
         if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
from ratis_tpu_torch.tools.cluster import Cluster

async def run(transport):
    c = Cluster(4, device="cpu", transport=transport)
    try:
        await c.start(timeout=60)
        stats = await c.write_all(1)
        return stats["commits"]
    finally:
        await c.close()

commits = [asyncio.run(run(t)) for t in ("sim", "tcp")]
from ratis_tpu_torch.tools import bench
bench.kernel_rung("cpu", 16, 8, 8, iters=1, scalar_groups=4)
bench.dryrun_multichip(8, "cpu")
bench.mesh_100k_rung("cpu", 64, 8, 16, iters=1, trials=1)
import torch
from ratis_tpu_torch.engine.engine import QuorumEngine
raised = None
if not torch.cuda.is_available():
    try:
        QuorumEngine()
        raised = False
    except RuntimeError:
        raised = True
new = sorted(set(sys.modules) - before)
bad = [m for m in new if m in ("jax", "ratis_tpu")
       or m.startswith(("jax.", "ratis_tpu."))]
print(json.dumps({"modules": names, "commits": commits, "bad": bad,
                  "raised": raised}))
"""


def test_port_loads_no_jax_and_no_ratis_tpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["commits"] == [4, 4]
    for name in ("server.server", "ops.quorum", "transport.tcp",
                 "transport.coalesce", "util.gcdiscipline", "tools.bench",
                 "parallel", "parallel.mesh", "models.filestore",
                 "metrics.timeseries", "metrics.flight", "metrics.prometheus",
                 "metrics.aggregate", "trace.export",
                 "tools.filestore_bench", "server.upkeep", "placement",
                 "placement.controller", "chaos.cluster", "chaos.campaign",
                 "tools.chaos_replay", "tools.upkeep_bench",
                 "tools.placement_bench", "tools.read_bench",
                 "transport.grpc", "shell", "shell.cli", "tools.parse_log",
                 "tools.loadgen", "tools.membership_console",
                 "tools.multiproc_bench", "tools.plan_recorder"):
        assert f"ratis_tpu_torch.{name}" in res["modules"], name
    assert res["raised"] in (True, None)  # None: this machine has CUDA


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|ratis_tpu)(?:\.|\s|$)",
                     re.M)


def test_port_sources_import_no_jax_and_no_ratis_tpu():
    files = sorted((ROOT / "ratis_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 60
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT.finditer(f.read_text())]
    assert offenders == []


# modules the port names (lazily, behind keys that are off by default) but
# has not ported yet; ROADMAP.md Queue 1 lists them as the next slices
NOT_YET_PORTED = frozenset()


def _module_path(name: str):
    """The file of module ``name`` under the repo, or None."""
    base = ROOT.joinpath(*name.split("."))
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _top_level_names(path) -> set:
    """Names a module defines or imports at its top level."""
    import ast
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
    return names


def _named_modules() -> dict:
    """Every ``ratis_tpu_torch`` module an import statement of the port or
    of ``chip_smoke.py`` names, lazy imports included, with one file that
    names it: ``import a.b``, ``from a.b import c`` (``a.b``), and ``from
    a import b`` where ``b`` is no name defined in package ``a`` (then
    ``a.b`` is a module)."""
    import ast
    files = sorted((ROOT / "ratis_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    named = {}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                mods = [node.module]
                pkg = _module_path(node.module)
                if pkg is not None and pkg.name == "__init__.py":
                    defined = _top_level_names(pkg)
                    mods += [f"{node.module}.{a.name}" for a in node.names
                             if a.name not in defined]
            else:
                continue
            for m in mods:
                if m == "ratis_tpu_torch" or \
                        m.startswith("ratis_tpu_torch."):
                    named.setdefault(m, str(f.relative_to(ROOT)))
    return named


def test_every_module_the_port_names_exists_or_is_listed():
    named = _named_modules()
    missing = {m: f for m, f in named.items() if _module_path(m) is None}
    assert set(missing) == NOT_YET_PORTED, missing
    # the modules the durable log and the admin plane need are in
    for m in ("ratis_tpu_torch.server.storage", "ratis_tpu_torch.server.admin",
              "ratis_tpu_torch.server.log.segmented",
              "ratis_tpu_torch.server.log.shared",
              "ratis_tpu_torch.models.arithmetic"):
        assert m in named and _module_path(m) is not None, m


def test_not_yet_ported_list_is_mirrored_in_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for m in NOT_YET_PORTED:
        rel = m.removeprefix("ratis_tpu_torch.").replace(".", "/")
        assert f"`{rel}" in roadmap, rel


# ``ratis_tpu/tools/bench_cluster.py`` is not copied whole: its harness and
# each of its loads are ported into the port's own tools/ modules
BENCH_CLUSTER_PORTS = {
    "bench_properties": "tools.cluster.cluster_properties",
    "BenchCluster": "tools.cluster.Cluster",
    "run_bench": "tools.bench.e2e_rung",
    "run_multiproc_bench": "tools.multiproc_bench.run_multiproc_bench",
    "run_upkeep_bench": "tools.upkeep_bench.upkeep_rung",
    "run_churn_bench": "tools.bench.churn_rung",
    "run_mixed_bench": "tools.filestore_bench.run_mixed_bench",
    "run_read_write_bench": "tools.read_bench.readmix_rung",
    "run_snapshot_catchup_bench": "tools.snapshot_bench.snapcatch_rung",
    "run_stream_throughput_bench":
        "tools.filestore_bench.run_stream_throughput_bench",
    "run_zipf_fleet_bench": "tools.read_bench.zipf_rung",
    "run_placement_bench": "tools.placement_bench.placement_rung",
}
# each leg of the JAX bench ladder (``bench.py`` ``main()``, by the name it
# is stored under) and the port's rung of it (``tools/bench.py`` RUNGS)
BENCH_LADDER = {
    "ladder[1]": "sim_1", "ladder[64]": "sim_64", "ladder[1024]": "sim_1024",
    "ladder[10240]": "sim_10240", "mesh_trials": "mesh",
    "peer5_mp": "peer5_mp", "peer5_sp": "peer5_sp",
    "peer5_scalar": "peer5_scalar", "peer7": "peer7", "headline": "e2e",
    "scalar": "scalar", "win_sweep[1]": "win1", "win_sweep[4]": "win4",
    "win_sweep[16]": "win16", "tel_on": "telemetry", "tel_off": "e2e",
    "sparse_hib": "sparse_hib", "sparse_plain": "sparse_plain",
    "traced": "traced", "churn": "churn", "mixed": "mixed",
    "mixed_fs": "mix_fs", "stream": "stream", "filestore5": "filestore5",
    "readmix": "readmix", "snapcatch": "snapcatch", "zipf": "zipf",
    "placement": "placement", "upk_64": "upk_64", "upk_1024": "upk_1024",
    "upk_tick": "upkeep", "chaos": "chaos", "kernel": "kernel",
    "kernel_100k": "kernel_100k", "mesh100k": "mesh_100k",
    # the 1024-group sim rung with the engine on the chip: every port rung
    # runs on the card
    "tpu_e2e": "sim_1024",
}
# the gRPC legs: the card host has no grpcio (gRPC is held against the JAX
# package on the CPU, tests/test_torch_grpc.py)
GRPC_LEGS = frozenset({"peer5_grpc", "peer5_grpc_scalar", "grpc_b",
                       "grpc_s_1024", "grpc_s_256"})


def test_every_jax_module_has_its_port():
    """Every module of ``ratis_tpu/`` has a file at the same path in
    ``ratis_tpu_torch/``, but ``tools/bench_cluster.py``, whose every
    ``run_*`` load (and its harness) names its port function."""
    import ast
    import importlib
    jax_root, port_root = ROOT / "ratis_tpu", ROOT / "ratis_tpu_torch"
    missing = sorted(str(f.relative_to(jax_root))
                     for f in jax_root.rglob("*.py")
                     if "__pycache__" not in f.parts
                     and not (port_root / f.relative_to(jax_root)).exists())
    assert missing == ["tools/bench_cluster.py"]
    tree = ast.parse((jax_root / "tools" / "bench_cluster.py").read_text())
    loads = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and n.name.startswith("run_")}
    assert loads | {"bench_properties", "BenchCluster"} \
        == set(BENCH_CLUSTER_PORTS)
    for name, target in BENCH_CLUSTER_PORTS.items():
        module, attr = target.rsplit(".", 1)
        assert hasattr(importlib.import_module(f"ratis_tpu_torch.{module}"),
                       attr), (name, target)


def _ladder_legs() -> set:
    """The names ``bench.py``'s ``main()`` stores a ladder leg's result
    under (a call of ``_run_child`` or ``_run_trials``; the sim ladder's
    and the window sweep's legs by their loops' stores)."""
    import ast
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    legs = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and getattr(node.value.func, "id", "") in ("_run_child",
                                                           "_run_trials"):
            for t in node.targets:
                legs.add(t.id if isinstance(t, ast.Name)
                         else ast.unparse(t.value))
    return legs


def test_every_leg_of_the_jax_bench_ladder_has_its_port_rung():
    from ratis_tpu_torch.tools.bench import RUNGS
    legs = _ladder_legs()
    # the window sweep's loop stores each child's result in ``r``
    assert legs - {"r"} == ({k.split("[")[0] for k in BENCH_LADDER}
                            - {"win_sweep"}) | GRPC_LEGS
    assert set(BENCH_LADDER.values()) <= set(RUNGS)
    # every port rung is a leg of the JAX ladder but ``durable`` and
    # ``shared``: the headline on the logs of the JAX ladder's durable
    # mixed pair (``mixed_fs``), with the arithmetic state machine
    assert set(RUNGS) == set(BENCH_LADDER.values()) | {"shared", "durable"}
