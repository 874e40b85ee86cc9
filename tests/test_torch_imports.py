"""The port stands alone: it imports neither jax nor ``ratis_tpu``.

A fresh interpreter imports every module of ``ratis_tpu_torch``, runs a
tiny CPU cluster through the port's own harness over the simulated
transport and over TCP, the bench's kernel rung, the mesh engine's
``dryrun_multichip`` and the ``mesh_100k`` rung; nothing it loads may be
``jax`` or a ``ratis_tpu`` module (``ratis_tpu_torch`` itself shares the
prefix, so names are matched exactly).  On a machine without CUDA an
engine built without ``device=`` must raise rather than fall back to the
CPU.  A source scan backs this up for ``ratis_tpu_torch/`` and
``chip_smoke.py``.
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
names = [m.name for m in pkgutil.walk_packages(ratis_tpu_torch.__path__,
                                               "ratis_tpu_torch.")]
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
                 "parallel", "parallel.mesh"):
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
NOT_YET_PORTED = frozenset({
    "ratis_tpu_torch.metrics.flight",
    "ratis_tpu_torch.metrics.prometheus",
    "ratis_tpu_torch.metrics.timeseries",
    "ratis_tpu_torch.placement",
    "ratis_tpu_torch.server.upkeep",
})


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
