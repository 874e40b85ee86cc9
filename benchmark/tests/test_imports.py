"""Nothing under ``benchmark/`` imports JAX, its libraries or the JAX
package (top-level names compared whole: ``ratis_tpu_torch`` is not
``ratis_tpu``), and the reference imports nothing of the program.  What
the run's processes load is checked by ``test_cell_cpu.py``."""

import ast
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "ratis_tpu"}


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & BANNED, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "ratis_tpu_torch" not in _imports(f), f
