"""The port's cluster harness run on the JAX package, for the tests that
hold the port's clusters to the JAX package's on one script.

``jax_cluster_module()`` reads ``ratis_tpu_torch/tools/cluster.py`` as
text, renames the package to ``ratis_tpu`` (the inverse of what
``ratis_tpu_torch.tools.sync_copies`` does to the copied host modules)
and executes it as a module of its own: the same ``Cluster`` steps
(bring-up in waves, writes and their message order, the fold check,
``restart()``) over the JAX package's servers, clients and transports.
``jax_tools_module(name)`` does the same to a load module of the port's
``tools/`` that drives the cluster it is given (``snapshot_bench``).
Give its ``Cluster`` explicit ``properties`` (the port's
``cluster_properties`` as a JAX ``RaftProperties``: the JAX keys have no
engine device), and prewarm its engine at the small buckets a tiny
cluster uses (``prewarm_small``).
"""

import functools
import pathlib
import re
import sys
import types

from ratis_tpu.conf import RaftProperties as JaxProperties

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def jax_cluster_module() -> types.ModuleType:
    src = (ROOT / "ratis_tpu_torch" / "tools" / "cluster.py").read_text()
    mod = types.ModuleType("jax_mirror_cluster")
    mod.__file__ = "jax_mirror_cluster.py"
    exec(compile(re.sub(r"\bratis_tpu_torch\.", "ratis_tpu.", src),
                 mod.__file__, "exec"), mod.__dict__)
    sys.modules[mod.__name__] = mod
    return mod


@functools.lru_cache(maxsize=None)
def jax_tools_module(name: str) -> types.ModuleType:
    """The port's ``tools/<name>.py`` renamed the same way, its imports of
    the harness (``ratis_tpu_torch.tools.cluster``) pointed at
    ``jax_cluster_module()``: a load written against the cluster it is
    given runs its same steps on the JAX package's servers."""
    jax_cluster_module()
    src = (ROOT / "ratis_tpu_torch" / "tools" / f"{name}.py").read_text()
    src = src.replace("ratis_tpu_torch.tools.cluster", "jax_mirror_cluster")
    mod = types.ModuleType(f"jax_mirror_{name}")
    mod.__file__ = f"jax_mirror_{name}.py"
    exec(compile(re.sub(r"\bratis_tpu_torch\.", "ratis_tpu.", src),
                 mod.__file__, "exec"), mod.__dict__)
    return mod


def jax_properties(port_properties) -> JaxProperties:
    """The port harness's properties as a JAX ``RaftProperties``."""
    return JaxProperties(dict(port_properties.items()))


def prewarm_small(cluster) -> None:
    """Compile the JAX engine's kernels at the buckets of a tiny cluster
    (the default buckets take the CPU tens of seconds), once per
    process; the mirrored ``start()`` then skips its own prewarm."""
    cluster.servers[0].engine.prewarm(group_counts=[64],
                                      event_counts=[64, 256])
    cluster.prewarm_s = 0.0
