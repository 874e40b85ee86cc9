"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``benchmark/configs/<name>.json``) and a
traffic mix (``benchmark/traffic/<name>.json``); a configuration names
its deployment kind (``benchmark/deployments/<kind>.py``); a per-layer
metric is read by ``benchmark/metrics/<name>.py``, whose ``read(records,
config)`` returns its value or None.  Adding any of them adds a file and
an entry, and edits nothing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent


def load(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


# Every key of a configuration or a mix, and the values of those the harness
# implements but does not compute with: a file that names another value,
# or a key the harness does not know, is refused when it is loaded, so a
# file can never name a behaviour that the run would silently not have.
CONFIG_KEYS = {"name", "source", "baseline", "reduced", "assumed",
               "departures", "deployment", "servers", "groups",
               "peers_per_group", "state_machine", "transport", "log",
               "guarantees", "client", "properties"}
TRAFFIC_KEYS = {"name", "loop", "clients", "client_procs", "read_share",
                "read_kind", "read_groups", "write_groups", "warmup_s",
                "drain_s"}
CONFIG_VALUES = {"transport": {"TCP"}, "log": {"memory"}}
TRAFFIC_VALUES = {"loop": {"closed"}, "read_kind": {"linearizable_leader"},
                  "write_groups": {"owned_round_robin"}}
READ_DISTRIBUTIONS = {"zipf"}
# the property that sets each log, and what it leaves of durability
LOGS = {"memory": ("raft.server.log.use.memory", "true",
                   "none across the loss of a process (the memory log)")}


def _json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def _refuse(where: str, what: str) -> None:
    raise ValueError(f"{where}: {what}: the harness does not implement it")


def _known(where: str, data: dict, keys: set, values: dict) -> None:
    for key in sorted(set(data) - keys):
        _refuse(where, f"unknown key {key!r}")
    for key, allowed in values.items():
        if data.get(key) not in allowed:
            _refuse(where, f"{key} {data.get(key)!r} (it has "
                    f"{sorted(allowed)})")


def config(name: str) -> dict:
    from benchmark.reference import MACHINES
    from benchmark.reference.check import GUARANTEES
    c = _json("configs", name)
    where = f"benchmark/configs/{name}.json"
    _known(where, c, CONFIG_KEYS, CONFIG_VALUES)
    if c["state_machine"]["kind"] not in MACHINES:
        _refuse(where, f"state machine {c['state_machine']['kind']!r}")
    key, value, durability = LOGS[c["log"]]
    if c["properties"].get(key) != value:
        _refuse(where, f"log {c['log']!r} without {key}={value}")
    stated = dict(GUARANTEES, durability=durability)
    if c["guarantees"] != stated:
        _refuse(where, f"guarantees {c['guarantees']!r} (the check holds "
                f"a run to {stated!r})")
    if c["properties"].get("raft.server.read.option") != "LINEARIZABLE":
        _refuse(where, "reads other than linearizable ones")
    return c


def traffic(name: str) -> dict:
    t = _json("traffic", name)
    where = f"benchmark/traffic/{name}.json"
    _known(where, t, TRAFFIC_KEYS, TRAFFIC_VALUES)
    reads = t["read_groups"]
    if set(reads) != {"distribution", "s"} \
            or reads["distribution"] not in READ_DISTRIBUTIONS:
        _refuse(where, f"read_groups {reads!r}")
    return t


def deployment(kind: str):
    return importlib.import_module(f"benchmark.deployments.{kind}")


def reader(metric: str):
    """The module that reads per-layer metric ``metric``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, cell_name: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell_name`` reports: those without a ``workloads`` list, and those
    whose list names it."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]
