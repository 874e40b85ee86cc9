"""``BENCHMARK.json`` against the contract's shape, and every file it
names found by name."""

import json
import re

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == TOP_KEYS
    assert len(json.dumps(bench)) <= 64 << 10
    assert 1 <= bench["run_seconds"] <= 51
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in
                                               bench["command"])
    names = []
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        keys = E2E_KEYS if "bound" in m else LAYER_KEYS
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in bench["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_every_cell_finds_its_files_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        c = configs[w["config"]]
        config = manifest.config(w["config"])
        assert c["file"] == f"benchmark/configs/{w['config']}.json"
        assert config["name"] == w["config"] and config["reduced"] == \
            c["reduced"]
        assert manifest.traffic(w["traffic"])["name"] == w["traffic"]
        assert manifest.deployment(config["deployment"]).run
        pairs.add((w["config"], w["traffic"]))
        e2e = {m["name"] for m in manifest.metrics_of(bench, w["name"],
                                                      "end_to_end")}
        layer = manifest.metrics_of(bench, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e
            assert callable(manifest.reader(m["name"]).read)
    assert len(pairs) == len(bench["workloads"])


def test_per_layer_metrics_name_known_layers_and_moves(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells


def _patched(monkeypatch, kind: str, name: str, change) -> None:
    """``manifest._json`` with ``change`` applied to one file's data."""
    real = manifest._json

    def fake(k, n):
        data = real(k, n)
        if (k, n) == (kind, name):
            change(data)
        return data

    monkeypatch.setattr(manifest, "_json", fake)


@pytest.mark.parametrize("key,value", [
    ("loop", "open"), ("read_kind", "stale"), ("write_groups", "any"),
    ("read_groups", {"distribution": "uniform"}), ("think_ms", 5)])
def test_a_mix_the_harness_does_not_implement_fails_to_load(monkeypatch,
                                                            key, value):
    _patched(monkeypatch, "traffic", "read95",
             lambda t: t.__setitem__(key, value))
    with pytest.raises(ValueError, match="does not implement"):
        manifest.traffic("read95")


@pytest.mark.parametrize("change", [
    lambda c: c.__setitem__("transport", "GRPC"),
    lambda c: c.__setitem__("log", "segmented"),
    lambda c: c["properties"].__setitem__("raft.server.log.use.memory",
                                          "false"),
    lambda c: c["properties"].__setitem__("raft.server.read.option",
                                          "DEFAULT"),
    lambda c: c["guarantees"].__setitem__("read", "stale reads"),
    lambda c: c["state_machine"].__setitem__("kind", "filestore"),
    lambda c: c.__setitem__("replicas_acked", 1)])
def test_a_config_the_harness_does_not_implement_fails_to_load(monkeypatch,
                                                               change):
    _patched(monkeypatch, "configs", "arith3x1024", change)
    with pytest.raises(ValueError, match="does not implement"):
        manifest.config("arith3x1024")
