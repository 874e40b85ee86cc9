"""The readers of the host loops' metrics (the three waits of
``server.replicate``, socket flushes per commit, the collector's share,
the loops' lag) on the records of a tiny CPU run of the write cell: a
finite number from a traced run, None from an untraced one, whose
servers write no spans."""

import asyncio
import math

import pytest

from benchmark import manifest

SEED = 2 ** 31 + 53
READERS = ("replication.send_wait_p50_ms", "replication.quorum_p50_ms",
           "replication.apply_wait_p50_ms", "transport.flushes_per_commit",
           "runtime.gc_pause_share", "runtime.loop_lag_p99_ms")


def _records(trace: bool, workdir: str) -> tuple[dict, dict]:
    """(records, config) of one 2 s window of ``arith3x1024-write`` at 12
    groups and 6 clients, the spans files left in ``workdir``."""
    bench = manifest.load()
    cell = manifest.cell(bench, "arith3x1024-write")
    config = manifest.config(cell["config"])
    config["groups"] = 12
    config["properties"]["raft.tpu.engine.max-groups"] = "64"
    mix = manifest.traffic(cell["traffic"])
    mix.update(clients=6, client_procs=2, warmup_s=0.5, drain_s=20.0)
    records = asyncio.run(manifest.deployment(config["deployment"]).run(
        config, mix, SEED, 2.0, trace, "cpu", workdir))
    return records, config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {trace: _records(trace, str(tmp_path_factory.mktemp(str(trace))))
            for trace in (True, False)}


def test_every_reader_is_in_the_benchmark():
    names = {m["name"] for m in manifest.load()["per_layer"]}
    assert set(READERS) <= names


@pytest.mark.parametrize("name", READERS)
def test_a_traced_run_reads_a_finite_number(runs, name):
    records, config = runs[True]
    value = manifest.reader(name).read(records, config)
    assert value is not None and math.isfinite(value) and value >= 0


@pytest.mark.parametrize("name", READERS)
def test_an_untraced_run_reads_nothing(runs, name):
    records, config = runs[False]
    assert manifest.reader(name).read(records, config) is None

