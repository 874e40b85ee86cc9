"""FileStore writes and DataStream streams, the port against the JAX package.

- 3 servers x 8 groups over localhost TCP, ``FileStoreStateMachine``,
  every server serving the DataStream plane on a port it bound before any
  group existed: the same script on the port's harness
  (``tools/cluster.py``) and on the JAX package (the harness renamed,
  ``tests/jax_mirror.py``) — 2 FileStore writes per group through the
  log, then 4 streams of 256 KB of seeded bytes (64 KB packets, window
  16) over the copied ``server/datastream.py`` and
  ``transport/datastream.py``; ``check_files()`` holds every replica's
  files (names, sizes, bytes) to the acknowledged writes and streams, and
  the ``{path: size}`` maps must be equal between the packages;
- ``check_files()`` itself fails on a replica whose file lost or changed
  a byte, or that holds a file nobody acknowledged;
- ``cluster_properties(num_servers=5, transport="tcp")`` is the JAX
  bench's ``bench_properties`` key for key at 8, 1024 and 10240 groups
  (the 1 s / 2 s, 4 s / 8 s and 24 s / 48 s tiers), and with tracing on;
- the bench's ``mixed``, ``stream`` and ``filestore5`` rungs run tiny
  through ``--device cpu`` (5 x 8 groups, 2 streams of 128 KB) and report
  the JAX bench's keys.
"""

import asyncio
import io
import json
from contextlib import redirect_stdout

import pytest

from ratis_tpu.tools.bench_cluster import bench_properties
from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.tools import bench, filestore_bench
from ratis_tpu_torch.tools.cluster import (Cluster, cluster_properties,
                                           filestore_message, stream_payload)

from tests.jax_mirror import jax_cluster_module, jax_properties, prewarm_small

GROUPS = 8
WRITES = 2
STREAMS = 4
STREAM_BYTES = 256 << 10
SEED = 11
TIMEOUT = 60.0


async def _filestore_script(cluster) -> dict:
    """Start, write, stream, check every replica's files; returns the
    {path: size} maps (in group order), the streams' replies and the
    DataStream addresses the groups advertise beside those bound."""
    try:
        await cluster.start(timeout=TIMEOUT)
        stats = await cluster.write_all(WRITES)
        assert stats["commits"] == GROUPS * WRITES
        replies = await asyncio.gather(*(
            cluster.stream_file(cluster.groups[i % GROUPS], f"s{i}.bin",
                                stream_payload(SEED, i, STREAM_BYTES),
                                packet=64 << 10, window=16)
            for i in range(STREAMS)))
        files = await cluster.check_files(TIMEOUT)
        return {"files": files, "ok": [r.success for r in replies],
                "advertised": sorted({p.datastream_address
                                      for g in cluster.groups
                                      for p in g.peers}),
                "bound": sorted(cluster.datastream_address(s)
                                for s in cluster.servers)}
    finally:
        await cluster.close()


def _props():
    return cluster_properties(GROUPS, 3, "cpu", "tcp")


def test_filestore_cluster_with_streams_matches_jax():
    port = Cluster(GROUPS, device="cpu", transport="tcp", sm="filestore",
                   datastream=True, properties=_props())
    jmod = jax_cluster_module()
    jax = jmod.Cluster(GROUPS, device="cpu", transport="tcp",
                       sm="filestore", datastream=True,
                       properties=jax_properties(_props()))
    prewarm_small(jax)
    runs = {"port": asyncio.run(_filestore_script(port)),
            "jax": asyncio.run(_filestore_script(jax))}
    want = {i: {**{filestore_message(w * GROUPS + i)[0]: 128
                   for w in range(WRITES)},
                **{f"s{k}.bin": STREAM_BYTES
                   for k in range(STREAMS) if k % GROUPS == i}}
            for i in range(GROUPS)}
    for name, run in runs.items():
        assert run["ok"] == [True] * STREAMS, name
        assert run["files"] == want, name
        # every group names the DataStream ports the servers bound
        assert run["advertised"] == run["bound"], name
        assert all(int(a.rsplit(":", 1)[1]) > 0 for a in run["bound"]), name
    assert runs["port"]["files"] == runs["jax"]["files"]


def test_stream_payload_is_seeded_per_stream():
    a = stream_payload(3, 0, 4096)
    assert a == stream_payload(3, 0, 4096) and len(a) == 4096
    assert a != stream_payload(3, 1, 4096) and a != stream_payload(4, 0, 4096)
    # the JAX bench's constant byte would hide a packet out of order
    assert len(set(a[i:i + 64] for i in range(0, 4096, 64))) == 64


@pytest.mark.parametrize("fault", ["byte", "extra", "missing"])
def test_check_files_fails_on_a_replica_that_differs(fault):
    async def run():
        c = Cluster(4, device="cpu", transport="sim", sm="filestore",
                    datastream=True, properties=cluster_properties(
                        4, 3, "cpu", "sim"))
        try:
            await c.start(timeout=TIMEOUT)
            await c.write_all(1)
            reply = await c.stream_file(c.groups[0], "s.bin",
                                        stream_payload(0, 0, 1 << 16),
                                        packet=8 << 10, window=4)
            assert reply.success
            await c.check_files(TIMEOUT)
            sm = c.servers[2].divisions[c.groups[0].group_id].state_machine
            if fault == "byte":
                path = sm.resolve("s.bin")
                data = bytearray(path.read_bytes())
                data[12345] ^= 1
                path.write_bytes(bytes(data))
            elif fault == "extra":
                sm.files["ghost"] = 1
            else:
                del sm.files["s.bin"]
            with pytest.raises(AssertionError, match=str(c.servers[2].peer_id)):
                await c.check_files(TIMEOUT)
        finally:
            await c.close()
    asyncio.run(run())


# channel counts in each of the 5-peer tiers: 32, 4096 and 40960
@pytest.mark.parametrize("groups,tier", [(8, ("1s", "2s")),
                                         (1024, ("4s", "8s")),
                                         (10_240, ("24s", "48s"))])
def test_five_peer_properties_are_the_jax_bench_properties(groups, tier):
    port = dict(cluster_properties(groups, 5, "cuda", "tcp").items())
    jax = dict(bench_properties(True, groups, num_servers=5,
                                transport="tcp").items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    assert (port["raft.server.rpc.timeout.min"],
            port["raft.server.rpc.timeout.max"]) == tier


def test_traced_properties_are_the_jax_bench_properties():
    port = dict(cluster_properties(1024, 3, "cuda", "sim",
                                   trace=True).items())
    jax = dict(bench_properties(True, 1024, trace=True,
                                trace_sample=16).items())
    assert port.pop(RaftServerConfigKeys.Engine.DEVICE_KEY) == "cuda"
    assert port == jax
    assert port["raft.tpu.trace.enabled"] == "true"


# the keys of bench_cluster.run_mixed_bench's and
# run_stream_throughput_bench's results
MIXED_KEYS = {"commits", "commits_per_sec", "p50_ms", "p99_ms", "groups",
              "mode", "transport", "peers", "streams_ok", "streams_failed",
              "stream_failures", "stream_mb_per_s"}
STREAM_KEYS = {"streams", "stream_mb", "packet_kb", "streams_ok",
               "streams_failed", "stream_failures", "stream_mb_per_s",
               "elapsed_s"}
TINY = {"mixed": {"groups": 8, "writes": 2, "streams": 2,
                  "stream_bytes": 128 << 10},
        "stream": {"streams": 2, "stream_bytes": 128 << 10,
                   "packet": 32 << 10},
        "filestore5": {"groups": 8, "streams": 2, "stream_bytes": 128 << 10}}


@pytest.mark.parametrize("rung", ["mixed", "stream", "filestore5"])
def test_filestore_rungs_tiny_on_cpu(monkeypatch, rung):
    loads = {k: dict(v) for k, v in filestore_bench.LOADS.items()}
    loads[rung].update(TINY[rung])
    monkeypatch.setattr(filestore_bench, "LOADS", loads)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(["--device", "cpu", "--rungs", rung, "--seed", "5"])
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])[rung]
    load = loads[rung]
    assert set(MIXED_KEYS if rung != "stream" else STREAM_KEYS) <= set(res)
    assert (res["streams_ok"], res["streams_failed"],
            res["stream_failures"]) == (load["streams"], 0, [])
    assert res["stream_mb_per_s"] > 0
    if rung == "stream":
        assert res["replicas_checked"] == 4 * 3
        assert res["files"] == load["streams"]
        return
    servers = load["servers"]
    assert (res["peers"], res["groups"], res["transport"]) == \
        (servers, 8, load["transport"])
    assert res["commits"] == 8 * load["writes"]
    # every write and stream on every replica
    assert res["replicas_checked"] == [8 * servers]
    assert res["files"] == 8 * load["writes"] + load["streams"]
    assert res["engine_device"] == "cpu"
