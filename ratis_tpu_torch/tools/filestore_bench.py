"""The JAX bench's FileStore loads on the port: FileStore writes through
the log and file streams over the DataStream plane.

``run_mixed_bench`` is ``ratis_tpu/tools/bench_cluster.py``'s
``run_mixed_bench`` and ``run_stream_throughput_bench`` its namesake, on
the port's ``Cluster`` (``tools/cluster.py``, ``sm="filestore"``,
``datastream=True``), with the same loads and the same result keys. Two
things differ from the JAX harness:

- each stream's bytes come from ``seed`` (``cluster.stream_payload``, a
  numpy pattern of its own per stream, made before the timed window), not
  one constant byte, so a packet lost or landed out of order shows; the
  sizes, packets and windows are the JAX bench's;
- every acknowledged write and stream is held to ``check_files()`` on
  every replica (names, sizes and bytes), where the JAX harness only
  counts them.

Leaders come from elections in waves, as in the port's other rungs (the
JAX harness appoints them).  A stream that fails is counted and named in
``stream_failures``, as the JAX bench does; the callers fail on it
(``tools/bench.py`` exits 1, ``chip_smoke.py`` raises).
"""

from __future__ import annotations

import asyncio
import sys
import time

import torch

# the JAX bench's stream packets in the mixed loads (run_mixed_bench's
# 64 << 10), and how many streams run at once there
MIXED_PACKET = 64 << 10
MIXED_PARALLEL = 8
# the bench's FileStore rungs (bench.py's children): servers, raft
# transport, groups, writes per group, streams, bytes and window a stream
# (the stream rung: 1 MB packets, all streams at once, max(streams, 4)
# groups)
LOADS = {
    "mixed": {"servers": 3, "transport": "sim", "groups": 1024,
              "writes": 4, "streams": 32, "stream_bytes": 256 << 10,
              "window": 16},
    "stream": {"streams": 4, "stream_bytes": 32 << 20, "packet": 1 << 20,
               "window": 32},
    "filestore5": {"servers": 5, "transport": "tcp", "groups": 10_240,
                   "writes": 1, "streams": 16, "stream_bytes": 4 << 20,
                   "window": 32},
}


# the durable mixed pair (bench.py:369-414, child_mixed_durable): the
# mixed rung on durable logs, per group and on the shared plane, then both
# again under a modeled disk whose fsync takes this many ms
MIX_FS_LEGS = (("pergroup", False, 0.0), ("shared", True, 0.0),
               ("pergroup_5ms", False, 5.0), ("shared_5ms", True, 5.0))


def filestore_cluster(device, groups: int, servers: int = 3,
                      transport: str = "sim", properties=None):
    """A FileStore cluster: ``servers`` servers x ``groups`` groups over
    ``transport`` (its ``properties`` when given), every server serving
    the DataStream plane on localhost TCP, its kernels built and launched
    once, not yet started."""
    from ratis_tpu_torch.tools.bench import _device
    from ratis_tpu_torch.tools.cluster import Cluster
    cluster = Cluster(groups, servers, device=str(_device(device)),
                      transport=transport, sm="filestore", datastream=True,
                      properties=properties)
    cluster.prewarm()
    return cluster


def payloads(streams: int, stream_bytes: int, seed: int) -> list[bytes]:
    """The seeded bytes of ``streams`` streams (``cluster.stream_payload``),
    made before a timed window."""
    from ratis_tpu_torch.tools.cluster import stream_payload
    return [stream_payload(seed, i, stream_bytes) for i in range(streams)]


async def run_streams(cluster, data: list[bytes], packet: int, window: int,
                      parallel: int = 0, prefix: str = "stream") -> dict:
    """One file stream of each of ``data`` into the groups in turn (stream
    i into group i mod G, file ``{prefix}-{i}.bin``), ``packet``-byte
    packets, ``window`` unacknowledged, ``parallel`` at a time (0: all at
    once).  Returns ok / failed counts, the failures' names, the bytes
    acknowledged and the seconds the streams took."""
    stats = {"ok": 0, "failed": 0, "bytes": 0, "failures": []}
    sem = asyncio.Semaphore(parallel or len(data) or 1)

    async def one(i: int) -> None:
        g = cluster.groups[i % len(cluster.groups)]
        async with sem:
            try:
                reply = await cluster.stream_file(
                    g, f"{prefix}-{i}.bin", data[i], packet, window)
            except Exception as e:
                stats["failed"] += 1
                stats["failures"].append(type(e).__name__)
                print(f"bench: stream {i} FAILED: {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                return
        if reply.success:
            stats["ok"] += 1
            stats["bytes"] += len(data[i])
        else:
            stats["failed"] += 1
            exc = reply.exception
            stats["failures"].append(type(exc).__name__ if exc
                                     else "no-exception")
            print(f"bench: stream {i} REJECTED: {exc}", file=sys.stderr,
                  flush=True)

    t0 = time.monotonic()
    await asyncio.gather(*(one(i) for i in range(len(data))))
    stats["elapsed_s"] = time.monotonic() - t0
    return stats


def _stream_keys(stats: dict) -> dict:
    return {"streams_ok": stats["ok"], "streams_failed": stats["failed"],
            "stream_failures": stats["failures"],
            "stream_mb_per_s": stats["bytes"]
            / max(stats["elapsed_s"], 1e-9) / (1 << 20),
            "stream_elapsed_s": stats["elapsed_s"]}


async def run_mixed_bench(cluster, writes_per_group: int, streams: int,
                          stream_bytes: int, concurrency: int = 128,
                          stream_window: int = 16, warmup: int = 0,
                          overlap: bool = True, seed: int = 0,
                          fsync_delay_ms: float = 0.0) -> dict:
    """``run_mixed_bench`` on a ``filestore_cluster``: bring it up, warm up
    with ``warmup`` writes per group and hold every replica's files to
    them (so each replica has applied them, and made its store's
    directory, before the measured window), then ``writes_per_group``
    128-byte
    file writes per group through the log at ``concurrency`` in flight
    while ``streams`` DataStream file streams of ``stream_bytes`` (64 KB
    packets, ``stream_window`` unacknowledged, 8 at a time) run into the
    groups; every replica's files held to the acknowledged writes and
    streams; close.  ``overlap=False`` runs the streams after the writes
    and checks the files after each.  ``fsync_delay_ms`` > 0 models a disk
    whose fsync takes that long over the measured window, as the JAX
    bench's ``run_mixed_bench`` does: the ``LOG_SYNC`` injection
    (``util/injection.py``) makes every drain sweep of a log worker wait
    that many ms for each file it syncs before its real I/O.  Returns the
    writes' commits/s and p50/p99, the stream keys, on a durable log
    ``fsyncs_per_commit`` and each server's fsync seconds in the window
    and their share of it (``cluster.sync_keys``; the modeled wait is not
    among them), and the replicas checked (per check)."""
    from ratis_tpu_torch.tools.bench import (_check_engines, _dispatch_summary,
                                             _fresh_dispatch_timers)
    from ratis_tpu_torch.tools.cluster import (log_fsyncs, log_sync_seconds,
                                               sync_keys)
    from ratis_tpu_torch.util import injection
    dev = torch.device(cluster.device)
    servers = len(cluster.servers)
    try:
        await _start(cluster)
        timeouts = [cluster.election_timeouts()]
        acked, checked = 0, []
        if warmup:
            acked = (await cluster.write_all(warmup, concurrency))["commits"]
            checked.append(len(await cluster.check_files(timeout=300))
                           * servers)
        timeouts.append(cluster.election_timeouts())
        engines = [s.engine for s in cluster.servers]
        saved = _fresh_dispatch_timers(engines)
        data = payloads(streams, stream_bytes, seed)
        if fsync_delay_ms > 0:
            delay_s = fsync_delay_ms / 1000.0

            async def disk_model(_local_id, _remote_id, *args):
                await asyncio.sleep(delay_s * (args[0] if args else 1))
            injection.put(injection.LOG_SYNC, disk_model)
        fsyncs, synced = log_fsyncs(), log_sync_seconds(cluster.servers)
        try:
            if overlap:
                stats, sstats = await asyncio.gather(
                    cluster.write_all(writes_per_group, concurrency),
                    run_streams(cluster, data, MIXED_PACKET, stream_window,
                                MIXED_PARALLEL))
            else:
                stats = await cluster.write_all(writes_per_group,
                                                concurrency)
        finally:
            if fsync_delay_ms > 0:
                injection.remove(injection.LOG_SYNC)
        fsyncs = log_fsyncs() - fsyncs
        sync = sync_keys(synced, log_sync_seconds(cluster.servers),
                         stats["elapsed_s"])
        timeouts.append(cluster.election_timeouts())
        dispatch = _dispatch_summary(engines, saved, stats["elapsed_s"])
        acked += stats["commits"]
        if not overlap:
            checked.append(len(await cluster.check_files(timeout=300))
                           * servers)
            sstats = await run_streams(cluster, data, MIXED_PACKET,
                                       stream_window, MIXED_PARALLEL)
        files = await cluster.check_files(timeout=300)
        checked.append(len(files) * servers)
        _check_engines(engines, dev)
        out = {"groups": cluster.num_groups, "peers": servers,
               "mode": "batched", "transport": cluster.transport,
               "writes": writes_per_group, "warmup": warmup,
               "concurrency": concurrency, "streams": streams,
               "stream_bytes": stream_bytes, "stream_window": stream_window,
               "overlap": overlap, "seed": seed,
               "fsync_delay_ms": fsync_delay_ms,
               "commits": stats["commits"], "acked": acked,
               "elapsed_s": stats["elapsed_s"],
               "commits_per_sec": stats["commits_per_sec"],
               "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
               **_stream_keys(sstats),
               "files": sum(len(f) for f in files.values()),
               "replicas_checked": checked,
               "election_convergence_s": cluster.bring_up_s,
               "election_timeouts": [timeouts[0],
                                     timeouts[1] - timeouts[0],
                                     timeouts[2] - timeouts[1]],
               "prewarm_s": cluster.prewarm_s,
               "dispatch": dispatch,
               "ledger_samples": [e.ledger.samples.count for e in engines],
               "engine_device": str(engines[0].device)}
        if fsyncs:
            # per replica, as the JAX bench counts them
            out["fsyncs"] = fsyncs
            out["fsyncs_per_commit"] = fsyncs / max(
                1, stats["commits"] * servers)
            out.update(sync)
        return out
    finally:
        await cluster.close()


async def run_stream_throughput_bench(cluster, streams: int,
                                      stream_bytes: int,
                                      packet: int = 1 << 20,
                                      window: int = 32,
                                      seed: int = 0) -> dict:
    """``run_stream_throughput_bench`` on a ``filestore_cluster`` of
    ``max(streams, 4)`` groups: bring it up, then ``streams`` streams of
    ``stream_bytes`` at once in ``packet``-byte packets, ``window``
    unacknowledged; every replica's files held to the acknowledged
    streams; close."""
    data = payloads(streams, stream_bytes, seed)
    try:
        await _start(cluster)
        stats = await run_streams(cluster, data, packet, window, 0, "bulk")
        files = await cluster.check_files(timeout=300)
        return {"streams": streams, "stream_mb": stream_bytes / (1 << 20),
                "packet_kb": packet / 1024, "window": window, "seed": seed,
                "peers": len(cluster.servers), **_stream_keys(stats),
                "elapsed_s": stats["elapsed_s"],
                "files": sum(len(f) for f in files.values()),
                "replicas_checked": len(files) * len(cluster.servers),
                "election_convergence_s": cluster.bring_up_s,
                "engine_device": str(cluster.servers[0].engine.device)}
    finally:
        await cluster.close()


async def _start(cluster) -> None:
    from ratis_tpu_torch.tools.cluster import bring_up_wave, sealed
    await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                        timeout=600))


def run_rung(rung: str, device, groups: int = None, seed: int = 0) -> dict:
    """One FileStore rung of ``LOADS`` on a fresh cluster (``groups``
    None: the rung's own; the stream rung's cluster is always
    ``max(streams, 4)`` groups)."""
    load = LOADS[rung]
    if rung == "stream":
        return asyncio.run(run_stream_throughput_bench(
            filestore_cluster(device, max(load["streams"], 4)),
            load["streams"], load["stream_bytes"], load["packet"],
            load["window"], seed))
    cluster = filestore_cluster(device, groups or load["groups"],
                                load["servers"], load["transport"])
    return asyncio.run(run_mixed_bench(
        cluster, load["writes"], load["streams"], load["stream_bytes"],
        stream_window=load["window"], seed=seed))


def run_mix_fs(device, groups: int = None, seed: int = 0) -> dict:
    """The ``mix_fs`` rung (``child_mixed_durable``): the ``mixed`` load
    (3 x ``groups`` (1024) FileStore groups over the simulated transport,
    4 writes per group while 32 streams of 256 KB run) on the server's
    default durable log in a fresh temporary directory, with the durable
    rungs' timeout tier, once per ``MIX_FS_LEGS`` leg (per-group segment
    files, the shared plane, and both again under a modeled 5 ms fsync),
    each leg on a cluster of its own: ``legs`` ({leg:
    ``run_mixed_bench``'s result}) and the streams that failed in all of
    them (``streams_failed``)."""
    import tempfile

    from ratis_tpu_torch.tools.bench import _device, durable_properties
    load = LOADS["mixed"]
    groups = groups or load["groups"]
    dev = str(_device(device))
    out = {}
    for leg, shared, delay_ms in MIX_FS_LEGS:
        with tempfile.TemporaryDirectory(prefix=f"ratis-mixfs-{leg}-") as tmp:
            props = durable_properties(groups, dev, tmp, shared,
                                       load["transport"])
            cluster = filestore_cluster(dev, groups, load["servers"],
                                        load["transport"], props)
            out[leg] = asyncio.run(run_mixed_bench(
                cluster, load["writes"], load["streams"],
                load["stream_bytes"], stream_window=load["window"],
                seed=seed, fsync_delay_ms=delay_ms))
    return {"legs": out,
            "streams_failed": sum(r["streams_failed"] for r in out.values())}
