"""The port's bench entry point: the JAX bench's kernel rungs and its
headline end-to-end rung, run on the port.

    python -m ratis_tpu_torch.tools.bench                 # on the CUDA card
    python -m ratis_tpu_torch.tools.bench --device cpu    # plain versions
    python -m ratis_tpu_torch.tools.bench --rungs mesh_100k,sim_10240
    python -m ratis_tpu_torch.tools.bench --rungs mesh
    python -m ratis_tpu_torch.tools.bench --rungs durable    # or shared, churn
    python -m ratis_tpu_torch.tools.bench --rungs filestore5  # or mixed, stream
    python -m ratis_tpu_torch.tools.bench --rungs telemetry   # or traced
    python -m ratis_tpu_torch.tools.bench --rungs upkeep      # or sparse_hib,
    python -m ratis_tpu_torch.tools.bench --rungs chaos       # sparse_plain,
    python -m ratis_tpu_torch.tools.bench --rungs placement   # one a process
    python -m ratis_tpu_torch.tools.bench --rungs readmix     # or zipf
    python -m ratis_tpu_torch.tools.bench --rungs snapcatch   # or peer7
    python -m ratis_tpu_torch.tools.bench --rungs peer5_mp    # or peer5_sp
    python -m ratis_tpu_torch.tools.bench --rungs scalar      # peer5_scalar,
    python -m ratis_tpu_torch.tools.bench --rungs win1        # win4, win16,
    python -m ratis_tpu_torch.tools.bench --rungs sim_64      # sim_1, sim_1024
    python -m ratis_tpu_torch.tools.bench --rungs upk_64      # or upk_1024
    python -m ratis_tpu_torch.tools.bench --rungs mix_fs

Prints exactly one JSON line on stdout, with the key names of ``bench.py``'s
rungs (the first three by default, the mesh rungs when ``--rungs`` names
them; at most one rung that brings up a cluster per run):

- ``kernel`` (``child_kernel``): the stateless fused tick ``engine_step``
  (K6) over a 10240 groups x 8 peers batch with 4096 acks, 3 warm calls,
  then the best of 3 x 100 calls, each loop closed by a device sync:
  ``group_updates_per_sec``, and ``vs_scalar_loop`` against the scalar
  Python loop of ``ops/reference.py`` over 2048 groups;
- ``kernel_100k`` (``child_kernel_100k``): the same tick at 102400 x 8
  with 8192 acks, 10 calls: ``group_updates_per_sec_100k``;
- ``e2e`` (``child_e2e`` -> ``run_bench``), the headline: 3 servers x 1024
  groups over real localhost TCP sockets, ``CounterStateMachine``, one
  warm-up write per group, then 8 writes per group at concurrency 128;
  every write acknowledged and every counter read back equal from all
  three replicas: ``commits_per_sec``, ``p50_ms``, ``p99_ms``,
  ``election_convergence_s`` (bring-up: servers start -> every group has
  a ready leader), ``prewarm_s`` (the kernels' build and first launch)
  and ``election_timeouts`` (fired in bring-up, warm-up, measured writes);
  ``dispatch``: each engine's batched dispatches in the measured writes
  (count, p50/p99/max ms on the host clock, share of the writes' wall,
  ack batch p50/p99/max), and ``pack_ms``: the host time of the flat and
  the slice-routed fast-tick pack at the largest p99 ack batch.
  Leaders come from elections (the JAX bench appoints them), so the
  bring-up includes 1024 elections through the batched vote tally;
- ``mesh_100k`` (``child_mesh100k``): a mesh engine's fast tick (K5) over
  8 slices of 102400 groups x 8 peers with 8192 acks routed to their
  slices, state updated in place as the engine does, against the flat
  fast tick (K1) on the same state and acks, each the best of 3 x 10
  calls closed by a device sync: ``updates_per_s``,
  ``per_slice_updates_per_s``, ``tick_ms``, ``control_tick_ms`` and
  ``efficiency_frac`` (control tick / mesh tick);
- ``mesh`` (``bench.py``'s mesh e2e rung): 3 servers x 10240 groups over
  the simulated transport with ``mesh-devices=8``, no warm-up, 2 writes
  per group at concurrency 128, the e2e rung's metrics; ``sim_10240`` is
  the same rung without a mesh, its control (the JAX ladder pairs them);
- ``durable`` (the log keys and timeout tier of ``bench.py``'s durable
  rungs, ``child_mixed_durable``): the e2e rung's deployment over TCP on the
  server's default durable log — per-group segment files in a fresh
  temporary directory — with ``ArithmeticStateMachine`` and the JAX
  bench's arithmetic writes (BASELINE config 2), 1 + 8 writes per group;
  every replica's variable map held to the fold of the acknowledged
  writes, then a full restart from disk and the same check again:
  the e2e metrics plus ``fsyncs_per_commit``, ``storage_fs`` and
  ``restart_s``; ``shared`` is the same on the shared log plane
  (``raft.tpu.log.shared``);
- ``churn`` (``child_churn`` -> ``run_churn_bench(1024, 8,
  transfers=64)``, BASELINE config 4): 3 x 1024 over the simulated
  transport, 8 writes per group while 64 leadership transfers (seed 17,
  20 ms apart) move leaders and 8 groups each go through one joint-
  consensus round (a SET_CONFIGURATION without a follower, then with it
  again): ``transfers_ok`` / ``transfers_failed``, ``joint_ok`` /
  ``joint_failed``, commits/s, p50/p99, election timeouts, ``dispatch``,
  and every counter read back from every replica in the final
  configuration;
- ``mixed`` (``child_mixed`` -> ``run_mixed_bench(1024, 4, streams=32,
  stream_bytes=256 << 10)``, ``tools/filestore_bench.py``): 3 servers x
  ``--groups`` (1024) FileStore groups, memory log, simulated transport,
  every server serving the DataStream plane on localhost TCP; 4 writes
  of a 128-byte file per group at 128 in flight while 32 streams of 256
  KB (64 KB packets, window 16, 8 at a time) run; every replica's files
  held to the acknowledged writes and streams: ``commits_per_sec``,
  ``p50_ms``, ``p99_ms``, ``streams_ok``, ``streams_failed``,
  ``stream_failures``, ``stream_mb_per_s``;
- ``stream`` (``child_stream`` -> ``run_stream_throughput_bench(4, 32,
  packet_kb=1024)``): 4 streams of 32 MB at once in 1 MB packets, window
  32, into 3 servers x 4 FileStore groups, DataStream over localhost TCP;
  every replica's files checked: ``stream_mb_per_s`` and the stream
  counts;
- ``filestore5`` (``child_filestore5``, BASELINE config 3): 5 servers x
  ``--groups`` (10240) FileStore groups over localhost TCP, 1 write per
  group at 128 in flight while 16 streams of 4 MB (window 32) run; the
  ``mixed`` keys;
- ``telemetry`` (``bench.py``'s ``tel_on`` leg): the ``e2e`` rung with
  ``raft.tpu.telemetry.enabled=true`` and ``raft.tpu.telemetry.interval=1s``;
  the e2e metrics plus ``telemetry``: ``samples``, ``sample_cost_p99_ms``,
  ``hot_share``, ``hot_group``, ``sampler_pass_ms`` and ``walk_pass_ms``
  (best-of-3 thread-CPU ms of a forced sampler pass and of the retired
  per-division walk, worst server; ``_wall_ms`` the same on the wall
  clock) and ``ledger_fetch_ms`` (p50 of the ledger's sample, worst
  server); ``e2e`` is its control, run in its own process;
- ``traced`` (``bench.py``'s host-path decomposition rung): 3 x 1024 over
  the simulated transport with host-path tracing on (every 16th write),
  1 + 8 writes per group; the e2e metrics plus
  ``host_path_decomposition`` (``trace/export.py``) over the measured
  writes, and ``--trace-out FILE`` writes their Chrome trace;
- ``upkeep`` (``child_upkeep`` -> ``run_upkeep_bench``,
  ``tools/upkeep_bench.py``): 3 servers x ``--groups`` (10240) idle groups
  over the simulated transport, hibernation and the upkeep plane
  (``raft.tpu.upkeep.enabled``) on, no client load, ``--settle`` (25) s,
  then the upkeep tick pair on the same live divisions, plane against
  legacy walk: ``hibernated_groups``, ``registered_slots``,
  ``due_groups``, ``tick_array_ms``, ``tick_legacy_ms``, ``tick_ratio``
  (thread CPU, best of 3, worst server; ``_wall_ms`` and
  ``tick_ratio_wall`` on the wall clock) and the raw scans
  ``sweep_ms_64``, ``sweep_ms_1024``; the cluster is left up and the
  process ends after the line;
- ``sparse_hib`` / ``sparse_plain`` (``bench.py``'s sparse pair): 3 x
  ``--groups`` (10240) hosted over the simulated transport, no warm-up,
  8 writes per group on the first ``--active`` (1024) groups at 128 in
  flight, every counter read back from every replica (the idle groups'
  at 0); ``sparse_hib`` with hibernation on and ``--settle`` (20) s after
  the bring-up, ``sparse_plain`` without either: the e2e metrics plus
  ``active_groups`` and ``hibernated_groups``;
- ``chaos`` (``child_chaos`` -> ``run_chaos_1024``, ``chaos/campaign.py``):
  the standing campaign of 12 scenarios (the 10 default and the durable
  ``slow_disk``, ``shared_log_tail_loss``) on 3 x ``--groups`` (1024)
  counter groups over the simulated transport on the shared durable log
  in a fresh temporary directory, seed ``--chaos-seed`` (1): the
  campaign summary (``passed``, ``total``, ``worst_reelect_s``,
  ``recovery_frac``, ``elapsed_s``, the fault events, each scenario's
  entry);
- ``placement`` (``child_placement`` -> ``run_placement_bench``,
  ``tools/placement_bench.py``): 4 servers x ``--groups`` (48) over
  localhost TCP, ``--clients`` (384) zipf clients x 6 write+read pairs
  0.25 s apart, element limit 192, 8 hot pins, a grey follower, settle 6
  s (``--settle``); phase OFF, then phase ON with a placement controller
  on every server: ``run_placement_bench``'s keys;
- ``readmix`` (``child_readmix`` -> ``run_read_write_bench(1024, 4,
  concurrency=128, transport="tcp")``, ``tools/read_bench.py``): 3
  servers x ``--groups`` (1024) over localhost TCP, linearizable reads
  with the leader lease; each group's client writes ``--writes`` (4)
  times, each write chased by a lease read at the leader, a
  linearizable read and a stale read at a follower (128 in flight):
  ``run_read_write_bench``'s keys, plus every read value and every
  replica's counter checked (``read_mismatches``,
  ``replica_mismatches``) and per server the reads served beside the
  readIndex confirmation sweeps;
- ``zipf`` (``child_zipf`` -> ``run_zipf_fleet_bench(1024,
  clients=10240, concurrency=512, transport="tcp")``): 3 x ``--groups``
  (1024) over TCP, ``--clients`` (10240) clients with zipf(1.1) homes,
  a write and a linearizable read each, 512 in flight (``--concurrency``),
  admission at ``--element-limit`` (192) pending elements, telemetry at
  250 ms, after an unsaturated phase of ``--unsat-clients`` (256):
  ``run_zipf_fleet_bench``'s keys plus the same checks;
- ``snapcatch`` (``child_snapcatch`` -> ``run_snapshot_catchup_bench(1024,
  4, concurrency=128, transport="tcp")``, ``tools/snapshot_bench.py``,
  the InstallSnapshot half of BASELINE config 5): 3 servers x
  ``--groups`` (1024) over localhost TCP, snapshot storage in a fresh
  temporary directory; seed 4 writes a group, snapshot and purge every
  leader, wipe the last server's replicas, 4 writes a group again while
  the leaders install their snapshots on it: ``catchup_s``, ``installs``,
  ``commits_per_sec`` / ``cps_before``, ``p99_ms``, every replica's
  counter read back equal to both loads' acknowledged writes, and the
  wiped server's engine rows (``snapshot_bench.snapcatch_rung``'s keys);
- ``peer7`` (``bench.py``'s config 5 probe, ``bench.py:801-808``): 7
  servers x ``--groups`` (2048) over the simulated transport, 4 writes a
  group, no warm-up, 128 in flight, every 32nd write traced: the e2e
  metrics, every counter read back from all 7 replicas, and
  ``host_path_decomposition`` (``--trace-out FILE`` writes the trace);
- ``peer5_mp`` (``bench.py``'s north star, ``bench.py:756-773``): 5
  servers x ``--groups`` (10240) over localhost TCP as the multi-process
  deployment (``tools/multiproc_bench.py``): one process per server, its
  divisions on 3 loop shards, the load from 4 client processes (2 shards
  and 2 clients on a host of fewer than 8 CPUs), leaders appointed by
  the first server, 2 writes a group at 128 in flight, every 32nd write
  traced: ``run_multiproc_bench``'s keys, every counter on every replica
  between the writes acknowledged and sent (``replica_mismatches``);
- ``peer5_sp`` (its one-process control, ``bench.py:774-778``): the same
  5 x 10240 over TCP in one process, leaders elected, no warm-up: the
  e2e metrics, every counter read back from all 5 replicas, and
  ``host_path_decomposition``;
- ``scalar`` (the headline's scalar control, ``bench.py:812-818``) and
  ``peer5_scalar`` (the north star's, ``bench.py:784-787``: 5 x
  ``--groups`` (10240) over TCP, 2 writes a group, no warm-up; a run that
  does not finish is recorded as a DNF, as there): the e2e rung on
  ``cluster_properties(..., batched=False)``, every tick on the
  per-division host loop (no kernel tick may run), one RPC per group and
  follower;
- ``win1``, ``win4``, ``win16`` (the window-depth sweep,
  ``bench.py:819-833``): the headline with
  ``raft.tpu.replication.window-depth`` 1, 4 or 16, its line's
  ``sweep_entry`` the JAX sweep's [commits/s, p99 ms, window occupancy];
- ``sim_1``, ``sim_64``, ``sim_1024`` (the sim ladder, ``bench.py:730-742``;
  ``SIM_LADDER``): 3 servers x 1, 64 or 1024 groups over the simulated
  transport, one warm-up write, then 256 writes a group at 32 in flight,
  128 at 128, or 8 at 128;
- ``upk_64``, ``upk_1024`` (the upkeep dip pair, ``bench.py:922-940``):
  ``sim_64`` and ``sim_1024``'s loads (``UPKEEP_LADDER``) with
  ``raft.tpu.upkeep.enabled``; ``--upkeep-triple`` folds the ``upkeep``,
  ``upk_64`` and ``upk_1024`` lines into the JAX bench's ``upkeep``
  triple;
- ``mix_fs`` (``child_mixed_durable``, ``bench.py:369-414``): the
  ``mixed`` load on the server's default durable log with the durable
  rungs' timeout tier, per-group segment files (``pergroup``), the shared
  plane (``shared``) and both under a modeled disk whose fsync takes 5
  ms (``pergroup_5ms``, ``shared_5ms``), each leg on a cluster of its own:
  each leg's ``mixed`` keys with ``fsyncs_per_commit`` and each server's
  fsync seconds in the writes and their share of them.

Every e2e rung's result holds the keys of the JAX harness's
``run_bench`` too (``mode``, ``peers``, ``scheduling_hops``,
``reply_hops_per_commit``, ``append_rewinds``, ``window_occupancy``,
``window_rewinds``, ``lane_resets``, ``codec``, the dispatch reasons,
``engine_occupancy``, ``watchdog_events``); the durable rungs' results
hold each server's log-worker fsync seconds in the measured writes
(``sync_time_s``) and their share of the writes' wall (``sync_share``).

``--seed`` seeds the streams' bytes.  A rung whose streams failed, whose
reads or replicas broke their checks, or (``snapcatch``) whose wiped
replicas were not all caught up by a snapshot install, prints its line
and exits 1; so does a ``scalar``, ``peer5_mp``, ``peer5_sp`` or
``peer5_scalar`` rung that did not finish, its line holding ``dnf``: the
error, and a ``peer5_mp`` rung in
which a server failed to take its group's leadership after the load
(``transfers_failed``).

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: the stateless tick through
``sharded_engine_step``, then a mesh engine of ``n`` slices driven through
its intake and tick surface until commits advance.

``--device cuda`` (the default) runs the kernels and fails where there is
no card; ``--device cpu`` runs the plain versions, for the tests.
``entry()`` is the counterpart of ``__graft_entry__.entry()``.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.ops import quorum
from ratis_tpu_torch.ops import reference as ref

RUNGS = ("kernel", "kernel_100k", "e2e", "mesh_100k", "mesh", "sim_10240",
         "durable", "shared", "churn", "mixed", "stream", "filestore5",
         "telemetry", "traced", "upkeep", "sparse_hib", "sparse_plain",
         "chaos", "placement", "readmix", "zipf", "snapcatch", "peer7",
         "peer5_mp", "peer5_sp", "scalar", "peer5_scalar", "win1", "win4",
         "win16", "sim_1", "sim_64", "sim_1024", "upk_64", "upk_1024",
         "mix_fs")
# what a run without --rungs measures: the headline and the kernel rungs
# (the mesh pair's bring-up of 2 x 10240 groups takes minutes)
DEFAULT_RUNGS = RUNGS[:3]
# the headline rung's load: one warm-up write per group, then the measured
# writes with this many in flight (bench.py's child_e2e at the headline)
WARMUP_WRITES = 1
CONCURRENCY = 128
# the slices of the mesh rungs (bench.py's "mesh": 8, child_mesh100k's S)
MESH_SLICES = 8
# the mesh rungs' load: writes per group, no warm-up (bench.py's mesh rung)
MESH_WRITES = 2
# rungs that bring up a cluster: one per process, as bench.py runs one
# child per rung (a second cluster in one process inherits the first's
# sealed heap and was measured churning elections)
E2E_RUNGS = ("e2e", "sim_10240", "mesh", "durable", "shared", "churn",
             "mixed", "stream", "filestore5", "telemetry", "traced",
             "upkeep", "sparse_hib", "sparse_plain", "chaos", "placement",
             "readmix", "zipf", "snapcatch", "peer7", "peer5_mp",
             "peer5_sp", *RUNGS[25:])
# groups of the rungs that bring up a cluster when --groups is not given
GROUPS = 1024
FILESTORE5_GROUPS = 10_240
# bench.py's config 5 probe (bench.py:801-808): 7 peers, sim, 4 writes
# per group, no warm-up, every 32nd write traced
PEER7 = {"groups": 2048, "servers": 7, "writes": 4, "warmup": 0,
         "transport": "sim", "trace_sample": 32}
# bench.py's north star and its one-process control (bench.py:756-778):
# 5 peers over TCP, 2 writes per group, no warm-up, every 32nd write traced
PEER5 = {"groups": 10_240, "servers": 5, "writes": 2, "warmup": 0,
         "transport": "tcp", "trace_sample": 32}
# bench.py's tel_on leg: the sampler on, one sample a second
TELEMETRY = {"raft.tpu.telemetry.enabled": "true",
             "raft.tpu.telemetry.interval": "1s"}
# the headline's window-depth sweep (bench.py:819-833): the e2e rung with
# the append window this deep
WINDOW_DEPTH_KEY = "raft.tpu.replication.window-depth"
WINDOW_DEPTHS = {"win1": 1, "win4": 4, "win16": 16}
# the sim ladder's rungs below 10240 groups (bench.py:730-742; its 1024
# rung also runs on the chip as tpu_e2e, bench.py:957-960): groups, writes
# per group and writes in flight, one warm-up write per group
SIM_LADDER = {"sim_1": (1, 256, 32), "sim_64": (64, 128, 128),
              "sim_1024": (1024, 8, 128)}
# the upkeep dip pair (bench.py:922-940): the sim rungs at 64 and 1024
# groups (128 and 8 writes per group) with the upkeep plane on
UPKEEP_PROPS = {"raft.tpu.upkeep.enabled": "true"}
UPKEEP_LADDER = {"upk_64": (64, 128), "upk_1024": (1024, 8)}


def _example_batch(num_groups: int, num_peers: int, num_events: int,
                   seed: int = 0):
    """Build a plausible mixed-role group batch + packed ack batch."""
    rng = np.random.default_rng(seed)
    g, p, e = num_groups, num_peers, num_events

    # 5 voting members in slots 0..4, self in slot 0.
    conf_cur = np.zeros((g, p), bool)
    conf_cur[:, :5] = True
    conf_old = np.zeros((g, p), bool)
    self_mask = np.zeros((g, p), bool)
    self_mask[:, 0] = True

    role = np.where(rng.random(g) < 0.5, np.int8(3), np.int8(1))  # leader/follower
    commit_index = rng.integers(0, 1000, g, dtype=np.int32)
    flush_index = commit_index + rng.integers(0, 64, g, dtype=np.int32)
    match_index = np.minimum(
        commit_index[:, None] + rng.integers(-8, 64, (g, p), dtype=np.int32),
        flush_index[:, None]).astype(np.int32)
    first_leader_index = np.maximum(commit_index - 10, 0).astype(np.int32)
    last_ack_ms = rng.integers(0, 5000, (g, p), dtype=np.int32)
    election_deadline_ms = rng.integers(4000, 8000, g, dtype=np.int32)

    ev_group = rng.integers(0, g, e, dtype=np.int32)
    ev_peer = rng.integers(1, 5, e, dtype=np.int32)
    ev_match = rng.integers(0, 1100, e, dtype=np.int32)
    ev_time_ms = np.full(e, 5000, np.int32)
    ev_valid = np.ones(e, bool)

    now_ms = np.int32(5000)
    leadership_timeout_ms = np.int32(300)

    return (match_index, last_ack_ms, ev_group, ev_peer, ev_match, ev_time_ms,
            ev_valid, self_mask, flush_index, conf_cur, conf_old, commit_index,
            first_leader_index, role, election_deadline_ms, now_ms,
            leadership_timeout_ms)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the kernels run only there "
                           "(--device cpu runs the plain versions)")
    return dev


def device_info(device) -> dict:
    dev = _device(device)
    if dev.type == "cuda":
        return {"type": "cuda", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"type": dev.type, "kind": "cpu", "count": 1}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def entry(device="cuda"):
    """(fn, args): the stateless fused tick and its example arguments at
    1024 group slots x 8 peer slots with 256 acks, on ``device``."""
    args = _example_batch(num_groups=1024, num_peers=8, num_events=256)
    return quorum.engine_step, quorum.engine_step_args_from_numpy(
        args, _device(device))


def _scalar_rate(num_peers: int, groups: int) -> float:
    """Group updates per second of the scalar Python loop: the same math,
    one group at a time."""
    (match_index, last_ack_ms, _eg, _ep, _em, _et, _ev, _sm, flush_index,
     conf_cur, conf_old, commit_index, first_leader_index, role, _dl,
     now_ms, lead_timeout) = _example_batch(groups, num_peers, 1)
    self_slot = np.zeros(groups, np.int32)
    t0 = time.perf_counter()
    for _ in range(3):
        for g in range(groups):
            ref.update_commit(
                match_index[g].tolist(), int(self_slot[g]),
                int(flush_index[g]), conf_cur[g].tolist(),
                conf_old[g].tolist(), int(commit_index[g]),
                int(first_leader_index[g]), bool(role[g] == 3))
            ref.check_leadership(
                last_ack_ms[g].tolist(), int(self_slot[g]),
                conf_cur[g].tolist(), conf_old[g].tolist(),
                int(now_ms), int(lead_timeout), bool(role[g] == 3))
    return groups * 3 / (time.perf_counter() - t0)


def kernel_rung(device="cuda", groups: int = 10_240, peers: int = 8,
                events: int = 4096, iters: int = 100,
                scalar_groups: int = 2048) -> dict:
    """``child_kernel``: the best rate of 3 x ``iters`` calls."""
    dev = _device(device)
    args = quorum.engine_step_args_from_numpy(
        _example_batch(groups, peers, events), dev)
    for _ in range(3):
        quorum.engine_step(*args)
    _sync(dev)
    batched = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            quorum.engine_step(*args)
        _sync(dev)
        batched = max(batched, groups * iters / (time.perf_counter() - t0))
    scalar = _scalar_rate(peers, scalar_groups)
    return {"group_updates_per_sec": batched,
            "vs_scalar_loop": batched / scalar,
            "platform": device_info(dev)["kind"],
            "shape": [groups, peers, events]}


def kernel_100k_rung(device="cuda", groups: int = 102_400, peers: int = 8,
                     events: int = 8192, iters: int = 10) -> dict:
    """``child_kernel_100k``: one warm call, then ``iters`` timed calls."""
    dev = _device(device)
    args = quorum.engine_step_args_from_numpy(
        _example_batch(groups, peers, events), dev)
    quorum.engine_step(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        quorum.engine_step(*args)
    _sync(dev)
    return {"group_updates_per_sec_100k":
            groups * iters / (time.perf_counter() - t0),
            "platform": device_info(dev)["kind"],
            "shape": [groups, peers, events]}


def mesh100k_batch(groups: int = 102_400, peers: int = 8,
                   events: int = 8192, slices: int = MESH_SLICES,
                   seed: int = 0):
    """``child_mesh100k``'s inputs: the ten DeviceState arrays (every
    group a leader of 5 voters), the acks routed to their slices
    (``[7, S, E / S]``, slice-local rows), the same acks flat (``[7, E]``,
    global rows) and ``meta``."""
    g, p, e, n = groups, peers, events, slices
    rng = np.random.default_rng(seed)
    conf = np.zeros((g, p), bool)
    conf[:, :5] = True
    self_mask = np.zeros((g, p), bool)
    self_mask[:, 0] = True
    state = [rng.integers(0, 512, (g, p)).astype(np.int32),
             rng.integers(0, 1000, (g, p)).astype(np.int32),
             self_mask, conf, np.zeros((g, p), bool),
             np.full(g, 3, np.int8),
             rng.integers(256, 512, g).astype(np.int32),
             np.zeros(g, np.int32), np.zeros(g, np.int32),
             np.full(g, 2 ** 31 - 1, np.int32)]
    evs = np.full((7, n, e // n), quorum.PACK_SENTINEL, np.int32)
    evs[0] = rng.integers(0, g // n, (n, e // n))
    evs[1] = rng.integers(0, 5, (n, e // n))
    evs[2] = rng.integers(0, 512, (n, e // n))
    evs[3] = 900
    evs[4] = 1
    evf = np.full((7, e), quorum.PACK_SENTINEL, np.int32)
    rows = evs.reshape(7, e)
    evf[:5] = rows[:5]
    evf[0] = (rows[0].reshape(n, e // n)
              + (np.arange(n) * (g // n))[:, None]).reshape(e)
    return state, evs, evf, np.array([1000, 10_000], np.int32)


def mesh_100k_rung(device="cuda", groups: int = 102_400, peers: int = 8,
                   events: int = 8192, slices: int = MESH_SLICES,
                   iters: int = 10, trials: int = 3) -> dict:
    """``child_mesh100k``: K5 over ``slices`` slices against the flat K1
    at the same load, each on its own copy of the state (updated in place
    call after call, as the engine's donated state is)."""
    from ratis_tpu_torch.parallel import (make_group_mesh,
                                          shard_device_state,
                                          sharded_resident_fast_step_sliced)
    dev = _device(device)
    state, evs, evf, meta = mesh100k_batch(groups, peers, events, slices)
    ev_s, ev_f, mt = (torch.from_numpy(a).to(dev) for a in (evs, evf, meta))

    def best_tick(step, st, ev) -> float:
        step(st, ev, mt)
        _sync(dev)
        best = None
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(iters):
                step(st, ev, mt)
            _sync(dev)
            dt = (time.perf_counter() - t0) / iters
            best = dt if best is None else min(best, dt)
        return best

    mesh = make_group_mesh(slices, device=dev)
    t_mesh = best_tick(
        sharded_resident_fast_step_sliced(mesh),
        shard_device_state(mesh, quorum.device_state_from_numpy(state, dev)),
        ev_s)
    t_ctrl = best_tick(quorum.engine_step_resident_fast,
                       quorum.device_state_from_numpy(state, dev), ev_f)
    return {"groups": groups, "devices": slices,
            "updates_per_s": groups / t_mesh,
            "per_slice_updates_per_s": groups / slices / t_mesh,
            "tick_ms": t_mesh * 1e3, "control_tick_ms": t_ctrl * 1e3,
            "efficiency_frac": t_ctrl / t_mesh,
            "platform": device_info(dev)["kind"],
            "shape": [groups, peers, events]}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """``__graft_entry__.dryrun_multichip`` on a mesh of ``n_devices``
    slices of one device: the stateless tick through
    ``sharded_engine_step``, then a mesh :class:`QuorumEngine` driven
    through ``on_flush`` / ``on_ack`` / ``tick`` — a quorum ack must
    advance every group's commit to 5 on the sliced state, a dirty-row
    refresh tick must run, and the resident state must hold ``n_devices``
    slices on the device."""
    from ratis_tpu_torch.engine.engine import QuorumEngine
    from ratis_tpu_torch.engine.state import ROLE_LEADER
    from ratis_tpu_torch.parallel import (make_group_mesh, shard_batch,
                                          sharded_engine_step)
    dev = _device(device)
    mesh = make_group_mesh(n_devices, device=dev)
    g = max(8, n_devices) * 2  # tiny, divisible by n_devices
    out = sharded_engine_step(mesh)(*shard_batch(
        mesh, _example_batch(num_groups=g, num_peers=8, num_events=16)))
    _sync(dev)
    assert out.new_commit.shape == (g,)

    async def drive():
        eng = QuorumEngine(max_groups=g, max_peers=8,
                           scalar_fallback_threshold=0, use_device=True,
                           mesh=mesh, device=dev)
        commits: dict[int, int] = {}

        class Listener:
            def __init__(self):
                self.slot = -1

            def on_commit_advance_now(self, c):
                commits[self.slot] = c

            async def on_commit_advance(self, c):
                commits[self.slot] = c

            async def on_election_timeout(self):
                pass

            async def on_leadership_stale(self):
                pass

        s = eng.state
        slots = []
        for _ in range(g):
            lst = Listener()
            lst.slot = eng.attach(lst)
            slots.append(lst.slot)
            cur = np.zeros(8, bool)
            cur[:3] = True
            s.set_conf(lst.slot, 0, cur, np.zeros(8, bool),
                       np.zeros(8, np.int32), 0)
            s.role[lst.slot] = ROLE_LEADER
            s.last_ack_ms[lst.slot, :3] = eng.clock.now_ms()
            s.mark_dirty(lst.slot)
        # first tick: full upload of the sliced DeviceState
        await eng.tick()
        # steady state: flush + quorum acks through the sliced fast tick
        for slot in slots:
            eng.on_flush(slot, 5)
            eng.on_ack(slot, 1, 5)
        await eng.tick()
        assert all(commits.get(slot) == 5 for slot in slots), commits
        # dirty rows between ticks: the refresh tick runs too
        for slot in slots[:4]:
            s.last_ack_ms[slot, 2] = eng.clock.now_ms()
            s.mark_dirty(slot)
        await eng.tick()
        assert eng.metrics["refresh_ticks"] > 0, eng.metrics
        assert eng._dev is not None
        on = eng._dev.match_index
        assert eng.state.n_slices == n_devices and on.shape[0] == g, \
            (eng.state.n_slices, tuple(on.shape))
        assert on.device.type == dev.type, on.device
        res = {"n_devices": n_devices, "groups": g,
               "n_slices": eng.state.n_slices, "device": str(on.device),
               "commits": sorted(set(commits.values())),
               "fast_ticks": eng.metrics["fast_ticks"],
               "refresh_ticks": eng.metrics["refresh_ticks"]}
        await eng.close()
        return res

    return asyncio.run(drive())


def e2e_cluster(device="cuda", groups: int = 1024, transport: str = "tcp",
                mesh_devices: int = 0, props: dict = None,
                trace: bool = False, hibernate: bool = False,
                servers: int = 3, trace_sample: int = None,
                batched: bool = True):
    """An e2e rung's cluster: ``servers`` servers x ``groups`` groups over
    ``transport``, the batched deployment or (``batched=False``) the
    scalar control, engines in ``mesh_devices`` slices when > 0,
    host-path tracing on with ``trace`` (every ``trace_sample``-th write,
    default the cluster's ``TRACE_SAMPLE``), idle groups hibernating with
    ``hibernate``, the properties ``props`` set over the cluster's (the
    JAX child's ``props``), its kernels built and launched once
    (``Cluster.prewarm``), not yet started."""
    from ratis_tpu_torch.tools.cluster import (TRACE_SAMPLE, Cluster,
                                               cluster_properties)
    dev = str(_device(device))
    properties = cluster_properties(
        groups, servers, dev, transport, mesh_devices, trace=trace,
        hibernate=hibernate, trace_sample=trace_sample or TRACE_SAMPLE,
        batched=batched)
    for k, v in (props or {}).items():
        properties.set(k, v)
    cluster = Cluster(groups, servers, device=dev, transport=transport,
                      properties=properties)
    cluster.prewarm()
    return cluster


def telemetry_cluster(device="cuda", groups: int = 1024,
                      http_port: int = None):
    """The telemetry rung's cluster: the e2e rung's with ``TELEMETRY``
    set, and each server's HTTP endpoint on ``http_port`` when given (0:
    a port the kernel picks)."""
    extra = dict(TELEMETRY)
    if http_port is not None:
        extra[RaftServerConfigKeys.Metrics.HTTP_PORT_KEY] = str(http_port)
    return e2e_cluster(device, groups, "tcp", props=extra)


def traced_cluster(device="cuda", groups: int = 1024):
    """The traced rung's cluster: the e2e rung's over the simulated
    transport with host-path tracing of every 16th write."""
    return e2e_cluster(device, groups, "sim", trace=True)


def peer7_cluster(device="cuda", groups: int = None):
    """The peer7 rung's cluster (``PEER7``): 7 servers x ``groups`` (2048)
    groups over the simulated transport, every ``trace_sample``-th write
    traced."""
    return e2e_cluster(device, groups or PEER7["groups"], PEER7["transport"],
                       trace=True, servers=PEER7["servers"],
                       trace_sample=PEER7["trace_sample"])


def peer5_cluster(device="cuda", groups: int = None):
    """The peer5_sp rung's cluster (``PEER5``): 5 servers x ``groups``
    (10240) groups over TCP in this process, every ``trace_sample``-th
    write traced."""
    return e2e_cluster(device, groups or PEER5["groups"], PEER5["transport"],
                       trace=True, servers=PEER5["servers"],
                       trace_sample=PEER5["trace_sample"])


def peer5_mp_shape(cpus: int = None) -> tuple[int, int]:
    """(client processes, loop shards) of the peer5_mp rung on a host of
    ``cpus`` CPUs (default this one's): 4 and 3 from 8 CPUs, else 2 and
    2 (bench.py:766-767)."""
    cpus = cpus or os.cpu_count() or 1
    return (4, 3) if cpus >= 8 else (2, 2)


async def peer5_mp_rung(device="cuda", groups: int = None,
                        writes: int = None, trace_out: str = None,
                        **harness) -> dict:
    """The peer5_mp rung: ``PEER5`` as the multi-process deployment
    (``run_multiproc_bench``, which takes ``harness``: its bring-up and
    load timeouts, ``record_plans``), its shards and client processes by
    ``peer5_mp_shape``."""
    from ratis_tpu_torch.tools.multiproc_bench import run_multiproc_bench
    clients, shards = peer5_mp_shape()
    return await run_multiproc_bench(
        groups or PEER5["groups"],
        PEER5["writes"] if writes is None else writes,
        num_servers=PEER5["servers"], device=str(_device(device)),
        loop_shards=shards, client_procs=clients, concurrency=CONCURRENCY,
        trace=True, trace_sample=PEER5["trace_sample"], trace_out=trace_out,
        **harness)


def _blocking_best_of_3(fn, clock=time.thread_time) -> float:
    """Best of 3 seconds of ``fn()`` on ``clock``: by default thread CPU,
    the time a pass holds the event loop's thread
    (``bench_cluster._blocking_best_of_3``)."""
    best = None
    for _ in range(3):
        t0 = clock()
        fn()
        dt = clock() - t0
        best = dt if best is None else min(best, dt)
    return best or 0.0


def telemetry_summary(cluster) -> dict:
    """``run_bench``'s ``telemetry`` block: samples taken, the sampler's
    p99 cost, the hottest group's guaranteed share of the sketched commit
    load, a forced sampler pass against the retired per-division walk
    (best-of-3 thread-CPU ms, worst server; ``_pass_cost_pair_ms``; and
    the same on the wall clock, ``_wall_ms``: a host whose thread-CPU
    clock ticks coarsely reads 0 there) and the ledger sample's p50
    (worst server)."""
    from ratis_tpu_torch.metrics.aggregate import merge_hotgroups
    from ratis_tpu_torch.metrics.timeseries import legacy_division_walk
    servers = [s for s in cluster.servers if s.telemetry is not None]
    tel = [s.telemetry for s in servers]
    hot = merge_hotgroups([t.hotgroups_info() for t in tel], n=4)
    top = hot["groups"][0] if hot["groups"] else None
    # the run's cost percentiles before the forced passes below add theirs
    cost_p99 = max(t._sample_cost.percentile_s(0.99) for t in tel) * 1e3
    out = {"sample_cost_p99_ms": cost_p99,
           "hot_share": top["share_min"] if top else 0.0,
           "hot_group": top["group"] if top else None}
    for suffix, clock in (("ms", time.thread_time),
                          ("wall_ms", time.perf_counter)):
        out[f"sampler_pass_{suffix}"] = 1e3 * max(
            _blocking_best_of_3(t.sample, clock) for t in tel)
        out[f"walk_pass_{suffix}"] = 1e3 * max(
            _blocking_best_of_3(lambda: legacy_division_walk(s, {}), clock)
            for s in servers)
    # the samples, as run_bench counts them, after the forced passes
    return {**out, "samples": sum(t._samples_taken.count for t in tel),
            "ledger_fetch_ms": max(s.engine.ledger.fetch_timer.percentile_s(
                0.5) for s in servers) * 1e3}


# bench.py's durable rungs (child_mixed_durable, bench.py:396-410): fsync
# traffic at 2048+ channels turns the 1 s / 2 s tier into election storms,
# so the JAX bench runs its durable logs on this tier
DURABLE_TIER = {"raft.server.rpc.timeout.min": "4s",
                "raft.server.rpc.timeout.max": "8s",
                "raft.server.rpc.request.timeout": "8s"}


def durable_properties(groups: int, device: str, storage_dir: str,
                       shared: bool, transport: str = "tcp"):
    """A durable rung's properties over ``transport``: the cluster's
    (``bench_properties`` key for key) with the default durable log under
    ``storage_dir``, per group or on the shared plane, and
    ``DURABLE_TIER``."""
    from ratis_tpu_torch.tools.cluster import cluster_properties
    p = cluster_properties(groups, 3, device, transport,
                           storage_dir=storage_dir, shared_log=shared)
    for k, v in DURABLE_TIER.items():
        p.set(k, v)
    return p


def durable_cluster(device, groups: int, storage_dir: str, shared: bool):
    """A durable rung's cluster: 3 servers x ``groups`` groups over TCP
    with ``ArithmeticStateMachine`` (BASELINE config 2's state machine) on
    the default durable log under ``storage_dir``, prewarmed, not yet
    started."""
    from ratis_tpu_torch.tools.cluster import Cluster
    dev = str(_device(device))
    cluster = Cluster(groups, device=dev, transport="tcp",
                      sm="arithmetic", properties=durable_properties(
                          groups, dev, storage_dir, shared))
    cluster.prewarm()
    return cluster


def _fresh_dispatch_timers(engines) -> list:
    """Give each engine fresh ``dispatchLatency`` / ``ackBatchSize``
    reservoirs, so that they hold the measured writes alone; returns the
    registry's own, for ``_dispatch_summary`` to put back."""
    from ratis_tpu_torch.metrics.registry import Histogram, Timekeeper
    saved = [(e._m.dispatch_timer, e._m.ack_batch) for e in engines]
    for e in engines:
        e._m.dispatch_timer, e._m.ack_batch = Timekeeper(), Histogram()
    return saved


def _dispatch_summary(engines, saved, elapsed_s: float) -> list[dict]:
    """Each engine's batched dispatches over the measured writes (pack,
    upload, kernel, download and the changed-row scan, host clock) and
    the ack batches they carried; puts the registry's timers back."""
    out = []
    for e, (timer, batch) in zip(engines, saved):
        t, b = e._m.dispatch_timer, e._m.ack_batch
        out.append({"dispatches": t.count,
                    "p50_ms": t.percentile_s(0.50) * 1e3,
                    "p99_ms": t.percentile_s(0.99) * 1e3,
                    "max_ms": t._max_s * 1e3,
                    "share": t._total_s / elapsed_s,
                    "ack_batch_p50": int(b.percentile_s(0.50)),
                    "ack_batch_p99": int(b.percentile_s(0.99)),
                    "ack_batch_max": int(b._max_s)})
        e._m.dispatch_timer, e._m.ack_batch = timer, batch
    return out


def pack_ms(engine, acks: int, reps: int = 200) -> dict:
    """Host ms of one flat (``_pack_tick``) and one slice-routed
    (``_pack_tick_sliced``; one slice on an engine without a mesh) fast-
    tick pack of ``acks`` acks over the engine's live slots (seed 0) and a
    slot update for each slot of the first half: the median of ``reps``
    calls."""
    rng = np.random.default_rng(0)
    live = np.array(sorted(engine.state.active), np.int64)
    slots = live[rng.integers(0, len(live), max(1, acks))]
    batch = [(int(x), 1, 5, 0) for x in slots]
    updates = {int(x): [5, 100] for x in slots[:len(slots) // 2]}
    saved = engine._last_event_rows, engine._last_event_cap
    out = {"acks": len(batch), "updates": len(updates)}
    for name, pack in (("flat", engine._pack_tick),
                       ("sliced", engine._pack_tick_sliced)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pack(batch, updates)
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times)) * 1e3
    engine._last_event_rows, engine._last_event_cap = saved
    return out


def _check_engines(engines, dev: torch.device, n_slices: int = 1,
                   batched: bool = True) -> None:
    """Every engine ran on ``dev`` in ``n_slices`` slices, its state there
    too, and made batched dispatches; a scalar control's engines
    (``batched=False``) hold no device state (their ticks run on the
    host)."""
    for e in engines:
        on = e._dev.match_index.device if e._dev is not None else None
        if e.device.type != dev.type or (on and on.type != dev.type) \
                or (e.metrics["batched_dispatches"] == 0 if batched
                    else on is not None) \
                or e.state.n_slices != n_slices:
            raise AssertionError(f"engine on {e.device}, state on {on}, "
                                 f"{e.metrics['batched_dispatches']} "
                                 f"batched dispatches, "
                                 f"{e.state.n_slices} slices")


def device_ticks(engines) -> list[int]:
    """Each engine's fast and refresh ticks so far (its kernel ticks)."""
    return [e.metrics["fast_ticks"] + e.metrics["refresh_ticks"]
            for e in engines]


# run_bench's counts of why the engines dispatched (bench_cluster.py:
# 1383-1389), each reported when not 0
DISPATCH_REASONS = ("dispatch_upload", "dispatch_commit", "dispatch_dirty",
                    "dispatch_votes", "dispatch_sweep", "dispatch_backlog")


def run_bench_keys(cluster, engines) -> dict:
    """``run_bench``'s observability keys over ``cluster`` (bench_cluster.py:
    1349-1398): append rewinds, the append window's peak occupancy (frames
    in flight over the envelope slots, worst server), its windowed
    rewinds and lane resets, the codec's counts, the dispatch reasons, the
    engines' live rows over their capacity and the watchdogs' events."""
    from ratis_tpu_torch.server.replication import ReplicationScheduler
    reps = [s.replication for s in cluster.servers]
    out = {"append_rewinds": sum(r.metrics.get("rewinds", 0) for r in reps),
           "window_occupancy": max(r.metrics.get("win_hwm", 0)
                                   / max(1, r.lane_slots) for r in reps),
           "window_rewinds": sum(r.metrics.get("windowed_rewinds", 0)
                                 for r in reps),
           "lane_resets": sum(r.metrics.get("lane_resets", 0) for r in reps),
           "codec": ReplicationScheduler.codec_stats()}
    for reason in DISPATCH_REASONS:
        v = sum(e.metrics.get(reason, 0) for e in engines)
        if v:
            out[reason] = v
    out["engine_occupancy"] = (sum(len(e.state.active) for e in engines)
                               / max(1, sum(e.state.capacity
                                            for e in engines)))
    out["watchdog_events"] = sum(s.watchdog.event_count()
                                 for s in cluster.servers
                                 if s.watchdog is not None)
    return out


async def e2e_rung(cluster, writes: int = 8, warmup: int = WARMUP_WRITES,
                   trace_out: str = None, during=None, after=None,
                   settle=None, active_groups: int = None,
                   concurrency: int = CONCURRENCY) -> dict:
    """``run_bench`` on an ``e2e_cluster``: bring it up (elections in
    waves of a tenth of the groups, at least 128), warm up with ``warmup``
    writes per group, measure ``writes`` writes per group (``concurrency``
    in flight), read every counter back from every replica, close it.
    With ``active_groups``
    only the first that many groups take writes (the sparse shape; the
    others' counters must read 0 on every replica).  With telemetry on,
    the result carries ``telemetry`` (``telemetry_summary``); with tracing
    on, ``host_path_decomposition`` over the measured writes (and their
    Chrome trace in ``trace_out``); with hibernation on,
    ``hibernated_groups`` right after the measured writes.
    ``settle(cluster)``, ``during(cluster)`` and ``after(cluster)``
    (coroutine functions) run after the bring-up, beside the measured
    writes and after the read-back; their results are ``settle``,
    ``during`` and ``after``.  The result holds ``run_bench``'s keys
    (``mode``, ``peers``, ``scheduling_hops``, ``reply_hops_per_commit``
    over the measured writes, ``run_bench_keys``) beside the port's.  On
    the scalar control (``mode`` "scalar") no engine may make a fast or
    refresh tick after its prewarm.  A replica whose counter is not its
    group's acknowledged writes raises."""
    from ratis_tpu_torch.metrics import hops
    from ratis_tpu_torch.tools.cluster import (bring_up_wave, is_batched,
                                               sealed)
    from ratis_tpu_torch.trace import get_tracer
    dev = torch.device(cluster.device)
    groups = cluster.num_groups
    tracing = RaftServerConfigKeys.Trace.enabled(cluster.properties)
    batched = is_batched(cluster.properties)
    engines = [s.engine for s in cluster.servers]
    ticks0 = device_ticks(engines)
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        probe = {}
        if settle is not None:
            probe["settle"] = await settle(cluster)
        timeouts = [cluster.election_timeouts()]
        acked = 0
        if warmup:
            acked = (await cluster.write_all(
                warmup, concurrency, active_groups))["commits"]
        timeouts.append(cluster.election_timeouts())
        saved = _fresh_dispatch_timers(engines)
        if tracing:
            # decompose the measured writes only
            get_tracer().reset()
        # scheduling hops per commit over the measured writes only
        hops.reset()
        advances = sum(e.metrics["commit_advances"] for e in engines)
        load = cluster.write_all(writes, concurrency, active_groups)
        if during is None:
            stats = await load
        else:
            stats, probe["during"] = await asyncio.gather(load,
                                                          during(cluster))
        advances = sum(e.metrics["commit_advances"]
                       for e in engines) - advances
        probe["scheduling_hops"] = hops.snapshot()
        probe["reply_hops_per_commit"] = (hops.reply_plane_hops()
                                          / max(1, advances))
        if tracing:
            records = get_tracer().snapshot()
        timeouts.append(cluster.election_timeouts())
        if RaftServerConfigKeys.Hibernate.enabled(cluster.properties):
            probe["hibernated_groups"] = cluster.hibernated_groups()
        dispatch = _dispatch_summary(engines, saved, stats["elapsed_s"])
        acked += stats["commits"]
        counters = await cluster.read_counters(timeout=300)
        active = {g.group_id for g in cluster.groups[:active_groups]}
        bad = {str(gid): v for gid, v in counters.items()
               if v != [warmup + writes * (gid in active)]
               * len(cluster.servers)}
        if len(counters) != groups or bad:
            raise AssertionError(f"counters differ from the acknowledged "
                                 f"writes in {len(bad)} groups: "
                                 f"{list(bad.items())[:4]}")
        # the watchdog's ledger pass samples once a second on every server
        deadline = time.monotonic() + 30
        while any(s.engine.ledger.samples.count == 0
                  for s in cluster.servers):
            if time.monotonic() > deadline:
                raise AssertionError("no ledger sample on some server")
            await asyncio.sleep(0.1)
        mesh_n = RaftServerConfigKeys.Engine.mesh_devices(cluster.properties)
        _check_engines(engines, dev, max(1, mesh_n), batched)
        if not batched and device_ticks(engines) != ticks0:
            raise AssertionError(f"the scalar control made kernel ticks: "
                                 f"{ticks0} -> {device_ticks(engines)}")
        if after is not None:
            probe["after"] = await after(cluster)
        if any(s.telemetry is not None for s in cluster.servers):
            probe["telemetry"] = telemetry_summary(cluster)
        if tracing:
            probe.update(_trace_blocks(records, trace_out))
        return {**probe, "groups": groups, "servers": len(cluster.servers),
                "peers": len(cluster.servers),
                "mode": "batched" if batched else "scalar",
                "transport": cluster.transport, "writes": writes,
                "warmup": warmup, "concurrency": concurrency,
                "mesh_devices": mesh_n,
                "active_groups": len(active),
                "commits": stats["commits"],
                "acked": acked,
                "write_failures": 0, "elapsed_s": stats["elapsed_s"],
                "commits_per_sec": stats["commits_per_sec"],
                "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                "election_convergence_s": cluster.bring_up_s,
                # election timeouts fired in bring-up, in the warm-up
                # writes and in the measured writes (churn would show in
                # the last two)
                "election_timeouts": [timeouts[0],
                                      timeouts[1] - timeouts[0],
                                      timeouts[2] - timeouts[1]],
                "prewarm_s": cluster.prewarm_s,
                "replicas_read_back": len(counters) * len(cluster.servers),
                "batched_dispatches": sum(e.metrics["batched_dispatches"]
                                          for e in engines),
                "engine_ticks": sum(e.metrics["ticks"] for e in engines),
                **run_bench_keys(cluster, engines),
                # each engine's dispatches in the measured writes, and the
                # two packs' host time at the largest p99 ack batch (none
                # on the scalar control: its ticks pack nothing)
                "dispatch": dispatch,
                "pack_ms": pack_ms(engines[0], max(
                    d["ack_batch_p99"] for d in dispatch))
                if batched else None,
                "ledger_samples": [e.ledger.samples.count for e in engines],
                "engine_device": str(engines[0].device)}
    finally:
        await cluster.close()


async def durable_rung(cluster, writes: int = 8, after=None) -> dict:
    """A durable rung on a ``durable_cluster``: bring it up, warm up with
    ``WARMUP_WRITES`` writes per group, measure ``writes`` arithmetic
    writes per group at concurrency 128, hold every replica's variable map
    to the fold of the acknowledged writes, restart every server from its
    storage (same addresses), hold every map to the fold again, close.
    ``after(cluster)`` (a function) runs just before the close; its
    result is ``after``.
    Reports the e2e rung's metrics, the fsyncs the log workers issued per
    measured commit, the storage's filesystem type (on tmpfs an fsync
    writes nothing to a device) and ``restart_s``: new servers started ->
    every group has a ready leader."""
    from ratis_tpu_torch.tools.cluster import (bring_up_wave, fs_type,
                                               log_fsyncs, log_sync_seconds,
                                               sealed, sync_keys)
    dev = torch.device(cluster.device)
    groups = cluster.num_groups
    storage = RaftServerConfigKeys.storage_dirs(cluster.properties)[0]
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        timeouts = [cluster.election_timeouts()]
        acked = (await cluster.write_all(WARMUP_WRITES,
                                         CONCURRENCY))["commits"]
        timeouts.append(cluster.election_timeouts())
        engines = [s.engine for s in cluster.servers]
        saved = _fresh_dispatch_timers(engines)
        fsyncs, synced = log_fsyncs(), log_sync_seconds(cluster.servers)
        stats = await cluster.write_all(writes, CONCURRENCY)
        fsyncs = log_fsyncs() - fsyncs
        sync = sync_keys(synced, log_sync_seconds(cluster.servers),
                         stats["elapsed_s"])
        timeouts.append(cluster.election_timeouts())
        dispatch = _dispatch_summary(engines, saved, stats["elapsed_s"])
        acked += stats["commits"]
        read_back = [await cluster.check_variables(timeout=300)]
        _check_engines(engines, dev)
        await sealed(cluster, cluster.restart(timeout=600))
        restart_timeouts = cluster.election_timeouts()
        read_back.append(await cluster.check_variables(timeout=300))
        probe = {} if after is None else {"after": after(cluster)}
        return {**probe, "groups": groups, "servers": len(cluster.servers),
                "transport": cluster.transport, "writes": writes,
                "warmup": WARMUP_WRITES, "concurrency": CONCURRENCY,
                "shared_log": RaftServerConfigKeys.TpuLog.shared(
                    cluster.properties),
                "commits": stats["commits"], "acked": acked,
                "elapsed_s": stats["elapsed_s"],
                "commits_per_sec": stats["commits_per_sec"],
                "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                "election_convergence_s": cluster.bring_up_s,
                "election_timeouts": [timeouts[0],
                                      timeouts[1] - timeouts[0],
                                      timeouts[2] - timeouts[1]],
                "fsyncs": fsyncs,
                "fsyncs_per_commit": fsyncs / max(1, stats["commits"]),
                # per server: the log workers' fsync seconds in the
                # measured writes, and their share of the writes' wall
                **sync,
                "storage_fs": fs_type(storage),
                "restart_s": cluster.restart_s,
                "restart_election_timeouts": restart_timeouts,
                # replicas whose map equalled the fold: before, after restart
                "replicas_read_back": read_back,
                "dispatch": dispatch,
                "engine_device": str(engines[0].device)}
    finally:
        await cluster.close()


# the churn rung (bench.py's child_churn -> run_churn_bench(1024, 8,
# transfers=64)): leadership transfers while the writes run, seeded as the
# JAX bench seeds them and 20 ms apart; plus one joint-consensus round
# (remove a follower, add it back) on this many groups
CHURN_TRANSFERS = 64
CHURN_SEED = 17
CHURN_JOINT_GROUPS = 8


async def _transfer_churn(cluster, groups, stats: dict) -> None:
    """``run_churn_bench``'s churn task over the port: ``CHURN_TRANSFERS``
    TRANSFER_LEADERSHIP requests on seeded random ``groups``, each to a
    random other member, following NotLeader suggestions (bounded by the
    peer count) and waiting out LeaderNotReady, as an admin client does."""
    import itertools
    import random

    from ratis_tpu_torch.protocol.admin import TransferLeadershipArguments
    from ratis_tpu_torch.protocol.exceptions import (LeaderNotReadyException,
                                                     NotLeaderException)
    from ratis_tpu_torch.protocol.ids import ClientId
    from ratis_tpu_torch.protocol.message import Message
    from ratis_tpu_torch.protocol.requests import (RaftClientRequest,
                                                   RequestType,
                                                   admin_request_type)
    rng = random.Random(CHURN_SEED)
    client = cluster.factory.new_client_transport()
    client_id = ClientId.random_id()
    call_ids = itertools.count(1)
    by_id = {s.peer_id: s for s in cluster.servers}
    failures = stats.setdefault("transfer_failures", [])
    try:
        for _ in range(CHURN_TRANSFERS):
            g = rng.choice(groups)
            leader_srv = cluster.leader_of(g) or cluster.servers[0]
            target = rng.choice([p.id for p in g.peers
                                 if p.id != leader_srv.peer_id])
            args = TransferLeadershipArguments(str(target), 3000.0)
            reply = None
            try:
                for _attempt in range(2 * len(g.peers)):
                    req = RaftClientRequest(
                        client_id, leader_srv.peer_id, g.group_id,
                        next(call_ids), Message(args.to_payload()),
                        type=admin_request_type(
                            RequestType.TRANSFER_LEADERSHIP),
                        timeout_ms=5000.0)
                    reply = await client.send_request(
                        leader_srv.transport.address, req)
                    exc = reply.exception
                    if reply.success:
                        break
                    if isinstance(exc, LeaderNotReadyException):
                        await asyncio.sleep(0.1)
                        continue
                    if not isinstance(exc, NotLeaderException) \
                            or exc.suggested_leader is None:
                        break
                    leader_srv = by_id.get(exc.suggested_leader.id,
                                           leader_srv)
                    if target == leader_srv.peer_id:
                        target = rng.choice([p.id for p in g.peers
                                             if p.id != leader_srv.peer_id])
                        args = TransferLeadershipArguments(str(target),
                                                           3000.0)
                if reply is not None and reply.success:
                    stats["transfers_ok"] += 1
                else:
                    stats["transfers_failed"] += 1
                    exc = reply.exception if reply is not None else None
                    failures.append(type(exc).__name__ if exc
                                    else "no-exception")
            except Exception as e:  # a failed transfer is counted, not fatal
                stats["transfers_failed"] += 1
                failures.append(type(e).__name__)
                print(f"bench: transfer {g.group_id} -> {target} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
            await asyncio.sleep(0.02)
    finally:
        await client.close()


async def _joint_round(cluster, g, stats: dict) -> None:
    """One joint-consensus round on ``g``: a SET_CONFIGURATION without one
    follower (the leader appends the joint entry, old and new confs, then
    the new one), then one with every peer again (the follower is staged
    back in through a second joint entry)."""
    leader = cluster.leader_of(g)
    follower = next(p for p in g.peers
                    if leader is None or p.id != leader.peer_id)
    admin = cluster.client(g).admin()
    for peers in ([p for p in g.peers if p.id != follower.id],
                  list(g.peers)):
        reply = await admin.set_configuration(peers)
        if not reply.success:
            stats["joint_failed"] += 1
            stats.setdefault("joint_failures", []).append(
                type(reply.exception).__name__)
            return
    stats["joint_ok"] += 1


def churn_cluster(device="cuda", groups: int = 1024):
    """The churn rung's cluster: ``run_churn_bench``'s 3 servers x
    ``groups`` groups over the simulated transport, prewarmed, not yet
    started."""
    return e2e_cluster(device, groups, "sim")


async def churn_rung(cluster, writes: int = 8) -> dict:
    """``run_churn_bench`` on a ``churn_cluster`` (BASELINE config 4's
    "setConfiguration churn + leader transfer"): bring it up, then run
    ``writes`` writes per group at concurrency 128 while
    ``CHURN_TRANSFERS`` leadership transfers move leaders (on the groups
    outside the joint rounds) and the first ``CHURN_JOINT_GROUPS`` groups
    each go through one joint-consensus round; read every counter back
    from every replica in the final configuration, close."""
    from ratis_tpu_torch.tools.cluster import bring_up_wave, sealed
    dev = torch.device(cluster.device)
    groups = cluster.num_groups
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        timeouts = [cluster.election_timeouts()]
        engines = [s.engine for s in cluster.servers]
        saved = _fresh_dispatch_timers(engines)
        stats = {"transfers_ok": 0, "transfers_failed": 0, "joint_ok": 0,
                 "joint_failed": 0}
        joint = cluster.groups[:CHURN_JOINT_GROUPS]
        moved = cluster.groups[CHURN_JOINT_GROUPS:] or cluster.groups
        res, *_ = await asyncio.gather(
            cluster.write_all(writes, CONCURRENCY),
            _transfer_churn(cluster, moved, stats),
            *(_joint_round(cluster, g, stats) for g in joint))
        timeouts.append(cluster.election_timeouts())
        dispatch = _dispatch_summary(engines, saved, res["elapsed_s"])
        counters = await cluster.read_counters(timeout=300)
        want = [writes] * len(cluster.servers)
        bad = {str(gid): v for gid, v in counters.items() if v != want}
        if len(counters) != groups or bad:
            raise AssertionError(f"counters differ from {want} in "
                                 f"{len(bad)} groups: {list(bad.items())[:4]}")
        confs = {len(s.divisions[g.group_id].state.configuration.conf.peers)
                 for s in cluster.servers for g in cluster.groups}
        _check_engines(engines, dev)
        return {"groups": groups, "servers": len(cluster.servers),
                "transport": cluster.transport, "writes": writes,
                "concurrency": CONCURRENCY, "transfers": CHURN_TRANSFERS,
                **stats, "joint_groups": len(joint),
                "commits": res["commits"], "elapsed_s": res["elapsed_s"],
                "commits_per_sec": res["commits_per_sec"],
                "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
                "election_convergence_s": cluster.bring_up_s,
                "election_timeouts": [timeouts[0],
                                      timeouts[1] - timeouts[0]],
                "replicas_read_back": len(counters) * len(cluster.servers),
                "final_conf_sizes": sorted(confs),
                "dispatch": dispatch,
                "engine_device": str(engines[0].device)}
    finally:
        await cluster.close()


def chaos_rung(device="cuda", seed: int = 1, groups: int = 1024,
               artifact_dir: str = None) -> dict:
    """``child_chaos``: ``run_chaos_1024`` on ``device`` (its ChaosCluster
    builds its own servers, so one engine is prewarmed first: the
    kernels' build and load must not fall inside an election); a failing
    scenario writes its replay artifact into ``artifact_dir``."""
    from ratis_tpu_torch.chaos.campaign import run_chaos_1024
    from ratis_tpu_torch.engine.engine import QuorumEngine
    dev = str(_device(device))
    QuorumEngine(max_groups=QuorumEngine._bucket(groups),
                 scalar_fallback_threshold=0, use_device=True,
                 device=dev).prewarm()
    out = asyncio.run(run_chaos_1024(seed=seed, num_groups=groups,
                                     artifact_dir=artifact_dir, device=dev))
    out["engine_device"] = dev
    return out


def _trace_blocks(records, trace_out: str = None) -> dict:
    """``host_path_decomposition`` of the traced writes' span records (and
    the rings' drops, when any), and their Chrome trace written to
    ``trace_out``."""
    import os

    from ratis_tpu_torch.trace import get_tracer
    from ratis_tpu_torch.trace.export import (host_path_decomposition,
                                              write_chrome_trace)
    out = {"host_path_decomposition": host_path_decomposition(records)}
    dropped = get_tracer().stage_dropped()
    if dropped:
        out["host_path_decomposition"]["rings_dropped"] = dropped
    if trace_out:
        write_chrome_trace(trace_out, records)
        out["trace_out"] = os.path.abspath(trace_out)
    return out


def upkeep_triple(upkeep: dict, upk_64: dict, upk_1024: dict) -> list:
    """bench.py's ``upkeep`` triple (bench.py:932-940) from the ``upkeep``,
    ``upk_64`` and ``upk_1024`` rungs' results: the upkeep plane's raw
    scans at 64 and 1024 groups, and the dip fraction, one less the
    commits/s at 1024 groups over those at 64 with the plane on."""
    return [upkeep["sweep_ms_64"], upkeep["sweep_ms_1024"],
            1.0 - upk_1024["commits_per_sec"] / upk_64["commits_per_sec"]]


def _shape(text: str) -> tuple[int, int, int]:
    g, p, e = (int(x) for x in text.split(","))
    return g, p, e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    ap.add_argument("--rungs", default=",".join(DEFAULT_RUNGS),
                    help=f"comma-separated subset of {','.join(RUNGS)} "
                         f"(default {','.join(DEFAULT_RUNGS)})")
    ap.add_argument("--kernel", type=_shape, default=(10_240, 8, 4096),
                    metavar="G,P,E", help="kernel rung shape")
    ap.add_argument("--kernel-100k", type=_shape, default=(102_400, 8, 8192),
                    metavar="G,P,E", help="kernel_100k rung shape")
    ap.add_argument("--iters", type=int, default=100,
                    help="calls per timed kernel-rung trial")
    ap.add_argument("--scalar-groups", type=int, default=2048)
    ap.add_argument("--mesh-100k", type=_shape, default=(102_400, 8, 8192),
                    metavar="G,P,E", help="mesh_100k rung shape")
    ap.add_argument("--groups", type=int, default=None,
                    help=f"groups of the rungs that bring up a cluster "
                         f"(default {GROUPS}; filestore5, upkeep and the "
                         f"sparse pair {FILESTORE5_GROUPS}; placement 48; "
                         f"peer7 {PEER7['groups']}; the peer5 pair "
                         f"{PEER5['groups']}; not the mesh pair's)")
    ap.add_argument("--writes", type=int, default=None,
                    help="writes per group (default 8; readmix, snapcatch "
                         "and peer7 4; the peer5 pair 2)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the streams' bytes")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="the traced, peer7 and peer5 rungs' Chrome "
                         "trace")
    ap.add_argument("--mesh-groups", type=int, default=10_240,
                    help="groups of the mesh and sim_10240 rungs")
    ap.add_argument("--active", type=int, default=None,
                    help="groups written in the sparse rungs (default "
                         "1024)")
    ap.add_argument("--settle", type=float, default=None,
                    help="seconds of the upkeep, sparse_hib and placement "
                         "rungs' settle (default 25, 20, 6)")
    ap.add_argument("--chaos-seed", type=int, default=1,
                    help="seed of the chaos rung's campaign")
    ap.add_argument("--artifact-dir", default=None,
                    help="where a failing chaos scenario writes its replay "
                         "artifact (python -m "
                         "ratis_tpu_torch.tools.chaos_replay FILE)")
    ap.add_argument("--clients", type=int, default=None,
                    help="clients of the placement rung (default 384) and "
                         "the zipf rung (default 10240)")
    ap.add_argument("--concurrency", type=int, default=None,
                    help="requests in flight in the readmix and zipf rungs "
                         "(default 128, 512)")
    ap.add_argument("--element-limit", type=int, default=None,
                    help="the zipf rung's pending-element limit (default "
                         "192)")
    ap.add_argument("--unsat-clients", type=int, default=None,
                    help="clients of the zipf rung's unsaturated phase "
                         "(default 256)")
    ap.add_argument("--loop-shards", type=int, default=1,
                    help="event loops of each server's divisions in the "
                         "snapcatch rung (default 1)")
    ap.add_argument("--upkeep-triple", default=None,
                    metavar="UPKEEP,UPK_64,UPK_1024",
                    help="print bench.py's upkeep triple from the lines "
                         "three runs of these rungs printed (files), and "
                         "exit")
    args = ap.parse_args(argv)
    if args.upkeep_triple:
        lines = []
        for path, rung in zip(args.upkeep_triple.split(","),
                              ("upkeep", "upk_64", "upk_1024")):
            with open(path) as f:
                lines.append(json.loads(f.read().strip().splitlines()[-1])
                             [rung])
        print(json.dumps({"upkeep": upkeep_triple(*lines)}))
        return 0
    rungs = [r for r in args.rungs.split(",") if r]
    unknown = sorted(set(rungs) - set(RUNGS))
    if unknown:
        ap.error(f"unknown rungs {unknown}")
    if len(set(rungs) & set(E2E_RUNGS)) > 1:
        ap.error(f"one of {', '.join(E2E_RUNGS)} per run: run each in its "
                 f"own process")
    out = {"metric": "aggregate_commits_per_sec", "value": None,
           "unit": "commits/s", "device": device_info(args.device)}
    groups = args.groups or GROUPS
    writes = 8 if args.writes is None else args.writes
    if "kernel" in rungs:
        g, p, e = args.kernel
        out["kernel"] = kernel_rung(args.device, g, p, e, iters=args.iters,
                                    scalar_groups=args.scalar_groups)
    if "kernel_100k" in rungs:
        g, p, e = args.kernel_100k
        out["kernel_100k"] = kernel_100k_rung(args.device, g, p, e)
    if "e2e" in rungs:
        out["e2e"] = asyncio.run(e2e_rung(
            e2e_cluster(args.device, groups), writes))
        out["value"] = out["e2e"]["commits_per_sec"]
    if "mesh_100k" in rungs:
        g, p, e = args.mesh_100k
        out["mesh_100k"] = mesh_100k_rung(args.device, g, p, e)
    # the mesh rung and its control (the JAX ladder runs them back to back,
    # each in its own child)
    for rung, mesh_n in (("sim_10240", 0), ("mesh", MESH_SLICES)):
        if rung in rungs:
            out[rung] = asyncio.run(e2e_rung(
                e2e_cluster(args.device, args.mesh_groups, "sim", mesh_n),
                MESH_WRITES, warmup=0))
    # the durable rungs: per-group segment files, the shared log plane
    for rung, shared in (("durable", False), ("shared", True)):
        if rung in rungs:
            with tempfile.TemporaryDirectory(prefix=f"ratis-{rung}-") as tmp:
                out[rung] = asyncio.run(durable_rung(
                    durable_cluster(args.device, groups, tmp, shared),
                    writes))
    if "churn" in rungs:
        out["churn"] = asyncio.run(churn_rung(
            churn_cluster(args.device, groups), writes))
    # the headline's window-depth sweep: [commits/s, p99 ms, occupancy]
    for rung, depth in WINDOW_DEPTHS.items():
        if rung in rungs:
            res = asyncio.run(e2e_rung(e2e_cluster(
                args.device, groups, props={WINDOW_DEPTH_KEY: str(depth)}),
                writes))
            res["sweep_entry"] = [res["commits_per_sec"], res["p99_ms"],
                                  res["window_occupancy"]]
            out[rung] = res
    # the sim ladder, and the upkeep dip pair
    ladder = {**{r: (g, w, c, None) for r, (g, w, c) in SIM_LADDER.items()},
              **{r: (g, w, CONCURRENCY, UPKEEP_PROPS)
                 for r, (g, w) in UPKEEP_LADDER.items()}}
    for rung, (g, w, conc, props) in ladder.items():
        if rung in rungs:
            out[rung] = asyncio.run(e2e_rung(
                e2e_cluster(args.device, args.groups or g, "sim",
                            props=props),
                w if args.writes is None else args.writes,
                concurrency=conc))
    if "telemetry" in rungs:
        out["telemetry"] = asyncio.run(e2e_rung(
            telemetry_cluster(args.device, groups), writes))
    if "traced" in rungs:
        out["traced"] = asyncio.run(e2e_rung(
            traced_cluster(args.device, groups), writes,
            trace_out=args.trace_out))
    # the upkeep plane and the sparse pair (tools/upkeep_bench.py)
    from ratis_tpu_torch.tools import upkeep_bench as ub
    if "upkeep" in rungs:
        settle = ub.UPKEEP_SETTLE_S if args.settle is None else args.settle
        out["upkeep"] = asyncio.run(ub.upkeep_rung(
            ub.upkeep_cluster(args.device, args.groups or ub.UPKEEP_GROUPS),
            settle, teardown=False))
    for rung, hibernate in (("sparse_hib", True), ("sparse_plain", False)):
        if rung in rungs:
            settle = (ub.SPARSE_SETTLE_S if args.settle is None
                      else args.settle)
            out[rung] = asyncio.run(e2e_rung(
                e2e_cluster(args.device, args.groups or ub.SPARSE_GROUPS,
                            "sim", hibernate=hibernate),
                ub.SPARSE_WRITES, warmup=0,
                settle=ub.hibernate_settle(settle),
                active_groups=args.active or ub.SPARSE_ACTIVE))
    if "chaos" in rungs:
        out["chaos"] = chaos_rung(args.device, args.chaos_seed, groups,
                                  args.artifact_dir)
    if "placement" in rungs:
        from ratis_tpu_torch.tools import placement_bench as pb
        load = pb.PLACEMENT
        out["placement"] = asyncio.run(pb.placement_rung(
            pb.placement_cluster(args.device, args.groups or load["groups"],
                                 load["servers"], load["element_limit"]),
            clients=args.clients or load["clients"],
            requests_per_client=load["requests_per_client"],
            pace_s=load["pace_s"], hot_pins=load["hot_pins"],
            settle_s=(load["settle_s"] if args.settle is None
                      else args.settle)))
    # the read rungs (tools/read_bench.py)
    from ratis_tpu_torch.tools import read_bench as rb
    if "readmix" in rungs:
        load = rb.READMIX
        out["readmix"] = asyncio.run(rb.readmix_rung(
            rb.read_cluster(args.device, groups, load["servers"]),
            writes=args.writes if args.writes is not None
            else load["writes"],
            concurrency=args.concurrency or load["concurrency"]))
    if "zipf" in rungs:
        load = rb.ZIPF
        limit = args.element_limit or load["element_limit"]
        out["zipf"] = asyncio.run(rb.zipf_rung(
            rb.read_cluster(args.device, groups, load["servers"], zipf=True,
                            element_limit=limit),
            clients=args.clients or load["clients"],
            concurrency=args.concurrency or load["concurrency"],
            element_limit=limit,
            unsat_clients=args.unsat_clients or load["unsat_clients"]))
    # BASELINE config 5's halves: InstallSnapshot catch-up under writes
    # (tools/snapshot_bench.py), and 7 peers end to end, traced
    if "snapcatch" in rungs:
        from ratis_tpu_torch.tools import snapshot_bench as sb
        load = sb.SNAPCATCH
        with tempfile.TemporaryDirectory(prefix="ratis-snapcatch-") as tmp:
            res = asyncio.run(sb.snapcatch_rung(
                sb.snapcatch_cluster(args.device, groups, tmp,
                                     loop_shards=args.loop_shards),
                writes=args.writes if args.writes is not None
                else load["writes"],
                concurrency=args.concurrency or load["concurrency"]))
        res["missed_installs"] = res["groups"] - res["installs"]
        # one line: the per-group maps as counts
        del res["counters"]
        res["snapshot_index"] = dict(sorted(collections.Counter(
            res["snapshot_index"].values()).items()))
        out["snapcatch"] = res
    if "peer7" in rungs:
        out["peer7"] = asyncio.run(e2e_rung(
            peer7_cluster(args.device, args.groups),
            PEER7["writes"] if args.writes is None else args.writes,
            warmup=PEER7["warmup"], trace_out=args.trace_out))
    # the north star as the multi-process deployment and in one process,
    # and the scalar controls; a run that does not finish is recorded as
    # a DNF with its error
    finishing = {"scalar": lambda: e2e_rung(
                 e2e_cluster(args.device, groups, batched=False), writes),
             "peer5_mp": lambda: peer5_mp_rung(
                 args.device, args.groups, args.writes, args.trace_out),
             "peer5_sp": lambda: e2e_rung(
                 peer5_cluster(args.device, args.groups),
                 PEER5["writes"] if args.writes is None else args.writes,
                 warmup=PEER5["warmup"], trace_out=args.trace_out),
             # the north star's scalar control (bench.py:784-787)
             "peer5_scalar": lambda: e2e_rung(
                 e2e_cluster(args.device, args.groups or PEER5["groups"],
                             PEER5["transport"], servers=PEER5["servers"],
                             batched=False),
                 PEER5["writes"] if args.writes is None else args.writes,
                 warmup=PEER5["warmup"])}
    for rung, run in finishing.items():
        if rung in rungs:
            try:
                out[rung] = asyncio.run(run())
            except Exception as e:
                out[rung] = {"dnf": f"{type(e).__name__}: {e}"[:4000]}
    # the FileStore rungs, each under its load in filestore_bench.LOADS
    from ratis_tpu_torch.tools import filestore_bench as fb
    for rung in fb.LOADS:
        if rung in rungs:
            out[rung] = fb.run_rung(rung, args.device, args.groups,
                                    args.seed)
    if "mix_fs" in rungs:
        out["mix_fs"] = fb.run_mix_fs(args.device, args.groups, args.seed)
    print(json.dumps(out), flush=True)
    failed = sum(r.get("streams_failed", 0) + r.get("read_mismatches", 0)
                 + r.get("replica_mismatches", 0)
                 + r.get("missed_installs", 0) + ("dnf" in r)
                 + r.get("transfers_failed", 0)
                 for r in out.values() if isinstance(r, dict))
    return 1 if failed else 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # the upkeep rung leaves its divisions up (3 x 10240): the process ends
    # here without unwinding them, as the JAX bench's measurement children
    # do
    os._exit(code)
