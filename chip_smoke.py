#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--groups 1024] [--writes 2] [--seed 0] [--out FILE]

Phases, in order; any failure raises, prints ``chip_smoke: FAILED in
phase <name>: <error>`` on stdout and stderr, exits non-zero and prints
no result line:

1. environment: the card's name and power limit (nvidia-smi), CUDA present,
   which msgpack the wire codec uses;
2. build: nvcc compiles the kernels from this checkout's sources;
3. kernel parity: K1-K6 against their plain-torch versions on the
   same CUDA inputs, several seeds with the edge cases of
   ``ratis_tpu_torch.tools.cases`` (negative indices included), K6 also
   on the bench's own batches at its three shapes, its inputs unchanged;
   K5 at 1, 2 and 8 slices with rows past and before the slice and padding
   columns, equal to K1 at one slice, and on the mesh100k rung's batch
   (also equal to K1 on the same acks unrouted); the redesigned K1 and K5
   (one launch each, the tile kernel of K2) at 3, 5, 8 and 16 peers, K1
   at G = 1 to 102400 and E = 64 and 16384, K5 at 1, 2 and 8 slices of G
   / S rows a multiple of the tile and not, every tile size, each case
   also through the engine's prepared call (``FastPlan``); the
   redesigned K2 (one
   launch) at 3, 5, 8 and 16 peers, G = 1 to 102400, every tile size,
   each case also through the engine's prepared call, and K3 (the row
   entry the engine runs) on gathered rows at every peer count, padded to
   the engine's bucket with stale rows, through the prepared call and on
   the packed tensors; K3's public [G, P] entry (``K3_public``) and K7a-c
   (the vote-reply scatter, the all-members replicated index, the lease
   expiry) at G = 1024 and 102400 with P = 8, at P = 3, 5, 7 and 16 (K7b
   and K3 public at 1024 and 102400 rows), and at G = 1001 and 1023, with
   the edge cases of ``cases.vote_event_edges``, every vote event on one
   row, the wrapping lease timeouts, K7b's rows of no self bit and of two
   and K3's ``cases.tally_edges`` (the redesigned K7a and K3 public
   through their launch rules and forced to each of their two designs);
   the redesigned K4 (one
   cooperative launch) at G = 1024, 1000 and 10240 with tables of 8, 16
   and 512 peers (512: the
   counters do not fit in shared memory and go straight to the output)
   and ``big_cell``, each case also through the engine's prepared call
   (``LedgerPlan``); the redesigned K6 (one launch) also at
   P = 3, 5, 7 and 16, and at G = 1001 and 1023 (no multiple of 4);
   the bar is exact equality;
4. the main paths, each with its kernels' launch counts zeroed just
   before and read just after (each must be > 0; K5 must stay 0 on the
   paths without a mesh):
   a. simulated transport: 3 port servers x ``--groups`` groups on
      ``cuda`` with the batched properties, leaders by election,
      ``--writes`` INCREMENTs per group through the port's RaftClient,
      every counter read back from all three replicas (K1-K4);
   b. the bench's kernel rungs (``tools/bench.py``): the stateless tick
      at 10240 x 8 x 4096 and 102400 x 8 x 8192 (K6);
   c. the bench's headline e2e rung over real localhost TCP sockets:
      3 servers x 1024 groups, one warm-up write and 2 writes per group,
      every write acknowledged and every counter read back equal from all
      three replicas (K1-K4; the cluster is prewarmed before the counts
      are zeroed); a socket that cannot bind fails the run;
   d. the mesh path: 3 servers x 1024 groups with ``mesh-devices=8`` over
      the simulated transport, 2 INCREMENTs per group, every counter read
      back from all three replicas, 8 slices on every server (K5, K2, K3
      and K4 > 0; K1 must stay 0: a mesh engine's fast ticks are K5);
      then ``dryrun_multichip(8)`` and the bench's ``mesh_100k`` rung
      (K5 against the flat K1 at 102400 x 8 x 8192);
   e. ``durable_1024``, the bench's ``durable`` rung: 3 servers x 256
      groups (the bench: 1024) over localhost TCP on the server's default
      durable log
      (per-group segment files in a fresh temporary directory),
      ``ArithmeticStateMachine``, 1 + 1 writes per group at 128 in
      flight; every replica's variable map equal to the fold of the
      acknowledged writes, then a full restart from disk and the same
      check (K1-K4 > 0, K5 0); fsyncs per commit, each server's fsync
      seconds in the measured writes (its log workers' ``syncTime``) and
      their share of the writes, and the storage's filesystem are
      printed; then, before the storage is removed,
      ``python -m ratis_tpu_torch.tools.parse_log`` on the segment files
      of one group's division on one server: the entries it counts must
      equal that division's log;
   f. ``shared_256``: the same on the shared log plane
      (``raft.tpu.log.shared``) at 3 x 256 groups;
   g. ``churn_1024``, the bench's ``churn`` rung: 3 x 1024 over the
      simulated transport, 4 writes per group while 64 leadership
      transfers run and 8 groups each go through a joint-consensus round;
      every write acknowledged and every counter read back in the final
      configuration (K1-K4 > 0, K5 0, and K1/K2 launched while the
      calling engine led a row with a non-empty ``conf_old`` more than 0
      times);
   h. ``stream``, the bench's ``stream`` rung: 4 streams of 32 MB at once
      (1 MB packets, window 32) into 3 servers x 4 FileStore groups, the
      DataStream plane over localhost TCP; every stream acknowledged and
      its bytes (seeded, ``--seed``) equal on all three replicas (K1-K4 >
      0, K5 0);
   i. ``filestore5_1024``, the bench's ``filestore5`` rung (BASELINE
      config 3) at 1024 groups: 5 servers over localhost TCP,
      ``FileStoreStateMachine``, DataStream on every server; one warm-up
      write of a 128-byte file per group and every replica's files held to
      it, one measured write per group and the files held again, then 16
      streams of 4 MB (window 32) and the files held again on all five
      replicas (K1-K4 > 0, K5 0, and the vote passes tallied rounds of 5
      members);
   j. ``telemetry_1024``, the bench's ``telemetry`` rung (the TCP
      headline's deployment with the telemetry sampler on, one sample a
      second; 1 + 2 writes per group) with every server's HTTP endpoint on
      a port it binds: every
      route (``/metrics``, ``/health``, ``/divisions``, ``/events``,
      ``/lag``, ``/timeseries``, ``/hotgroups``, ``/flightrecorder``)
      fetched over HTTP from every server during the measured writes and
      after them, each answering 200 and parsing; ``/timeseries`` holding a
      sample for each second of the writes but one; after the writes
      settle, every row a server leads carrying its division's own commit
      index in the ledger sample its ``/lag`` request took; then the
      shell's HTTP commands as subprocesses against the servers' ports
      (``python -m ratis_tpu_torch.shell health``, ``lag``, ``top
      -iterations 1``): ``lag`` and ``top`` must exit 0 and list every
      server, ``health``'s exit code and the watchdog events it counts are
      printed (it exits 1 on any journaled event) (K1-K4 > 0, K5 0);
   k. ``sparse_4096``: 3 servers x 4096 groups over the simulated
      transport with hibernation and the upkeep plane
      (``raft.tpu.upkeep.enabled``) on; settled until every idle leader
      sleeps (at most 20 s; some must), the upkeep tick pair timed on the
      live divisions (the plane's sweep against the legacy walk), the
      plane's registered slots equal to the 12288 divisions; then 4
      writes per group on the first 1024 groups at 128 in flight and
      every counter read back from all three replicas (4 on the written
      groups, 0 on the others); the stale verdicts the engine skipped for
      hibernating leaders are counted (K1-K4 > 0, K5 0);
   l. ``chaos_1024``, the bench's ``chaos`` rung: the campaign of 12
      scenarios (``chaos/campaign.py`` ``run_chaos_1024``, seed 1) on 3 x
      256 counter groups (the bench: 1024) over the simulated transport
      on the shared
      durable log in a fresh temporary directory; every scenario must pass
      its SLOs and every injected fault be journaled and recovered; the
      servers a crash rebuilds are counted too (K1-K4 > 0, K5 0); it runs
      in a process of its own (``chip_smoke.py --path chaos_1024``),
      started after phase 3 and running beside a-k, which counts its own
      launches and reports them with its recorder's shapes and samples
      (its scenarios' fault holds took 330-360 s of a run that went past
      the 1200 s limit);
   m. ``placement_48``, the bench's ``placement`` rung: 4 servers x 48
      groups over localhost TCP, 384 zipf clients (3 write+read pairs
      each, 0.25 s apart) with a pinned hotspot and a grey follower, phase
      OFF, then a placement controller on every server, 3 s of settle and
      phase ON; no request may fail and the controllers
      must have planned (K1-K4 > 0, K5 0);
   n. ``readmix_1024``, the bench's ``readmix`` rung at its full size: 3
      servers x 1024 groups over localhost TCP, CounterStateMachine,
      memory log, linearizable reads with the leader lease, 4 writes per
      group each chased by a lease read at the leader and a linearizable
      and a stale read at a follower, 128 in flight; every read value
      within the group's writes acknowledged and sent, every replica's
      counter within them after the load (0 read and 0 replica
      mismatches), failures within the JAX rung's bounds; per server the
      reads served beside the readIndex confirmation sweeps (K1-K4 > 0,
      K5 0; K7c too: the lease expiry is computed on the host, as in the
      reference);
   o. ``zipf_1024``, the bench's ``zipf`` rung at its full size: 3 x 1024
      over TCP, 10240 clients with zipf(1.1) homes, a write and a
      linearizable read each, 512 in flight, admission control at 192
      pending elements, telemetry at 250 ms, after an unsaturated phase of
      256 clients; the same read and replica checks, fleet failures within
      the rung's bound and the pending peak at or under 192; shed
      fraction, overload p99 ratio and the sketch's hot group against the
      expected one are printed (K1-K4 > 0, K5 0);
   p. ``snapcatch_1024``, the bench's ``snapcatch`` rung at its full size
      (``tools/snapshot_bench.py``, the InstallSnapshot half of BASELINE
      config 5): 3 servers x 1024 groups over localhost TCP, snapshot
      storage in a fresh temporary directory; the last server's
      leaderships moved to the first, 4 writes a group, every leader (and
      the other surviving replica) snapshots and purges, the last
      server's 1024 replicas wiped (removed and added afresh on the engine
      rows they released), 4 writes a group again at 128 in flight while
      the leaders install their snapshots; every wiped group must catch up
      (deadline 600 s), ``installs`` must be 1024, the wiped engine must
      hold 1024 live rows, every counter on all three servers must equal
      both loads' acknowledged writes, and the commits/s during the
      installs must stay above a quarter of those before (the ratio is
      printed) (K1-K4 > 0, K5 0);
   q. ``peer7_1024``, the bench's ``peer7`` rung cut to 1024 groups and 2
      writes a group (the bench: 2048 and 4): 7 servers x 1024 groups over
      the simulated transport, no warm-up, 128 in flight, every 32nd
      write traced; every write acknowledged and every counter read back
      from all 7 replicas, the host-path decomposition printed, the vote
      rounds counted by their members (K1-K4 > 0, K5 0);
   r. ``mp5_1024``, the bench's ``peer5_mp`` rung (``tools/bench.py``,
      ``tools/multiproc_bench.py``) cut to 1024 groups (the bench: 10240):
      5 server processes over localhost TCP, each with its own engine on
      the card and its divisions on 3 loop shards, the load from 4 client
      processes (2 and 2 on a host of fewer than 8 CPUs), leaders
      appointed by server 0, 2 writes a group at 128 in flight, every 32nd
      write traced; every write acknowledged (or failures within the JAX
      harness's bound), every counter on all 5 servers between its
      group's writes acknowledged and sent, no client process touching
      CUDA, the merged snapshot of the 5 servers' HTTP endpoints with 5
      pids, all healthy, the merged trace over at least 2 pids, and no
      child process left; after the load each server takes one group's
      leadership by a transfer (its own election); each server process
      counts its own launches from after its prewarm and reports them
      (K1-K4 > 0, K5-K7 and the public K3 0 in every one), with none of
      its prepared calls made off its home loop's thread, the shapes its
      kernels were given (checked in phase 5) and its ledger samples;
   s. ``scalar_512``, the bench's ``scalar`` rung (the TCP headline's
      scalar control, ``cluster_properties(batched=False)``: a 2 ms tick
      that never leaves the per-division host loop, one RPC per group and
      follower, no coalescing, no replication sweep) at c's writes cut to
      3 servers x 512 groups (the bench: 1024) over localhost TCP, one
      warm-up write and 2 writes per group at 128 in flight; every write
      acknowledged and
      every counter read back from all three replicas, every engine on
      the card, K1, K2, K3 and K5 launched 0 times and K4 once per ledger
      sample of the phase; then the batched deployment at the same shape
      and load, a control outside the phase's counts; the scalar
      control's commits/s, p99 and election timeouts and the batched
      control's commits/s over its own are printed (not gated); like l
      it runs in a process of its own (``chip_smoke.py --path
      scalar_512``), started after c and running beside d-k;
   t. ``profile_256``: 3 servers x 256 groups over the simulated
      transport, the batched deployment, 2 writes per group, with
      ``raft.tpu.engine.profile-dir`` in a fresh temporary directory: the
      first engine owns the process's ``torch.profiler`` session (CPU and
      CUDA activity) and names each tick ``engine_tick``; after the close
      exactly one trace file, with ``engine_tick`` ranges and kernel
      events of ``tile_tick``, and no engine owning a session (K1-K4 > 0,
      K5 0);
   on every served path (a, c-t) each ledger sample (the watchdogs', the
   telemetry samplers', the placement controllers' and each ``GET
   /lag``'s) must make exactly one call into the kernel library, its
   prepared call's, and launch K4 once;
   Before the paths, one K2 call captured in a CUDA graph, which must
   hold exactly one node, the kernel ``tile_tick`` on K2's refresh
   events, and one K1 call and one K5 call, each one node, ``tile_tick``
   on the fast events; one K4 call and one K6 call, each one kernel node,
   and one call of K4's prepared call, its two copies around one kernel;
   one K7a call (by its rule and forced to each design), one K7c call,
   one K7b call and one call of K3's public entry (the last two also at
   102400 rows), each one kernel node; one call of K3's row entry, its
   nodes counted (every kernel's count is its ``nodes`` in the kernels
   line);
5. kernel parity again at every shape the main paths gave K1-K5 (K3 at
   every padded row count of the vote passes; on the ``filestore5_1024``
   and ``mp5_1024`` paths' shapes (the latter as the server processes
   reported them) also with every row's conf of exactly 5 members, on the
   ``peer7_1024`` path's with 7 of the 8 lanes and on the
   ``snapcatch_1024`` path's, after its rows' reuse, with 3), and
   K1 and K2 on the sleeping-rows family (``cases.sleeping_state``: most
   rows asleep, deadlines 60000-62000 ms ahead or INT32_MAX, leaders
   whose acks stopped, few acks) at 4096 and 16384 rows, through the
   public wrappers and the prepared calls, at a mid-epoch clock and at
   one where the armed deadlines clamp; the
   engine's own routes on one card engine of 1024 rows, host clock,
   median of 200: the refresh dispatch (K2's prepared call, D = E = 64)
   and its prepared call alone, the fast dispatch (K1's prepared call,
   64 acks), its prepared call alone and the earlier route (pack,
   ``upload``, the wrapper, ``.cpu()``) as the same-run control, the same
   three on a mesh engine of 8 slices (K5), the vote pass at R = 1, 64,
   1024 open rounds and its tally alone (K3's prepared call) beside the
   earlier tally of all G rows; one refresh tick, one fast tick and one
   vote pass must each make exactly one call into the kernel library, the
   refresh tick one K2 launch, a flat fast tick one K1 launch, a mesh
   fast tick one K5 launch and no K1; the ledger sample (K4's prepared
   call) on the flat and the mesh engine, its prepared call alone and the
   earlier route (``upload``, the wrapper, ``.cpu()``), a sample checked
   to be one library call and one K4 launch; then timing: K1-K5 at their most
   common shape
   (K3 at the vote passes' most common padded R, ``K3_public`` at G; K5
   also at the mesh100k rung's), K6 at both rung shapes; CUDA events, warm-up,
   median of 200 calls (K1/K2/K5 each on the same fresh state), beside
   the plain version's time (median of 20 calls) and the card's bound
   for the same work, each one's device time per call from 20 calls
   captured in a CUDA graph and replayed between CUDA events, and its
   host time per call issued back to back; K1 also with each tile
   size at G = 1024, 10240, 102400 and E = 64, 16384, and on the mesh100k
   rung's flat control (102400 x 8 x 8192); K7a-c at G = 1024, P = 8
   (K7a with 2048 events), K7a-c and ``K3_public`` again at G = 102400
   (``K7a_100k`` with 204800 events, ``K7b_100k``, ``K7c_100k``,
   ``K3_public_100k``; no path calls K7 or ``K3_public``:
   every path's
   run checks that they launched 0 times, so phases 3 and 5 make all of
   their launches); K2 also with each
   tile size at G = 1024, 10240, 102400 and (D, E) = (64, 64), (1024,
   16384); K1 and K2 once more, each call after the state restore, a
   synchronisation and a 1 ms idle gap, event ms beside the call's host
   ms;
6. one JSON line of kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

It needs one CUDA card and nothing else of the machine but nvcc; it
builds into ``ratis_tpu_torch/_build/`` and starts no process that
outlives it.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ratis_tpu_torch.tools.fast_tick_timing import (K6_SHAPES,
                                                     engine_padded, graph_us,
                                                     host_us,
                                                     ledger_earlier_route,
                                                     tally_design, timed,
                                                     timed_host, vote_design)
from ratis_tpu_torch.tools.plan_recorder import (ShapeRecorder,
                                                 kernel_launchers)

P = 8
NOW = 100_000
TIMEOUT_MS = 300
# the bench's headline e2e rung: 3 servers x 1024 groups over TCP, one
# warm-up write and then 2 measured writes per group (the bench writes 8;
# the smoke cuts writes, never groups, to stay inside its time limit)
TCP_GROUPS = 1024
TCP_WRITES = 2
# H100 SXM published peaks: HBM bytes/s, and the INT32 rate (132 SMs x
# 64 INT32 lanes x 1.98 GHz, a multiply-add counted as two, as NVIDIA
# counts it), against which the kernels' integer ops count
HBM_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 33.5e12

KERNELS = (
    # name, wrapper attribute, source, the JAX function it replaces
    ("engine_step_resident_fast", "K1",
     "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:394"),
    ("engine_step_resident", "K2",
     "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:325"),
    ("tally_votes", "K3", "ratis_tpu_torch/ops/kernels/tally_votes.cu",
     "ratis_tpu/ops/quorum.py:144"),
    ("tally_votes_public", "K3_public",
     "ratis_tpu_torch/ops/kernels/tally_votes.cu",
     "ratis_tpu/ops/quorum.py:144"),
    ("ledger_pass", "K4", "ratis_tpu_torch/ops/kernels/ledger_pass.cu",
     "ratis_tpu/ops/ledger.py:68"),
    ("engine_step_resident_fast_sliced", "K5",
     "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:465"),
    ("engine_step", "K6", "ratis_tpu_torch/ops/kernels/resident_step.cu",
     "ratis_tpu/ops/quorum.py:257"),
    ("apply_vote_events", "K7a", "ratis_tpu_torch/ops/kernels/vote_lease.cu",
     "ratis_tpu/ops/quorum.py:501"),
    ("all_replicated_min", "K7b",
     "ratis_tpu_torch/ops/kernels/vote_lease.cu",
     "ratis_tpu/ops/quorum.py:110"),
    ("lease_expiry", "K7c", "ratis_tpu_torch/ops/kernels/vote_lease.cu",
     "ratis_tpu/ops/quorum.py:208"),
)
# kernels no path of the server launches: K7 (none of the JAX package's
# paths calls it) and K3's public [G, P] entry (the engine's vote pass
# runs K3's row entry); every path checks that they launched 0 times
K7 = ("K7a", "K7b", "K7c")
OFF_PATH = ("K3_public", *K7)
K7_PEERS = (3, 5, 7, 16)
K7_VOTE_EDGES = ((4, 3), (2, 3), (16, 8), (8, 16), (1024, 8))
# K7a and K7c also at rows that fill no multiple of 4
K7_ODD_ROWS = (1001, 1023)
# the redesigned K1, K2, K5 (one launch per tick of one tile kernel) and
# K3 (gathered rows): peers and tile sizes held against the plain
# versions (and the tiles timed)
K2_PEERS = (3, 5, 8, 16)
TILES = (32, 128)
REDESIGNED = {
    "K1": "redesigned: one launch per tick (row tiles in shared memory, the "
          "kernel of K2); the engine's fast tick is one prepared call",
    "K5": "redesigned: one launch per tick (row tiles in shared memory, each "
          "block scanning only its slices' planes); a mesh engine's fast "
          "tick is one prepared call",
    "K2": "redesigned: one launch per tick (row tiles in shared memory); the "
          "engine's refresh tick is one prepared call",
    "K3": "redesigned: the engine's vote pass tallies only the open rounds' "
          "rows, packed as bit words, in one prepared call",
    "K4": "redesigned: one cooperative launch (a lane per link, counters "
          "in shared memory, one grid sync); a ledger sample is one "
          "prepared call",
    "K6": "redesigned: one launch (each block lists the acks landing in "
          "its rows, then copies and runs them), its outputs views of one "
          "buffer",
    "K7a": "redesigned: one launch, no copy node (blocks owning rows copy "
           "them and land the events listed there, or one cooperative "
           "launch with one grid sync, by G, P, E), its masks views of one "
           "buffer",
    "K7c": "redesigned: one launch, each row's peer slots over 8 lanes "
           "(one or two a lane; ranks by shuffles, the majority member by "
           "a ballot)",
    "K7b": "redesigned: one launch, each row's peer slots over 8 lanes "
           "(one or two a lane, every load issued before any is used; the "
           "row's min by three shuffle steps, the empty union by a ballot)",
    "K3_public": "redesigned: one launch by one of two designs, by G: "
                 "rows of 8 lanes (five ballots give a row's bit words) "
                 "or tiles of 128 rows staged in shared memory, one thread "
                 "a row; the verdict shared with K3's row entry"}
# why no kernel has a library time: no one PyTorch call computes the same
# function (``library_ms`` null in the kernels line)
_TICK = ("none: no one PyTorch call scatter-maxes the acks and takes each "
         "row's majority-min, timeouts and staleness")
NO_LIBRARY = {
    "K1": _TICK, "K2": _TICK + " (after the refreshed rows)", "K5": _TICK,
    "K6": _TICK + " (into copies)",
    "K3": "none: no one PyTorch call tallies masked vote majorities with a "
          "priority veto",
    "K3_public": "none: as K3",
    "K4": "none: no one PyTorch call gives the per-row gap, delta and worst "
          "link with the per-peer histogram and rollups",
    "K7a": "none: no one PyTorch call scatters vote replies gated on the "
           "input masks",
    "K7b": "none: a masked min over the conf union is a where and an amin, "
           "two calls",
    "K7c": "none: no one PyTorch call takes the lease's majority-min with "
           "its wrapping expiry"}
# the durable paths: 3 x 256 per-group logs (the bench: 1024), 3 x 256 on
# the shared plane, 1 warm-up + 1 measured write per group (the bench: 8);
# the churn path: 3 x 1024, 4 writes per group (the bench: 8)
DURABLE_GROUPS = 256
SHARED_GROUPS = 256
DURABLE_WRITES = 1
CHURN_GROUPS = 1024
CHURN_WRITES = 4
# K6: the other peer counts it is held at (at the first two of
# K6_SHAPES, entry() and the bench's two kernel rungs)
K6_PEERS = (3, 5, 7, 16)
# K4: rows and table widths held against the plain version (W = 512: the
# counters do not fit in shared memory and go straight to the output)
K4_ROWS = (1024, 1000, 10_240)
K4_WIDTHS = (8, 16, 512)
# the mesh path: 3 servers x 1024 groups in 8 slices, 2 writes per group.
# Capacity 2048, not the bench's bucket of 1024: divisions pin to their
# crc32 slice, which fills 8 slices of 128 rows unevenly, and a full slice
# refuses its group (the bench's 10240 rung has 16384 rows)
MESH_GROUPS = 1024
MESH_SLICES = 8
MESH_MAX_GROUPS = 2048
MESH_WRITES = 2
# the FileStore paths (BASELINE config 3): the stream rung as the bench runs
# it; 5 servers x 1024 groups over TCP, one warm-up write and one write per
# group, then 16 streams of 4 MB (window 32); the telemetry path: the TCP
# headline's deployment with the sampler on and every server's HTTP
# endpoint on a port it binds, fetched during and after the writes (1 + 2
# writes per group; the bench: 1 + 8)
FS5_GROUPS = 1024
FS5_SERVERS = 5
FS5_WRITES = 1
TEL_GROUPS = 1024
TEL_WRITES = 2
# the telemetry path's wait for a ready leader in every group after the writes
TEL_SETTLE_S = 60.0
# the sparse path: 3 servers x 4096 hosted groups over the simulated
# transport, hibernation and the upkeep plane on, settled until the idle
# leaders sleep (at most the JAX sparse rung's 20 s), then 4 writes per
# group on the first 1024 at 128 in flight (the bench: 8)
SPARSE_GROUPS = 4096
SPARSE_ACTIVE = 1024
SPARSE_WRITES = 4
SPARSE_SETTLE_S = 20.0
# the placement path: the bench's placement rung with 3 write+read pairs
# a client and a 3 s settle (the bench: 6 and 6 s)
PLACEMENT_REQUESTS = 3
PLACEMENT_SETTLE_S = 3.0
# the chaos path: the bench's chaos rung (run_chaos_1024, 12 scenarios)
# at its seed; its scenario count
CHAOS_SEED = 1
CHAOS_SCENARIOS = 12
# cut to 256 groups (the bench: 1024) for the smoke's time, every scenario
# kept
CHAOS_GROUPS = 256
# the chaos process (``PathProcess``) fails past this many seconds
CHAOS_TIMEOUT_S = 900.0
# the sleeping-rows parity family: sparse paths' buckets (4096, and the
# bench's 16384), and a clock late in the epoch where
# now + 62000 passes INT32_MAX and the armed deadlines clamp
SLEEP_ROWS = (4096, 16_384)
LATE_NOW = 2 ** 31 - 61_000
# the read paths: the bench's readmix and zipf rungs at their full sizes
# (tools/read_bench.py READMIX and ZIPF: 3 servers x 1024 groups over
# TCP, linearizable reads with the leader lease)
READ_GROUPS = 1024
# BASELINE config 5's halves: the bench's snapcatch rung at its full size
# (tools/snapshot_bench.py SNAPCATCH), and its peer7 rung cut to 1024
# groups and 2 writes a group (the bench: 2048 and 4)
PEER7_GROUPS = 1024
PEER7_WRITES = 2
# the multi-process deployment: the bench's peer5_mp rung cut to 1024
# groups (the bench: 10240), 2 writes a group as there
MP5_GROUPS = 1024
MP5_WRITES = 2
# its bring-up and load each fail past this (the harness's defaults are
# 900 s and 1200 s)
MP5_TIMEOUT_S = 240.0
# the headline's scalar control: the bench's scalar rung at the TCP
# path's writes (1 + TCP_WRITES a group) cut to 3 x 512 (the bench:
# 1024).  At 1024 its one loop, walking every group each 2 ms tick beside
# 6144 heartbeat streams, held the phase for 229 s alone (18.2 commits/s),
# which the smoke's time cannot take on a slow card host, and beside the
# other phases a write starved past the JAX write budget
SCALAR_GROUPS = 512
# the scalar process (``PathProcess``) fails past this many seconds
SCALAR_TIMEOUT_S = 600.0
# the engine's profiler hook: 3 x 256 over the simulated transport, the
# batched deployment, 2 writes a group, no warm-up
PROFILE_GROUPS = 256
PROFILE_WRITES = 2
# this checkout's root: the shell and parse_log run from it as
# subprocesses (``python -m ratis_tpu_torch...``)
ROOT = pathlib.Path(__file__).resolve().parent


def log(*a) -> None:
    print(*a, flush=True)


# seconds since the start at the end of each phase (``mark``)
PHASE_END_S = {}
# the phase running now (``begin``): a failure names it
RUNNING = ["1 environment"]


def begin(phase: str) -> None:
    RUNNING[0] = phase


def mark(phase: str, t_start: float) -> None:
    PHASE_END_S[phase] = time.monotonic() - t_start
    log(f"phase {phase} done at {PHASE_END_S[phase]:.1f} s")


def max_abs_err(got, want) -> int:
    err = 0
    for x, y in zip(got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def cuda(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


# -- phases 3 and 5: parity ----------------------------------------------------

def fast_plan_err(tq, cases, st, ev_np, sliced, k, a, now=NOW):
    """The engine's prepared call (``FastPlan``) on the tick ``ev_np``
    packed into its buffer, on a fresh copy of the state ``st``, against
    the public wrapper's result ``k`` and state ``a``."""
    c = tq.device_state_from_numpy(st, "cuda")
    pl = cases.fast_plan(c, ev_np, sliced)
    out = torch.from_numpy(pl.run(ev_np.shape[-1], now, TIMEOUT_MS).copy())
    return max_abs_err([out.cuda(), *c], [k.out, *a])


def parity_k1(tq, cases, g, p, e, seed, negative=False, plan=False,
              hot=False, engine_padding=False, members=None,
              sleeping=False, now=NOW):
    """K1's public wrapper (one launch) against its plain version; with
    ``plan``, also the engine's prepared call on the same tick, against
    the wrapper; with ``hot``, every ack aimed at three rows of one tile
    (``cases.hot_acks``); with ``engine_padding``, padded as the engine
    pads (``fast_tick_timing.engine_padded``); with ``members``, every
    row's conf of exactly that many peers; with ``sleeping``, a
    hibernated fleet's rows and tick (``cases.sleeping_state``,
    ``sleeping_events``) at clock ``now``."""
    rng = np.random.default_rng(seed)
    if sleeping:
        st = cases.sleeping_state(rng, g, p, now, members)
        ev_np = cases.sleeping_events(rng, g, p, e, now)
    else:
        st = cases.resident_state(rng, g, p, now, members)
        ev_np = cases.fast_events(rng, g, p, e, now, negative)
    if hot:
        cases.hot_acks(rng, ev_np)
    if engine_padding:
        engine_padded(ev_np)
    ev, meta = cuda([ev_np, np.array([now, TIMEOUT_MS], np.int32)])
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident_fast(a, ev, meta)
    want = tq._resident_fast_plain(b, ev, meta)
    err = max_abs_err([k.out, *a], [want, *b])
    if plan:
        err = max(err, fast_plan_err(tq, cases, st, ev_np, False, k, a,
                                     now))
    return err


def parity_k2(tq, cases, g, p, d, e, seed, negative=False, plan=False,
              members=None, sleeping=False, now=NOW):
    """K2's public wrapper (one launch) against its plain version; with
    ``plan``, also the engine's prepared call on the same tick packed into
    a plan's buffer, against the wrapper; ``members``, ``sleeping`` and
    ``now`` as K1's (``cases.sleeping_refresh``)."""
    rng = np.random.default_rng(seed)
    if sleeping:
        st = cases.sleeping_state(rng, g, p, now, members)
        rf_idx_np, rf_np, acks_np = cases.sleeping_refresh(rng, g, p, d, e,
                                                           now)
    else:
        st = cases.resident_state(rng, g, p, now, members)
        rf_idx_np, rf_np, acks_np = cases.refresh(rng, g, p, d, e, now,
                                                  negative)
    rf_idx, *rf = cuda([rf_idx_np, *rf_np])
    acks = cuda(acks_np)
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident(a, rf_idx, *rf, *acks, now, TIMEOUT_MS)
    want = tq._resident_refresh_plain(b, rf_idx, rf, acks, now, TIMEOUT_MS)
    err = max_abs_err([torch.stack(k[1:]), *a], [want, *b])
    if plan:
        c = tq.device_state_from_numpy(st, "cuda")
        pl = cases.refresh_plan(c, rf_idx_np, rf_np, acks_np)
        out = torch.from_numpy(pl.run(d, e, now, TIMEOUT_MS).copy()).cuda()
        err = max(err, max_abs_err([out, *c], [torch.stack(k[1:]), *a]))
    return err


def parity_k5(tq, cases, g, p, s, e, seed, negative=False, plan=False,
              hot=False, engine_padding=False, members=None):
    """K5 against its plain version; at one slice also against K1 on the
    same plane; with ``plan``, also the engine's prepared call on the same
    tick, against the wrapper; with ``hot``, every ack aimed at three rows
    of each slice (``cases.hot_acks``); with ``engine_padding``, padded as
    the engine pads (``fast_tick_timing.engine_padded``); ``members`` as
    K1's."""
    rng = np.random.default_rng(seed)
    st = cases.resident_state(rng, g, p, NOW, members)
    ev_np = cases.sliced_events(rng, g, p, s, e, NOW, negative)
    if hot:
        cases.hot_acks(rng, ev_np)
    if engine_padding:
        engine_padded(ev_np)
    ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
    a = tq.device_state_from_numpy(st, "cuda")
    b = tq.device_state_from_numpy(st, "cuda")
    k = tq.engine_step_resident_fast_sliced(a, ev, meta)
    want = tq._resident_fast_sliced_plain(b, ev, meta)
    err = max_abs_err([k.out, *a], [want, *b])
    if plan:
        err = max(err, fast_plan_err(tq, cases, st, ev_np, True, k, a))
    if s == 1:
        c = tq.device_state_from_numpy(st, "cuda")
        k1 = tq.engine_step_resident_fast(c, ev[:, 0].contiguous(), meta)
        err = max(err, max_abs_err([k.out, *a], [k1.out, *c]))
    return err


def parity_k5_rung(tq, bench):
    """K5 on the mesh100k rung's batch against its plain version, and
    against K1 on the same acks with global rows."""
    state, evs, evf, meta = bench.mesh100k_batch()
    ev_s, ev_f, mt = cuda([evs, evf, meta])
    a, b, c = (tq.device_state_from_numpy(state, "cuda") for _ in range(3))
    k = tq.engine_step_resident_fast_sliced(a, ev_s, mt)
    want = tq._resident_fast_sliced_plain(b, ev_s, mt)
    k1 = tq.engine_step_resident_fast(c, ev_f, mt)
    return max(max_abs_err([k.out, *a], [want, *b]),
               max_abs_err([k.out, *a], [k1.out, *c]))


def parity_k6(tq, args_np):
    """K6 against its plain version on the same card tensors; raises if
    the kernel wrote any of its inputs (it is functional, as in JAX)."""
    args = tq.engine_step_args_from_numpy(args_np, "cuda")
    before = [t.clone() for t in args[:15]]
    k = tq.engine_step(*args)
    want = tq._engine_step_plain(*args)
    torch.cuda.synchronize()
    for (name, _, _), x, y in zip(tq.ENGINE_STEP_ARRAYS, args, before):
        if not torch.equal(x, y):
            raise AssertionError(f"K6 wrote its input {name}")
    return max_abs_err(list(k), list(want))


def parity_k3(tq, cases, g, p, seed):
    return parity_k3_public(tq, cases.tally_inputs(
        np.random.default_rng(seed), g, p))


def parity_k3_rows(tq, cases, g, p, r, cap, seed, members=None):
    """K3 (the row entry) on ``r`` gathered rows packed as the engine's
    vote pass packs them, padded to ``cap`` rows with stale rows: through
    the engine's prepared call and launched on the packed tensors, each
    against the plain tally of the same ``cap`` rows; ``members`` as
    K1's."""
    rng = np.random.default_rng(seed)
    arrays = cases.tally_inputs(rng, g, p, members)
    rows = np.sort(rng.permutation(g)[:r])
    plan = cases.tally_plan(arrays, rows, "cuda", cap)
    got = torch.from_numpy(plan.run(cap).copy()).cuda()
    v = plan.views(cap)
    k = tq.tally_rows(*cuda([v.masks, v.priority, v.self_priority]))
    full = cases.padded_rows(rows, cap, g)
    want = tq._tally_plain(*cuda([a[full] for a in arrays]))
    return max_abs_err([got, k], [want, want])


def parity_k4(tl, cases, g, p, width, seed, big_cell=False, plan=False,
              members=None):
    """K4's wrapper against its plain version on the same card tensors;
    with ``plan``, also the engine's prepared call on the same inputs
    written into its buffer (a plan built for a table of 8, so a wider
    one grows it); ``members`` as K1's."""
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(seed), g, p,
                                          width, big_cell=big_cell,
                                          members=members)
    dev = cuda(arrays)
    want = tl._ledger_plain(*dev, *scalars, width)
    got = [tl.ledger_pass(*dev, *scalars, num_peers=width)]
    if plan:
        pl = tl.LedgerPlan(g, p, "cuda")
        for v, a in zip(pl.views, arrays):
            np.copyto(v, a)
        got.append(torch.from_numpy(pl.run(width, *scalars).copy()).cuda())
    return max_abs_err(got, [want] * len(got))


def parity_k7a(tq, arrays):
    """K7a against its plain version, through the wrapper's own launch and
    forced to each of its two designs (blocks owning rows; one
    cooperative launch); raises if the kernel wrote any of its inputs (it
    is functional, as in JAX)."""
    args = cuda(arrays)
    before = [t.clone() for t in args]
    want = tq._apply_vote_events_plain(*args)
    got = list(tq.apply_vote_events(*args))
    for rows in (tq.vote_block_rows(args[0].shape[0]), 0):
        with vote_design(tq, rows):
            got += tq.apply_vote_events(*args)
    torch.cuda.synchronize()
    for x, y in zip(args, before):
        if not torch.equal(x, y):
            raise AssertionError("K7a wrote one of its inputs")
    return max_abs_err(got, list(want) * 3)


def parity_k7b(tq, arrays):
    args = cuda(arrays)
    return max_abs_err([tq.all_replicated_min(*args)],
                       [tq._all_replicated_min_plain(*args)])


def parity_k3_public(tq, arrays):
    """K3's public tally against its plain version, through the wrapper's
    own launch and forced to each of its two designs (rows of 8 lanes;
    staged tiles)."""
    args = cuda(arrays)
    got = [tq.tally_votes_packed(*args)]
    for tile in (0, tq.TALLY_TILE):
        with tally_design(tq, tile):
            got.append(tq.tally_votes_packed(*args))
    return max_abs_err(got, [tq._tally_plain(*args)] * 3)


def parity_k7c(tq, arrays, timeout):
    args = cuda(arrays)
    return max_abs_err([tq.lease_expiry(*args, timeout)],
                       [tq._lease_expiry_plain(*args, timeout)])


def run_parity_k7(tq, cases, par) -> None:
    """K7a-c and K3's public tally: seeded cases at G = 1024 and 102400
    with P = 8, at P = 3, 5, 7, 16 with G = 1024 and 102400, at G = 1001
    and 1023, the hand-made vote edges, every event on one row (more than
    a block of K7a's design (a) lists), every lease timeout of
    ``cases.LEASE_TIMEOUTS``; K7b also with rows of no self bit and of
    two, K3 also on ``cases.tally_edges`` (extreme priorities, empty
    current confs, joint rounds, every member or none replied)."""
    shapes = [(1024, P), (102_400, P)] + [(1024, p) for p in K7_PEERS] \
        + [(g, p) for g in K7_ODD_ROWS for p in (3, P)]
    for seed, (g, p) in enumerate(shapes):
        rng = np.random.default_rng(seed)
        for e in (g // 4, 2 * g):
            par.add("K7a", parity_k7a(tq, cases.vote_events(rng, g, p, e)))
        par.add("K7b", parity_k7b(tq, cases.replicated_inputs(rng, g, p)))
        par.add("K7b", parity_k7b(tq, cases.replicated_self_edges(rng, g,
                                                                  p)))
        par.add("K3_public", parity_k3_public(tq, cases.tally_inputs(
            rng, g, p)))
        par.add("K3_public", parity_k3_public(tq, cases.tally_edges(rng, g,
                                                                    p)))
        lease = cases.lease_inputs(rng, g, p, NOW)
        for t in cases.LEASE_TIMEOUTS:
            par.add("K7c", parity_k7c(tq, lease, t))
    for seed, p in enumerate(K7_PEERS):  # the other peer counts at 100k
        rng = np.random.default_rng(100 + seed)
        par.add("K7b", parity_k7b(tq, cases.replicated_self_edges(
            rng, 102_400, p)))
        par.add("K3_public", parity_k3_public(tq, cases.tally_edges(
            rng, 102_400, p)))
    for g, p in K7_VOTE_EDGES:
        par.add("K7a", parity_k7a(tq, cases.vote_event_edges(g, p)))
    for g, e in ((1024, 2048), (102_400, 204_800)):
        hot = cases.vote_events(np.random.default_rng(e), g, P, e)
        hot[2][:] = 7  # every event on one row
        par.add("K7a", parity_k7a(tq, hot))


class Parity:
    """The largest error and the number of cases, per kernel."""

    def __init__(self):
        self.errs = collections.defaultdict(int)
        self.n = collections.Counter()

    def add(self, key: str, err: int) -> None:
        self.errs[key] = max(self.errs[key], err)
        self.n[key] += 1

    def check(self, what: str) -> None:
        torch.cuda.synchronize()
        for k in sorted(self.n):
            log(f"parity ({what}): {k} {self.n[k]} cases, "
                f"max_abs_err {self.errs[k]}")
            if self.errs[k] != 0:
                raise AssertionError(f"{k} disagrees with its plain version: "
                                     f"max_abs_err {self.errs[k]}")


def run_parity(tq, tl, cases, bench, par: Parity) -> None:
    """Fixed shapes, before the main path: the edge cases at G up to
    102400 and E up to 16384."""
    for g in (1024, 10240, 102400):
        for e in (64, 1024, 16384):
            for seed in (0, 1):
                par.add("K1", parity_k1(tq, cases, g, P, e, seed))
            par.add("K1", parity_k1(tq, cases, g, P, e, 2, negative=True))
    for g in (1024, 10240):
        for d, e in ((64, 64), (1024, 1024), (64, 16384)):
            for seed in (0, 1):
                par.add("K2", parity_k2(tq, cases, g, P, d, e, seed))
            par.add("K2", parity_k2(tq, cases, g, P, d, e, 2, negative=True))
        for seed in (0, 1, 2):
            par.add("K3_public", parity_k3(tq, cases, g, P, seed))
    run_parity_redesigned(tq, cases, par)
    run_parity_fast(tq, cases, par)
    for g in K4_ROWS:
        for width in K4_WIDTHS:
            for seed in (0, 1):
                par.add("K4", parity_k4(tl, cases, g, P, width, seed,
                                        plan=True))
        par.add("K4", parity_k4(tl, cases, g, P, 8, 2, big_cell=True,
                                plan=True))
    for p4 in (3, 5, 16):  # rows of 8 lanes, and of 16
        par.add("K4", parity_k4(tl, cases, 1024, p4, 16, p4, plan=True))
    for g in (2048, 10240):
        for s in (1, 2, MESH_SLICES):
            for e in (64, 2048):
                par.add("K5", parity_k5(tq, cases, g, P, s, e, 0))
                par.add("K5", parity_k5(tq, cases, g, P, s, e, 1,
                                        negative=True))
    par.add("K5", parity_k5_rung(tq, bench))
    for g, p, e in K6_SHAPES:
        for seed in (0, 1, 2):
            par.add("K6", parity_k6(tq, cases.step_args(
                np.random.default_rng(seed), g, p, e, NOW, TIMEOUT_MS)))
            par.add("K6", parity_k6(tq, bench._example_batch(g, p, e, seed)))
    for g, p6, e in K6_SHAPES[1:]:
        # every ack on one row: more than the row's block lists
        hot = cases.step_args(np.random.default_rng(g), g, p6, e, NOW,
                              TIMEOUT_MS)
        hot[2][:] = 7
        par.add("K6", parity_k6(tq, hot))
    for p6 in K6_PEERS:
        for g, _, e in K6_SHAPES[:2]:
            par.add("K6", parity_k6(tq, cases.step_args(
                np.random.default_rng(p6), g, p6, e, NOW, TIMEOUT_MS)))
            par.add("K6", parity_k6(tq, bench._example_batch(g, p6, e, p6)))
    for g in (1001, 1023):  # the outputs' one buffer ends mid-word
        par.add("K6", parity_k6(tq, cases.step_args(
            np.random.default_rng(g), g, P, 1024, NOW, TIMEOUT_MS)))
    run_parity_k7(tq, cases, par)
    par.check("fixed shapes")


def run_parity_redesigned(tq, cases, par) -> None:
    """The redesigned K2 and K3: K2 at P = 3, 5, 8, 16, G = 1,
    100, 1024, 10240 (G not a multiple of the tile), D and E from 64 to
    16384, negative and padding indices, each case also through the
    engine's prepared call; every tile size; K2 at G = 102400; K3's row
    entry at R = 1, 64, 1024 for every P, padded to the engine's bucket
    with stale rows."""
    for p in K2_PEERS:
        for g in (1, 100, 1024, 10240):
            for d, e in ((64, 64), (1024, 16384), (16384, 1024)):
                for negative in (False, True):
                    par.add("K2", parity_k2(tq, cases, g, p, d, e,
                                            p + g + d + negative, negative,
                                            plan=True))
        for r, cap in ((1, 64), (64, 64), (100, 256), (1024, 1024)):
            par.add("K3", parity_k3_rows(tq, cases, 2048, p, r, cap, p + r))
    tile = tq.tick_tile
    try:
        for t in TILES:
            tq.tick_tile = lambda g, t=t: t
            for g in (100, 1024, 10240):
                par.add("K2", parity_k2(tq, cases, g, P, 1024, 1024, g, True,
                                        plan=True))
    finally:
        tq.tick_tile = tile
    par.add("K2", parity_k2(tq, cases, 102_400, P, 1024, 16384, 5, True))


def run_parity_fast(tq, cases, par) -> None:
    """The redesigned K1 and K5 (one launch each), every case through the
    public wrapper and through the engine's prepared call: K1 at P = 3,
    5, 8, 16, G = 1, 100, 1024, 10240 and E = 64, 16384, negative,
    out-of-range and sentinel columns and duplicate acks included; K5 at
    S = 1, 2, 8 with slices of G / S rows a multiple of the tile (G =
    2048) and not (G = 264: a tile straddles slices), for every P; K1 and
    K5 at every tile size; K1 at G = 102400 with E = 16384; K1 and K5 with
    every ack aimed at three rows (a tile lists more columns than its list
    holds) and padded as the engine pads."""
    for p in K2_PEERS:
        for g in (1, 100, 1024, 10240):
            for e in (64, 16384):
                for negative in (False, True):
                    par.add("K1", parity_k1(tq, cases, g, p, e,
                                            p + g + e + negative, negative,
                                            plan=True))
        for g in (264, 2048):
            for s in (1, 2, MESH_SLICES):
                for negative in (False, True):
                    par.add("K5", parity_k5(tq, cases, g, p, s, 256,
                                            p + g + s + negative, negative,
                                            plan=True))
    tile = tq.tick_tile
    try:
        for t in TILES:
            tq.tick_tile = lambda g, t=t: t
            for g in (100, 1024, 10240):
                par.add("K1", parity_k1(tq, cases, g, P, 1024, g + t, True,
                                        plan=True))
            for g, s in ((264, 8), (2048, 2), (10240, 8)):
                par.add("K5", parity_k5(tq, cases, g, P, s, 1024, g + t,
                                        True, plan=True))
    finally:
        tq.tick_tile = tile
    par.add("K1", parity_k1(tq, cases, 102_400, P, 16384, 5, True,
                            plan=True))
    for e in (4096, 16384):
        for hot in (False, True):
            par.add("K1", parity_k1(tq, cases, 1024, P, e, e + hot, True,
                                    plan=True, hot=hot,
                                    engine_padding=True))
            par.add("K5", parity_k5(tq, cases, 2048, P, 2, e, e + hot, True,
                                    plan=True, hot=hot,
                                    engine_padding=True))
        par.add("K1", parity_k1(tq, cases, 1024, P, e, e, plan=True,
                                hot=True))
        par.add("K5", parity_k5(tq, cases, 2048, P, 2, e, e, plan=True,
                                hot=True))


def run_parity_sleeping(tq, cases, par) -> None:
    """The sleeping-rows family (``cases.sleeping_state``,
    ``sleeping_events``, ``sleeping_refresh``): most rows asleep, their
    deadlines 60000-62000 ms ahead or at INT32_MAX, the sleeping leaders'
    acks stopped, few acks; K1 and K2 at the sparse paths' buckets, each
    case through the public wrapper and the engine's prepared call, at a
    mid-epoch clock and at one late in the epoch (the deadlines clamp)."""
    for g in SLEEP_ROWS:
        for now in (NOW, LATE_NOW):
            for e in (64, 1024, 4096):
                par.add("K1", parity_k1(tq, cases, g, P, e, g + e, plan=True,
                                        sleeping=True, now=now))
            for d, e in ((64, 64), (1024, 1024), (64, 4096)):
                par.add("K2", parity_k2(tq, cases, g, P, d, e, g + d + e,
                                        plan=True, sleeping=True, now=now))
    par.check("sleeping rows")


def run_parity_observed(tq, tl, cases, main, shapes, par: Parity,
                        what: str, members=None) -> None:
    """Every shape a main path gave a kernel, after the main path (K3: at
    every padded row count R the vote passes ran, with a quarter and all
    of the rows real, the rest stale padding); with ``members``, every
    row's conf also of exactly that many peers (the path's groups)."""
    g, p, w = main["capacity"], main["peers"], main["ledger_width"]
    for seed in (10, 11):
        for m in (None, members) if members else (None,):
            for e in shapes["K1"]:
                par.add("K1", parity_k1(tq, cases, g, p, e, seed,
                                        members=m))
            for d, e in shapes["K2"]:
                par.add("K2", parity_k2(tq, cases, g, p, d, e, seed,
                                        members=m))
            for s, e in shapes["K5"]:
                par.add("K5", parity_k5(tq, cases, g, p, s, e, seed,
                                        members=m))
            for cap in shapes["K3"]:
                for r in (max(1, cap // 4), cap):
                    par.add("K3", parity_k3_rows(tq, cases, max(g, cap), p,
                                                 r, cap, seed, m))
            par.add("K4", parity_k4(tl, cases, g, p, w, seed, plan=True,
                                    members=m))
    par.check(f"{what} shapes")


# -- phase 4: the main path --------------------------------------------------

def module_env() -> dict:
    """The environment of a ``python -m`` subprocess of this checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [x for x in [env.get("PYTHONPATH")] if x])
    return env


async def run_module(*argv, timeout: float = 120.0) -> tuple:
    """``python -m argv`` of this checkout as a subprocess, the event loop
    serving meanwhile: (exit code, stdout, stderr)."""
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", *argv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=module_env(), cwd=ROOT)
    try:
        out, err = await asyncio.wait_for(proc.communicate(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise
    return proc.returncode, out.decode(), err.decode()


async def run_shell(cluster) -> dict:
    """The shell's HTTP commands against ``cluster``'s endpoints, each a
    subprocess: ``health`` (its exit code and the watchdog events it
    counts; it exits 1 on any journaled event), ``lag`` (must exit 0 and
    list every server), ``top -iterations 1`` (must exit 0)."""
    endpoints = ",".join(cluster.http_addresses())
    peers = sorted(str(s.peer_id) for s in cluster.servers)
    out = {}
    t0 = time.monotonic()
    for name, extra in (("health", ()), ("lag", ()),
                        ("top", ("-iterations", "1"))):
        rc, text, err = await run_module("ratis_tpu_torch.shell", name,
                                         "-endpoints", endpoints, *extra)
        rows = sorted(line.split()[0] for line in text.splitlines()
                      if line.split() and line.split()[0] in peers)
        out[name] = {"rc": rc, "servers_listed": rows,
                     "first_line": text.splitlines()[0] if text else "",
                     "stderr_tail": err[-300:]}
    out["seconds"] = time.monotonic() - t0
    first = out["health"]["first_line"].split()
    out["health"]["events"] = (int(first[first.index("watchdog") - 1])
                               if "watchdog" in first else None)
    for name in ("lag", "top"):
        if out[name]["rc"] != 0 or out[name]["servers_listed"] != peers:
            raise AssertionError(f"shell {name}: {out[name]}")
    return out


def log_span(cluster) -> tuple:
    """The entries in the log of the first group's division on the first
    server, and that division's segment files (taken before the close)."""
    g = cluster.groups[0]
    d = cluster.servers[0].divisions[g.group_id]
    return (d.state.log.get_last_entry_term_index().index + 1,
            sorted(str(f) for f in d.storage.current.glob("log_*")))


def parse_log_check(span: tuple) -> dict:
    """``python -m ratis_tpu_torch.tools.parse_log`` on a ``log_span``'s
    segment files: the entries it counts must equal the division's log."""
    want, segments = span
    if not segments:
        raise AssertionError("parse_log: no segment file")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m",
                           "ratis_tpu_torch.tools.parse_log", *segments],
                          capture_output=True, text=True, env=module_env(),
                          cwd=ROOT, timeout=120)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    got = int(last.split()[2]) if last.startswith("# total ") else None
    res = {"rc": proc.returncode, "segments": len(segments),
           "entries": got, "log_entries": want,
           "seconds": time.monotonic() - t0}
    if proc.returncode != 0 or got != want:
        raise AssertionError(f"parse_log: {res} {proc.stderr[-300:]}")
    return res


async def drive(cluster, writes: int) -> dict:
    try:
        t0 = time.monotonic()
        await cluster.start(timeout=600)
        bring_up = time.monotonic() - t0
        timeouts = cluster.election_timeouts()
        stats = await cluster.write_all(writes)
        timeouts = [timeouts, cluster.election_timeouts() - timeouts]
        counters = await cluster.read_counters(timeout=300)
        # the watchdog's ledger pass runs once a second on every server
        deadline = time.monotonic() + 30
        while any(s.engine.ledger.samples.count == 0
                  for s in cluster.servers):
            if time.monotonic() > deadline:
                raise AssertionError("no ledger sample on some server")
            await asyncio.sleep(0.1)
        for g in cluster.groups:
            want = stats["acked"][g.group_id]
            got = counters[g.group_id]
            if want != writes or got != [want] * len(cluster.servers):
                raise AssertionError(f"group {g.group_id}: acked {want}, "
                                     f"replica counters {got}")
        for s in cluster.servers:
            e = s.engine
            if e.device.type != "cuda" or not e._dev.match_index.is_cuda:
                raise AssertionError(f"{s.peer_id}: engine state not on "
                                     f"cuda")
            if e.metrics["batched_dispatches"] == 0:
                raise AssertionError(f"{s.peer_id}: no batched dispatch")
        return {"bring_up_s": bring_up, **{k: v for k, v in stats.items()
                                           if k != "acked"},
                "election_timeouts": timeouts,
                "dispatches": [s.engine.metrics["batched_dispatches"]
                               for s in cluster.servers],
                "ledger_samples": [s.engine.ledger.samples.count
                                   for s in cluster.servers]}
    finally:
        await cluster.close()


class StaleSkips:
    """While active, counts the "stale" verdicts the engines' ticks gave
    (``stale``) and those whose row's listener, a division, was
    hibernating then (``skipped``: the engine's dispatch drops them, a
    sleeping leader's acks having stopped on request);
    ``QuorumEngine._tick_locked`` is swapped for a counting one and
    restored on exit."""

    def __init__(self):
        self.stale = 0
        self.skipped = 0

    def __enter__(self):
        from ratis_tpu_torch.engine.engine import QuorumEngine
        self.tick = tick = QuorumEngine._tick_locked

        def counting(engine):
            changed, votes = tick(engine)
            for slot, kind, _ in changed:
                if kind == "stale":
                    self.stale += 1
                    self.skipped += bool(getattr(
                        engine._listeners.get(slot), "hibernating", False))
            return changed, votes
        QuorumEngine._tick_locked = counting
        return self

    def __exit__(self, *exc):
        from ratis_tpu_torch.engine.engine import QuorumEngine
        QuorumEngine._tick_locked = self.tick


def counted(kernels: dict, keys, drive, never=()):
    """Zero the launch counts of ``keys``, ``never`` and OFF_PATH just
    before ``drive()``, read them just after; every one of ``keys`` must
    be > 0, every one of ``never`` and of OFF_PATH (no path launches
    them) 0."""
    never = (*never, *OFF_PATH)
    for k in (*keys, *never):
        kernels[k].launches = 0
    res = drive()
    launches = {k: kernels[k].launches for k in (*keys, *never)}
    for k in keys:
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on this path")
    for k in never:
        if launches[k] != 0:
            raise AssertionError(f"{k} launched {launches[k]} times on a "
                                 f"path that must not take it")
    return res, launches


# -- phase 5: the engine's routes ------------------------------------------

ROUTE_GROUPS = 1024
ROUTE_ROWS = 64     # dirty rows and acks of a timed refresh / fast tick
ROUTE_ROUNDS = (1, 64, 1024)


class _Listener:
    async def on_commit_advance(self, c):
        pass

    async def on_election_timeout(self):
        pass

    async def on_leadership_stale(self):
        pass


def route_engine(tq, mesh: bool = False):
    """A card engine of ``ROUTE_GROUPS`` leader rows (3 of 8 peers), built
    and prewarmed as a server builds one, its state uploaded; with
    ``mesh``, in ``MESH_SLICES`` slices of ``MESH_MAX_GROUPS`` rows, the
    groups pinned round-robin to the slices (as the mesh path's engines
    are).  Returns the engine and its attached slots."""
    from ratis_tpu_torch.engine.engine import QuorumEngine
    from ratis_tpu_torch.engine.state import ROLE_LEADER
    from ratis_tpu_torch.parallel import make_group_mesh
    eng = QuorumEngine(
        max_groups=MESH_MAX_GROUPS if mesh else ROUTE_GROUPS, max_peers=P,
        scalar_fallback_threshold=0, use_device=True, device="cuda",
        mesh=make_group_mesh(MESH_SLICES, device="cuda") if mesh else None)
    cur = np.arange(P) < 3
    slots = []
    for i in range(ROUTE_GROUPS):
        slot = eng.attach(_Listener(), i % MESH_SLICES if mesh else -1)
        eng.state.set_conf(slot, 0, cur, np.zeros(P, bool),
                           np.zeros(P, np.int32), 0)
        eng.state.role[slot] = ROLE_LEADER
        slots.append(slot)
    eng.prewarm()
    eng._tick_batched([], eng.clock.now_ms())  # the full upload
    return eng, slots


def earlier_fast_dispatch(tq, eng, acks, now):
    """The fast dispatch by the engine's earlier route, the same-run
    control of the prepared call: the tick packed into a fresh array, it
    and meta uploaded in one pageable copy (``ops.quorum.upload``), the
    public wrapper (K1, or K5 on a mesh engine; eleven tensors checked,
    ``out`` allocated), a synchronising pageable copy of ``out`` down,
    the changed list."""
    sliced = eng.mesh is not None
    ev = (eng._pack_tick_sliced(acks, {}) if sliced
          else eng._pack_tick(acks, {})).copy()
    ev_t, meta_t = tq.upload(
        (ev, np.array([now, eng.leadership_timeout_ms], np.int32)), "cuda")
    step = (tq.engine_step_resident_fast_sliced if sliced
            else tq.engine_step_resident_fast)
    out = step(eng._dev, ev_t, meta_t).out.cpu().numpy()
    return eng._collect_changed(out[0], out[1] != 0, out[2] != 0,
                                out[3] != 0)


def fast_route_rows(tq, eng, acks, now, prefix: str) -> dict:
    """One engine's fast route: a fast tick must be ONE call into the
    kernel library that launches K1 once on a flat engine, K5 once (and
    K1 never) on a mesh engine, and nothing else; then host ms (median
    of 200) of the fast dispatch, of its prepared call alone and of the
    earlier route."""
    plan = eng._fast_plan
    sliced = eng.mesh is not None
    before = (tq.K1.launches, tq.K2.launches, tq.K5.launches)
    with CallCounter(plan) as calls:
        eng._tick_batched_pass(acks, now)
    got = tuple(k.launches - n for k, n in zip((tq.K1, tq.K2, tq.K5),
                                                before))
    want = (0, 0, 1) if sliced else (1, 0, 0)
    if calls.calls != 1 or got != want:
        raise AssertionError(f"{prefix} fast tick: {calls.calls} calls into "
                             f"the library, K1/K2/K5 +{got}, expected "
                             f"+{want}")
    e = eng._last_event_cap
    return {
        f"{prefix}fast_dispatch": {
            "ms": timed_host(lambda: eng._tick_batched_pass(acks, now)),
            "acks": len(acks), "slices": plan.n_slices, "columns": e,
            "library_calls": calls.calls,
            "launches": dict(zip(("K1", "K2", "K5"), got))},
        f"{prefix}fast_plan_run": {"ms": timed_host(
            lambda: plan.run(e, now, eng.leadership_timeout_ms))},
        f"{prefix}fast_dispatch_earlier_route": {"ms": timed_host(
            lambda: earlier_fast_dispatch(tq, eng, acks, now))}}


def ledger_route_rows(tq, tl, eng, prefix: str) -> dict:
    """One engine's ledger route (its rows leading 3 peers interned in the
    ledger's table): a sample must be ONE call into the kernel library,
    its prepared call's ``k4_tick``, that launches K4 once; then host ms
    (median of 200) of the whole sample, of its prepared call alone and of
    the earlier route (the eleven mirrors uploaded in one pageable copy by
    ``ops.quorum.upload``, the public wrapper, a synchronising pageable
    ``.cpu()``)."""
    ledger, st = eng.ledger, eng.state
    for i in range(3):
        st.peer_index[:, i] = ledger.peer_for(f"route-peer-{i}")
    ledger.sample()  # builds the prepared call
    plan = ledger._ledger_plan
    n = tl.K4.launches
    with CallCounter(plan) as calls:
        ledger.sample()
    got = tl.K4.launches - n
    if calls.calls != 1 or got != 1:
        raise AssertionError(f"{prefix}ledger sample: {calls.calls} calls "
                             f"into the library, K4 +{got}")
    width = ledger._table_width()
    now = eng.clock.now_ms()
    scalars = (now, ledger.lag_threshold, ledger.up_window_ms)
    mirrors = (st.role, st.match_index, st.commit_index, st.applied_index,
               st.conf_cur, st.conf_old, st.self_mask, st.last_ack_ms,
               st.peer_index, ledger._prev_commit,
               ledger._prev_gen == st.alloc_gen)
    return {
        f"{prefix}ledger_sample": {
            "ms": timed_host(ledger.sample), "rows": st.capacity,
            "width": width, "library_calls": calls.calls,
            "launches": {"K4": got}},
        f"{prefix}ledger_plan_run": {"ms": timed_host(
            lambda: plan.run(width, *scalars))},
        f"{prefix}ledger_earlier_route": {"ms": timed_host(
            lambda: ledger_earlier_route(tl, tq, mirrors, scalars, width))}}


class CallCounter:
    """Counts the calls into one C function of a plan (its ``_tick``)."""

    def __init__(self, plan):
        self.plan, self.fn, self.calls = plan, plan._tick, 0

    def __enter__(self):
        def counting(*a):
            self.calls += 1
            return self.fn(*a)
        self.plan._tick = counting
        return self

    def __exit__(self, *exc):
        self.plan._tick = self.fn


def run_route_timing(tq, log_card) -> dict:
    """Host time of the engine's own routes on one card engine: the
    refresh dispatch (K2's prepared call: pack, one C call, the changed
    list) at D = E = ROUTE_ROWS and its prepared call alone; the fast
    dispatch (K1's prepared call) with ROUTE_ROWS acks, its prepared call
    alone and the earlier route (pack, ``upload``, the wrapper, ``.cpu()``)
    as the same-run control; the same three on a mesh engine of 8 slices
    (K5); the vote pass at R = 1, 64, 1024 open rounds (the whole pass,
    and its tally alone: K3's prepared call on the open rounds' rows)
    beside the earlier tally (all G rows of six mirrors uploaded, the
    public K3, the download).  Checks that one refresh tick, one fast tick
    and one vote pass each make exactly ONE call into the kernel library
    (and launch K2, K1 or K5, K3 once, and no other of K1, K2, K5).  The
    refresh and fast ticks' device operations come from a profiler trace,
    the refresh tick's failed only on a trace that shows another kernel
    (on the card hosts a trace sometimes records nothing, or the tick's
    copies without its kernel: such a trace is taken again); the ticks
    synchronise, so they cannot be captured in a graph, but their kernels
    come from the C launchers of the wrappers', which phase 3 holds to one
    kernel in a graph."""
    from ratis_tpu_torch.ops import ledger as tl
    from ratis_tpu_torch.tools.profile_main_path import device_ops, is_copy
    eng, _ = route_engine(tq)
    s = eng.state
    rng = np.random.default_rng(17)
    now = eng.clock.now_ms()
    rows = [int(r) for r in rng.permutation(ROUTE_GROUPS)[:ROUTE_ROWS]]
    acks = [(int(g), int(rng.integers(0, 3)), int(rng.integers(0, 99)), now)
            for g in rng.integers(0, ROUTE_GROUPS, size=ROUTE_ROWS)]

    def dirty():
        s.dirty.update(rows)

    def refresh():
        eng._tick_batched_pass(acks, now)

    out = {}
    plan = eng._refresh_plan
    n1, n2 = tq.K1.launches, tq.K2.launches
    dirty()
    with CallCounter(plan) as calls:
        refresh()
    if calls.calls != 1 or tq.K2.launches != n2 + 1 \
            or tq.K1.launches != n1:
        raise AssertionError(f"refresh tick: {calls.calls} calls into the "
                             f"library, K2 +{tq.K2.launches - n2}, K1 "
                             f"+{tq.K1.launches - n1}")
    for _ in range(3):
        # a trace that dropped the kernel's record (it holds the tick's
        # download, no kernel) is taken again, as an empty one is
        ops = device_ops(lambda: (dirty(), refresh()))
        kernels = [op for op in ops if not is_copy(op)]
        if kernels or not ops:
            break
    if ops and (len(kernels) != 1 or "tile_tick" not in kernels[0]
                or "RefreshEvents" not in kernels[0]):
        raise AssertionError(f"refresh tick put {ops} on the card")
    out["refresh_dispatch"] = {
        "ms": timed_host(refresh, dirty), "rows": ROUTE_ROWS,
        "acks": ROUTE_ROWS, "library_calls": calls.calls,
        "device_ops": ops or None}
    out["refresh_plan_run"] = {"ms": timed_host(
        lambda: plan.run(64, 64, now, eng.leadership_timeout_ms))}
    out.update(fast_route_rows(tq, eng, acks, now, ""))
    out.update(ledger_route_rows(tq, tl, eng, ""))
    out["fast_dispatch"]["device_ops"] = device_ops(
        lambda: eng._tick_batched_pass(acks, now)) or None
    mesh_eng, slots = route_engine(tq, mesh=True)
    mesh_now = mesh_eng.clock.now_ms()
    mesh_acks = [(int(g), int(rng.integers(0, 3)), int(rng.integers(0, 99)),
                  mesh_now) for g in rng.choice(slots, size=ROUTE_ROWS)]
    out.update(fast_route_rows(tq, mesh_eng, mesh_acks, mesh_now, "mesh_"))
    out.update(ledger_route_rows(tq, tl, mesh_eng, "mesh_"))

    async def votes():
        for r in ROUTE_ROUNDS:
            # only the self grant of 3 members: every round stays open
            for slot in range(r):
                eng.begin_vote_round(slot, now + 10 ** 6)
            n3 = tq.K3.launches
            with CallCounter(eng._tally_plan) as calls:
                if eng._vote_pass(now):
                    raise AssertionError("a timed vote round resolved")
            if calls.calls != 1 or tq.K3.launches != n3 + 1:
                raise AssertionError(f"vote pass: {calls.calls} calls into "
                                     f"the library, K3 "
                                     f"+{tq.K3.launches - n3}")
            slots = np.fromiter(eng._vote_rounds, np.int64, r)
            out[f"vote_pass_R{r}"] = {
                "ms": timed_host(lambda: eng._vote_pass(now)), "rounds": r,
                "library_calls": calls.calls}
            out[f"vote_tally_R{r}"] = {"ms": timed_host(
                lambda: eng._tally_rounds(slots)), "rounds": r}
            out[f"vote_all_rows_tally_R{r}"] = {"ms": timed_host(
                lambda: tq.tally_votes_packed(*tq.upload(
                    (s.vote_grants, s.vote_rejects, s.conf_cur, s.conf_old,
                     s.priority, s.self_priority), "cuda")).cpu().numpy())}
            for slot in range(r):
                eng.end_vote_round(slot)
    asyncio.run(votes())
    for k, v in out.items():
        log(f"route: {log_card} | {k}: host {v['ms']:.4f} ms (median)")
    return out


IDLE_GAP_S = 0.001


def k1_k2_split(tq, cases, main, n: int = 200) -> dict:
    """K1's and K2's wrappers at the main shape (E = D = 64), each call
    after the same state restore as ``timed``'s, a synchronisation and
    an idle gap of ``IDLE_GAP_S``, so the restore's copies are over and
    the card idles when the call starts: the median CUDA-event ms of the
    call (the events bracket the wrapper's host work too, since the
    stream waits for its launch) and the median host ms of the call, in
    the same loop.  Where the event ms follows the host ms, the wrapper's
    host work bounds the timed call, not the restore or the kernel."""
    g, p = main["capacity"], main["peers"]
    rng = np.random.default_rng(31)
    st = cases.resident_state(rng, g, p, NOW)
    ev, meta = cuda([cases.fast_events(rng, g, p, 64, NOW),
                     np.array([NOW, TIMEOUT_MS], np.int32)])
    rf_idx, rf, acks = cases.refresh(rng, g, p, 64, 64, NOW)
    rf_idx, *rf = cuda([rf_idx, *rf])
    acks = cuda(acks)
    fresh = tq.device_state_from_numpy(st, "cuda")
    a = tq.device_state_from_numpy(st, "cuda")
    calls = {"K1": lambda: tq.engine_step_resident_fast(a, ev, meta),
             "K2": lambda: tq.engine_step_resident(a, rf_idx, *rf, *acks,
                                                   NOW, TIMEOUT_MS)}
    out = {}
    for key, fn in calls.items():
        ev_ms, host_ms = [], []
        for i in range(n + 5):
            for x, y in zip(a, fresh):
                x.copy_(y)
            torch.cuda.synchronize()
            time.sleep(IDLE_GAP_S)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            e1.record()
            e1.synchronize()
            if i >= 5:
                ev_ms.append(e0.elapsed_time(e1))
                host_ms.append((t1 - t0) * 1e3)
        out[key] = {"event_ms": statistics.median(ev_ms),
                    "host_ms": statistics.median(host_ms)}
    log(f"K1/K2 after restore, sync and a {IDLE_GAP_S * 1e3:.0f} ms idle "
        f"gap: " + "; ".join(f"{k} event {v['event_ms']:.4f} ms, host "
                             f"{v['host_ms']:.4f} ms" for k, v in out.items()))
    return out


def k2_one_launch(tq, cases) -> list[str]:
    """One K2 public-wrapper call at the main shape, captured in a CUDA
    graph: the graph must hold exactly one node, the kernel
    ``tile_tick`` on K2's refresh events (the earlier design put three
    kernels).  Returns the
    nodes' first lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(23)
    st = cases.resident_state(rng, ROUTE_GROUPS, P, NOW)
    rf_idx, rf, acks = cases.refresh(rng, ROUTE_GROUPS, P, 64, 64, NOW)
    rf_idx, *rf = cuda([rf_idx, *rf])
    acks = cuda(acks)
    a = tq.device_state_from_numpy(st, "cuda")
    nodes = graph_nodes(lambda: tq.engine_step_resident(
        a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS))
    if len(nodes) != 1 or not is_kernel_node(nodes[0]) \
            or "tile_tick" not in nodes[0] \
            or "RefreshEvents" not in nodes[0]:
        raise AssertionError(f"one K2 call put {len(nodes)} graph nodes on "
                             f"the card: {nodes}")
    return [" ".join(n.split())[:160] for n in nodes]


def fast_one_launch(tq, cases) -> dict:
    """One K1 public-wrapper call (G = 1024, E = 64) and one K5 call (G =
    2048 in 8 slices, E = 64), each captured in a CUDA graph: each graph
    must hold exactly one node, the kernel ``tile_tick`` on the fast
    events (the earlier design put two kernels).  Returns each call's nodes' first lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(29)
    out = {}
    for key, g, sliced in (("K1", ROUTE_GROUPS, False),
                           ("K5", MESH_MAX_GROUPS, True)):
        st = cases.resident_state(rng, g, P, NOW)
        ev_np = (cases.sliced_events(rng, g, P, MESH_SLICES, 64, NOW)
                 if sliced else cases.fast_events(rng, g, P, 64, NOW))
        ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
        a = tq.device_state_from_numpy(st, "cuda")
        wrapper = (tq.engine_step_resident_fast_sliced if sliced
                   else tq.engine_step_resident_fast)
        nodes = graph_nodes(lambda: wrapper(a, ev, meta))
        if len(nodes) != 1 or not is_kernel_node(nodes[0]) \
                or "tile_tick" not in nodes[0] \
                or "FastEvents" not in nodes[0]:
            raise AssertionError(f"one {key} call put {len(nodes)} graph "
                                 f"nodes on the card: {nodes}")
        out[key] = [" ".join(n.split())[:160] for n in nodes]
    return out


def ledger_step_one_launch(tq, tl, cases, bench) -> dict:
    """One K4 wrapper call (G = 1024, W = 8) and one K6 call (the bench's
    entry batch), each captured in a CUDA graph, must each hold exactly
    one node, the kernel (the earlier designs put two kernels, and two
    copies and two kernels); one call of K4's prepared call (captured it
    does not synchronise) its copy in, the same one kernel and its copy
    out.  Returns each call's nodes' first lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    arrays, scalars = cases.ledger_inputs(np.random.default_rng(37),
                                          ROUTE_GROUPS, P, 8)
    dev = cuda(arrays)
    plan = tl.LedgerPlan(ROUTE_GROUPS, P, "cuda")
    for v, a in zip(plan.views, arrays):
        np.copyto(v, a)

    def plan_call():
        plan._stream = torch.cuda.current_stream().cuda_stream
        plan.run(8, *scalars)

    fn, args = bench.entry("cuda")
    out = {}
    for key, call, want, kernel in (
            ("K4", lambda: tl.ledger_pass(*dev, *scalars, num_peers=8),
             [True], tl.K4),
            ("K4_plan", plan_call, [False, True, False], tl.K4),
            ("K6", lambda: fn(*args), [True], tq.K6)):
        n = kernel.launches
        nodes = graph_nodes(call)
        # the warm-up call and the captured one; a node's label cuts the
        # kernel's mangled name short, so the launch count names it
        if [is_kernel_node(x) for x in nodes] != want \
                or kernel.launches != n + 2:
            raise AssertionError(f"one {key} call put {len(nodes)} graph "
                                 f"nodes on the card ({kernel.launches - n} "
                                 f"launches counted): {nodes}")
        out[key] = [" ".join(x.split())[:160] for x in nodes]
    return out


def other_one_launch(tq, cases) -> dict:
    """One call each of K3's row entry (``tally_rows`` at R = 64), K3's
    public entry (G = 1024, and 102400: ``K3_public_100k``; at 1024 also
    forced to each design: ``K3_public_lanes``, ``K3_public_tile``), K7a
    (1024 x 8 with 2048 events, by its rule and forced to each design:
    ``K7a_rows``, ``K7a_grid``), K7b (1024 x 8, and 102400:
    ``K7b_100k``) and K7c (1024 x 8), each captured in a CUDA graph: every
    call but K3's row entry must be one node, the kernel, and count two
    launches (the warm-up call and the captured; K7a's earlier design put
    two copies before its kernel).  Returns each call's nodes' first
    lines."""
    from ratis_tpu_torch.tools.profile_main_path import (graph_nodes,
                                                         is_kernel_node)
    rng = np.random.default_rng(41)
    g = ROUTE_GROUPS
    arrays = cases.tally_inputs(rng, g, P)
    v = cases.tally_plan(arrays, np.arange(0, g, 16), "cpu", 64).views(64)
    packed = cuda([v.masks, v.priority, v.self_priority])
    tally = cuda(arrays)
    votes = cuda(cases.vote_events(rng, g, P, 2 * g))
    repl = cuda(cases.replicated_inputs(rng, g, P))
    lease = cuda(cases.lease_inputs(rng, g, P, NOW))
    tally_100k = cuda(cases.tally_inputs(rng, 102_400, P))
    repl_100k = cuda(cases.replicated_inputs(rng, 102_400, P))

    def forced(rows):
        def call():
            with vote_design(tq, rows):
                tq.apply_vote_events(*votes)
        return call

    def tally_forced(tile, args):
        def call():
            with tally_design(tq, tile):
                tq.tally_votes_packed(*args)
        return call

    out = {}
    for key, call, kernel in (
            ("K3", lambda: tq.tally_rows(*packed), None),
            ("K3_public", lambda: tq.tally_votes_packed(*tally),
             tq.K3_PUBLIC),
            ("K3_public_100k", lambda: tq.tally_votes_packed(*tally_100k),
             tq.K3_PUBLIC),
            ("K3_public_lanes", tally_forced(0, tally), tq.K3_PUBLIC),
            ("K3_public_tile", tally_forced(tq.TALLY_TILE, tally),
             tq.K3_PUBLIC),
            ("K7a", lambda: tq.apply_vote_events(*votes), tq.K7a),
            ("K7a_rows", forced(tq.vote_block_rows(g)), tq.K7a),
            ("K7a_grid", forced(0), tq.K7a),
            ("K7b", lambda: tq.all_replicated_min(*repl), tq.K7b),
            ("K7b_100k", lambda: tq.all_replicated_min(*repl_100k), tq.K7b),
            ("K7c", lambda: tq.lease_expiry(*lease, 1000), tq.K7c)):
        n = kernel.launches if kernel else 0
        nodes = graph_nodes(call)
        if kernel and ([is_kernel_node(x) for x in nodes] != [True]
                       or kernel.launches != n + 2):
            raise AssertionError(f"one {key} call put {len(nodes)} graph "
                                 f"nodes on the card ({kernel.launches - n} "
                                 f"launches counted): {nodes}")
        out[key] = [" ".join(x.split())[:160] for x in nodes]
    return out


def run_main_path(tq, kernels, groups: int, writes: int, rec):
    from ratis_tpu_torch.tools.cluster import Cluster
    cluster = Cluster(groups, device="cuda")
    cluster.prewarm()
    with rec:
        res, launches = counted(kernels, ("K1", "K2", "K3", "K4"),
                                lambda: asyncio.run(drive(cluster, writes)),
                                never=("K5",))
    res.update(engine_shape(cluster))
    return res, launches


def engine_shape(cluster) -> dict:
    e = cluster.servers[0].engine
    return {"capacity": e.state.capacity, "peers": e.state.max_peers,
            "ledger_width": e.ledger._table_width()}


def run_mesh_path(kernels, rec):
    """3 servers x 1024 groups, every engine in 8 slices: the fast ticks
    must all be K5."""
    from ratis_tpu_torch.conf import RaftServerConfigKeys
    from ratis_tpu_torch.tools.cluster import Cluster, cluster_properties
    props = cluster_properties(MESH_GROUPS, 3, "cuda", "sim", MESH_SLICES)
    props.set(RaftServerConfigKeys.Engine.MAX_GROUPS_KEY,
              str(MESH_MAX_GROUPS))
    cluster = Cluster(MESH_GROUPS, device="cuda", properties=props)
    cluster.prewarm()
    with rec:
        res, launches = counted(
            kernels, ("K2", "K3", "K4", "K5"),
            lambda: asyncio.run(drive(cluster, MESH_WRITES)), never=("K1",))
    slices = [(s.engine.state.n_slices, s.engine.mesh.n_slices)
              for s in cluster.servers]
    if slices != [(MESH_SLICES, MESH_SLICES)] * 3:
        raise AssertionError(f"mesh path: slices {slices}")
    res["n_slices"] = [n for n, _ in slices]
    res.update(engine_shape(cluster))
    return res, launches


def run_mesh_rungs(kernels, bench):
    """``dryrun_multichip(8)`` (K6, then a mesh engine: K5 and K2) and the
    bench's ``mesh_100k`` rung (K5 and its control K1)."""
    return counted(kernels, ("K1", "K2", "K5", "K6"), lambda: {
        "dryrun_multichip": bench.dryrun_multichip(MESH_SLICES, "cuda"),
        "mesh_100k": bench.mesh_100k_rung("cuda")})


def run_kernel_rungs(kernels, bench):
    """The bench's kernel rungs on the card (K6)."""
    return counted(kernels, ("K6",), lambda: {
        "kernel": bench.kernel_rung("cuda"),
        "kernel_100k": bench.kernel_100k_rung("cuda")})


def run_tcp_path(kernels, bench, rec):
    """The bench's headline e2e rung: 3 servers over localhost TCP."""
    cluster = bench.e2e_cluster("cuda", TCP_GROUPS)
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.e2e_rung(cluster, TCP_WRITES)),
            never=("K5",))
    groups = TCP_GROUPS
    want = groups * (bench.WARMUP_WRITES + TCP_WRITES)
    if res["acked"] != want or res["replicas_read_back"] != groups * 3:
        raise AssertionError(f"TCP path: {res['acked']} of {want} writes "
                             f"acked, {res['replicas_read_back']} replicas "
                             f"read back")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"TCP path: engine on {res['engine_device']}")
    return res, launches


def run_durable_path(kernels, bench, groups: int, shared: bool, rec):
    """The bench's durable rung (``shared``: on the shared log plane) in a
    fresh temporary directory: 3 servers x ``groups`` groups over TCP,
    ArithmeticStateMachine, every map held to the fold before and after a
    full restart from disk."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="ratis-smoke-durable-") as tmp:
        cluster = bench.durable_cluster("cuda", groups, tmp, shared)
        with rec:
            res, launches = counted(
                kernels, ("K1", "K2", "K3", "K4"),
                lambda: asyncio.run(bench.durable_rung(
                    cluster, DURABLE_WRITES,
                    after=None if shared else log_span)),
                never=("K5",))
        if not shared:
            # one group's segment files, before the storage goes
            res["parse_log"] = parse_log_check(res.pop("after"))
    want = groups * (bench.WARMUP_WRITES + DURABLE_WRITES)
    if res["acked"] != want or res["replicas_read_back"] != [groups * 3] * 2:
        raise AssertionError(f"durable path: {res['acked']} of {want} "
                             f"writes acked, replicas read back "
                             f"{res['replicas_read_back']}")
    if not res["engine_device"].startswith("cuda") \
            or res["shared_log"] != shared:
        raise AssertionError(f"durable path: engine on "
                             f"{res['engine_device']}, shared log "
                             f"{res['shared_log']}")
    return res, launches


class JointRecorder:
    """While active, counts the K1 and K2 calls an engine made while its
    host mirror had a row it leads (role leader) with a non-empty
    ``conf_old`` (joint consensus: the only rows where the ``conf_old``
    branch decides a commit); the plans' ``run`` are swapped for counting
    ones and restored on exit."""

    def __init__(self, tq, cluster):
        from ratis_tpu_torch.engine.roles import ROLE_LEADER
        self.tq = tq
        self.cluster = cluster
        self.leader = ROLE_LEADER
        self.joint_calls = {"K1": 0, "K2": 0}
        # calls on a state no engine held (reported; expected 0)
        self.unmatched = 0

    def _leads_joint_row(self, state) -> bool:
        for s in self.cluster.servers:
            e = s.engine
            if e._dev is state:
                m = e.state
                return bool((m.conf_old.any(axis=1)
                             & (m.role == self.leader)).any())
        self.unmatched += 1
        return False

    def __enter__(self):
        tq = self.tq
        self.fast, self.refresh = tq.FastPlan.run, tq.RefreshPlan.run
        fast, refresh = self.fast, self.refresh

        def rec_fast(plan, *rest):
            self.joint_calls["K1"] += self._leads_joint_row(plan.state)
            return fast(plan, *rest)

        def rec_refresh(plan, *rest):
            self.joint_calls["K2"] += self._leads_joint_row(plan.state)
            return refresh(plan, *rest)

        tq.FastPlan.run = rec_fast
        tq.RefreshPlan.run = rec_refresh
        return self

    def __exit__(self, *exc):
        self.tq.FastPlan.run = self.fast
        self.tq.RefreshPlan.run = self.refresh


def run_churn_path(tq, kernels, bench, shapes):
    """The bench's churn rung: leadership transfers and joint-consensus
    rounds under write load, over the simulated transport."""
    cluster = bench.churn_cluster("cuda", CHURN_GROUPS)
    with shapes, JointRecorder(tq, cluster) as rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.churn_rung(cluster, CHURN_WRITES)),
            never=("K5",))
    res["joint_calls"] = dict(rec.joint_calls)
    res["joint_unmatched_calls"] = rec.unmatched
    if res["transfers_ok"] + res["transfers_failed"] != bench.CHURN_TRANSFERS:
        raise AssertionError(f"churn path: {res['transfers_ok']} + "
                             f"{res['transfers_failed']} transfers counted "
                             f"of {bench.CHURN_TRANSFERS}")
    if res["commits"] != CHURN_GROUPS * CHURN_WRITES \
            or res["replicas_read_back"] != CHURN_GROUPS * 3 \
            or res["final_conf_sizes"] != [3]:
        raise AssertionError(f"churn path: {res['commits']} writes acked, "
                             f"{res['replicas_read_back']} replicas read "
                             f"back, conf sizes {res['final_conf_sizes']}")
    if rec.joint_calls["K1"] + rec.joint_calls["K2"] == 0:
        raise AssertionError("churn path: no K1/K2 launch while the engine "
                             "led a row in joint consensus")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"churn path: engine on {res['engine_device']}")
    return res, launches


def run_stream_path(kernels, fb, seed: int, rec):
    """The bench's stream rung: 4 streams of 32 MB at once into 3 servers
    x 4 FileStore groups; every stream acknowledged and its bytes equal on
    all three replicas."""
    load = fb.LOADS["stream"]
    cluster = fb.filestore_cluster("cuda", max(load["streams"], 4))
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(fb.run_stream_throughput_bench(
                cluster, load["streams"], load["stream_bytes"],
                load["packet"], load["window"], seed)), never=("K5",))
    n = load["streams"]
    if (res["streams_ok"], res["streams_failed"]) != (n, 0) \
            or res["files"] != n or res["replicas_checked"] != 4 * 3:
        raise AssertionError(f"stream path: {res}")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"stream path: engine on {res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


def run_filestore5_path(kernels, fb, seed: int, rec):
    """BASELINE config 3 at 5 x 1024: the filestore5 rung's deployment
    (5 servers over localhost TCP, FileStore, DataStream on every server),
    one warm-up write per group and every replica's files held to it, one
    write per group and the files held again, then 16 streams of 4 MB and
    the files held a third time; the vote passes must have tallied rounds
    of 5 members."""
    load = fb.LOADS["filestore5"]
    cluster = fb.filestore_cluster("cuda", FS5_GROUPS, FS5_SERVERS, "tcp")
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(fb.run_mixed_bench(
                cluster, FS5_WRITES, load["streams"], load["stream_bytes"],
                stream_window=load["window"], warmup=1, overlap=False,
                seed=seed)), never=("K5",))
    res["vote_round_members"] = dict(rec.members)
    want = FS5_GROUPS * (1 + FS5_WRITES)
    replicas = FS5_GROUPS * FS5_SERVERS
    if res["acked"] != want or res["peers"] != FS5_SERVERS \
            or res["replicas_checked"] != [replicas] * 3 \
            or (res["streams_ok"], res["streams_failed"]) \
            != (load["streams"], 0) \
            or res["files"] != want + load["streams"]:
        raise AssertionError(f"filestore5 path: {res['acked']} of {want} "
                             f"writes acked, replicas checked "
                             f"{res['replicas_checked']}, streams ok "
                             f"{res['streams_ok']} failed "
                             f"{res['streams_failed']} "
                             f"{res['stream_failures']}, files "
                             f"{res['files']}")
    if rec.members.get(FS5_SERVERS, 0) == 0:
        raise AssertionError(f"filestore5 path: no vote round of "
                             f"{FS5_SERVERS} members: {dict(rec.members)}")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"filestore5 path: engine on "
                             f"{res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


def _route_summary(routes: dict) -> dict:
    """{route: servers that answered it} of one ``fetch_routes()``."""
    out = collections.Counter()
    for got in routes.values():
        out.update(got.keys())
    return dict(out)


def run_telemetry_path(kernels, bench, rec):
    """The bench's telemetry rung with every server's HTTP endpoint on a
    port it binds: every route fetched over HTTP from every server during
    the measured writes and after them (each must answer 200 and parse);
    ``/timeseries`` holding a sample for each second of the writes but
    one; after the writes settle (every group led by a ready leader
    again), every row a server leads carrying its division's own commit
    index in the ledger sample its ``/lag`` request took, and every group
    led in one of those samples.  The settled ``/lag`` requests go to the
    servers at once: fetched one server after the other, a leadership
    that moved between two servers' samples (elections follow a loop
    pause at this 1 s / 2 s tier) was counted by neither or by both."""
    from ratis_tpu_torch.metrics.aggregate import fetch_json
    from ratis_tpu_torch.tools.cluster import HTTP_ROUTES
    watched = {}

    async def during(cluster):
        watched["lag"] = cluster.watch_lag()
        await asyncio.sleep(1.0)
        t0 = time.monotonic()
        routes = await cluster.fetch_routes()
        watched["fetch_s"] = time.monotonic() - t0
        return _route_summary(routes)

    async def after(cluster):
        routes = await cluster.fetch_routes()
        await cluster.wait_leaders(cluster.groups, TEL_SETTLE_S)
        n = len(watched["lag"])
        await asyncio.gather(*(fetch_json(a, f"/lag?n={TEL_GROUPS}")
                               for a in cluster.http_addresses()))
        settled = watched["lag"][n:]
        mismatched = [(peer, str(gid), ledger, own)
                      for peer, rows, _ in settled
                      for gid, (ledger, own) in rows.items() if ledger != own]
        led = sum(len(rows) for _, rows, _ in settled)
        return {"routes": _route_summary(routes),
                "timeseries": {p: got["/timeseries"]["count"]
                               for p, got in routes.items()},
                "lag_gets": len(watched["lag"]), "lag_rows": led,
                "lag_mismatched": mismatched[:10],
                "lag_listed": sum(len(payload["groups"])
                                  for _, _, payload in settled),
                "ports": [s.metrics_http.bound_port
                          for s in cluster.servers],
                # every route of every server, fetched once in the writes
                "fetch_during_s": watched["fetch_s"],
                # the shell's HTTP commands against the servers
                "shell": await run_shell(cluster)}

    cluster = bench.telemetry_cluster("cuda", TEL_GROUPS, http_port=0)
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.e2e_rung(cluster, TEL_WRITES,
                                               during=during, after=after)),
            never=("K5",))
    servers = len(cluster.servers)
    every = {r: servers for r in HTTP_ROUTES}
    got = res["after"]
    least = int(res["elapsed_s"]) - 1
    want = TEL_GROUPS * (bench.WARMUP_WRITES + TEL_WRITES)
    if res["during"] != every or got["routes"] != every:
        raise AssertionError(f"telemetry path: routes answered during "
                             f"{res['during']}, after {got['routes']}")
    if min(got["timeseries"].values()) < least:
        raise AssertionError(f"telemetry path: /timeseries samples "
                             f"{got['timeseries']} over {res['elapsed_s']} "
                             f"s of writes")
    if got["lag_mismatched"] or got["lag_rows"] != TEL_GROUPS:
        raise AssertionError(f"telemetry path: /lag led rows "
                             f"{got['lag_rows']} of {TEL_GROUPS}, commit "
                             f"indexes unlike the divisions' "
                             f"{got['lag_mismatched']}")
    if res["acked"] != want or res["replicas_read_back"] != TEL_GROUPS * 3 \
            or not all(got["ports"]) or res["telemetry"]["samples"] == 0:
        raise AssertionError(f"telemetry path: {res['acked']} of {want} "
                             f"writes acked, ports {got['ports']}, "
                             f"telemetry {res['telemetry']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


def run_sparse_path(kernels, bench, rec):
    """The sparse shape with the upkeep plane: 3 servers x
    ``SPARSE_GROUPS`` groups, hibernation and ``raft.tpu.upkeep.enabled``
    on; settled until every idle leader sleeps (at most 20 s), the upkeep
    tick pair timed on the live divisions (plane sweep against the legacy
    walk), then ``SPARSE_WRITES`` writes per group on the first
    ``SPARSE_ACTIVE`` groups and every counter read back from all three
    replicas (those writes on the written groups, 0 on the rest)."""
    from ratis_tpu_torch.tools import upkeep_bench as ub
    settle = ub.hibernate_settle(SPARSE_SETTLE_S, until_asleep=True)

    async def settle_and_time(cluster):
        res = await settle(cluster)
        res["tick_pair"] = ub.tick_pair(cluster)
        return res

    cluster = ub.upkeep_cluster("cuda", SPARSE_GROUPS)
    with rec, StaleSkips() as skips:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.e2e_rung(
                cluster, SPARSE_WRITES, warmup=0, settle=settle_and_time,
                active_groups=SPARSE_ACTIVE)), never=("K5",))
    res["stale_verdicts"] = skips.stale
    res["stale_skipped_hibernating"] = skips.skipped
    pair = res["settle"]["tick_pair"]
    if res["settle"]["hibernated_groups"] == 0 \
            or pair["registered_slots"] != 3 * SPARSE_GROUPS:
        raise AssertionError(f"sparse path: {res['settle']}")
    if res["commits"] != SPARSE_ACTIVE * SPARSE_WRITES \
            or res["replicas_read_back"] != SPARSE_GROUPS * 3:
        raise AssertionError(f"sparse path: {res['commits']} writes acked, "
                             f"{res['replicas_read_back']} replicas read "
                             f"back")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"sparse path: engine on {res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


class PathProcess:
    """A phase in a process of its own, beside the main process's phases:
    ``chip_smoke.py --path NAME --result FILE`` runs the path
    (``PROCESS_PATHS``) under its own ``ShapeRecorder`` (its launch counts
    zeroed just before it drives the path and read just after, as every
    path's) and writes the result, the launches and the recorder's report
    to FILE; its output goes to a file beside it.  Phase 4l: the chaos
    campaign's 12 scenarios hold their faults for 330-360 s on the card
    host, most of which its process spends idle waiting on them.  Phase
    4s: the scalar control's one loop is busy for 229 s, on a core of its
    own.  ``collect`` waits for it (``timeout_s`` from its start) and
    raises with the end of its output if it failed; ``kill`` stops it."""

    def __init__(self, path: str, tmp: str, timeout_s: float):
        self.path, self.timeout_s = path, timeout_s
        self.result = os.path.join(tmp, f"{path}.json")
        self.output = os.path.join(tmp, f"{path}.out")
        with open(self.output, "wb") as out:
            self.proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--path",
                 path, "--result", self.result], cwd=ROOT,
                env=module_env(), stdout=out, stderr=subprocess.STDOUT)
        self.t0 = time.monotonic()

    def collect(self, rec) -> tuple:
        try:
            rc = self.proc.wait(max(1.0, self.timeout_s
                                    - (time.monotonic() - self.t0)))
        except subprocess.TimeoutExpired:
            self.kill()
            rc = f"none after {self.timeout_s:.0f} s"
        if rc != 0:
            with open(self.output, errors="replace") as f:
                tail = f.read().splitlines()[-40:]
            raise AssertionError(f"{self.path} process: exit {rc}; its "
                                 f"output ended:\n" + "\n".join(tail))
        with open(self.result) as f:
            out = json.load(f)
        rec.merge(out["recorder"])
        return out["res"], out["launches"]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def path_process_main(path: str, result: str) -> int:
    """``--path PATH``: that phase alone, into ``result``."""
    rec = ShapeRecorder()
    res, launches = PROCESS_PATHS[path](kernel_launchers(), rec)
    with open(result, "w") as f:
        json.dump({"res": res, "launches": launches,
                   "recorder": rec.report()}, f, default=str)
    return 0


def run_chaos_path(kernels, rec):
    """The bench's chaos rung: ``run_chaos_1024`` on ``cuda`` (3 x
    ``CHAOS_GROUPS`` counter groups over the simulated transport on the
    shared durable log in a fresh temporary directory, the 12 scenarios,
    seed 1); every scenario must pass and every injected fault be
    journaled and recovered.  The servers a crash rebuilds mid-phase are
    new engines and plans: the recorders swap class methods, so they
    count them too."""
    from ratis_tpu_torch.chaos.campaign import run_chaos_1024
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(run_chaos_1024(seed=CHAOS_SEED,
                                               num_groups=CHAOS_GROUPS,
                                               device="cuda")),
            never=("K5",))
    failed = {n: e.get("error") for n, e in res["scenarios"].items()
              if not e["passed"]}
    if failed or res["passed"] != res["total"] \
            or res["total"] != CHAOS_SCENARIOS:
        raise AssertionError(f"chaos path: {res['passed']} of "
                             f"{res['total']} scenarios passed; failed "
                             f"{failed}")
    if res["fault_events"] == 0 \
            or res["recovered_events"] < res["fault_events"]:
        raise AssertionError(f"chaos path: {res['fault_events']} faults "
                             f"journaled, {res['recovered_events']} "
                             f"recovered")
    res["engine"] = rec.engine()
    return res, launches


def run_placement_path(kernels, rec):
    """The bench's placement rung: 4 servers x 48 groups over localhost
    TCP, the zipf fleet with a pinned hotspot and a grey follower, phase
    OFF, then a placement controller on every server and phase ON; no
    request may fail and the controllers must have planned."""
    from ratis_tpu_torch.tools import placement_bench as pb
    load = pb.PLACEMENT
    cluster = pb.placement_cluster("cuda", load["groups"], load["servers"],
                                   load["element_limit"])
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(pb.placement_rung(
                cluster, clients=load["clients"],
                requests_per_client=PLACEMENT_REQUESTS,
                pace_s=load["pace_s"], hot_pins=load["hot_pins"],
                settle_s=PLACEMENT_SETTLE_S)), never=("K5",))
    if res["failures"] != 0 or res["plans_computed"] == 0:
        raise AssertionError(f"placement path: {res['failures']} requests "
                             f"failed, {res['plans_computed']} plans")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"placement path: engine on "
                             f"{res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


def run_readmix_path(kernels, rec):
    """The bench's readmix rung at its full size: 3 servers x 1024 groups
    over TCP, linearizable reads with the leader lease, 4 writes per group
    each chased by a lease read at the leader and a linearizable and a
    stale read at a follower, 128 in flight; no read value and no replica
    may break its bounds."""
    from ratis_tpu_torch.tools import read_bench as rb
    load = rb.READMIX
    cluster = rb.read_cluster("cuda", READ_GROUPS, load["servers"])
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(rb.readmix_rung(
                cluster, load["writes"], load["reads_per_write"],
                load["concurrency"])), never=("K5",))
    want = READ_GROUPS * load["writes"]
    if res["read_mismatches"] or res["replica_mismatches"] \
            or res["replicas_read_back"] != READ_GROUPS * load["servers"] \
            or res["commits"] + res["write_failures"] != want:
        raise AssertionError(
            f"readmix path: {res['commits']} of {want} writes, read "
            f"mismatches {res['read_mismatch_examples']}, replica "
            f"mismatches {res['replica_mismatch_examples']}, replicas "
            f"read back {res['replicas_read_back']}")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"readmix path: engine on "
                             f"{res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


def run_zipf_path(kernels, rec):
    """The bench's zipf rung at its full size: 3 servers x 1024 groups
    over TCP, 10240 clients with zipf(1.1) homes, a write and a
    linearizable read each, 512 in flight, admission at 192 pending
    elements, telemetry at 250 ms; no read value and no replica may break
    its bounds, and the pending peak stays at or under the limit (one
    shard per server)."""
    from ratis_tpu_torch.tools import read_bench as rb
    load = rb.ZIPF
    cluster = rb.read_cluster("cuda", READ_GROUPS, load["servers"],
                              zipf=True,
                              element_limit=load["element_limit"])
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(rb.zipf_rung(cluster)), never=("K5",))
    if res["read_mismatches"] or res["replica_mismatches"] \
            or res["replicas_read_back"] != READ_GROUPS * load["servers"] \
            or res["pending_peak"] > load["element_limit"]:
        raise AssertionError(
            f"zipf path: pending peak {res['pending_peak']} (limit "
            f"{load['element_limit']}), read mismatches "
            f"{res['read_mismatch_examples']}, replica mismatches "
            f"{res['replica_mismatch_examples']}, replicas read back "
            f"{res['replicas_read_back']}")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"zipf path: engine on {res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


def run_snapcatch_path(kernels, rec):
    """The bench's snapcatch rung at its full size on ``cuda`` (snapshot
    storage in a fresh temporary directory): every wiped group caught up
    by an install, every replica's counter equal to both loads'
    acknowledged writes, the wiped engine on 1024 live rows."""
    import tempfile

    from ratis_tpu_torch.tools import snapshot_bench as sb
    load = sb.SNAPCATCH
    groups = load["groups"]
    with tempfile.TemporaryDirectory(prefix="ratis-snapcatch-") as tmp:
        cluster = sb.snapcatch_cluster("cuda", groups, tmp)
        with rec:
            res, launches = counted(
                kernels, ("K1", "K2", "K3", "K4"),
                lambda: asyncio.run(sb.snapcatch_rung(
                    cluster, load["writes"], load["concurrency"])),
                never=("K5",))
    want = groups * load["writes"] * 2
    if res["installs"] != groups or res["replica_mismatches"] \
            or res["replicas_read_back"] != groups * load["servers"] \
            or res["commits"] != want or res["victim_live_rows"] != groups:
        raise AssertionError(
            f"snapcatch path: installs {res['installs']} of {groups}, "
            f"{res['commits']} of {want} writes, replica mismatches "
            f"{res['replica_mismatch_examples']}, replicas read back "
            f"{res['replicas_read_back']}, wiped engine's live rows "
            f"{res['victim_live_rows']}")
    if not res["engine_device"].startswith("cuda") or any(
            s.engine.device.type != "cuda" for s in cluster.servers):
        raise AssertionError(f"snapcatch path: engine on "
                             f"{res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    return res, launches


def run_peer7_path(kernels, bench, rec):
    """The bench's peer7 rung at ``PEER7_GROUPS`` x ``PEER7_WRITES``: 7
    servers over the simulated transport, traced; every write acked and
    read back from all 7 replicas."""
    cluster = bench.peer7_cluster("cuda", PEER7_GROUPS)
    with rec:
        res, launches = counted(
            kernels, ("K1", "K2", "K3", "K4"),
            lambda: asyncio.run(bench.e2e_rung(
                cluster, PEER7_WRITES, warmup=bench.PEER7["warmup"])),
            never=("K5",))
    servers = bench.PEER7["servers"]
    want = PEER7_GROUPS * PEER7_WRITES
    if res["acked"] != want or res["servers"] != servers \
            or res["replicas_read_back"] != PEER7_GROUPS * servers:
        raise AssertionError(f"peer7 path: {res['acked']} of {want} writes "
                             f"acked, {res['replicas_read_back']} replicas "
                             f"read back")
    if not res["engine_device"].startswith("cuda"):
        raise AssertionError(f"peer7 path: engine on {res['engine_device']}")
    res["engine"] = engine_shape(cluster)
    res["vote_round_members"] = dict(rec.members)
    return res, launches


def run_mp5_path(bench, rec):
    """The bench's peer5_mp rung at ``MP5_GROUPS`` x ``MP5_WRITES``: 5
    server processes over localhost TCP, loop shards and client processes
    by ``bench.peer5_mp_shape``, leaders appointed by server 0, every
    32nd write traced.  Every write acked (or failures within the JAX
    bound, which the harness raises past) and every counter on all 5
    servers between its group's writes acked and sent; each server's
    engine on the card with K1-K4 > 0 (K3 at least from the election by
    which it took one group's leadership after the load) and K5, K6,
    K7a-c and the public K3 at 0 in its own counts (each process counts
    its own launches, from after its prewarm: the smoke's counts see none
    of them), none of its
    prepared calls off the home loop's thread, and each of its ledger
    samples one library call and one K4 launch; no client touched CUDA;
    the merged snapshot holds 5 pids, all healthy; the merged trace at
    least 2 pids; and no child is left.  The children's shapes and
    samples go into ``rec``.  Returns the result and the launches summed
    over the children."""
    import tempfile
    from ratis_tpu_torch.tools.multiproc_bench import live_children
    with tempfile.TemporaryDirectory(prefix="ratis-mp5-") as tmp:
        res = asyncio.run(bench.peer5_mp_rung(
            "cuda", MP5_GROUPS, MP5_WRITES,
            trace_out=os.path.join(tmp, "trace.json"), record_plans=True,
            bringup_timeout_s=MP5_TIMEOUT_S, load_timeout_s=MP5_TIMEOUT_S))
    servers, n = res["servers"], bench.PEER5["servers"]
    faults = []
    left = live_children(res["child_pids"])
    if left:
        faults.append(f"children left running: {left}")
    if len(servers) != n:
        faults.append(f"{len(servers)} of {n} servers reported")
    for r in servers:
        who = f"{r['peer']} (pid {r['pid']})"
        if not r["device"].startswith("cuda"):
            faults.append(f"{who}: engine on {r['device']}")
        idle = [k for k in ("K1", "K2", "K3", "K4") if not r["launches"][k]]
        busy = [k for k in ("K5", "K6", *OFF_PATH) if r["launches"][k]]
        if idle or busy:
            faults.append(f"{who}: never launched {idle}, launched {busy}: "
                          f"{r['launches']}")
        if r["off_home_calls"]:
            faults.append(f"{who}: prepared calls off the home loop's "
                          f"thread {r['off_home_calls']}")
        if not r["ledger_samples"] or r["ledger_faults"]:
            faults.append(f"{who}: ledger samples {r['ledger_samples']}, "
                          f"(library calls, K4 launches) of those not one "
                          f"and one {r['ledger_faults']}")
        if r["divisions"] != MP5_GROUPS:
            faults.append(f"{who}: {r['divisions']} divisions")
    failed_transfers = [t for t in res["transfers"] if not t["ok"]]
    if failed_transfers:
        faults.append(f"leadership transfers failed: {failed_transfers}")
    touched = [c["pid"] for c in res["clients"] if c["cuda_initialized"]]
    if touched:
        faults.append(f"clients that initialized CUDA: {touched}")
    if res["replica_mismatches"] \
            or res["replicas_read_back"] != n * MP5_GROUPS:
        faults.append(f"{res['replica_mismatches']} of "
                      f"{res['replicas_read_back']} counters outside their "
                      f"writes acked and sent: {res['mismatch_examples']}")
    cm = res["cluster_metrics"]
    if len(cm["procs"]) != n or cm["healthy"] != n:
        faults.append(f"merged snapshot: {len(cm['procs'])} pids, "
                      f"{cm['healthy']} healthy")
    if res["trace_pids"] < 2:
        faults.append(f"merged trace over {res['trace_pids']} pids")
    if faults:
        raise AssertionError("mp5 path: " + "; ".join(faults))
    for r in servers:
        rec.merge(r)
    res["engine"] = servers[0]["engine_shape"]
    res["vote_round_members"] = dict(rec.members)
    launches = {k: sum(r["launches"][k] for r in servers)
                for k in servers[0]["launches"]}
    return res, launches


def run_scalar_path(kernels, rec):
    """The bench's scalar rung (the TCP headline's scalar control) at
    ``SCALAR_GROUPS`` x (1 + ``TCP_WRITES``): every write acked and every
    counter read back from 3 replicas, every engine on the card, no K1,
    K2, K3 or K5 launched (every tick on the per-division host loop) and
    one K4 launch per ledger sample of the phase.  Then the batched
    deployment at the same shape and load (``batched_control``: the
    comparison's numerator, outside the phase's counts)."""
    from ratis_tpu_torch.tools import bench
    cluster = bench.e2e_cluster("cuda", SCALAR_GROUPS, batched=False)
    with rec:
        res, launches = counted(
            kernels, ("K4",),
            lambda: asyncio.run(bench.e2e_rung(cluster, TCP_WRITES)),
            never=("K1", "K2", "K3", "K5"))
    want = SCALAR_GROUPS * (bench.WARMUP_WRITES + TCP_WRITES)
    if res["mode"] != "scalar" or res["acked"] != want \
            or res["replicas_read_back"] != SCALAR_GROUPS * 3:
        raise AssertionError(f"scalar path ({res['mode']}): {res['acked']} "
                             f"of {want} writes acked, "
                             f"{res['replicas_read_back']} replicas read "
                             f"back")
    if not res["engine_device"].startswith("cuda") or any(
            s.engine.device.type != "cuda" for s in cluster.servers):
        raise AssertionError(f"scalar path: engine on "
                             f"{res['engine_device']}")
    if launches["K4"] != rec.ledger_samples:
        raise AssertionError(f"scalar path: {launches['K4']} K4 launches "
                             f"for {rec.ledger_samples} ledger samples")
    control = asyncio.run(bench.e2e_rung(
        bench.e2e_cluster("cuda", SCALAR_GROUPS), TCP_WRITES))
    if control["mode"] != "batched" or control["acked"] != want:
        raise AssertionError(f"scalar path's batched control "
                             f"({control['mode']}): {control['acked']} of "
                             f"{want} writes acked")
    res["batched_control"] = {k: control[k] for k in (
        "commits_per_sec", "p50_ms", "p99_ms", "election_timeouts",
        "election_convergence_s")}
    return res, launches


# the phases that run in a process of their own (``PathProcess``)
PROCESS_PATHS = {"chaos_1024": run_chaos_path,
                 "scalar_512": run_scalar_path}


def run_profile_path(kernels, bench, rec):
    """``PROFILE_GROUPS`` x ``PROFILE_WRITES`` over the simulated transport
    with ``raft.tpu.engine.profile-dir`` in a fresh temporary directory:
    after the close exactly one trace file, holding ``engine_tick``
    ranges and kernel events of ``tile_tick`` (the session's CUDA
    activity), and no engine owning a session any more (K1-K4 > 0, K5
    0)."""
    import tempfile

    from ratis_tpu_torch.conf import RaftServerConfigKeys
    from ratis_tpu_torch.engine.engine import QuorumEngine
    with tempfile.TemporaryDirectory(prefix="ratis-smoke-profile-") as tmp:
        cluster = bench.e2e_cluster("cuda", PROFILE_GROUPS, "sim", props={
            RaftServerConfigKeys.Engine.PROFILE_DIR_KEY: tmp})
        with rec:
            res, launches = counted(
                kernels, ("K1", "K2", "K3", "K4"),
                lambda: asyncio.run(bench.e2e_rung(cluster, PROFILE_WRITES,
                                                   warmup=0)),
                never=("K5",))
        traces = sorted(os.listdir(tmp))
        if len(traces) != 1:
            raise AssertionError(f"profile path: trace files {traces}")
        path = os.path.join(tmp, traces[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(path)
    kernel_events = collections.Counter(
        e.get("name", "") for e in events if e.get("cat") == "kernel")
    ranges = sum(1 for e in events if e.get("name") == "engine_tick")
    tile = sum(n for name, n in kernel_events.items() if "tile_tick" in name)
    owners = [s.peer_id for s in cluster.servers
              if s.engine._profiler is not None]
    if not ranges or not tile or owners \
            or QuorumEngine._profiling_owner is not None:
        raise AssertionError(
            f"profile path: {ranges} engine_tick ranges, {tile} tile_tick "
            f"kernel events ({dict(kernel_events)}), sessions still owned "
            f"by {owners} / {QuorumEngine._profiling_owner}")
    if res["acked"] != PROFILE_GROUPS * PROFILE_WRITES:
        raise AssertionError(f"profile path: {res['acked']} writes acked")
    res["profile"] = {
        "trace_file": traces[0], "trace_bytes": trace_bytes,
        "events": len(events), "engine_tick_ranges": ranges,
        "tile_tick_events": tile,
        # kernel events by name (a mangled name cut to 80 characters)
        "kernel_events": {name[:80]: n for name, n in kernel_events.items()}}
    res["engine"] = engine_shape(cluster)
    return res, launches


# -- phase 5: timing ---------------------------------------------------------

def state_bytes(g, p):
    # match, last_ack (int32), self/cur/old (bool), role (int8), 4 x int32
    return g * p * (4 + 4 + 3) + g * (1 + 16)


def written_bytes(before, after) -> int:
    """Bytes of the in-place state that one call changed: the least an
    in-place update must write."""
    return sum(int((x != y).sum()) * x.element_size()
               for x, y in zip(before, after))


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_INT32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_inplace(tq, st, kernel, plain):
    """Kernel and plain times of an in-place step, each call on the same
    fresh state, and the state bytes one call changes."""
    fresh = tq.device_state_from_numpy(st, "cuda")
    a = tq.device_state_from_numpy(st, "cuda")

    def restore():
        for x, y in zip(a, fresh):
            x.copy_(y)

    ms = timed(lambda: kernel(a), restore)
    plain_ms = timed(lambda: plain(a), restore, n=PLAIN_CALLS)
    restore()
    plain(a)
    return ms, plain_ms, written_bytes(fresh, a)


def k6_bytes(g: int, p: int, e: int) -> int:
    """K6's least traffic: each input read once (match and last_ack int32
    and three bool masks per link; four int32 and one bool per ack;
    flush, commit, first, deadline int32 and role int8 per row), each
    output written once (two [G, P] int32, new_commit int32 and three
    bools per row)."""
    return g * p * (8 + 3) + 17 * e + 17 * g + g * p * 8 + 7 * g


# host us per call of each timed wrapper, and its device us per call from
# a CUDA graph, by timing key
HOST_US: dict = {}
GRAPH_US: dict = {}
# calls in a plain version's timed median (its ms-scale times need no 200)
PLAIN_CALLS = 20


def per_call(key: str, fn) -> None:
    """The host us per call of ``fn`` (HOST_US[key]) and its device us per
    call from a CUDA graph (GRAPH_US[key])."""
    HOST_US[key] = host_us(fn)
    GRAPH_US[key] = graph_us_per_call(fn)


def graph_us_per_call(fn, n: int = 20):
    """Device us per call of ``fn`` from ``n`` calls in one CUDA graph
    (``fast_tick_timing.graph_us``); None, and a log line, where a call
    cannot be captured."""
    try:
        return graph_us(fn, n)
    except RuntimeError as exc:
        log(f"graph timing: not measured ({exc})")
        return None


def k2_timing(tq, cases, rng, g, p, d, e, out, key) -> None:
    """K2's public wrapper at one shape: each input read once (the state,
    the refresh indices and the rows that are not padding, 17 bytes per
    ack), the state bytes it changes and the int32 [4, G] output written
    once."""
    st = cases.resident_state(rng, g, p, NOW)
    rf_idx_np, rf, acks = cases.refresh(rng, g, p, d, e, NOW)
    d_real = int((rf_idx_np < g).sum())
    rf_idx, *rf = cuda([rf_idx_np, *rf])
    acks = cuda(acks)
    ms, plain, wrote = time_inplace(
        tq, st, lambda s: tq.engine_step_resident(s, rf_idx, *rf, *acks, NOW,
                                                  TIMEOUT_MS),
        lambda s: tq._resident_refresh_plain(s, rf_idx, rf, acks, NOW,
                                             TIMEOUT_MS))
    nbytes = (state_bytes(g, p) + 4 * d + state_bytes(d_real, p) + 17 * e
              + wrote + 16 * g)
    out[key] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * e
                                  + d_real * 12 * p),
                f"G={g} P={p} D={d} ({d_real} rows) E={e} "
                f"tile={tq.tick_tile(g)}")
    a = tq.device_state_from_numpy(st, "cuda")
    per_call(key, lambda: tq.engine_step_resident(
        a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS))


def k2_extra_timing(tq, cases, rng, p, out) -> None:
    """K2 with each tile size at G = 1024, 10240 and 102400, at the main
    paths' most common (D, E) = (64, 64) and at the acks' cap (E = 16384,
    where every block scans 64 KB of ack rows)."""
    tile = tq.tick_tile
    try:
        for gx in (1024, 10_240, 102_400):
            for d, e in ((64, 64), (1024, 16384)):
                for t in TILES:
                    tq.tick_tile = lambda g, t=t: t
                    k2_timing(tq, cases, rng, gx, p, d, e, out,
                              f"K2_G{gx}_D{d}_E{e}_tile{t}")
    finally:
        tq.tick_tile = tile


def k1_timing(tq, st, ev_np, out, key) -> None:
    """K1 on ``ev_np`` ([7, E]) over the state ``st``: each input read
    once (the state, the E event columns, meta), the state it changes and
    the [4, G] output written once."""
    g, p = st[0].shape
    e = ev_np.shape[1]
    ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
    ms, plain, wrote = time_inplace(
        tq, st, lambda a: tq.engine_step_resident_fast(a, ev, meta),
        lambda a: tq._resident_fast_plain(a, ev, meta))
    nbytes = state_bytes(g, p) + 28 * e + 8 + wrote + 16 * g
    out[key] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * e),
                f"G={g} P={p} E={e} tile={tq.tick_tile(g)}")
    a = tq.device_state_from_numpy(st, "cuda")
    per_call(
        key, lambda: tq.engine_step_resident_fast(a, ev, meta))


def k1_extra_timing(tq, cases, rng, p, out) -> None:
    """K1 with each tile size at G = 1024, 10240 and 102400, at the main
    paths' most common E = 64 and at the acks' cap (E = 16384, where
    every block scans 64 KB of slot rows); at 1024 rows also at the
    backlog buckets between (E = 1024, 4096)."""
    tile = tq.tick_tile
    try:
        for g in (1024, 10_240, 102_400):
            st = cases.resident_state(rng, g, p, NOW)
            for e in (64, 1024, 4096, 16384) if g == 1024 else (64, 16384):
                ev = cases.fast_events(rng, g, p, e, NOW)
                for t in TILES:
                    tq.tick_tile = lambda g, t=t: t
                    k1_timing(tq, st, ev, out, f"K1_G{g}_E{e}_tile{t}")
    finally:
        tq.tick_tile = tile


def k5_timing(tq, st, ev_np, out, key) -> None:
    """K5 on ``ev_np`` ([7, S, E]) over the state ``st``: each input read
    once (the state, the S x E event columns, meta), the state it changes
    and the [4, G] output written once."""
    g, p = st[0].shape
    _, s, e = ev_np.shape
    ev, meta = cuda([ev_np, np.array([NOW, TIMEOUT_MS], np.int32)])
    ms, plain, wrote = time_inplace(
        tq, st, lambda a: tq.engine_step_resident_fast_sliced(a, ev, meta),
        lambda a: tq._resident_fast_sliced_plain(a, ev, meta))
    nbytes = state_bytes(g, p) + 7 * s * e * 4 + 8 + wrote + 16 * g
    out[key] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * s * e),
                f"G={g} P={p} S={s} E={e} tile={tq.tick_tile(g)}")
    a = tq.device_state_from_numpy(st, "cuda")
    per_call(
        key, lambda: tq.engine_step_resident_fast_sliced(a, ev, meta))


def k7_timing(tq, cases, g: int, p: int, out) -> None:
    """K7a-c at the main paths' G and P (K7a with two replies per group),
    and again at 102400 rows (``K7a_100k``, ``K7b_100k``, ``K7c_100k``):
    each input read once and each output written once (K7a: both [G, P]
    masks in and out, 10 bytes per event; K7b: the int32 and three bool
    [G, P] arrays and the flush index in, int32 [G] out; K7c: the int32
    and three bool [G, P] arrays in, int32 [G] out).  No PyTorch call
    computes any of the three alone, so there is no library time."""
    rng = np.random.default_rng(7)
    timeout = 1000
    work = []
    for key, rows in ((("K7a", "K7c", "K7b"), g),
                      (("K7a_100k", "K7c_100k", "K7b_100k"), 102_400)):
        e = 2 * rows
        votes = cuda(cases.vote_events(rng, rows, p, e))
        lease = cuda(cases.lease_inputs(rng, rows, p, NOW))
        repl = cuda(cases.replicated_inputs(rng, rows, p))
        work += [
            (key[2], lambda repl=repl: tq.all_replicated_min(*repl),
             lambda repl=repl: tq._all_replicated_min_plain(*repl),
             7 * rows * p + 8 * rows, rows * (3 * p + 4),
             f"G={rows} P={p}"),
            (key[0], lambda votes=votes: tq.apply_vote_events(*votes),
             lambda votes=votes: tq._apply_vote_events_plain(*votes),
             4 * rows * p + 10 * e, 10 * e, f"G={rows} P={p} E={e}"),
            (key[1], lambda lease=lease: tq.lease_expiry(*lease, timeout),
             lambda lease=lease: tq._lease_expiry_plain(*lease, timeout),
             7 * rows * p + 4 * rows, rows * (8 * p * p + 16),
             f"G={rows} P={p}")]
    for key, kernel, plain, nbytes, ops, shape in work:
        ms = timed(kernel)
        plain_ms = timed(plain, n=PLAIN_CALLS)
        out[key] = (ms, plain_ms, *bound(nbytes, ops), shape)
        per_call(key, kernel)


def run_timing(tq, tl, cases, bench, main, shapes, mesh_main,
               mesh_shapes) -> dict:
    """K1-K4 at the main paths' most common shape (K3's row entry at the
    vote passes' most common padded R; its public entry ``K3_public`` at
    G), K1 also with each tile size at G = 1024, 10240, 102400 and E = 64,
    16384 (at 1024 also E = 1024, 4096), at 1024 x 16384 padded as the
    engine pads, and on the mesh100k rung's flat control (``K1_100k``), K5 at
    the mesh path's
    (key ``K5``) and on the mesh100k rung's batch (``K5_100k``), K6 at
    both kernel-rung shapes (key ``K6`` at 10240 groups, ``K6_100k`` at
    102400).  Bytes: every input read once (K2's refresh rows only where
    they are not padding), the state elements a call changes and the
    outputs written once.  Device time per call from a CUDA graph for
    every kernel (K1/K2 on a state of their own that the captured calls
    keep updating: the same events again, so the same work); the plain
    versions' median over ``PLAIN_CALLS`` calls."""
    g, p, w = main["capacity"], main["peers"], main["ledger_width"]
    e1 = shapes["K1"].most_common(1)[0][0]
    d2, e2 = shapes["K2"].most_common(1)[0][0]
    rng = np.random.default_rng(99)
    st = cases.resident_state(rng, g, p, NOW)
    out = {}

    # K1 at the main shape, with each tile, and at the mesh100k rung's
    # flat control (102400 x 8 x 8192, global rows)
    k1_timing(tq, st, cases.fast_events(rng, g, p, e1, NOW), out, "K1")
    k1_extra_timing(tq, cases, rng, p, out)
    ev = engine_padded(cases.fast_events(rng, 1024, p, 16384, NOW))
    k1_timing(tq, cases.resident_state(rng, 1024, p, NOW), ev, out,
              "K1_G1024_E16384_engine_padding")
    state, evs, evf, _ = bench.mesh100k_batch()
    k1_timing(tq, state, evf, out, "K1_100k")

    # K2
    rf_idx_np, rf, acks = cases.refresh(rng, g, p, d2, e2, NOW)
    d_real = int((rf_idx_np < g).sum())
    rf_idx, *rf = cuda([rf_idx_np, *rf])
    acks = cuda(acks)
    ms, plain, wrote = time_inplace(
        tq, st, lambda s: tq.engine_step_resident(s, rf_idx, *rf, *acks, NOW,
                                                  TIMEOUT_MS),
        lambda s: tq._resident_refresh_plain(s, rf_idx, rf, acks, NOW,
                                             TIMEOUT_MS))
    nbytes = (state_bytes(g, p) + 4 * d2 + state_bytes(d_real, p) + 17 * e2
              + wrote + 16 * g)
    out["K2"] = (ms, plain, *bound(nbytes, g * (4 * p * p + 64) + 10 * e2
                                   + d_real * 12 * p),
                 f"G={g} P={p} D={d2} ({d_real} rows) E={e2}")
    a = tq.device_state_from_numpy(st, "cuda")
    per_call("K2", lambda: tq.engine_step_resident(
        a, rf_idx, *rf, *acks, NOW, TIMEOUT_MS))
    k2_extra_timing(tq, cases, rng, p, out)

    # K3, the row entry the engine runs, at the vote passes' most common
    # padded R, packed as the engine packs it: uint16 [4, R] mask words,
    # int32 [R, P] priority and [R] self priority in, bool [4, R] out
    r3 = shapes["K3"].most_common(1)[0][0]
    arrays = cases.tally_inputs(rng, max(g, r3), p)
    rows = np.sort(rng.permutation(max(g, r3))[:max(1, r3 // 4)])
    v = cases.tally_plan(arrays, rows, "cpu", r3).views(r3)
    packed = cuda([v.masks, v.priority, v.self_priority])
    ms = timed(lambda: tq.tally_rows(*packed))
    plain = timed(lambda: tq._tally_rows_plain(*packed), n=PLAIN_CALLS)
    out["K3"] = (ms, plain, *bound(8 * r3 + 4 * r3 * p + 4 * r3 + 4 * r3,
                                   r3 * (8 * p + 40)),
                 f"R={r3} ({len(rows)} open rounds) P={p}")
    per_call("K3", lambda: tq.tally_rows(*packed))

    # K3's public [G, P] entry (no path launches it) at the main paths' G
    # and at 102400 rows: four bool and one int32 [G, P] inputs, int32
    # [G], bool [4, G] out
    for key, g3 in (("K3_public", g), ("K3_public_100k", 102_400)):
        args = cuda(cases.tally_inputs(rng, g3, p))
        ms = timed(lambda: tq.tally_votes_packed(*args))
        plain = timed(lambda: tq._tally_plain(*args), n=PLAIN_CALLS)
        out[key] = (ms, plain, *bound(g3 * p * 8 + 4 * g3 + 4 * g3,
                                      g3 * (8 * p + 40)), f"G={g3} P={p}")
        per_call(key,
                                  lambda: tq.tally_votes_packed(*args))

    # K4: role (int8), commit, applied, prev_commit (int32), prev_valid
    # (bool) per row; match, last_ack, peer_index (int32) and three bool
    # masks per link; the packed int32 output
    arrays, scalars = cases.ledger_inputs(rng, g, p, w)
    dev = cuda(arrays)
    ms = timed(lambda: tl.ledger_pass(*dev, *scalars, num_peers=w))
    plain = timed(lambda: tl._ledger_plain(*dev, *scalars, w),
                  n=PLAIN_CALLS)
    nbytes = g * (1 + 3 * 4 + 1) + g * p * (3 * 4 + 3) \
        + 4 * tl.packed_size(g, w)
    out["K4"] = (ms, plain, *bound(nbytes, g * p * 45), f"G={g} P={p} W={w}")
    per_call(
        "K4", lambda: tl.ledger_pass(*dev, *scalars, num_peers=w))

    # K5 at the mesh path's most common (S, E) and at the rung's batch
    s5, e5 = mesh_shapes["K5"].most_common(1)[0][0]
    g5 = mesh_main["capacity"]
    k5_timing(tq, cases.resident_state(rng, g5, p, NOW),
              cases.sliced_events(rng, g5, p, s5, e5, NOW), out, "K5")
    k5_timing(tq, state, evs, out, "K5_100k")

    # K6 on the bench's own batches, at the rungs' shapes; functional, so
    # every call sees the same inputs
    for key, (g6, p6, e6) in zip(("K6", "K6_100k"), K6_SHAPES[1:]):
        args = tq.engine_step_args_from_numpy(
            bench._example_batch(g6, p6, e6), "cuda")
        ms = timed(lambda: tq.engine_step(*args))
        plain = timed(lambda: tq._engine_step_plain(*args), n=PLAIN_CALLS)
        out[key] = (ms, plain, *bound(k6_bytes(g6, p6, e6),
                                      g6 * (4 * p6 * p6 + 64) + 10 * e6),
                    f"G={g6} P={p6} E={e6}")
        per_call(key, lambda: tq.engine_step(*args))

    k7_timing(tq, cases, g, p, out)
    for k, (ms, plain, b_ms, by, shape) in out.items():
        dev = (f", graph {GRAPH_US[k]:.3f} us/call" if GRAPH_US.get(k)
               else ", device not measured") + \
            f", host {HOST_US[k]:.2f} us/call"
        log(f"timing: {k} [{shape}] kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, bound {b_ms:.6f} ms ({by}){dev}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=1024)
    ap.add_argument("--writes", type=int, default=2)
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the FileStore streams' bytes")
    ap.add_argument("--path", choices=tuple(PROCESS_PATHS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.path:
        begin(args.path)
        return path_process_main(args.path, args.result)

    # 1. environment
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    import msgpack
    log(f"wire codec: msgpack {'.'.join(map(str, msgpack.version))}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from ratis_tpu_torch.ops import _build
    from ratis_tpu_torch.ops import ledger as tl
    from ratis_tpu_torch.ops import quorum as tq
    from ratis_tpu_torch.tools import bench, cases
    kernels = kernel_launchers()

    # 2. build
    begin("2 build")
    t0 = time.monotonic()
    _build.build_all()
    log(f"build: {time.monotonic() - t0:.2f} s wall; nvcc per source "
        + ", ".join(f"{s} {t:.2f} s" for s, t in _build.build_seconds.items()))
    for s, report in _build.build_reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {s}: {line.strip()}")

    mark("2 build", t_start)

    # 3. parity at fixed shapes (the off-path kernels' launches here and
    # in phase 5 are their only ones: every path checks they made none)
    begin("3 parity")
    par = Parity()
    off_before = {k: kernels[k].launches for k in OFF_PATH}
    run_parity(tq, tl, cases, bench, par)
    k2_nodes = k2_one_launch(tq, cases)
    log(f"K2: one public-wrapper call captured in a CUDA graph: "
        f"{len(k2_nodes)} node, {k2_nodes[0]}")
    fast_nodes = fast_one_launch(tq, cases)
    fast_nodes.update(ledger_step_one_launch(tq, tl, cases, bench))
    fast_nodes.update(other_one_launch(tq, cases))
    for key, nodes in fast_nodes.items():
        log(f"{key}: one call captured in a CUDA graph: {len(nodes)} "
            f"node(s): " + " | ".join(n[:100] for n in nodes))
    off_launches = {k: {"parity": kernels[k].launches - off_before[k]}
                    for k in OFF_PATH}
    off_before = {k: kernels[k].launches for k in OFF_PATH}

    mark("3 parity", t_start)

    # 4l. the chaos campaign, in a process of its own from here on, beside
    # 4a-4k (``PathProcess``); stopped at exit if the run fails first
    import atexit
    import shutil
    import tempfile
    chaos_tmp = tempfile.mkdtemp(prefix="ratis-smoke-chaos-")
    atexit.register(shutil.rmtree, chaos_tmp, True)
    chaos = PathProcess("chaos_1024", chaos_tmp, CHAOS_TIMEOUT_S)
    atexit.register(chaos.kill)

    # 4a. the main path over the simulated transport
    begin("4a sim")
    recs = {k: ShapeRecorder() for k in ("sim", "tcp", "mesh",
                                               "durable_1024", "shared_256",
                                               "churn_1024", "stream",
                                               "filestore5_1024",
                                               "telemetry_1024",
                                               "sparse_4096", "chaos_1024",
                                               "placement_48",
                                               "readmix_1024", "zipf_1024",
                                               "snapcatch_1024",
                                               "peer7_1024", "mp5_1024",
                                               "scalar_512",
                                               "profile_256")}
    main_res, sim_launches = run_main_path(tq, kernels, args.groups,
                                           args.writes, recs["sim"])
    log(f"main path (sim): {card} | 3 servers x {args.groups} groups | "
        f"bring-up {main_res['bring_up_s']:.3f} s | "
        f"{main_res['commits']} writes acked, all replicas read back | "
        f"{main_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {main_res['p50_ms']:.2f} ms | p99 {main_res['p99_ms']:.2f} ms | "
        f"election timeouts (bring-up, writes) "
        f"{main_res['election_timeouts']}")
    log(f"main path (sim) launches: {sim_launches}")

    mark("4a sim", t_start)

    # 4b. the bench's kernel rungs
    begin("4b kernel rungs")
    rungs, rung_launches = run_kernel_rungs(kernels, bench)
    log(f"kernel rungs: {card} | 10240 x 8 x 4096: "
        f"{rungs['kernel']['group_updates_per_sec']:.1f} group updates/s, "
        f"{rungs['kernel']['vs_scalar_loop']:.2f} x the scalar loop | "
        f"102400 x 8 x 8192: "
        f"{rungs['kernel_100k']['group_updates_per_sec_100k']:.1f} group "
        f"updates/s | launches {rung_launches}")

    mark("4b kernel rungs", t_start)

    # 4c. the headline e2e rung over localhost TCP
    begin("4c tcp")
    tcp_res, tcp_launches = run_tcp_path(kernels, bench, recs["tcp"])
    log(f"main path (tcp): {card} | 3 servers x {TCP_GROUPS} groups | "
        f"bring-up {tcp_res['election_convergence_s']:.3f} s | "
        f"{tcp_res['acked']} writes acked, all replicas read back | "
        f"{tcp_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {tcp_res['p50_ms']:.2f} ms | p99 {tcp_res['p99_ms']:.2f} ms | "
        f"election timeouts (bring-up, warm-up, writes) "
        f"{tcp_res['election_timeouts']}")
    log(f"main path (tcp) launches: {tcp_launches}")
    shapes = {k: recs["sim"].shapes[k] + recs["tcp"].shapes[k]
              for k in recs["sim"].shapes}
    log(f"K1 E {dict(shapes['K1'])}; K2 (D, E) {dict(shapes['K2'])}")

    mark("4c tcp", t_start)

    # 4s. the scalar control, in a process of its own from here on, beside
    # 4d-4k (``PathProcess``); stopped at exit if the run fails first
    scalar = PathProcess("scalar_512", chaos_tmp, SCALAR_TIMEOUT_S)
    atexit.register(scalar.kill)

    # 4d. the mesh path, then dryrun_multichip and the mesh100k rung
    begin("4d mesh")
    rec_mesh = recs["mesh"]
    mesh_res, mesh_launches = run_mesh_path(kernels, rec_mesh)
    log(f"main path (mesh): {card} | 3 servers x {MESH_GROUPS} groups in "
        f"{MESH_SLICES} slices, slices per server {mesh_res['n_slices']} | "
        f"bring-up {mesh_res['bring_up_s']:.3f} s | "
        f"{mesh_res['commits']} writes acked, all replicas read back | "
        f"{mesh_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {mesh_res['p50_ms']:.2f} ms | p99 {mesh_res['p99_ms']:.2f} ms "
        f"| election timeouts (bring-up, writes) "
        f"{mesh_res['election_timeouts']}")
    log(f"main path (mesh) launches: {mesh_launches}")
    log(f"mesh K5 (S, E) {dict(rec_mesh.shapes['K5'])}; K2 (D, E) "
        f"{dict(rec_mesh.shapes['K2'])}")
    mesh_rungs, mesh_rung_launches = run_mesh_rungs(kernels, bench)
    m = mesh_rungs["mesh_100k"]
    log(f"dryrun_multichip(8): {mesh_rungs['dryrun_multichip']}")
    log(f"mesh_100k: {card} | {m['groups']} groups in {m['devices']} "
        f"slices | {m['updates_per_s']:.1f} updates/s, "
        f"{m['per_slice_updates_per_s']:.1f} per slice | tick "
        f"{m['tick_ms']:.4f} ms, control (K1) {m['control_tick_ms']:.4f} "
        f"ms, efficiency {m['efficiency_frac']:.3f} | launches "
        f"{mesh_rung_launches}")

    mark("4d mesh", t_start)

    # 4e/4f. the durable paths: per-group logs at 1024, the shared plane
    # at 256; 4g. leadership and configuration churn
    durable = {}
    for key, groups, shared in (("durable_1024", DURABLE_GROUPS, False),
                                ("shared_256", SHARED_GROUPS, True)):
        begin(key)
        res, launches = run_durable_path(kernels, bench, groups, shared,
                                         recs[key])
        durable[key] = (res, launches)
        log_kind = "shared log plane" if shared else "per-group segments"
        log(f"{key}: {card} | 3 servers x {groups} groups over TCP, "
            f"ArithmeticStateMachine, {log_kind} on {res['storage_fs']} | "
            f"bring-up "
            f"{res['election_convergence_s']:.3f} s | {res['acked']} writes "
            f"acked | {res['commits_per_sec']:.1f} commits/s | p50 "
            f"{res['p50_ms']:.2f} ms | p99 {res['p99_ms']:.2f} ms | "
            f"fsyncs {res['fsyncs']} ({res['fsyncs_per_commit']:.4f} per "
            f"commit), the log workers' fsync s per server in the writes "
            f"{[round(t, 4) for t in res['sync_time_s']]} (share of the "
            f"writes {[round(x, 4) for x in res['sync_share']]}) | "
            f"election timeouts (bring-up, warm-up, writes) "
            f"{res['election_timeouts']} | restart to all leaders "
            f"{res['restart_s']:.3f} s ({res['restart_election_timeouts']} "
            f"election timeouts) | replicas equal to the fold before, after "
            f"restart {res['replicas_read_back']}")
        log(f"{key} launches: {launches}")
        if "parse_log" in res:
            log(f"{key} parse_log: {res['parse_log']}")
        mark(key, t_start)
    begin("4g churn_1024")
    churn_res, churn_launches = run_churn_path(tq, kernels, bench,
                                               recs["churn_1024"])
    log(f"churn_1024: {card} | 3 servers x {CHURN_GROUPS} groups (sim) | "
        f"bring-up {churn_res['election_convergence_s']:.3f} s | transfers "
        f"ok {churn_res['transfers_ok']} failed "
        f"{churn_res['transfers_failed']} "
        f"{churn_res.get('transfer_failures', [])} | joint rounds ok "
        f"{churn_res['joint_ok']} failed {churn_res['joint_failed']} | "
        f"{churn_res['commits']} writes acked, all replicas read back in "
        f"the final configuration | {churn_res['commits_per_sec']:.1f} "
        f"commits/s | p50 {churn_res['p50_ms']:.2f} ms | p99 "
        f"{churn_res['p99_ms']:.2f} ms | election timeouts (bring-up, "
        f"writes) {churn_res['election_timeouts']}")
    log(f"churn_1024 launches: {churn_launches}; K1/K2 launches while "
        f"the engine led a joint row: {churn_res['joint_calls']} "
        f"(unmatched calls "
        f"{churn_res['joint_unmatched_calls']})")
    mark("4g churn_1024", t_start)

    # 4h. the stream rung; 4i. BASELINE config 3 at 5 x 1024; 4j. the
    # telemetry plane over HTTP
    from ratis_tpu_torch.tools import filestore_bench as fb
    begin("4h stream")
    stream_res, stream_launches = run_stream_path(kernels, fb, args.seed,
                                                  recs["stream"])
    log(f"stream: {card} | {stream_res['streams']} streams x "
        f"{stream_res['stream_mb']:g} MB in {stream_res['packet_kb']:g} KB "
        f"packets, window {stream_res['window']}, into 3 servers x 4 "
        f"FileStore groups (sim raft, DataStream over localhost TCP) | ok "
        f"{stream_res['streams_ok']} failed {stream_res['streams_failed']} "
        f"| bytes equal on all 3 replicas | "
        f"{stream_res['stream_mb_per_s']:.2f} MB/s over "
        f"{stream_res['elapsed_s']:.3f} s")
    log(f"stream launches: {stream_launches}")
    mark("4h stream", t_start)
    begin("4i filestore5_1024")
    fs5_res, fs5_launches = run_filestore5_path(kernels, fb, args.seed,
                                                recs["filestore5_1024"])
    log(f"filestore5_1024: {card} | {FS5_SERVERS} servers x {FS5_GROUPS} "
        f"FileStore groups over TCP, DataStream on every server | bring-up "
        f"{fs5_res['election_convergence_s']:.3f} s | {fs5_res['acked']} "
        f"writes acked (1 warm-up + {FS5_WRITES} a group) | "
        f"{fs5_res['commits_per_sec']:.1f} commits/s | p50 "
        f"{fs5_res['p50_ms']:.2f} ms | p99 {fs5_res['p99_ms']:.2f} ms | "
        f"streams {fs5_res['streams']} x "
        f"{fs5_res['stream_bytes'] >> 20} MB ok {fs5_res['streams_ok']} "
        f"failed {fs5_res['streams_failed']} | "
        f"{fs5_res['stream_mb_per_s']:.2f} MB/s | files equal on all "
        f"{FS5_SERVERS} replicas after the warm-up, the writes and the "
        f"streams "
        f"{fs5_res['replicas_checked']} | election timeouts (bring-up, "
        f"warm-up, writes) {fs5_res['election_timeouts']}")
    log(f"filestore5_1024 launches: {fs5_launches}; vote rounds by "
        f"members {fs5_res['vote_round_members']}")
    mark("4i filestore5_1024", t_start)
    begin("4j telemetry_1024")
    tel_res, tel_launches = run_telemetry_path(kernels, bench,
                                               recs["telemetry_1024"])
    tel, got = tel_res["telemetry"], tel_res["after"]
    log(f"telemetry_1024: {card} | 3 servers x {TEL_GROUPS} groups over "
        f"TCP, telemetry 1 s, HTTP on ports {got['ports']} | bring-up "
        f"{tel_res['election_convergence_s']:.3f} s | {tel_res['acked']} "
        f"writes acked | {tel_res['commits_per_sec']:.1f} commits/s | p50 "
        f"{tel_res['p50_ms']:.2f} ms | p99 {tel_res['p99_ms']:.2f} ms | "
        f"routes 200 on every server during {tel_res['during']} and after "
        f"the writes (one fetch of all in the writes: "
        f"{got['fetch_during_s']:.3f} s) | /timeseries samples "
        f"{got['timeseries']} over "
        f"{tel_res['elapsed_s']:.3f} s of writes | /lag: {got['lag_rows']} "
        f"led rows at their divisions' commit index, {got['lag_gets']} "
        f"GETs | sampler {tel['samples']} samples, pass "
        f"{tel['sampler_pass_ms']:.3f} ms thread CPU, "
        f"{tel['sampler_pass_wall_ms']:.3f} ms wall (walk "
        f"{tel['walk_pass_ms']:.3f}, {tel['walk_pass_wall_ms']:.3f} ms), "
        f"p99 cost {tel['sample_cost_p99_ms']:.3f} ms, ledger fetch "
        f"p50 {tel['ledger_fetch_ms']:.3f} ms | election timeouts "
        f"(bring-up, warm-up, writes) {tel_res['election_timeouts']}")
    log(f"telemetry_1024 launches: {tel_launches}")
    sh = got["shell"]
    log(f"telemetry_1024 shell: health rc {sh['health']['rc']} "
        f"({sh['health']['first_line']}), lag rc {sh['lag']['rc']} "
        f"listing {sh['lag']['servers_listed']}, top rc {sh['top']['rc']} "
        f"listing {sh['top']['servers_listed']}, "
        f"{sh['seconds']:.3f} s for the three")
    mark("4j telemetry_1024", t_start)

    # 4k. the sparse shape with the upkeep plane; 4l. the chaos campaign;
    # 4m. the placement controller
    begin("4k sparse_4096")
    sp_res, sp_launches = run_sparse_path(kernels, bench,
                                          recs["sparse_4096"])
    pair, settled = sp_res["settle"]["tick_pair"], sp_res["settle"]
    log(f"sparse_4096: {card} | 3 servers x {SPARSE_GROUPS} groups (sim), "
        f"hibernation and the upkeep plane on | bring-up "
        f"{sp_res['election_convergence_s']:.3f} s | hibernated groups "
        f"{settled['hibernated_groups']} after "
        f"{settled['settle_s']:.3f} s of settle, "
        f"{sp_res['hibernated_groups']} after the writes | upkeep tick "
        f"array {pair['tick_array_wall_ms']:.4f} ms vs legacy "
        f"{pair['tick_legacy_wall_ms']:.4f} ms wall (thread CPU "
        f"{pair['tick_array_ms']:.4f} vs {pair['tick_legacy_ms']:.4f}), "
        f"{pair['registered_slots']} slots, {pair['due_groups']} due | "
        f"{sp_res['commits']} writes acked on {sp_res['active_groups']} "
        f"groups, all {SPARSE_GROUPS} counters read back from 3 replicas | "
        f"{sp_res['commits_per_sec']:.1f} commits/s | p50 "
        f"{sp_res['p50_ms']:.2f} ms | p99 {sp_res['p99_ms']:.2f} ms | "
        f"stale verdicts {sp_res['stale_verdicts']}, skipped for "
        f"hibernating leaders {sp_res['stale_skipped_hibernating']} | "
        f"election timeouts (bring-up, warm-up, writes) "
        f"{sp_res['election_timeouts']}")
    log(f"sparse_4096 launches: {sp_launches}")
    mark("4k sparse_4096", t_start)
    begin("4l chaos_1024")
    chaos_res, chaos_launches = chaos.collect(recs["chaos_1024"])
    log(f"chaos_1024: {card} | 3 servers x {chaos_res['groups']} groups "
        f"(sim, shared durable log) seed {chaos_res['seed']} | "
        f"{chaos_res['passed']} of {chaos_res['total']} scenarios passed | "
        f"worst re-election {chaos_res['worst_reelect_s']} s | recovery "
        f"fraction {chaos_res['recovery_frac']} | bring-up "
        f"{chaos_res['bring_up_s']} s | elapsed {chaos_res['elapsed_s']} s | "
        f"events: injected {chaos_res['fault_events']}, recovered "
        f"{chaos_res['recovered_events']}, organic "
        f"{chaos_res['organic_events']}")
    for name, e in chaos_res["scenarios"].items():
        log(f"chaos_1024 {name}: {e}")
    log(f"chaos_1024 launches: {chaos_launches}")
    mark("4l chaos_1024", t_start)
    begin("4m placement_48")
    pl_res, pl_launches = run_placement_path(kernels, recs["placement_48"])
    log(f"placement_48: {card} | {pl_res['peers']} servers x "
        f"{pl_res['groups']} groups over TCP, {pl_res['clients']} clients, "
        f"grey {pl_res['grey_peer']} | hot pins {pl_res['hot_pins']} | "
        f"OFF: writes {pl_res['writes_ok_off']}, reads "
        f"{pl_res['reads_ok_off']}, hot p99 "
        f"{pl_res['hotspot_p99_before_ms']} ms, hot shed "
        f"{pl_res['hot_shed_off']}, grey confirm share "
        f"{pl_res['grey_confirm_frac_off']:.4f} | ON: writes "
        f"{pl_res['writes_ok_on']}, reads {pl_res['reads_ok_on']}, hot p99 "
        f"{pl_res['hotspot_p99_after_ms']} ms, hot shed "
        f"{pl_res['hot_shed_on']}, grey confirm share "
        f"{pl_res['grey_confirm_frac_on']:.4f} | transfers "
        f"{pl_res['transfers']}, plans {pl_res['plans_computed']}, steered "
        f"reads {pl_res['steered_reads']} | failures {pl_res['failures']}")
    log(f"placement_48 launches: {pl_launches}")
    mark("4m placement_48", t_start)

    # 4n. the read paths; 4o. the zipf client fleet under admission
    begin("4n readmix_1024")
    rm_res, rm_launches = run_readmix_path(kernels, recs["readmix_1024"])
    log(f"readmix_1024: {card} | 3 servers x {rm_res['groups']} groups "
        f"over TCP, linearizable reads with the leader lease | bring-up "
        f"{rm_res['election_convergence_s']:.3f} s | {rm_res['commits']} "
        f"writes acked ({rm_res['write_failures']} failed) | "
        f"{rm_res['commits_per_sec']:.1f} commits/s | p50 "
        f"{rm_res['p50_ms']:.2f} ms | p99 {rm_res['p99_ms']:.2f} ms | "
        f"reads: {rm_res['reads_ok']} ok ({rm_res['read_failures']} "
        f"failed): lease leader {rm_res['reads_lease_leader']}, follower "
        f"linearizable {rm_res['reads_follower_linearizable']}, stale "
        f"{rm_res['reads_stale']} | {rm_res['reads_per_sec']:.1f} reads/s "
        f"| read p50 {rm_res['read_p50_ms']:.2f} ms, p99 "
        f"{rm_res['read_p99_ms']:.2f} ms | read mismatches "
        f"{rm_res['read_mismatches']} of {rm_res['reads_checked']}, "
        f"replica mismatches {rm_res['replica_mismatches']} of "
        f"{rm_res['replicas_read_back']} | reads served by server "
        f"{rm_res['reads_served']}, confirmation sweeps "
        f"{rm_res['confirm_sweeps']}, reads they confirmed "
        f"{rm_res['confirmed_reads']}")
    log(f"readmix_1024 launches: {rm_launches}")
    mark("4n readmix_1024", t_start)
    begin("4o zipf_1024")
    zf_res, zf_launches = run_zipf_path(kernels, recs["zipf_1024"])
    log(f"zipf_1024: {card} | 3 servers x {zf_res['groups']} groups over "
        f"TCP, {zf_res['clients']} clients zipf({zf_res['zipf_s']}), "
        f"admission at {zf_res['pending_limit']} | bring-up "
        f"{zf_res['election_convergence_s']:.3f} s | writes "
        f"{zf_res['writes_ok']}, reads {zf_res['reads_ok']}, failures "
        f"{zf_res['failures']} | {zf_res['writes_per_sec']:.1f} writes/s, "
        f"{zf_res['reads_per_sec']:.1f} reads/s over "
        f"{zf_res['elapsed_s']:.3f} s | p99 {zf_res['p99_ms']} ms, read "
        f"p99 {zf_res['read_p99_ms']} ms, unsaturated p99 "
        f"{zf_res['p99_unsat_ms']} ms, ratio "
        f"{zf_res['overload_p99_ratio']} | shed {zf_res['shed']} of "
        f"{zf_res['shed'] + zf_res['admitted']} ({zf_res['shed_frac']:.4f}) "
        f"| pending peak {zf_res['pending_peak']} | confirmation sweeps "
        f"per read {zf_res['confirm_sweeps_per_read']:.4f} "
        f"({zf_res['confirm_sweeps']}) | hot group {zf_res['hot_group']} "
        f"(expected {zf_res['hot_group_expected']}: "
        f"{zf_res['hot_group'] == zf_res['hot_group_expected']}), share "
        f"{zf_res['hot_share']} against {zf_res['expected_top_share']:.4f} "
        f"| read mismatches {zf_res['read_mismatches']} of "
        f"{zf_res['reads_checked']}, replica mismatches "
        f"{zf_res['replica_mismatches']} of {zf_res['replicas_read_back']}")
    log(f"zipf_1024 launches: {zf_launches}")
    mark("4o zipf_1024", t_start)

    # 4p. InstallSnapshot catch-up under writes; 4q. 7 peers end to end
    begin("4p snapcatch_1024")
    sc_res, sc_launches = run_snapcatch_path(kernels,
                                             recs["snapcatch_1024"])
    log(f"snapcatch_1024: {card} | {sc_res['peers']} servers x "
        f"{sc_res['groups']} groups over TCP, snapshot storage on "
        f"{sc_res['fs_type']} | bring-up "
        f"{sc_res['election_convergence_s']:.3f} s | leaderships moved "
        f"off the wiped server {sc_res['transfers']} | seed "
        f"{sc_res['cps_before']:.1f} commits/s (p99 "
        f"{sc_res['p99_ms_before']:.2f} ms) | snapshot indexes "
        f"{dict(collections.Counter(sc_res['snapshot_index'].values()))} | "
        f"wipe {sc_res['wipe_s']:.3f} s, wiped engine's live rows "
        f"{sc_res['victim_live_rows']} ({sc_res['victim_rows_reused']} "
        f"reused) | catch-up {sc_res['catchup_s']:.3f} s, installs "
        f"{sc_res['installs']}, leaders changed "
        f"{sc_res['leaders_changed']}, election timeouts per server "
        f"(wiped last) {sc_res['catchup_election_timeouts']} (while the "
        f"snapshots ran {sc_res['snapshot_election_timeouts']}), refresh "
        f"rows during it {sc_res['refresh_rows_during_catchup']}, loop's "
        f"longest pause {sc_res['loop_longest_pause_s']:.3f} s, pauses at "
        f"least the election timeout's minimum "
        f"{sc_res['loop_pauses_over_timeout_min']} | during the installs "
        f"{sc_res['commits_per_sec']:.1f} commits/s, during / before "
        f"{sc_res['commits_per_sec'] / sc_res['cps_before']:.3f} (gate "
        f"0.25) | p50 "
        f"{sc_res['p50_ms']:.2f} ms | p99 {sc_res['p99_ms']:.2f} ms | "
        f"{sc_res['commits']} writes acked, replica mismatches "
        f"{sc_res['replica_mismatches']} of {sc_res['replicas_read_back']}")
    log(f"snapcatch_1024 launches: {sc_launches}")
    mark("4p snapcatch_1024", t_start)
    begin("4q peer7_1024")
    p7_res, p7_launches = run_peer7_path(kernels, bench, recs["peer7_1024"])
    log(f"peer7_1024: {card} | {p7_res['servers']} servers x "
        f"{p7_res['groups']} groups (sim), every 32nd write traced | "
        f"bring-up {p7_res['election_convergence_s']:.3f} s | "
        f"{p7_res['acked']} writes acked, all {p7_res['replicas_read_back']}"
        f" replicas read back | {p7_res['commits_per_sec']:.1f} commits/s | "
        f"p50 {p7_res['p50_ms']:.2f} ms | p99 {p7_res['p99_ms']:.2f} ms | "
        f"election timeouts (bring-up, warm-up, writes) "
        f"{p7_res['election_timeouts']} | vote rounds by members "
        f"{p7_res['vote_round_members']}")
    log(f"peer7_1024 host path: "
        f"{json.dumps(p7_res['host_path_decomposition'])}")
    log(f"peer7_1024 launches: {p7_launches}")
    mark("4q peer7_1024", t_start)

    # 4r. the multi-process deployment: one process per server
    begin("4r mp5_1024")
    mp_res, mp_launches = run_mp5_path(bench, recs["mp5_1024"])
    mp = mp_res["mp"]
    log(f"mp5_1024: {card} | {mp['server_procs']} server processes x "
        f"{mp_res['groups']} groups over TCP, {mp['loop_shards']} loop "
        f"shards each, {mp['client_procs']} client processes, nproc "
        f"{os.cpu_count()} | start-up {max(mp_res['startup_s']):.3f} s, "
        f"groups added {mp_res['addgroups_s']:.3f} s, leaders appointed "
        f"{mp_res['election_convergence_s']:.2f} s | {mp_res['commits']} "
        f"writes acked ({mp_res['write_failures']} failed) | "
        f"{mp_res['commits_per_sec']:.1f} commits/s | p50 "
        f"{mp_res['p50_ms']:.2f} ms | p99 {mp_res['p99_ms']:.2f} ms | "
        f"counters outside their writes acked and sent "
        f"{mp_res['replica_mismatches']} of {mp_res['replicas_read_back']} "
        f"| merged snapshot {len(mp_res['cluster_metrics']['procs'])} pids, "
        f"{mp_res['cluster_metrics']['healthy']} healthy, merged trace "
        f"{mp_res['trace_pids']} pids | vote rounds by members "
        f"{mp_res['vote_round_members']}")
    for r in mp_res["servers"]:
        log(f"mp5_1024 {r['peer']} (pid {r['pid']}, {r['device']}, "
            f"{r['shards_used']} of {r['loop_shards']} shards used): "
            f"launches {r['launches']}, ledger samples "
            f"{r['ledger_samples']}, off the home thread "
            f"{r['off_home_calls']}, host path "
            f"{json.dumps(r.get('host_path_decomposition'))}")
    log(f"mp5_1024 launches (the children's): {mp_launches}")
    mark("4r mp5_1024", t_start)

    # 4s. the headline's scalar control (its process's); 4t. the engine's
    # profiler hook
    begin("4s scalar_512")
    sc1_res, sc1_launches = scalar.collect(recs["scalar_512"])
    ctl = sc1_res["batched_control"]
    log(f"scalar_512: {card} | 3 servers x {SCALAR_GROUPS} groups (the "
        f"bench: 1024) over TCP, the scalar control (every tick on the "
        f"host loop), in its own process beside 4d-4k | bring-up "
        f"{sc1_res['election_convergence_s']:.3f} s | {sc1_res['acked']} "
        f"writes acked, all replicas read back | "
        f"{sc1_res['commits_per_sec']:.1f} commits/s | p50 "
        f"{sc1_res['p50_ms']:.2f} ms | p99 {sc1_res['p99_ms']:.2f} ms | "
        f"election timeouts (bring-up, warm-up, writes) "
        f"{sc1_res['election_timeouts']} | the batched deployment at "
        f"{SCALAR_GROUPS} groups, same process and load: "
        f"{ctl['commits_per_sec']:.1f} commits/s, p99 "
        f"{ctl['p99_ms']:.2f} ms; batched / scalar "
        f"{ctl['commits_per_sec'] / sc1_res['commits_per_sec']:.3f}")
    log(f"scalar_512 launches: {sc1_launches}; ledger samples "
        f"{recs['scalar_512'].ledger_samples}")
    mark("4s scalar_512", t_start)
    begin("4t profile_256")
    prof_res, prof_launches = run_profile_path(kernels, bench,
                                               recs["profile_256"])
    pr = prof_res["profile"]
    log(f"profile_256: {card} | 3 servers x {PROFILE_GROUPS} groups "
        f"(sim), raft.tpu.engine.profile-dir set | {prof_res['acked']} "
        f"writes acked | {prof_res['commits_per_sec']:.1f} commits/s | p99 "
        f"{prof_res['p99_ms']:.2f} ms | one trace {pr['trace_file']} "
        f"({pr['trace_bytes']} bytes, {pr['events']} events): "
        f"{pr['engine_tick_ranges']} engine_tick ranges, "
        f"{pr['tile_tick_events']} tile_tick kernel events | kernel events "
        f"{pr['kernel_events']} | ownership released")
    log(f"profile_256 launches: {prof_launches}")
    mark("4t profile_256", t_start)

    ledger_checks = {k: r.ledger_samples for k, r in recs.items()}
    log(f"ledger samples by path, each one call into the kernel library "
        f"and K4 +1: {ledger_checks}")

    # 5. parity at every shape the main paths gave a kernel, then timing
    begin("5 parity")
    run_parity_observed(tq, tl, cases, main_res, shapes, par, "main path")
    run_parity_observed(tq, tl, cases, mesh_res, rec_mesh.shapes, par,
                        "mesh path")
    for key, res, members in (("stream", stream_res, None),
                              ("filestore5_1024", fs5_res, FS5_SERVERS),
                              ("telemetry_1024", tel_res, None),
                              ("sparse_4096", sp_res, None),
                              ("chaos_1024", chaos_res, None),
                              ("placement_48", pl_res, None),
                              ("readmix_1024", rm_res, None),
                              ("zipf_1024", zf_res, None),
                              ("snapcatch_1024", sc_res, 3),
                              ("peer7_1024", p7_res,
                               bench.PEER7["servers"]),
                              ("mp5_1024", mp_res, bench.PEER5["servers"]),
                              ("profile_256", prof_res, None)):
        run_parity_observed(tq, tl, cases, res["engine"], recs[key].shapes,
                            par, f"{key} path", members)
    run_parity_sleeping(tq, cases, par)
    mark("5 parity", t_start)
    begin("5 timing")
    routes = run_route_timing(tq, card)
    timing = run_timing(tq, tl, cases, bench, main_res, shapes,
                                   mesh_res, rec_mesh.shapes)
    split = k1_k2_split(tq, cases, main_res)
    for k in OFF_PATH:
        # every path in between checked 0: these are phase 5's comparisons
        off_launches[k]["timing"] = kernels[k].launches - off_before[k]
    k2_shapes = {path: {str(k): n for k, n in r.shapes["K2"].items()}
                 for path, r in recs.items()}
    log(f"K2 (D, E) by path: {k2_shapes}")
    k3_shapes = {path: dict(r.shapes["K3"]) for path, r in recs.items()}
    log(f"K3 R (padded) by path: {k3_shapes}")
    for key, control in (
            ("fast_dispatch", "refresh_dispatch"),
            ("mesh_fast_dispatch", "refresh_dispatch"),
            ("fast_dispatch", "fast_dispatch_earlier_route"),
            ("mesh_fast_dispatch", "mesh_fast_dispatch_earlier_route"),
            ("fast_plan_run", "refresh_plan_run"),
            ("mesh_fast_plan_run", "refresh_plan_run"),
            ("ledger_sample", "ledger_earlier_route"),
            ("ledger_plan_run", "ledger_earlier_route"),
            ("mesh_ledger_sample", "mesh_ledger_earlier_route")):
        a, b = routes[key]["ms"], routes[control]["ms"]
        log(f"{key} {a:.4f} ms vs {control} {b:.4f} ms: "
            f"{'at or below' if a <= b else 'NOT at or below'}")
    for key in ("K1", "K5"):
        if GRAPH_US.get(key) and GRAPH_US.get("K2"):
            log(f"{key} device (graph) {GRAPH_US[key]:.3f} us vs K2 "
                f"{GRAPH_US['K2']:.3f} us")

    mark("5 timing", t_start)

    # 6. results
    begin("6 results")
    # each kernel's counts as every path's run read them (the off-path
    # kernels' are all 0, checked there); their comparison launches are
    # listed beside them
    paths = {"sim": sim_launches, "kernel_rungs": rung_launches,
             "tcp": tcp_launches, "mesh": mesh_launches,
             "mesh_rungs": mesh_rung_launches,
             **{k: launches for k, (_, launches) in durable.items()},
             "churn_1024": churn_launches, "stream": stream_launches,
             "filestore5_1024": fs5_launches,
             "telemetry_1024": tel_launches, "sparse_4096": sp_launches,
             "chaos_1024": chaos_launches, "placement_48": pl_launches,
             "readmix_1024": rm_launches, "zipf_1024": zf_launches,
             "snapcatch_1024": sc_launches, "peer7_1024": p7_launches,
             "mp5_1024": mp_launches, "scalar_512": sc1_launches,
             "profile_256": prof_launches}
    by_path = {k: {p: n[k] for p, n in paths.items() if k in n}
               for k in kernels}
    # one call's CUDA-graph nodes, per kernel
    graph_nodes_of = {"K2": k2_nodes, **fast_nodes}
    rows = []
    for name, key, source, replaces in KERNELS:
        ms, plain, b_ms, by, shape = timing[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(by_path[key].values()),
                     "launches_by_path": {**by_path[key],
                                          **off_launches.get(key, {})},
                     "max_abs_err": par.errs[key], "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                     "library": NO_LIBRARY[key],
                     "nodes": len(graph_nodes_of[key]),
                     "device_us": GRAPH_US.get(key),
                     "host_us": HOST_US.get(key)})
        if key in REDESIGNED:
            rows[-1]["redesigned"] = REDESIGNED[key]
    by_key = {key: row for (_, key, _, _), row in zip(KERNELS, rows)}
    by_key["K1"]["engine_route_ms"] = routes["fast_dispatch"]["ms"]
    by_key["K2"]["engine_route_ms"] = routes["refresh_dispatch"]["ms"]
    by_key["K5"]["engine_route_ms"] = routes["mesh_fast_dispatch"]["ms"]
    by_key["K3"]["engine_route_ms"] = {r: routes[f"vote_pass_R{r}"]["ms"]
                                       for r in ROUTE_ROUNDS}
    by_key["K4"]["engine_route_ms"] = routes["ledger_sample"]["ms"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "main_path": main_res,
                       "tcp_path": tcp_res, "kernel_rungs": rungs,
                       "mesh_path": mesh_res, "mesh_rungs": mesh_rungs,
                       "durable_paths": {k: r for k, (r, _) in
                                         durable.items()},
                       "churn_path": churn_res,
                       "stream_path": stream_res,
                       "filestore5_path": fs5_res,
                       "telemetry_path": tel_res,
                       "sparse_path": sp_res, "chaos_path": chaos_res,
                       "placement_path": pl_res,
                       "readmix_path": rm_res, "zipf_path": zf_res,
                       "snapcatch_path": {k: v for k, v in sc_res.items()
                                          if k != "counters"},
                       "peer7_path": p7_res,
                       "mp5_path": mp_res,
                       "scalar_path": sc1_res, "profile_path": prof_res,
                       "seconds": time.monotonic() - t_start,
                       "phase_end_s": PHASE_END_S,
                       "shapes": {k: {str(s): n for s, n in v.items()}
                                  for k, v in shapes.items()},
                       "mesh_shapes": {k: {str(s): n for s, n in v.items()}
                                       for k, v in rec_mesh.shapes.items()},
                       "timing": {k: {**dict(zip(("ms", "plain_ms",
                                                  "bound_ms", "bound_by",
                                                  "shape"), v)),
                                      "nodes": len(graph_nodes_of[k])
                                      if k in graph_nodes_of else None}
                                  for k, v in timing.items()},
                       "device_us": GRAPH_US, "host_us": HOST_US,
                       "k1_k2_after_idle_gap": split,
                       "routes": routes, "k2_graph_nodes": k2_nodes,
                       "fast_graph_nodes": fast_nodes,
                       "k2_shapes_by_path": k2_shapes,
                       "k3_rows_by_path": k3_shapes,
                       "ledger_samples_by_path": ledger_checks,
                       "parity_cases": dict(par.n),
                       "kernels": rows}, f, indent=1, default=str)
    log(f"smoke: {time.monotonic() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def failed(exc: BaseException) -> int:
    """Name the phase a failure stopped, on stdout and stderr."""
    import traceback
    traceback.print_exception(exc)
    line = f"chip_smoke: FAILED in phase {RUNNING[0]}: " \
        f"{type(exc).__name__}: {exc}"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    return 1


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:
        code = failed(e)
    sys.exit(code)
