"""The snapshot catch-up rung on the port: the JAX bench's
``child_snapcatch`` (``run_snapshot_catchup_bench``,
``ratis_tpu/tools/bench_cluster.py``), the InstallSnapshot half of
BASELINE config 5.

    python -m ratis_tpu_torch.tools.bench --rungs snapcatch

On the port's ``Cluster`` (``tools/cluster.py``): ``servers`` servers x
``groups`` groups, the batched deployment, ``CounterStateMachine`` on the
in-memory log with real snapshot storage in ``{root}/{peer}/{group}``
(``sm_storage_root``).  Step by step, as the JAX rung:

1. seed every group with ``writes`` writes;
2. snapshot every group's leader, 256 at a time
   (``Division.take_snapshot_async``: the counter's file, then the purge
   of the covered log); the leader's index is the group's snapshot
   index;
3. wipe the last server's replicas (``Cluster.wipe``: ``group_remove``
   then a fresh ``group_add``, in waves of 256): the new divisions start
   from an empty log on the engine rows the old ones released, against
   leaders whose logs no longer reach back to index 0, so each leader
   must install its snapshot;
4. run the same load again while polling every 0.1 s until each wiped
   division has applied its group's snapshot index (deadline 600 s);
5. count the installs (the wiped replica's state machine holds a
   snapshot); raise if a group never caught up or if the commits/s during
   the installs fell below a quarter of those before.

The port adds checks the JAX rung lacks: every replica's counter on every
server, the wiped one included, read back and equal to the acknowledged
writes of both loads; ``installs == groups``; the wiped server's engine
holding ``groups`` live rows after the wipe, on the rows it released;
the rows its refresh ticks (K2) rewrote during the catch-up; from the
wipe to the last install, the loop's pauses, each server's election
timeouts and the groups that changed leader, once a second
(``catchup_timeline``); the storage's filesystem.

Where the harnesses differ (``PERF.md`` section 4): the port elects its
leaders, where the JAX bench appoints them all on its first server, so
before the seed load every leadership the last server holds is
transferred to the first, and at its snapshot a group the seed load
left between leaders or led by the last server again is waited for and
moved off it (a leader on the wiped server would hand its group to a
follower whose log was never purged, and that follower would catch the
wiped replica up by appends, not by a snapshot); a wiped
replica's snapshot directory goes with it, so a snapshot it holds after
the wipe is one a leader installed; and the replicas that are neither the
leader nor wiped snapshot (and purge) too, so a group that elects another
leader during the catch-up still installs a snapshot on the wiped
replica rather than replaying its log from index 0.

``snapcatch_rung`` uses only the cluster it is given, so the same text
runs on the JAX package's servers (``tests/jax_mirror.py``).
"""

from __future__ import annotations

import asyncio
import time

from ratis_tpu_torch.conf import RaftServerConfigKeys
from ratis_tpu_torch.tools.cluster import (bring_up_wave, cluster_properties,
                                           fs_type, sealed)

# child_snapcatch: run_snapshot_catchup_bench(1024, 4, concurrency=128,
# transport="tcp") on 3 servers
SNAPCATCH = {"groups": 1024, "writes": 4, "concurrency": 128,
             "transport": "tcp", "servers": 3}
# the JAX rung's snapshot waves and its catch-up deadline (its wipes run
# in waves of the same size, ``cluster.WIPE_WAVE``)
WAVE = 256
CATCHUP_DEADLINE_S = 600.0
POLL_S = 0.1
# the catch-up timeline walks the fleet (every group's leader, every
# division's timeouts) once in this many polls: a walk at every poll held
# the one loop the writes and installs share, which the JAX rung's poll
# does not
TIMELINE_EVERY = 10
# leadership transfers off the wiped server: this many at a time, for at
# most this many passes
TRANSFER_WAVE = 64
TRANSFER_ROUNDS = 5


def snapcatch_cluster(device="cuda", groups: int = SNAPCATCH["groups"],
                      storage_root: str = None,
                      transport: str = SNAPCATCH["transport"],
                      loop_shards: int = 1):
    """The rung's cluster with its snapshot storage under
    ``storage_root`` (its properties the cluster's: the JAX bench's
    ``bench_properties(batched=True, ..., loop_shards=...)`` key for key,
    plus the engine's device; ``loop_shards`` > 1 puts each server's
    divisions on that many event loops, as the JAX rung's
    ``loop_shards`` does), prewarmed, not yet started."""
    from ratis_tpu_torch.tools.bench import _device
    from ratis_tpu_torch.tools.cluster import Cluster
    dev = str(_device(device))
    servers = SNAPCATCH["servers"]
    cluster = Cluster(groups, servers, device=dev, transport=transport,
                      properties=cluster_properties(
                          groups, servers, dev, transport,
                          loop_shards=loop_shards),
                      sm_storage_root=storage_root)
    cluster.prewarm()
    return cluster


async def move_leaders(cluster, off, to) -> int:
    """Transfer every leadership ``off`` holds to ``to`` (TRANSFER_LEADERSHIP
    through each group's client), ``TRANSFER_WAVE`` at a time; returns the
    transfers that succeeded.  Raises if ``off`` still leads a group
    after ``TRANSFER_ROUNDS`` passes."""
    moved = 0
    for _ in range(TRANSFER_ROUNDS):
        led = [g for g in cluster.groups if cluster.leader_of(g) is off]
        if not led:
            return moved
        for i in range(0, len(led), TRANSFER_WAVE):
            replies = await asyncio.gather(
                *(cluster.client(g).admin().transfer_leadership(to.peer_id)
                  for g in led[i:i + TRANSFER_WAVE]),
                return_exceptions=True)
            moved += sum(1 for r in replies if getattr(r, "success", False))
        await cluster.wait_leaders(led, 60.0)
    left = sum(1 for g in cluster.groups if cluster.leader_of(g) is off)
    if left:
        raise RuntimeError(f"{off.peer_id} still leads {left} groups after "
                           f"{TRANSFER_ROUNDS} rounds of transfers")
    return moved


def _timeouts(server) -> dict:
    """Each division of ``server`` and the election timeouts it fired."""
    return {d: d.election_metrics.timeout_count.count
            for d in server.divisions.values()}


def _timeouts_since(server, before: dict) -> int:
    """Election timeouts ``server``'s divisions fired since ``before``
    (``_timeouts`` then; a division added since counts from 0)."""
    return sum(n - before.get(d, 0) for d, n in _timeouts(server).items())


async def snapcatch_rung(cluster, writes: int = SNAPCATCH["writes"],
                         concurrency: int = SNAPCATCH["concurrency"]) -> dict:
    """``run_snapshot_catchup_bench`` on a ``snapcatch_cluster``: bring it
    up, move the last server's leaderships to the first, seed, snapshot
    every leader, wipe the last server's replicas, load again while the
    leaders install their snapshots on it, check every replica; close
    it.  Returns the JAX rung's keys and the port's checks."""
    victim, keeper = cluster.servers[-1], cluster.servers[0]
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        transfers = await move_leaders(cluster, victim, keeper)
        before = await cluster.write_all(writes, concurrency)
        seed_last = dict(cluster.last_index)

        snap_indexes: dict = {}
        leaders: dict = {}
        # each server's election timeouts while the snapshots run
        timeouts_snap = [_timeouts(s) for s in cluster.servers]

        async def snap(g) -> None:
            nonlocal transfers
            # the seed load may have moved a leadership back to the victim
            # or left a group between leaders: wait for its leader and
            # move it off the victim again before the snapshot
            for _ in range(TRANSFER_ROUNDS):
                await cluster.wait_leaders([g], 60.0)
                leader = cluster.leader_of(g)
                if leader is not None and leader is not victim:
                    break
                if leader is victim:
                    reply = (await asyncio.gather(
                        cluster.client(g).admin().transfer_leadership(
                            keeper.peer_id), return_exceptions=True))[0]
                    transfers += bool(getattr(reply, "success", False))
            leaders[g.group_id] = leader
            if leader is None or leader is victim:
                raise RuntimeError(f"{g.group_id}: leader {leader} at the "
                                   f"snapshot")
            d = leader.divisions[g.group_id]
            snap_indexes[g.group_id] = await d.take_snapshot_async()
            for s in cluster.servers:
                if s is not leader and s is not victim:
                    await s.divisions[g.group_id].take_snapshot_async()
        for i in range(0, len(cluster.groups), WAVE):
            await asyncio.gather(*(snap(g)
                                   for g in cluster.groups[i:i + WAVE]))
        if not any(v >= 0 for v in snap_indexes.values()):
            raise RuntimeError("no leader produced a snapshot")
        snapshot_timeouts = [_timeouts_since(s, n)
                             for s, n in zip(cluster.servers, timeouts_snap)]

        engine = victim.engine
        rows_before = set(engine.state.active)
        refresh0 = engine.metrics["refresh_rows"]
        # the election timeouts of the wipe and the catch-up, server by
        # server (the wiped replicas' new divisions count from 0)
        timeouts0 = [_timeouts(s) for s in cluster.servers]

        def moved() -> int:
            return sum(1 for g in cluster.groups
                       if cluster.leader_of(g) is not leaders[g.group_id])
        pending = {g.group_id for g in cluster.groups
                   if snap_indexes.get(g.group_id, -1) >= 0}
        # from the wipe to the last install, the loop's pause before each
        # poll (how much later than asked a POLL_S sleep woke), and every
        # TIMELINE_EVERY polls a row of the timeline: s since the wipe
        # began, the longest pause since the last row, groups whose wiped
        # replica has not applied its snapshot index (its old replica
        # counts while the wipe runs), groups led by another server than
        # at their snapshot, each server's election timeouts so far
        timeline, pauses = [], []

        async def watch() -> None:
            while True:
                t0 = time.monotonic()
                await asyncio.sleep(POLL_S)
                now = time.monotonic()
                pauses.append(round(now - t0 - POLL_S, 3))
                if len(pauses) % TIMELINE_EVERY:
                    continue
                timeline.append(
                    [round(now - t_wipe, 3),
                     max(pauses[-TIMELINE_EVERY:]),
                     sum(1 for gid in pending
                         if (d := victim.divisions.get(gid)) is None
                         or d._applied_index < snap_indexes[gid]),
                     moved(),
                     *(_timeouts_since(s, n)
                       for s, n in zip(cluster.servers, timeouts0))])

        t_wipe = time.monotonic()
        watcher = asyncio.ensure_future(watch())
        try:
            await cluster.wipe(victim, cluster.groups)
            wipe_s = time.monotonic() - t_wipe
            live_rows = len(engine.state.active)
            rows_reused = len(rows_before & engine.state.active)
            load = asyncio.ensure_future(cluster.write_all(writes,
                                                           concurrency))
            deadline = time.monotonic() + CATCHUP_DEADLINE_S
            while pending and time.monotonic() < deadline:
                pending = {gid for gid in pending
                           if (d := victim.divisions.get(gid)) is None
                           or d._applied_index < snap_indexes[gid]}
                if pending:
                    await asyncio.sleep(POLL_S)
            catchup_s = time.monotonic() - t_wipe
        finally:
            watcher.cancel()
        catchup_timeouts = [_timeouts_since(s, n)
                            for s, n in zip(cluster.servers, timeouts0)]
        # the loop's pauses from the wipe to the last install: the
        # longest, and those at least the election timeout's lower bound,
        # long enough for a follower's election deadline to pass with no
        # heartbeat handled
        timeout_min_s = RaftServerConfigKeys.Rpc.timeout_min(
            cluster.properties).to_ms() / 1000
        longest_pause = max(pauses, default=0.0)
        long_pauses = sum(1 for p in pauses if p >= timeout_min_s)
        refresh_rows = engine.metrics["refresh_rows"] - refresh0
        leaders_changed = moved()
        during = await load
        installed = sum(
            1 for gid, idx in snap_indexes.items() if idx >= 0
            and (d := victim.divisions.get(gid)) is not None
            and d.state_machine.get_latest_snapshot() is not None)
        if pending:
            raise TimeoutError(f"{len(pending)} groups never caught up "
                               f"after the wipe")
        if during["commits_per_sec"] < before["commits_per_sec"] / 4:
            raise RuntimeError(
                f"write path collapsed during snapshot installs: "
                f"{during['commits_per_sec']} vs "
                f"{before['commits_per_sec']} before")

        counters = await cluster.read_counters(timeout=300)
        acked = {g.group_id: before["acked"][g.group_id]
                 + during["acked"][g.group_id] for g in cluster.groups}
        bad = {str(gid): v for gid, v in counters.items()
               if v != [acked[gid]] * len(cluster.servers)}
        root = cluster.sm_storage_root
        return {
            "commits_per_sec": during["commits_per_sec"],
            "cps_before": before["commits_per_sec"],
            "p99_ms": during["p99_ms"],
            "p50_ms": during["p50_ms"],
            "p99_ms_before": before["p99_ms"],
            "write_failures": 0,
            "catchup_s": catchup_s,
            "installs": installed,
            "groups": cluster.num_groups,
            "transport": cluster.transport,
            "peers": len(cluster.servers),
            "election_convergence_s": cluster.bring_up_s,
            "writes": writes, "concurrency": concurrency,
            "commits": before["commits"] + during["commits"],
            "snapshot_index": {str(g.group_id): snap_indexes[g.group_id]
                               for g in cluster.groups},
            # groups whose snapshot ends at their last acknowledged seed
            # write (the leader had applied it and nothing after it)
            "snapshots_at_last_seed_write": sum(
                1 for g in cluster.groups
                if snap_indexes[g.group_id] == seed_last[g.group_id]),
            "transfers": transfers,
            "leaders_changed": leaders_changed,
            "wipe_s": wipe_s,
            "victim_live_rows": live_rows,
            "victim_rows_reused": rows_reused,
            "refresh_rows_during_catchup": refresh_rows,
            "loop_longest_pause_s": longest_pause,
            "loop_pauses_over_timeout_min": long_pauses,
            # per server, the wiped one last: while the snapshots ran, and
            # from the wipe to the last install
            "snapshot_election_timeouts": snapshot_timeouts,
            "catchup_election_timeouts": catchup_timeouts,
            # a row every TIMELINE_EVERY polls: s since the wipe, the
            # longest pause since the last row, groups not yet caught up,
            # groups led by another server than at their snapshot, each
            # server's election timeouts so far
            "catchup_timeline": timeline,
            "counters": {str(gid): v for gid, v in counters.items()},
            "replicas_read_back": len(counters) * len(cluster.servers),
            "replica_mismatches": len(bad),
            "replica_mismatch_examples": list(bad.items())[:4],
            "election_timeouts": cluster.election_timeouts(),
            "fs_type": fs_type(root) if root else None,
            # (the JAX package's engine, in the mirrored run, names none)
            "engine_device": str(getattr(engine, "device", None)),
        }
    finally:
        await cluster.close()
