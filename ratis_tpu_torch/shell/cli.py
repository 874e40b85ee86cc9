"""Admin shell: the operator CLI over the client admin APIs.

Capability parity with the reference ratis-shell
(ratis-shell/src/main/java/org/apache/ratis/shell/cli/sh/RatisShell.java:60
and its command tree): ``election {transfer,stepDown,pause,resume}``,
``group {info,list}``, ``peer {add,remove,setPriority}``,
``snapshot create``, and the offline ``local raftMetaConf`` rewriter.

Usage (mirrors the reference flags):
  python -m ratis_tpu_torch.shell election transfer -peers s0=h:p,s1=h:p -peerId s1
  python -m ratis_tpu_torch.shell group info -peers s0=h:p,s1=h:p [-groupid UUID]
  python -m ratis_tpu_torch.shell peer add -peers ... -peerId s3 -address h:p
  python -m ratis_tpu_torch.shell local raftMetaConf -path <dir> -peers s0=h:p,...

``-peers`` entries are ``id=host:port`` (or bare ``host:port``, id derived
from the address like the reference's getPeerId).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from typing import List, Optional

from ratis_tpu_torch.protocol.group import RaftGroup
from ratis_tpu_torch.protocol.ids import RaftGroupId, RaftPeerId
from ratis_tpu_torch.protocol.peer import RaftPeer


def parse_peers(spec: str) -> List[RaftPeer]:
    peers = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            pid, _, address = part.partition("=")
        else:
            address = part
            pid = address.replace(":", "_").replace(".", "_")
        peers.append(RaftPeer(RaftPeerId.value_of(pid), address=address))
    if not peers:
        raise ValueError(f"no peers in {spec!r}")
    return peers


def _new_client(peers: List[RaftPeer], group_id: Optional[RaftGroupId]):
    from ratis_tpu_torch.client import RaftClient
    from ratis_tpu_torch.transport import grpc as _grpc  # noqa: F401 (registers)
    from ratis_tpu_torch.transport.base import TransportFactory
    factory = TransportFactory.get("GRPC")
    group = RaftGroup.value_of(group_id or RaftGroupId.empty_id(), peers)
    return (RaftClient.builder()
            .set_raft_group(group)
            .set_transport(factory.new_client_transport())
            .build())


async def _resolve_group(args) -> tuple:
    """(peers, group_id): use -groupid, else ask a server for its groups
    (reference GroupListCommand-assisted default)."""
    peers = parse_peers(args.peers)
    if args.groupid:
        return peers, RaftGroupId.value_of(args.groupid)
    async with _new_client(peers, None) as probe:
        groups = await probe.group_management().group_list(peers[0].id)
    if len(groups) != 1:
        raise SystemExit(
            f"server hosts {len(groups)} groups "
            f"({', '.join(str(g) for g in groups)}); pass -groupid")
    return peers, groups[0]


def _target_peer_id(args, peers) -> RaftPeerId:
    if getattr(args, "peerId", None):
        return RaftPeerId.value_of(args.peerId)
    if getattr(args, "address", None):
        for p in peers:
            if p.address == args.address:
                return p.id
        raise SystemExit(f"address {args.address} not in -peers")
    raise SystemExit("pass -peerId or -address")


# ------------------------------------------------------------- commands

async def cmd_group_list(args) -> int:
    peers = parse_peers(args.peers)
    target = _target_peer_id(args, peers) if (args.peerId or args.address) \
        else peers[0].id
    async with _new_client(peers, None) as client:
        groups = await client.group_management().group_list(target)
    print(f"{target}: {len(groups)} group(s)")
    for gid in groups:
        print(f"  {gid.uuid}")
    return 0


async def cmd_group_info(args) -> int:
    peers, gid = await _resolve_group(args)
    async with _new_client(peers, gid) as client:
        info = await client.group_management().group_info(peers[0].id, gid)
    print(f"group id: {info.group.group_id.uuid}")
    print(f"leader: {info.leader_id or '<none>'} (term {info.term})")
    print(f"commit index: {info.commit_index}  "
          f"applied index: {info.applied_index}")
    for p in info.group.peers:
        print(f"  peer {p.id} | {p.address} | priority={p.priority}"
              f"{' | LISTENER' if p.is_listener() else ''}")
    return 0


async def cmd_election_transfer(args) -> int:
    peers, gid = await _resolve_group(args)
    target = _target_peer_id(args, peers)
    async with _new_client(peers, gid) as client:
        reply = await client.admin().transfer_leadership(
            target, timeout_ms=args.timeout * 1000.0)
    print(f"leadership transfer to {target}: "
          f"{'SUCCESS' if reply.success else reply.exception}")
    return 0 if reply.success else 1


async def cmd_election_step_down(args) -> int:
    peers, gid = await _resolve_group(args)
    async with _new_client(peers, gid) as client:
        reply = await client.admin().transfer_leadership(None)
    print(f"step down: {'SUCCESS' if reply.success else reply.exception}")
    return 0 if reply.success else 1


async def _election_pause_resume(args, op: str) -> int:
    peers, gid = await _resolve_group(args)
    target = _target_peer_id(args, peers)
    async with _new_client(peers, gid) as client:
        api = client.leader_election_management()
        reply = await (api.pause(target) if op == "pause"
                       else api.resume(target))
    print(f"election {op} on {target}: "
          f"{'SUCCESS' if reply.success else reply.exception}")
    return 0 if reply.success else 1


async def cmd_peer_add(args) -> int:
    from ratis_tpu_torch.protocol.admin import SetConfigurationMode
    peers, gid = await _resolve_group(args)
    new_peer = RaftPeer(RaftPeerId.value_of(args.peerId),
                        address=args.address)
    async with _new_client(peers, gid) as client:
        info = await client.group_management().group_info(peers[0].id, gid)
        current = [p for p in info.group.peers if not p.is_listener()]
        if any(p.id == new_peer.id for p in current):
            print(f"peer {new_peer.id} already in the group")
            return 1
        reply = await client.admin().set_configuration(
            current + [new_peer], mode=SetConfigurationMode.SET_UNCONDITIONALLY)
    print(f"peer add {new_peer.id}: "
          f"{'SUCCESS' if reply.success else reply.exception}")
    return 0 if reply.success else 1


async def cmd_peer_remove(args) -> int:
    from ratis_tpu_torch.protocol.admin import SetConfigurationMode
    peers, gid = await _resolve_group(args)
    victim = _target_peer_id(args, peers)
    async with _new_client(peers, gid) as client:
        info = await client.group_management().group_info(peers[0].id, gid)
        current = [p for p in info.group.peers if not p.is_listener()]
        remaining = [p for p in current if p.id != victim]
        if len(remaining) == len(current):
            print(f"peer {victim} not in the group")
            return 1
        reply = await client.admin().set_configuration(
            remaining, mode=SetConfigurationMode.SET_UNCONDITIONALLY)
    print(f"peer remove {victim}: "
          f"{'SUCCESS' if reply.success else reply.exception}")
    return 0 if reply.success else 1


async def cmd_peer_set_priority(args) -> int:
    from ratis_tpu_torch.protocol.admin import SetConfigurationMode
    peers, gid = await _resolve_group(args)
    updates = {}
    for spec in args.addressPriority:
        address, _, prio = spec.rpartition("|")
        updates[address] = int(prio)
    async with _new_client(peers, gid) as client:
        info = await client.group_management().group_info(peers[0].id, gid)
        new_conf = []
        for p in info.group.peers:
            if p.is_listener():
                continue
            new_conf.append(p.with_priority(updates[p.address])
                            if p.address in updates else p)
        reply = await client.admin().set_configuration(new_conf)
    print(f"setPriority: {'SUCCESS' if reply.success else reply.exception}")
    return 0 if reply.success else 1


async def cmd_snapshot_create(args) -> int:
    peers, gid = await _resolve_group(args)
    target = (_target_peer_id(args, peers)
              if (args.peerId or args.address) else None)
    async with _new_client(peers, gid) as client:
        reply = await client.snapshot_management().create(
            creation_gap=args.creationGap, server_id=target)
    if reply.success:
        print(f"snapshot created at index {reply.log_index}")
        return 0
    print(f"snapshot create failed: {reply.exception}")
    return 1


async def cmd_health(args) -> int:
    """Cluster health from the observability plane: scrape one or more
    servers' introspection endpoints (``raft.tpu.metrics.http-port``) and
    pretty-print liveness, engine freshness, per-division state, active
    chaos-injected faults, and the stall watchdog's journal.  Exit 0 =
    every endpoint reachable and ok; 1 = any endpoint degraded,
    unreachable, with journaled (organic) events, with ACTIVE injected
    faults, or with an injected-fault event whose recovery pair never
    landed.  A recovered injected fault is printed as history and does
    NOT degrade the exit status — a finished chaos campaign leaves a
    healthy cluster healthy."""
    from ratis_tpu_torch.metrics.aggregate import scrape_cluster
    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    if not endpoints:
        raise SystemExit("pass -endpoints host:port[,host:port...]")
    merged = await scrape_cluster(endpoints, timeout_s=args.timeout)
    rc = 0
    procs = merged.get("procs", {})
    print(f"cluster: {merged['healthy']}/{merged['servers']} server(s) "
          f"healthy, {merged['watchdog_events']} watchdog event(s)")
    for pid, proc in sorted(procs.items()):
        roles = ", ".join(f"{n} {r}" for r, n in
                          sorted(proc.get("roles", {}).items()))
        print(f"  {proc.get('peer')} pid={pid} @{proc.get('address')}: "
              f"{proc.get('status')} | {proc.get('divisions')} division(s)"
              f"{' (' + roles + ')' if roles else ''} | "
              f"engine ticks={proc.get('engineTicks')} "
              f"occupancy={proc.get('laneOccupancyGroups'):.3f} | "
              f"pending={proc.get('pendingRequests')} "
              f"lagMax={proc.get('followerLagMax')} "
              f"shed={proc.get('shedRequests', 0)}")
        if proc.get("status") != "ok":
            rc = 1
        if proc.get("chaosActiveFaults"):
            rc = 1
            inj = proc.get("chaosInjections") or []
            print(f"    ACTIVE INJECTED FAULTS: "
                  f"{proc['chaosActiveFaults']}"
                  f"{' (injections: ' + ', '.join(inj) + ')' if inj else ''}")
    for dead in merged.get("unreachable", []):
        print(f"  UNREACHABLE {dead['address']}: {dead['error']}")
        rc = 1
    if args.verbose:
        for address in endpoints:
            from ratis_tpu_torch.metrics.aggregate import fetch_json
            try:
                divisions = await fetch_json(address, "/divisions",
                                             args.timeout)
            except Exception:
                continue
            print(f"  divisions @{address}:")
            for d in divisions:
                fol = " ".join(
                    f"{p}:lag={f['lag']}"
                    for p, f in sorted((d.get("followers") or {}).items()))
                print(f"    {d['group']} {d['role'].lower()} "
                      f"term={d['term']} commit={d['commitIndex']} "
                      f"applied={d['lastApplied']} "
                      f"shard={d['loopShard']}"
                      f"{' | ' + fol if fol else ''}")
    all_events: list = []
    for address in endpoints:
        from ratis_tpu_torch.metrics.aggregate import fetch_json
        try:
            events = await fetch_json(address, "/events", args.timeout)
        except Exception:
            continue
        all_events.extend((address, e) for e in events.get("events", []))
    # injected-fault / fault-recovered pairing (ratis_tpu_torch.chaos): a fault
    # whose recovery event landed — on ANY endpoint — is campaign history,
    # not a degradation; an unrecovered one fails health like an organic
    # event does
    recovered = {e.get("fault") for _a, e in all_events
                 if e.get("kind") in ("fault-recovered", "rebalance-done")
                 and e.get("fault")}
    shown = 0
    for address, e in all_events:
        kind = e.get("kind")
        if kind in ("fault-recovered", "rebalance-done"):
            continue  # shown through its opening pair below
        if shown == 0:
            print("watchdog events:")
        shown += 1
        group = f" [{e['group']}]" if e.get("group") else ""
        if kind == "injected-fault" and e.get("fault") in recovered:
            print(f"  {address} {kind}{group} (recovered): {e['detail']}")
            continue
        # placement actuations pair rebalance with rebalance-done the way
        # chaos pairs injected-fault with fault-recovered: a converged
        # actuation is history, a dangling one degrades health
        if kind == "rebalance" and e.get("fault") in recovered:
            print(f"  {address} {kind}{group} (converged): {e['detail']}")
            continue
        rc = 1
        tag = (" UNRECOVERED" if kind == "injected-fault"
               else " UNCONVERGED" if kind == "rebalance" else "")
        print(f"  {address} {kind}{group}{tag}: {e['detail']}")
    return rc


async def cmd_top(args) -> int:
    """Live cluster view over the continuous-telemetry plane: poll every
    server's ``GET /timeseries`` (incrementally, via ``?since=``) and
    render per-process rates computed from successive counter deltas,
    plus the merged hot-group leaderboard.  ``-iterations 0`` (default)
    refreshes until interrupted; a fixed count makes it scriptable."""
    import time as _time

    from ratis_tpu_torch.metrics.aggregate import scrape_cluster_timeseries
    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    if not endpoints:
        raise SystemExit("pass -endpoints host:port[,host:port...]")
    since: dict = {}
    prev: dict = {}          # pid -> (monotonic, cumulative totals)
    i = 0
    while True:
        merged = await scrape_cluster_timeseries(
            endpoints, timeout_s=args.timeout,
            since=since if since else None)
        now = _time.monotonic()
        procs = merged.get("procs", {})
        print(f"-- top @ {_time.strftime('%H:%M:%S')} | "
              f"{len(procs)} process(es) | cluster "
              + " ".join(f"{k}={v:g}"
                         for k, v in sorted(
                             merged.get("rates", {}).items())))
        print(f"{'PEER':<10} {'PID':<8} {'C/S':>9} {'ACK/S':>9} "
              f"{'REW/S':>7} {'SHED/S':>7} {'OCC':>6} {'PEND':>6} "
              f"{'LAG':>6} {'DIV':>6} {'EVT':>5}")
        for pid, proc in sorted(procs.items()):
            addr = merged.get("addresses", {}).get(pid)
            if addr is not None and proc.get("seq", -1) >= 0:
                since[addr] = proc["seq"]
            last = proc.get("last") or {}
            totals = last.get("totals") or {}
            rates = dict(last.get("rates") or {})
            p = prev.get(pid)
            if p is not None and totals:
                # rates over OUR polling window from the cumulative
                # counters each sample carries — true /timeseries deltas,
                # independent of the server-side sampling cadence
                dt = max(1e-6, now - p[0])
                for k in ("commits", "acks", "rewinds", "shed"):
                    if k in totals and k in p[1]:
                        rates[f"{k}_per_s"] = round(
                            max(0, totals[k] - p[1][k]) / dt, 1)
            if totals:
                prev[pid] = (now, totals)
            print(f"{str(proc.get('peer') or '?'):<10} {pid:<8} "
                  f"{rates.get('commits_per_s', 0):>9g} "
                  f"{rates.get('acks_per_s', 0):>9g} "
                  f"{rates.get('rewinds_per_s', 0):>7g} "
                  f"{rates.get('shed_per_s', 0):>7g} "
                  f"{last.get('occupancy', 0):>6g} "
                  f"{last.get('pending', 0):>6g} "
                  f"{last.get('lag', 0):>6g} "
                  f"{last.get('divisions', 0):>6g} "
                  f"{totals.get('events', 0):>5g}")
        hot = (merged.get("hotgroups") or {}).get("groups", [])
        if hot:
            print("hot groups: " + "  ".join(
                f"{g['group']}={g['commits']}c/{g['pending']}p"
                f"({g['share']:.0%})" for g in hot[:5]))
        for dead in merged.get("unreachable", []):
            print(f"  UNREACHABLE {dead['address']}: {dead['error']}")
        i += 1
        if args.iterations and i >= args.iterations:
            return 0
        await asyncio.sleep(args.interval)


async def cmd_lag(args) -> int:
    """Cluster lag heatmap over the lag & health ledger: scrape every
    server's ``GET /lag`` and render the peers x leaders health-score
    matrix (each row is one server's leader-side view of every follower
    peer; 1.00 = every watched link inside the lag threshold), then each
    server's worst laggard groups with their shard placement."""
    import time as _time

    from ratis_tpu_torch.metrics.aggregate import scrape_cluster_lag
    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    if not endpoints:
        raise SystemExit("pass -endpoints host:port[,host:port...]")
    out = await scrape_cluster_lag(endpoints, timeout_s=args.timeout)
    servers = out.get("servers", [])
    peer_cols = sorted({p["peer"] for s in servers for p in s["peers"]})
    thr = servers[0]["lagThreshold"] if servers else "?"
    print(f"-- lag @ {_time.strftime('%H:%M:%S')} | {len(servers)} "
          f"server(s) | score = healthy share of watched links "
          f"(threshold {thr} entries; '-' = no links)")
    print(f"{'LEADER':<10} {'LEADS':>6} {'GAP':>6} "
          + " ".join(f"{c:>10}" for c in peer_cols))
    worst_lines = []
    for s in servers:
        by = {p["peer"]: p for p in s["peers"]}
        cells = []
        for name in peer_cols:
            p = by.get(name)
            cells.append("-" if p is None else f"{p['score']:.2f}")
        print(f"{str(s.get('peer') or '?'):<10} {s['leading']:>6} "
              f"{s['gapTotal']:>6} "
              + " ".join(f"{c:>10}" for c in cells))
        if s.get("groups"):
            worst_lines.append(
                f"  {s['peer']} worst: " + "  ".join(
                    f"{g['group']}[shard{g['shard']}]={g['lag']}"
                    f" via {g['peer']}" for g in s["groups"]))
    if worst_lines:
        print("laggard groups (entries behind commit):")
        for line in worst_lines:
            print(line)
    rc = 0
    for dead in out.get("unreachable", []):
        rc = 1
        print(f"  UNREACHABLE {dead['address']}: {dead['error']}")
    return rc


async def cmd_rebalance(args) -> int:
    """Placement plan over the whole fleet: scrape every server's
    ``/lag`` ``/divisions?rollup=1`` ``/health`` ``/hotgroups`` into the
    same ClusterSnapshot the in-server policy loop builds locally, run
    the same PlacementPolicy, and print the plan with reasons.

    ``--dry-run`` only prints (exit 0 = balanced, nothing to do; 2 =
    the plan has actions — scriptable as "work exists").  Without it the
    transfers are executed through the admin client (exit 0 = every
    transfer succeeded, 1 = any failed); steering and repins are
    in-server/advisory actions and are printed, never executed here."""
    from ratis_tpu_torch.metrics.aggregate import fetch_json
    from ratis_tpu_torch.placement import (ClusterSnapshot, PlacementPolicy,
                                     view_from_payloads)
    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    if not endpoints:
        raise SystemExit("pass -endpoints host:port[,host:port...]")
    views = []
    for address in endpoints:
        payloads = {}
        for name, path in (("lag", "/lag"),
                           ("rollup", "/divisions?rollup=1"),
                           ("health", "/health"),
                           ("hotgroups", "/hotgroups")):
            try:
                payloads[name] = await fetch_json(address, path,
                                                  args.timeout)
            except Exception:
                payloads[name] = None  # telemetry-off / degraded server
        if all(v is None for v in payloads.values()):
            print(f"  UNREACHABLE {address}", file=sys.stderr)
            return 1
        views.append(view_from_payloads(**payloads))
    policy = PlacementPolicy(hot_share=args.hot_share,
                             grey_score=args.grey_score,
                             hysteresis=args.hysteresis,
                             max_transfers_per_round=args.max_transfers)
    plan = policy.plan(ClusterSnapshot(views=tuple(views)))
    print(f"placement plan over {len(views)} server(s): "
          f"imbalance={plan.imbalance:g}, "
          f"{len(plan.transfers())} transfer(s), "
          f"{len(plan.steers())} steer(s), "
          f"{len(plan.repins())} advisory repin(s)")
    for line in plan.explain():
        print(f"  {line}")
    if not plan.transfers() and not plan.steers():
        print("balanced: nothing to do")
        return 0
    if args.dry_run:
        return 2
    if not args.peers:
        raise SystemExit("executing a plan needs -peers id=host:port,...")
    peers = parse_peers(args.peers)
    async with _new_client(peers, None) as probe:
        groups = await probe.group_management().group_list(peers[0].id)
    # plan groups carry display strings (str(RaftGroupId) is not
    # parseable back) — resolve them against the server's group list
    by_display = {str(g): g for g in groups}
    rc = 0
    for t in plan.transfers():
        gid = by_display.get(t.group)
        if gid is None:
            print(f"  {t.group}: not hosted by {peers[0].id}, skipped")
            rc = 1
            continue
        async with _new_client(peers, gid) as client:
            reply = await client.admin().transfer_leadership(
                RaftPeerId.value_of(t.to_peer),
                timeout_ms=args.timeout * 1000.0)
        print(f"  TRANSFER {t.group} -> {t.to_peer}: "
              f"{'SUCCESS' if reply.success else reply.exception}")
        if not reply.success:
            rc = 1
    return rc


def cmd_local_raft_meta_conf(args) -> int:
    """Offline rewrite of raft-meta.conf to a new peer list (reference
    `local raftMetaConf`, used to resurrect a group whose quorum is gone)."""
    import pathlib

    from ratis_tpu_torch.protocol.logentry import LogEntry, make_config_entry
    from ratis_tpu_torch.server.storage import RaftStorageDirectory
    peers = parse_peers(args.peers)
    path = pathlib.Path(args.path)
    conf_file = path / RaftStorageDirectory.CONF_FILE
    if not conf_file.exists():
        print(f"no {RaftStorageDirectory.CONF_FILE} under {path}",
              file=sys.stderr)
        return 1
    old = LogEntry.from_bytes(conf_file.read_bytes())
    new_entry = make_config_entry(old.term, old.index + 1, peers)
    backup = conf_file.with_suffix(".conf.bak")
    backup.write_bytes(conf_file.read_bytes())
    tmp = conf_file.with_suffix(".conf.tmp")
    tmp.write_bytes(new_entry.to_bytes())
    tmp.replace(conf_file)
    print(f"rewrote {conf_file} at index {new_entry.index} with "
          f"{len(peers)} peer(s); backup at {backup}")
    return 0


# -------------------------------------------------------------- parser

def _add_common(p: argparse.ArgumentParser, group_opt: bool = True) -> None:
    p.add_argument("-peers", required=True,
                   help="comma list of id=host:port")
    if group_opt:
        p.add_argument("-groupid", default=None, help="group UUID")


def _add_target(p: argparse.ArgumentParser) -> None:
    p.add_argument("-peerId", default=None)
    p.add_argument("-address", default=None)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ratis sh", description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("group").add_subparsers(dest="sub", required=True)
    p = g.add_parser("list")
    _add_common(p, group_opt=False)
    _add_target(p)
    p.set_defaults(func=cmd_group_list)
    p = g.add_parser("info")
    _add_common(p)
    p.set_defaults(func=cmd_group_info)

    e = sub.add_parser("election").add_subparsers(dest="sub", required=True)
    p = e.add_parser("transfer")
    _add_common(p)
    _add_target(p)
    p.add_argument("-timeout", type=float, default=10.0, help="seconds")
    p.set_defaults(func=cmd_election_transfer)
    p = e.add_parser("stepDown")
    _add_common(p)
    p.set_defaults(func=cmd_election_step_down)
    p = e.add_parser("pause")
    _add_common(p)
    _add_target(p)
    p.set_defaults(func=lambda a: _election_pause_resume(a, "pause"))
    p = e.add_parser("resume")
    _add_common(p)
    _add_target(p)
    p.set_defaults(func=lambda a: _election_pause_resume(a, "resume"))

    pe = sub.add_parser("peer").add_subparsers(dest="sub", required=True)
    p = pe.add_parser("add")
    _add_common(p)
    p.add_argument("-peerId", required=True)
    p.add_argument("-address", required=True)
    p.set_defaults(func=cmd_peer_add)
    p = pe.add_parser("remove")
    _add_common(p)
    _add_target(p)
    p.set_defaults(func=cmd_peer_remove)
    p = pe.add_parser("setPriority")
    _add_common(p)
    p.add_argument("-addressPriority", nargs="+", required=True,
                   metavar="host:port|priority")
    p.set_defaults(func=cmd_peer_set_priority)

    s = sub.add_parser("snapshot").add_subparsers(dest="sub", required=True)
    p = s.add_parser("create")
    _add_common(p)
    _add_target(p)
    p.add_argument("-creationGap", type=int, default=0)
    p.set_defaults(func=cmd_snapshot_create)

    p = sub.add_parser(
        "health",
        help="scrape servers' observability endpoints "
             "(raft.tpu.metrics.http-port) and print cluster health")
    p.add_argument("-endpoints", required=True,
                   help="comma list of host:port metrics endpoints")
    p.add_argument("-timeout", type=float, default=10.0, help="seconds")
    p.add_argument("-verbose", action="store_true",
                   help="also print every division's state")
    p.set_defaults(func=cmd_health)

    p = sub.add_parser(
        "top",
        help="live per-process rate view over the telemetry plane "
             "(raft.tpu.telemetry.enabled servers' GET /timeseries)")
    p.add_argument("-endpoints", required=True,
                   help="comma list of host:port metrics endpoints")
    p.add_argument("-interval", type=float, default=2.0,
                   help="refresh seconds")
    p.add_argument("-iterations", type=int, default=0,
                   help="refresh count (0 = until interrupted)")
    p.add_argument("-timeout", type=float, default=10.0, help="seconds")
    p.set_defaults(func=cmd_top)

    p = sub.add_parser(
        "lag",
        help="cluster lag heatmap over the lag & health ledger "
             "(every server's GET /lag: per-peer health scores + "
             "worst laggard groups)")
    p.add_argument("-endpoints", required=True,
                   help="comma list of host:port metrics endpoints")
    p.add_argument("-timeout", type=float, default=10.0, help="seconds")
    p.set_defaults(func=cmd_lag)

    p = sub.add_parser(
        "rebalance",
        help="compute (and optionally execute) the placement plan the "
             "in-server policy loop runs, from scraped endpoints")
    p.add_argument("-endpoints", required=True,
                   help="comma list of host:port metrics endpoints")
    p.add_argument("-peers", default=None,
                   help="comma list of id=host:port (needed to execute)")
    p.add_argument("-dry-run", "--dry-run", action="store_true",
                   dest="dry_run",
                   help="print the plan only; exit 2 when actions exist")
    p.add_argument("-hot-share", type=float, default=0.2, dest="hot_share",
                   help="share_min floor marking a group hot")
    p.add_argument("-grey-score", type=float, default=0.5,
                   dest="grey_score",
                   help="health score under which a peer is steered")
    p.add_argument("-hysteresis", type=float, default=1.0,
                   help="extra hot groups over fair share tolerated")
    p.add_argument("-max-transfers", type=int, default=2,
                   dest="max_transfers", help="transfer cap per round")
    p.add_argument("-timeout", type=float, default=10.0, help="seconds")
    p.set_defaults(func=cmd_rebalance)

    lo = sub.add_parser("local").add_subparsers(dest="sub", required=True)
    p = lo.add_parser("raftMetaConf")
    p.add_argument("-path", required=True,
                   help="the group's `current/` storage dir")
    p.add_argument("-peers", required=True)
    p.set_defaults(func=cmd_local_raft_meta_conf, sync=True)

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    func = args.func
    if getattr(args, "sync", False):
        return func(args)
    try:
        return asyncio.run(func(args))
    except SystemExit:
        raise
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
