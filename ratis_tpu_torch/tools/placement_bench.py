"""The placement rung on the port: the JAX bench's ``child_placement``
(``run_placement_bench``, ``ratis_tpu/tools/bench_cluster.py``).

    python -m ratis_tpu_torch.tools.bench --rungs placement

A zipf fleet with an induced hotspot and an induced grey follower,
measured back to back with the placement controller OFF, then ON, on the
port's ``Cluster`` (``tools/cluster.py``): ``servers`` servers x ``groups``
groups over localhost TCP, linearizable reads with leases off (every read
rides a batched readIndex confirmation sweep, the path that steering
gates), the telemetry sampler at 250 ms and admission control with a
pending-element limit.  The ``hot_pins`` hottest zipf groups' leaderships
are moved onto server 0 by leadership transfers (the port's harness elects
its leaders, where the JAX bench appoints them all on server 0), and the
last server's append handling is delayed ``grey_delay_ms`` per envelope
(``util/injection``).  Phase OFF drives the fleet open loop (every client
fires a write and a read every ``pace_s``); then a ``PlacementController``
is armed on every server with the storm tuning, given ``settle_s`` of
load to act, its transfer budget frozen, and phase ON drives the same
fleet.  The result keys are ``run_placement_bench``'s.
"""

from __future__ import annotations

import asyncio
import bisect
import itertools
import random
import time

from ratis_tpu_torch.conf import RaftServerConfigKeys

# child_placement: 4 servers x 48 groups over TCP, 384 clients x 6
# requests 0.25 s apart, element limit 192, 8 hot pins, settle 6 s
PLACEMENT = {"groups": 48, "servers": 4, "clients": 384,
             "requests_per_client": 6, "pace_s": 0.25,
             "element_limit": 192, "hot_pins": 8, "settle_s": 6.0}


def placement_properties(groups: int, servers: int, device: str,
                         element_limit: int):
    """The cluster's batched properties over TCP with
    ``run_placement_bench``'s extra keys: linearizable reads, leases off,
    telemetry every 250 ms, admission control at ``element_limit`` pending
    elements, retry-after 40 ms."""
    from ratis_tpu_torch.tools.cluster import cluster_properties
    keys = RaftServerConfigKeys.Serving
    p = cluster_properties(groups, servers, device, "tcp")
    for k, v in {
            RaftServerConfigKeys.Read.OPTION_KEY: "LINEARIZABLE",
            RaftServerConfigKeys.Read.LEADER_LEASE_ENABLED_KEY: "false",
            RaftServerConfigKeys.Telemetry.ENABLED_KEY: "true",
            RaftServerConfigKeys.Telemetry.INTERVAL_KEY: "250ms",
            keys.ADMISSION_ENABLED_KEY: "true",
            keys.PENDING_ELEMENT_LIMIT_KEY: str(element_limit),
            keys.RETRY_AFTER_KEY: "40ms"}.items():
        p.set(k, v)
    return p


def placement_cluster(device="cuda", groups: int = PLACEMENT["groups"],
                      servers: int = PLACEMENT["servers"],
                      element_limit: int = PLACEMENT["element_limit"]):
    """The placement rung's cluster over TCP, prewarmed, not yet
    started."""
    from ratis_tpu_torch.tools.bench import _device
    from ratis_tpu_torch.tools.cluster import Cluster
    dev = str(_device(device))
    cluster = Cluster(groups, servers, device=dev, transport="tcp",
                      properties=placement_properties(groups, servers, dev,
                                                      element_limit))
    cluster.prewarm()
    return cluster


async def placement_rung(cluster, clients: int = 384,
                         requests_per_client: int = 6,
                         zipf_s: float = 1.2, pace_s: float = 0.25,
                         seed: int = 23, hot_pins: int = 8,
                         grey_delay_ms: int = 120,
                         settle_s: float = 4.0) -> dict:
    """``run_placement_bench`` on a ``placement_cluster``: bring it up,
    pin the hot groups, delay the grey follower, phase OFF, arm the
    controllers, settle, phase ON; close it."""
    from ratis_tpu_torch.placement import PlacementController
    from ratis_tpu_torch.protocol.admin import TransferLeadershipArguments
    from ratis_tpu_torch.protocol.exceptions import (
        LeaderNotReadyException, NotLeaderException, RaftException,
        ResourceUnavailableException)
    from ratis_tpu_torch.protocol.ids import ClientId
    from ratis_tpu_torch.protocol.message import Message
    from ratis_tpu_torch.protocol.requests import (RaftClientRequest,
                                                   RequestType,
                                                   admin_request_type,
                                                   read_request_type,
                                                   write_request_type)
    from ratis_tpu_torch.tools.cluster import bring_up_wave, sealed
    from ratis_tpu_torch.util import injection

    num_groups = cluster.num_groups
    rng = random.Random(seed)
    weights = [(r + 1) ** -zipf_s for r in range(num_groups)]
    total_w = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w
        cdf.append(acc / total_w)
    call_ids = itertools.count(1)
    client = None
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        # group id -> the server a request goes to first (the JAX bench's
        # BenchCluster._leader_hint), from the elected leaders
        hint = {g.group_id: cluster.leader_of(g) or cluster.servers[0]
                for g in cluster.groups}
        client = cluster.factory.new_client_transport(cluster.properties)
        hot_srv = cluster.servers[0]
        grey_srv = cluster.servers[-1]
        grey_name = str(grey_srv.peer_id)
        by_id = {s.peer_id: s for s in cluster.servers}
        admin_id = ClientId.random_id()

        async def pin(group, target_srv) -> bool:
            """Transfer ``group``'s leadership to ``target_srv`` (the
            churn rung's NotLeader-following retry idiom)."""
            leader_srv = hint.get(group.group_id, cluster.servers[0])
            if leader_srv is target_srv:
                return True
            args = TransferLeadershipArguments(str(target_srv.peer_id),
                                               3000.0)
            reply = None
            for _attempt in range(2 * len(group.peers)):
                req = RaftClientRequest(
                    admin_id, leader_srv.peer_id, group.group_id,
                    next(call_ids), Message(args.to_payload()),
                    type=admin_request_type(
                        RequestType.TRANSFER_LEADERSHIP),
                    timeout_ms=5000.0)
                try:
                    reply = await client.send_request(
                        leader_srv.transport.address, req)
                except (RaftException, asyncio.TimeoutError):
                    reply = None
                if reply is None:
                    break
                if reply.success:
                    hint[group.group_id] = target_srv
                    return True
                exc = reply.exception
                if isinstance(exc, LeaderNotReadyException):
                    await asyncio.sleep(0.1)
                    continue
                if isinstance(exc, NotLeaderException) \
                        and exc.suggested_leader is not None:
                    nxt = by_id.get(exc.suggested_leader.id)
                    if nxt is target_srv:   # already there
                        hint[group.group_id] = target_srv
                        return True
                    leader_srv = nxt or leader_srv
                    continue
                break
            return False

        # the induced hotspot: every hot group's leadership on server 0
        pinned = 0
        for g in cluster.groups[:hot_pins]:
            pinned += bool(await pin(g, hot_srv))

        # the induced grey follower: its append handling (inbound) is
        # delayed; it stays up and acking, just slow
        delay_s = grey_delay_ms / 1e3

        async def on_append(local_id, _remote_id, *_args):
            if str(local_id).split("@")[0] == grey_name:
                await asyncio.sleep(delay_s)

        injection.put(injection.APPEND_ENTRIES, on_append)

        def confirm_totals() -> tuple:
            """(grey group-requests, all group-requests) across servers."""
            grey_n = tot = 0
            for s in cluster.servers:
                rb = s.serving.read_batch
                if rb is None:
                    continue
                for name, n in rb.confirm_sent.items():
                    tot += n
                    if name == grey_name:
                        grey_n += n
            return grey_n, tot

        def steered_now() -> int:
            return sum(s.read_steering.steered for s in cluster.servers)

        def hot_adm_now() -> tuple:
            """(shed, admitted) on the pinned hot server (the rung's shed
            metric is the fraction of intake shed)."""
            a = hot_srv.serving.admission
            return a.shed_total, a.admitted_total

        async def one_op(client_id, gid, is_read, lat, stats) -> None:
            server = hint.get(gid, cluster.servers[0])
            deadline = time.monotonic() + 60.0
            t0 = time.monotonic()
            while True:
                req = RaftClientRequest(
                    client_id, server.peer_id, gid, next(call_ids),
                    Message.value_of(b"GET" if is_read else b"INCREMENT"),
                    type=(read_request_type() if is_read
                          else write_request_type()),
                    timeout_ms=10_000.0)
                try:
                    reply = await client.send_request(
                        server.transport.address, req)
                except (RaftException, asyncio.TimeoutError):
                    reply = None
                if reply is not None and reply.success:
                    lat.append(time.monotonic() - t0)
                    hint[gid] = server
                    return
                if time.monotonic() > deadline:
                    stats["failures"] += 1
                    return
                exc = reply.exception if reply is not None else None
                if isinstance(exc, ResourceUnavailableException):
                    stats["shed_seen"] += 1
                    await asyncio.sleep(max(exc.retry_after_ms, 1) / 1e3)
                elif isinstance(exc, NotLeaderException) \
                        and exc.suggested_leader is not None:
                    server = by_id.get(exc.suggested_leader.id, server)
                else:
                    idx = cluster.servers.index(server)
                    server = cluster.servers[(idx + 1)
                                             % len(cluster.servers)]
                    await asyncio.sleep(0.01)

        async def drive(n_clients: int, pace_s: float) -> dict:
            """One measured fleet pass, open loop: every client fires a
            write+read pair every ``pace_s`` on a fixed schedule, in
            synchronized waves; hot-group write latencies apart."""
            stats = {"shed_seen": 0, "failures": 0}
            hot_lat: list[float] = []
            write_lat: list[float] = []
            read_lat: list[float] = []
            homes = [bisect.bisect_left(cdf, rng.random())
                     for _ in range(n_clients)]

            async def pair(client_id, gid, wlat) -> None:
                await one_op(client_id, gid, False, wlat, stats)
                await one_op(client_id, gid, True, read_lat, stats)

            pairs: list = []
            t0 = time.monotonic()

            async def fleet_client(i: int) -> None:
                client_id = ClientId.random_id()
                rank = min(homes[i], num_groups - 1)
                gid = cluster.groups[rank].group_id
                wlat = hot_lat if rank < hot_pins else write_lat
                for k in range(requests_per_client):
                    at = t0 + pace_s * k
                    delay = at - time.monotonic()
                    if delay > 0:
                        await asyncio.sleep(delay)
                    pairs.append(asyncio.ensure_future(
                        pair(client_id, gid, wlat)))

            await asyncio.gather(*(fleet_client(i)
                                   for i in range(n_clients)))
            await asyncio.gather(*pairs)
            elapsed = time.monotonic() - t0
            hot_lat.sort()
            nh = len(hot_lat)
            return {
                "elapsed": elapsed,
                "writes_ok": nh + len(write_lat),
                "reads_ok": len(read_lat),
                "hot_writes": nh,
                "hot_p99_s": (hot_lat[min(nh - 1, (nh * 99) // 100)]
                              if nh else None),
                **stats,
            }

        ctrls = []
        try:
            # ------------------------------------------- phase OFF
            grey0, tot0 = confirm_totals()
            shed0, adm0 = hot_adm_now()
            off = await drive(clients, pace_s)
            grey1, tot1 = confirm_totals()
            shed1, adm1 = hot_adm_now()
            off_shed, off_adm = shed1 - shed0, adm1 - adm0
            off_grey_frac = ((grey1 - grey0) / max(1, tot1 - tot0))

            # ------------------------------- arm the control loop
            for s in cluster.servers:
                # the armed tuning of run_placement_bench: the delayed
                # peer scores low enough to steer, single-digit-percent
                # groups cross the hot floor, hysteresis 1, a cooldown
                # that outlasts the measured phase
                s.engine.ledger.lag_threshold = 1
                s.engine.ledger.up_window_ms = 8000
                ctrl = PlacementController(
                    s, interval_s=0.4, cooldown_s=60.0, max_per_round=2,
                    hot_share=0.02, grey_score=0.5, hysteresis=1.0,
                    steer_ttl_s=6.0, transfer_timeout_s=3.0)
                ctrl.start()
                s.placement = ctrl
                ctrls.append(ctrl)
            # settle under sustained full-fleet load, one more (bounded)
            # pass while the controllers still actuate
            deadline = time.monotonic() + settle_s
            hard_stop = deadline + 2 * settle_s
            while time.monotonic() < deadline:
                await drive(clients, pace_s)
                if time.monotonic() >= deadline \
                        and time.monotonic() < hard_stop \
                        and any(c.last_plan is not None
                                and c.last_plan.transfers()
                                for c in ctrls):
                    deadline = min(hard_stop,
                                   time.monotonic() + settle_s / 2)

            # freeze the placement for the measured phase: steering stays
            # live, the transfer budget drops to zero
            for c in ctrls:
                c.policy.max_transfers_per_round = 0

            # -------------------------------------------- phase ON
            grey2, tot2 = confirm_totals()
            shed2, adm2 = hot_adm_now()
            steer0 = steered_now()
            on = await drive(clients, pace_s)
            grey3, tot3 = confirm_totals()
            shed3, adm3 = hot_adm_now()
            on_shed, on_adm = shed3 - shed2, adm3 - adm2
            on_grey_sends = grey3 - grey2
            on_grey_frac = on_grey_sends / max(1, tot3 - tot2)
            steered = steered_now() - steer0
            transfers = sum(c.actuator.transfers_ok for c in ctrls)
            plans = sum(c.rounds for c in ctrls)
        finally:
            for c in ctrls:
                await c.close()
            for s in cluster.servers:
                s.placement = None
            injection.remove(injection.APPEND_ENTRIES)

        hot_leads_after = sum(
            1 for g in cluster.groups[:hot_pins]
            if (d := hot_srv.divisions.get(g.group_id)) is not None
            and d.is_leader())
        p99_off = off["hot_p99_s"]
        p99_on = on["hot_p99_s"]
        engine = cluster.servers[0].engine
        return {
            "groups": num_groups, "clients": clients, "zipf_s": zipf_s,
            "transport": cluster.transport, "peers": len(cluster.servers),
            "hot_pins_requested": hot_pins, "hot_pins": pinned,
            "hot_leads_after": hot_leads_after,
            "grey_peer": grey_name, "grey_delay_ms": grey_delay_ms,
            "writes_ok_off": off["writes_ok"], "writes_ok_on": on["writes_ok"],
            "reads_ok_off": off["reads_ok"], "reads_ok_on": on["reads_ok"],
            "failures": off["failures"] + on["failures"],
            "hotspot_p99_before_ms": (p99_off * 1e3 if p99_off else None),
            "hotspot_p99_after_ms": (p99_on * 1e3 if p99_on else None),
            "hotspot_p99_ratio": (p99_on / p99_off
                                  if p99_on and p99_off else None),
            "hot_shed_off": off_shed, "hot_shed_on": on_shed,
            "hot_shed_frac_off": off_shed / max(1, off_shed + off_adm),
            "hot_shed_frac_on": on_shed / max(1, on_shed + on_adm),
            "grey_confirm_frac_off": off_grey_frac,
            "grey_confirm_frac_on": on_grey_frac,
            # of the confirmation group-requests the sweeps would have
            # aimed at the grey peer during ON, the fraction steered away
            "grey_steer_frac": steered / max(1, steered + on_grey_sends),
            "steered_reads": steered,
            "transfers": transfers,
            "plans_computed": plans,
            "election_convergence_s": cluster.bring_up_s,
            "prewarm_s": cluster.prewarm_s,
            "ledger_samples": [s.engine.ledger.samples.count
                               for s in cluster.servers],
            "engine_device": str(engine.device),
        }
    finally:
        if client is not None:
            await client.close()
        await cluster.close()
