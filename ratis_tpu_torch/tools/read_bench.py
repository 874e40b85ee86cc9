"""The read rungs on the port: the JAX bench's ``child_readmix``
(``run_read_write_bench``) and ``child_zipf`` (``run_zipf_fleet_bench``,
``ratis_tpu/tools/bench_cluster.py``).

    python -m ratis_tpu_torch.tools.bench --rungs readmix
    python -m ratis_tpu_torch.tools.bench --rungs zipf

Both run on the port's ``Cluster`` (``tools/cluster.py``): ``servers``
servers x ``groups`` groups over localhost TCP, the batched deployment,
``CounterStateMachine``, linearizable reads (``raft.server.read.option``)
with the leader lease on.

- ``readmix``: each group has one sequential client; every write is
  chased by three reads, one per read path the server has: a
  linearizable read at the leader (served from the lease while it holds,
  else through a readIndex confirmation sweep), a linearizable read at a
  follower (it asks the leader for a readIndex and waits for its own
  apply) and a stale read at a follower (local state, no protocol).
  The follower reads go to the first server that is not the group's
  leader, as the reference's traffic does.
- ``zipf``: ``clients`` logical clients whose home groups follow a
  zipf(s) law over the groups (group 0 the hottest), each sending one
  write and then one linearizable read to its home, with admission
  control on at a pending-element limit below the offered concurrency
  (typed ``ResourceUnavailableException`` sheds; clients honour the
  retry-after hint) and the telemetry sampler at 250 ms; an unsaturated
  phase first (``unsat_clients`` at low concurrency), then the fleet.

The result keys are the JAX loads', and their failure bounds raise as
there.  The JAX loads check no read value; these do, for every read
served (``ReadChecks``): a linearizable read must return a counter no
lower than the group's writes acknowledged before the read was sent and
no higher than its writes sent before the reply came back (with
``readmix``'s one sequential client per group no write is in flight
while a read is out, so both counts are the ones taken when the read was
sent); a stale read at most the writes sent.  After the load every
group's counter on every replica (``Cluster.read_counters``) must equal
its acknowledged writes, or lie between acknowledged and sent where a
write failed.  ``read_mismatches`` and ``replica_mismatches`` count the
reads and replicas that broke these; both must be 0.

Where the harnesses differ (``PERF.md`` section 4): the port elects its
leaders (the JAX bench appoints them); the first server a request goes
to is the group's elected leader (``hint``, the JAX bench's
``_leader_hint``); a request's retries keep its call id (the JAX
harness draws a new one per attempt), so the server's retry cache makes
each logical write apply at most once and the sent count is exact.
"""

from __future__ import annotations

import asyncio
import bisect
import itertools
import random
import time

from ratis_tpu_torch.conf import RaftServerConfigKeys

# child_readmix: run_read_write_bench(1024, 4, concurrency=128,
# transport="tcp"), 3 reads a write
READMIX = {"groups": 1024, "servers": 3, "writes": 4, "reads_per_write": 3,
           "concurrency": 128}
# child_zipf: run_zipf_fleet_bench(1024, clients=10240, concurrency=512,
# transport="tcp") with its defaults
ZIPF = {"groups": 1024, "servers": 3, "clients": 10_240,
        "requests_per_client": 1, "zipf_s": 1.1, "concurrency": 512,
        "seed": 11, "element_limit": 192, "unsat_clients": 256}
# the three read paths of readmix, in the order each write's reads go
READ_KINDS = ("lease_leader", "follower_lin", "stale")


def read_properties(groups: int, servers: int, device: str,
                    zipf: bool = False, element_limit: int = 192):
    """The cluster's batched properties over TCP with the read loads'
    extra keys: linearizable reads with the leader lease; for ``zipf``
    also telemetry every 250 ms and admission control at
    ``element_limit`` pending elements, retry-after 40 ms."""
    from ratis_tpu_torch.tools.cluster import cluster_properties
    p = cluster_properties(groups, servers, device, "tcp")
    extra = {RaftServerConfigKeys.Read.OPTION_KEY: "LINEARIZABLE",
             RaftServerConfigKeys.Read.LEADER_LEASE_ENABLED_KEY: "true"}
    if zipf:
        keys = RaftServerConfigKeys.Serving
        extra.update({
            RaftServerConfigKeys.Telemetry.ENABLED_KEY: "true",
            RaftServerConfigKeys.Telemetry.INTERVAL_KEY: "250ms",
            keys.ADMISSION_ENABLED_KEY: "true",
            keys.PENDING_ELEMENT_LIMIT_KEY: str(element_limit),
            keys.RETRY_AFTER_KEY: "40ms"})
    for k, v in extra.items():
        p.set(k, v)
    return p


def read_cluster(device="cuda", groups: int = READMIX["groups"],
                 servers: int = READMIX["servers"], zipf: bool = False,
                 element_limit: int = ZIPF["element_limit"]):
    """A read rung's cluster over TCP, prewarmed, not yet started."""
    from ratis_tpu_torch.tools.bench import _device
    from ratis_tpu_torch.tools.cluster import Cluster
    dev = str(_device(device))
    cluster = Cluster(groups, servers, device=dev, transport="tcp",
                      properties=read_properties(groups, servers, dev, zipf,
                                                 element_limit))
    cluster.prewarm()
    return cluster


def zipf_cdf(num_groups: int, zipf_s: float) -> tuple[list, float]:
    """The zipf CDF over group ranks (rank r weighs (r + 1)^-s) and the
    top group's share, as ``run_zipf_fleet_bench`` builds them."""
    weights = [(r + 1) ** -zipf_s for r in range(num_groups)]
    total_w = sum(weights)
    cdf, acc = [], 0.0
    for w in weights:
        acc += w
        cdf.append(acc / total_w)
    return cdf, weights[0] / total_w


def _p99(sorted_lat: list) -> float:
    n = len(sorted_lat)
    return sorted_lat[min(n - 1, (n * 99) // 100)]


class ReadChecks:
    """Per group, the writes sent and acknowledged so far, and every read
    value held to them (the plain reference of a counter under
    linearizable and stale reads)."""

    def __init__(self):
        self.sent: dict = {}
        self.acked: dict = {}
        self.reads = 0
        self.mismatches: list = []

    def write_sent(self, gid) -> None:
        self.sent[gid] = self.sent.get(gid, 0) + 1

    def write_acked(self, gid) -> None:
        self.acked[gid] = self.acked.get(gid, 0) + 1

    def before_read(self, gid) -> int:
        """The acknowledged count when a read is sent (its lower bound)."""
        return self.acked.get(gid, 0)

    def read(self, gid, kind: str, value: int, acked_before: int) -> None:
        """A read of ``kind`` served ``value``: a linearizable one must lie
        in [acked before it was sent, sent now], a stale one at most sent
        now."""
        self.reads += 1
        hi = self.sent.get(gid, 0)
        lo = 0 if kind == "stale" else acked_before
        if not lo <= value <= hi:
            self.mismatches.append((str(gid), kind, value, lo, hi))

    def replicas(self, counters: dict) -> list:
        """The (group, counters) whose replicas do not all hold a value in
        [acknowledged, sent] (equal to acknowledged when nothing failed)."""
        bad = []
        for gid, vals in counters.items():
            lo, hi = self.acked.get(gid, 0), self.sent.get(gid, 0)
            if any(not lo <= v <= hi for v in vals):
                bad.append((str(gid), vals, lo, hi))
        return bad


async def _replica_check(cluster, checks: ReadChecks) -> tuple[int, list]:
    """Every group's counter from every replica (stale reads at the last
    acknowledged index), held to ``checks``: (replicas read, mismatches)."""
    counters = await cluster.read_counters(timeout=300)
    return len(counters) * len(cluster.servers), checks.replicas(counters)


class _Requests:
    """Client requests with the JAX harness's leader-hint failover: one
    client transport, a hint per group (its elected leader at first), a
    call id per logical request kept across its retries."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.client = cluster.factory.new_client_transport(
            cluster.properties)
        self.call_ids = itertools.count(1)
        self.by_id = {s.peer_id: s for s in cluster.servers}
        self.hint = {g.group_id: cluster.leader_of(g) or cluster.servers[0]
                     for g in cluster.groups}

    def request(self, client_id, server, gid, call_id: int, rtype,
                content: bytes, timeout_ms: float):
        from ratis_tpu_torch.protocol.message import Message
        from ratis_tpu_torch.protocol.requests import RaftClientRequest
        return RaftClientRequest(client_id, server.peer_id, gid, call_id,
                                 Message.value_of(content), type=rtype,
                                 timeout_ms=timeout_ms)

    async def send(self, server, req):
        from ratis_tpu_torch.protocol.exceptions import RaftException
        try:
            return await self.client.send_request(server.transport.address,
                                                  req)
        except (RaftException, asyncio.TimeoutError):
            return None

    async def failover(self, server, reply):
        """Where a failed attempt goes next: the suggested leader at once,
        else the next server after 10 ms."""
        from ratis_tpu_torch.protocol.exceptions import NotLeaderException
        exc = reply.exception if reply is not None else None
        if isinstance(exc, NotLeaderException) \
                and exc.suggested_leader is not None:
            return self.by_id.get(exc.suggested_leader.id, server)
        servers = self.cluster.servers
        await asyncio.sleep(0.01)
        return servers[(servers.index(server) + 1) % len(servers)]

    async def write(self, client_id, gid, timeout: float = 60.0):
        """One INCREMENT with failover (the JAX harness's ``_write``):
        the successful reply, or TimeoutError after ``timeout`` s."""
        from ratis_tpu_torch.protocol.exceptions import \
            LeaderNotReadyException
        from ratis_tpu_torch.protocol.requests import write_request_type
        server = self.hint.get(gid, self.cluster.servers[0])
        deadline = time.monotonic() + timeout
        call_id = next(self.call_ids)
        while True:
            reply = await self.send(server, self.request(
                client_id, server, gid, call_id, write_request_type(),
                b"INCREMENT", 10_000.0))
            if reply is not None and reply.success:
                self.hint[gid] = server
                return reply
            if time.monotonic() > deadline:
                raise TimeoutError(f"write to {gid} kept failing")
            if isinstance(reply.exception if reply is not None else None,
                          LeaderNotReadyException):
                await asyncio.sleep(0.01)
            else:
                server = await self.failover(server, reply)

    async def close(self) -> None:
        await self.client.close()


async def readmix_rung(cluster, writes: int = READMIX["writes"],
                       reads_per_write: int = READMIX["reads_per_write"],
                       concurrency: int = READMIX["concurrency"]) -> dict:
    """``run_read_write_bench`` on a ``read_cluster``: bring it up, each
    group's sequential client writes ``writes`` times, each write chased
    by ``reads_per_write`` reads (lease read at the leader, linearizable
    and stale reads at a follower), every read value and, after the load,
    every replica's counter checked; close it."""
    from ratis_tpu_torch.protocol.ids import ClientId
    from ratis_tpu_torch.protocol.requests import (read_request_type,
                                                   stale_read_request_type)
    from ratis_tpu_torch.tools.cluster import bring_up_wave, sealed

    num_groups = cluster.num_groups
    reqs = None
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        reqs = _Requests(cluster)
        checks = ReadChecks()
        sem = asyncio.Semaphore(concurrency)
        write_lat: list[float] = []
        read_lat: list[float] = []
        counts = {k: 0 for k in READ_KINDS}
        counts["read_failures"] = 0
        served = {str(s.peer_id): 0 for s in cluster.servers}
        failures: list[str] = []

        async def one_read(client_id, gid, kind: str) -> None:
            leader = reqs.hint.get(gid, cluster.servers[0])
            if kind == "lease_leader":
                server, rtype = leader, read_request_type()
            else:
                others = [s for s in cluster.servers if s is not leader]
                server = others[0] if others else leader
                rtype = (read_request_type() if kind == "follower_lin"
                         else stale_read_request_type(0))
            lo = checks.before_read(gid)
            t0 = time.monotonic()
            reply = await reqs.send(server, reqs.request(
                client_id, server, gid, next(reqs.call_ids), rtype, b"GET",
                15_000.0))
            if reply is not None and reply.success:
                read_lat.append(time.monotonic() - t0)
                counts[kind] += 1
                served[str(server.peer_id)] += 1
                checks.read(gid, kind, int(reply.message.content), lo)
            else:
                counts["read_failures"] += 1

        async def group_load(g) -> None:
            client_id = ClientId.random_id()
            gid = g.group_id
            for _ in range(writes):
                async with sem:
                    t0 = time.monotonic()
                    checks.write_sent(gid)
                    try:
                        reply = await reqs.write(client_id, gid)
                    except TimeoutError:
                        failures.append(str(gid))
                        continue
                    write_lat.append(time.monotonic() - t0)
                    checks.write_acked(gid)
                    cluster.last_index[gid] = reply.log_index
                for kind in READ_KINDS[:reads_per_write]:
                    async with sem:
                        await one_read(client_id, gid, kind)

        sweeps0 = _sweeps(cluster)
        t_start = time.monotonic()
        await asyncio.gather(*(group_load(g) for g in cluster.groups))
        elapsed = time.monotonic() - t_start
        sweeps = {k: [a - b for a, b in zip(v, sweeps0[k])]
                  for k, v in _sweeps(cluster).items()}
        total_w = num_groups * writes
        if not write_lat or len(failures) > max(8, total_w // 100):
            raise TimeoutError(f"{len(failures)}/{total_w} writes failed")
        reads_ok = len(read_lat)
        if counts["read_failures"] > max(8, (reads_ok or 1) // 20):
            raise TimeoutError(
                f"{counts['read_failures']} reads failed "
                f"(vs {reads_ok} ok) — the read paths are broken")
        replicas, replica_bad = await _replica_check(cluster, checks)
        write_lat.sort()
        read_lat.sort()
        nw, nr = len(write_lat), len(read_lat)
        return {
            "commits": total_w - len(failures),
            "write_failures": len(failures),
            "elapsed_s": elapsed,
            "commits_per_sec": (total_w - len(failures)) / elapsed,
            "reads_per_sec": reads_ok / elapsed,
            "reads_ok": reads_ok,
            "read_failures": counts["read_failures"],
            "reads_lease_leader": counts["lease_leader"],
            "reads_follower_linearizable": counts["follower_lin"],
            "reads_stale": counts["stale"],
            "p50_ms": write_lat[nw // 2] * 1e3,
            "p99_ms": _p99(write_lat) * 1e3,
            "read_p50_ms": read_lat[nr // 2] * 1e3 if nr else None,
            "read_p99_ms": _p99(read_lat) * 1e3 if nr else None,
            "election_convergence_s": cluster.bring_up_s,
            "groups": num_groups,
            "mode": "batched",
            "transport": cluster.transport,
            "peers": len(cluster.servers),
            # the port's read-value checks
            "reads_checked": checks.reads,
            "read_mismatches": len(checks.mismatches),
            "read_mismatch_examples": checks.mismatches[:8],
            "replicas_read_back": replicas,
            "replica_mismatches": len(replica_bad),
            "replica_mismatch_examples": replica_bad[:8],
            # per server: reads served there, and the readIndex
            # confirmation sweeps it fired and the reads they confirmed
            # (a lease read that found its lease valid takes neither)
            "reads_served": served,
            "confirm_sweeps": sweeps["sweeps"],
            "confirmed_reads": sweeps["confirmed"],
            "prewarm_s": cluster.prewarm_s,
            "ledger_samples": [s.engine.ledger.samples.count
                               for s in cluster.servers],
            "engine_device": str(cluster.servers[0].engine.device)}
    finally:
        if reqs is not None:
            await reqs.close()
        await cluster.close()


def _sweeps(cluster) -> dict:
    """Per server, the readIndex confirmation sweeps fired and the reads
    they confirmed so far (``server/serving/readbatch.py``)."""
    out = {"sweeps": [], "confirmed": []}
    for s in cluster.servers:
        rb = s.serving.read_batch
        out["sweeps"].append(rb.sweeps if rb is not None else 0)
        out["confirmed"].append(rb.confirmed if rb is not None else 0)
    return out


async def zipf_rung(cluster, clients: int = ZIPF["clients"],
                    requests_per_client: int = ZIPF["requests_per_client"],
                    zipf_s: float = ZIPF["zipf_s"],
                    concurrency: int = ZIPF["concurrency"],
                    seed: int = ZIPF["seed"],
                    element_limit: int = ZIPF["element_limit"],
                    unsat_clients: int = ZIPF["unsat_clients"]) -> dict:
    """``run_zipf_fleet_bench`` on a ``read_cluster(zipf=True)``: bring it
    up, the unsaturated phase, then the fleet; every read value and, after
    the fleet, every replica's counter checked; close it."""
    from ratis_tpu_torch.metrics.aggregate import merge_hotgroups
    from ratis_tpu_torch.protocol.exceptions import \
        ResourceUnavailableException
    from ratis_tpu_torch.protocol.ids import ClientId
    from ratis_tpu_torch.protocol.requests import (read_request_type,
                                                   write_request_type)
    from ratis_tpu_torch.tools.cluster import bring_up_wave, sealed

    num_groups = cluster.num_groups
    rng = random.Random(seed)
    cdf, expected_top_share = zipf_cdf(num_groups, zipf_s)
    reqs = None
    try:
        await sealed(cluster, cluster.start(wave=bring_up_wave(cluster),
                                            timeout=600))
        reqs = _Requests(cluster)
        checks = ReadChecks()

        def shed_now() -> int:
            return sum(s.serving.admission.shed_total
                       for s in cluster.servers)

        def admitted_now() -> int:
            return sum(s.serving.admission.admitted_total
                       for s in cluster.servers)

        def pending_now() -> int:
            return max(sum(s.serving.admission.pending_count)
                       for s in cluster.servers)

        async def one_op(client_id, gid, is_read, lat, stats) -> None:
            server = reqs.hint.get(gid, cluster.servers[0])
            deadline = time.monotonic() + 60.0
            call_id = next(reqs.call_ids)
            if is_read:
                lo = checks.before_read(gid)
            else:
                checks.write_sent(gid)
            t0 = time.monotonic()
            while True:
                reply = await reqs.send(server, reqs.request(
                    client_id, server, gid, call_id,
                    read_request_type() if is_read else write_request_type(),
                    b"GET" if is_read else b"INCREMENT", 10_000.0))
                if reply is not None and reply.success:
                    lat.append(time.monotonic() - t0)
                    reqs.hint[gid] = server
                    if is_read:
                        checks.read(gid, "linearizable",
                                    int(reply.message.content), lo)
                    else:
                        checks.write_acked(gid)
                        cluster.last_index[gid] = max(
                            cluster.last_index.get(gid, 0), reply.log_index)
                    return
                if time.monotonic() > deadline:
                    stats["failures"] += 1
                    return
                exc = reply.exception if reply is not None else None
                if isinstance(exc, ResourceUnavailableException):
                    # the typed overload reply: honour the retry-after hint
                    stats["shed_seen"] += 1
                    await asyncio.sleep(max(exc.retry_after_ms, 1) / 1e3)
                    continue
                server = await reqs.failover(server, reply)

        async def drive(n_clients: int, conc: int) -> dict:
            sem = asyncio.Semaphore(conc)
            stats = {"shed_seen": 0, "failures": 0, "pending_peak": 0}
            write_lat: list[float] = []
            read_lat: list[float] = []
            homes = [bisect.bisect_left(cdf, rng.random())
                     for _ in range(n_clients)]

            async def fleet_client(i: int) -> None:
                client_id = ClientId.random_id()
                gid = cluster.groups[min(homes[i], num_groups - 1)].group_id
                for _ in range(requests_per_client):
                    async with sem:
                        await one_op(client_id, gid, False, write_lat, stats)
                    async with sem:
                        await one_op(client_id, gid, True, read_lat, stats)

            async def sample_pending() -> None:
                while True:
                    stats["pending_peak"] = max(stats["pending_peak"],
                                                pending_now())
                    await asyncio.sleep(0.025)

            sampler = asyncio.ensure_future(sample_pending())
            t0 = time.monotonic()
            try:
                await asyncio.gather(*(fleet_client(i)
                                       for i in range(n_clients)))
            finally:
                sampler.cancel()
            elapsed = time.monotonic() - t0
            write_lat.sort()
            read_lat.sort()
            nw, nr = len(write_lat), len(read_lat)
            return {
                "elapsed": elapsed, "writes_ok": nw, "reads_ok": nr,
                "p99_s": _p99(write_lat) if nw else None,
                "read_p99_s": _p99(read_lat) if nr else None,
                "homes": homes, **stats,
            }

        # phase 1: the unsaturated baseline, a small fleet well under the
        # pending budget (the denominator of the overload p99 ratio)
        unsat = await drive(unsat_clients, max(8, element_limit // 8))
        # phase 2: the fleet, offered concurrency above the budget
        shed0, adm0 = shed_now(), admitted_now()
        sweeps0 = _sweeps(cluster)
        fleet = await drive(clients, concurrency)
        shed = shed_now() - shed0
        admitted = admitted_now() - adm0
        sweeps_by = {k: [a - b for a, b in zip(v, sweeps0[k])]
                     for k, v in _sweeps(cluster).items()}
        sweeps = sum(sweeps_by["sweeps"])

        total_ops = clients * requests_per_client * 2
        if fleet["failures"] > max(16, total_ops // 50):
            raise TimeoutError(
                f"{fleet['failures']}/{total_ops} fleet ops failed outright "
                f"— shedding must surface typed replies, not timeouts")
        replicas, replica_bad = await _replica_check(cluster, checks)

        tel = [s.telemetry for s in cluster.servers
               if s.telemetry is not None]
        hot = merge_hotgroups([t.hotgroups_info() for t in tel], n=4) \
            if tel else {"groups": []}
        top = hot["groups"][0] if hot["groups"] else None
        p99_unsat = unsat["p99_s"]
        p99_fleet = fleet["p99_s"]
        home_counts = [0] * num_groups
        for h in unsat["homes"] + fleet["homes"]:
            home_counts[min(h, num_groups - 1)] += 1
        return {
            "clients": clients,
            "groups": num_groups,
            "zipf_s": zipf_s,
            "writes_ok": fleet["writes_ok"],
            "reads_ok": fleet["reads_ok"],
            "failures": fleet["failures"],
            "elapsed_s": fleet["elapsed"],
            "writes_per_sec": fleet["writes_ok"] / fleet["elapsed"],
            "reads_per_sec": fleet["reads_ok"] / fleet["elapsed"],
            "shed": shed,
            "admitted": admitted,
            "shed_frac": shed / max(1, shed + admitted),
            "shed_seen_by_clients": fleet["shed_seen"],
            "p99_ms": p99_fleet * 1e3 if p99_fleet else None,
            "read_p99_ms": (fleet["read_p99_s"] * 1e3
                            if fleet["read_p99_s"] else None),
            "p99_unsat_ms": p99_unsat * 1e3 if p99_unsat else None,
            "overload_p99_ratio": (p99_fleet / p99_unsat
                                   if p99_fleet and p99_unsat else None),
            "pending_peak": fleet["pending_peak"],
            "pending_limit": element_limit,
            "confirm_sweeps_per_read": sweeps / max(1, fleet["reads_ok"]),
            "hot_share": top["share_min"] if top else 0.0,
            "hot_group": top["group"] if top else None,
            "hot_group_expected": str(cluster.groups[0].group_id),
            "expected_top_share": expected_top_share,
            "election_convergence_s": cluster.bring_up_s,
            "mode": "batched",
            "transport": cluster.transport,
            "peers": len(cluster.servers),
            # the unsaturated phase's own counts
            "unsat_clients": unsat_clients,
            "unsat_writes_ok": unsat["writes_ok"],
            "unsat_reads_ok": unsat["reads_ok"],
            "unsat_failures": unsat["failures"],
            # clients per group rank over both phases (the seeded homes)
            "home_counts": home_counts,
            # the port's read-value checks, both phases
            "reads_checked": checks.reads,
            "read_mismatches": len(checks.mismatches),
            "read_mismatch_examples": checks.mismatches[:8],
            "replicas_read_back": replicas,
            "replica_mismatches": len(replica_bad),
            "replica_mismatch_examples": replica_bad[:8],
            "confirm_sweeps": sweeps_by["sweeps"],
            "confirmed_reads": sweeps_by["confirmed"],
            "prewarm_s": cluster.prewarm_s,
            "ledger_samples": [s.engine.ledger.samples.count
                               for s in cluster.servers],
            "engine_device": str(cluster.servers[0].engine.device)}
    finally:
        if reqs is not None:
            await reqs.close()
        await cluster.close()
