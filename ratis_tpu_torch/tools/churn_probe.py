"""Where the e2e rung's election timeouts fall, and whether the host
stalls then.

    python -m ratis_tpu_torch.tools.churn_probe [--device cuda]
        [--groups 1024]

Runs the steps of ``bench.e2e_rung`` on an ``e2e_cluster`` (3 servers
over localhost TCP: bring-up, the heap seal, one warm-up write and then 8
writes per group at concurrency 128) and, from the seal on, samples:

- the event loop's lag: a task that sleeps 10 ms and records how late it
  woke (every lag above 0.1 s, and every 20th sample);
- the collector's passes longer than 50 ms (time, generation, seconds);
- the election timeouts fired so far (``Cluster.election_timeouts``);
- for each election timeout a follower takes: when, and how long since
  it last heard from its leader (``_last_heard_leader_s``).

An election timeout fires after 1-2 s without a heartbeat (the headline's
timeouts), so timeouts beside a loop lag far below 1 s are not host
stalls, and one taken less than 1 s after hearing the leader was fired
by a deadline older than that contact.  Prints one JSON line: the seal's
seconds, timeouts in bring-up, warm-up and measured writes, each window's
end, the lags above 0.1 s, the largest lag, the long collector passes,
the timeouts taken (seconds, seconds since heard) and a timeline of
(seconds, lag, timeouts) samples.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import time

from ratis_tpu_torch.server.division import Division
from ratis_tpu_torch.tools import bench


async def probe(cluster) -> dict:
    t0 = [time.monotonic()]
    samples: list[tuple] = []
    passes: list[tuple] = []
    started = [0.0]
    done = asyncio.Event()
    taken: list[tuple] = []
    on_timeout = Division.on_election_timeout

    async def traced_timeout(div):
        em = div.election_metrics.timeout_count
        before = em.count
        now_s = asyncio.get_running_loop().time()
        heard = now_s - div._last_heard_leader_s
        await on_timeout(div)
        if em.count > before:
            taken.append((time.monotonic() - t0[0], heard))

    def on_gc(phase, info):
        now = time.monotonic()
        if phase == "start":
            started[0] = now
        elif now - started[0] > 0.05:
            passes.append((now - t0[0], info["generation"],
                           now - started[0]))

    async def sampler():
        n = 0
        while not done.is_set():
            t = time.monotonic()
            await asyncio.sleep(0.01)
            lag = time.monotonic() - t - 0.01
            n += 1
            if lag > 0.1 or n % 20 == 0:
                samples.append((time.monotonic() - t0[0], lag,
                                cluster.election_timeouts()))

    gc.disable()
    try:
        await cluster.start(timeout=600)
        seal_s = cluster.servers[0].seal_heap()
        gc.enable()
        gc.callbacks.append(on_gc)
        Division.on_election_timeout = traced_timeout
        t0[0] = time.monotonic()
        task = asyncio.ensure_future(sampler())
        timeouts = [cluster.election_timeouts()]
        ends = []
        for writes in (bench.WARMUP_WRITES, 8):
            await cluster.write_all(writes, bench.CONCURRENCY)
            timeouts.append(cluster.election_timeouts())
            ends.append(time.monotonic() - t0[0])
        done.set()
        await task
    finally:
        Division.on_election_timeout = on_timeout
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)
        gc.enable()
        await cluster.close()
    return {"seal_s": seal_s, "bring_up_s": cluster.bring_up_s,
            "election_timeouts": [timeouts[0], timeouts[1] - timeouts[0],
                                  timeouts[2] - timeouts[1]],
            "warmup_end_s": ends[0], "writes_end_s": ends[1],
            "lags_over_100ms": [s[:2] for s in samples if s[1] > 0.1],
            "max_lag_s": max((s[1] for s in samples), default=None),
            "gc_over_50ms": passes, "timeouts_taken": taken,
            "timeline": samples}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu")
    ap.add_argument("--groups", type=int, default=1024)
    args = ap.parse_args(argv)
    res = asyncio.run(probe(bench.e2e_cluster(args.device, args.groups)))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
