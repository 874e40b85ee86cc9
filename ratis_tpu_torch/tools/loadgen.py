"""FileStore load generator (reference ratis-examples filestore cli
LoadGen.java + ratis-examples/README.md:56-66): drives N clients writing
numFiles files of a given size — over the DataStream path or as plain log
writes — and reports aggregate throughput + latency percentiles.

Usage:
  python -m ratis_tpu_torch.tools.loadgen -peers s0=h:p,s1=h:p,s2=h:p \
      [-groupid UUID] [-numFiles 64] [-size 1048576] [-numClients 4]
      [--log-path]   # bypass DataStream, send file bytes through the log
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time
from typing import List

import msgpack

from ratis_tpu_torch.shell.cli import _new_client, parse_peers


async def _run_client(client_no: int, peers, group_id, num_files: int,
                      size: int, use_log_path: bool,
                      latencies: List[float]) -> int:
    payload = bytes((client_no + i) % 256 for i in range(size))
    errors = 0
    async with _new_client(peers, group_id) as client:
        for i in range(num_files):
            path = f"loadgen/c{client_no}/f{i}.bin"
            t0 = time.perf_counter()
            try:
                if use_log_path:
                    reply = await client.io().send(msgpack.packb(
                        {"op": "write", "path": path, "data": payload},
                        use_bin_type=True))
                else:
                    out = await client.data_stream().stream(msgpack.packb(
                        {"op": "stream", "path": path}, use_bin_type=True))
                    for off in range(0, size, 1 << 20):
                        await out.write_async(payload[off:off + (1 << 20)])
                    reply = await out.close_async()
                if not reply.success:
                    errors += 1
            except Exception as e:
                print(f"client {client_no} file {i}: {e}", file=sys.stderr)
                errors += 1
            else:
                latencies.append(time.perf_counter() - t0)
    return errors


async def run(args) -> int:
    peers = parse_peers(args.peers)
    group_id = None
    if args.groupid:
        from ratis_tpu_torch.protocol.ids import RaftGroupId
        group_id = RaftGroupId.value_of(args.groupid)
    else:
        from ratis_tpu_torch.shell.cli import _resolve_group
        peers, group_id = await _resolve_group(args)

    latencies: List[float] = []
    t0 = time.perf_counter()
    errors = sum(await asyncio.gather(*(
        _run_client(c, peers, group_id, args.numFiles, args.size,
                    args.log_path, latencies)
        for c in range(args.numClients))))
    elapsed = time.perf_counter() - t0

    total_files = args.numClients * args.numFiles
    ok = total_files - errors
    total_bytes = ok * args.size
    latencies.sort()

    def pct(q: float) -> float:
        return latencies[min(len(latencies) - 1, int(q * len(latencies)))] \
            if latencies else 0.0

    print(f"files: {ok}/{total_files} ok, {errors} errors")
    print(f"elapsed: {elapsed:.3f}s  "
          f"throughput: {total_bytes / max(elapsed, 1e-9) / (1 << 20):.2f} "
          f"MiB/s  ({ok / max(elapsed, 1e-9):.1f} files/s)")
    print(f"latency p50={pct(0.5) * 1000:.1f}ms  "
          f"p99={pct(0.99) * 1000:.1f}ms  "
          f"max={(latencies[-1] if latencies else 0) * 1000:.1f}ms")
    return 1 if errors else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-peers", required=True)
    p.add_argument("-groupid", default=None)
    p.add_argument("-numFiles", type=int, default=64)
    p.add_argument("-size", type=int, default=1 << 20)
    p.add_argument("-numClients", type=int, default=4)
    p.add_argument("--log-path", action="store_true",
                   help="send bytes through the raft log instead of "
                        "the DataStream path")
    return asyncio.run(run(p.parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
