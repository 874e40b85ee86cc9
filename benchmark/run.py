"""The benchmark of ``ratis_tpu_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the configuration names its deployment kind.  The run starts
the deployment (set-up: the servers, their groups, the clients' initial
writes, the warm-up), measures ``--seconds`` of closed-loop traffic,
checks every answer against the plain reference (``benchmark/reference``)
and prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted`` and ``failed`` (the operations sent in the
window, and those of them without a successful answer), ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``: each number
compared with the reference beside its limit, also printed as the last
lines of standard error.

End-to-end, over the window [start, end):

- ``ops_per_s``: operations acknowledged in the window over its length;
- ``setup_s``: from this process's start to the window's start.

The tails of writes and reads are per-layer metrics
(``benchmark/metrics/write_p95_ms.diag.py``, ``read_p95_ms.diag.py``).

It exits non-zero and prints no result where there is no CUDA device, or
fewer than the cell asks for, or where this process or one it started
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import manifest, tracefile, window  # noqa: E402
from benchmark.clients import foreign_modules  # noqa: E402
from benchmark.reference import check as reference  # noqa: E402

# build and kernel caches of the program and of torch, inside the checkout
# at fixed paths, so a cell's first run in a checkout fills them and the
# later runs find them
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".bench_cache/triton"}


def e2e_metrics(records: dict) -> tuple[dict, int, int]:
    """(metrics, attempted, failed) over the window, from every client
    operation's record."""
    w0, w1 = records["window"]
    ops = window.operations(records)
    acked = [r[3] for r in ops if r[4] and w0 <= r[3] < w1]
    per_s = [0] * max(1, round(w1 - w0))
    for t in acked:
        per_s[min(int(t - w0), len(per_s) - 1)] += 1
    out = {"ops_per_s": len(acked) / (w1 - w0), "acked_each_second": per_s}
    sent = [r for r in ops if w0 <= r[2] < w1]
    return out, len(sent), sum(1 for r in sent if not r[4])


def diagnostics(records: dict, acked_each_second: list) -> dict:
    """What the run's standard error reports besides the checks: set-up's
    steps, the acks of each second, each server's collector pauses of 20
    ms or more in each second, each process's CPU and collector seconds a
    second of the window, and in a traced run each server loop's worst
    lag and CPU seconds in each second."""
    w0, w1 = records["window"]
    span = w1 - w0
    servers, clients = records["servers"], records["clients"]
    gc_each = [[0.0] * len(acked_each_second) for _ in servers]
    for row, s in zip(gc_each, servers):
        for t, took, _ in s["gc_pauses"]:
            if 0 <= t - w0 < span:
                row[int(t - w0)] += took

    def per_s(report, key):
        return (report["window"]["end"][key]
                - report["window"]["start"][key]) / span

    out = {
        "set-up steps, s": records["phases"],
        "operations acknowledged in each second": acked_each_second,
        "each server's collector pauses, s in each second":
            [[round(x, 3) for x in row] for row in gc_each],
        "CPU s a second": {
            "servers": [per_s(s, "cpu_s") for s in servers],
            "servers in the collector": [per_s(s, "gc_s") for s in servers],
            "clients": [c["window_cpu_s"] / span for c in clients],
            "clients in the collector": [c["window_gc_s"] / span
                                         for c in clients]}}
    if all(s.get("loop") for s in servers):
        out["each server's loop, worst lag ms in each second"] = [
            [round(1e3 * x, 1) for x in s["loop"]["worst_lag_s"]]
            for s in servers]
        out["each server's loop, CPU s in each second"] = [
            [round(x, 2) for x in s["loop"]["cpu_s"]] for s in servers]
    return out


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float = T_START,
             config: dict = None, mix: dict = None) -> dict:
    """Run ``cell`` once; returns the result line's object, ``checks``
    last (and the reference's mismatch examples under ``examples``, which
    the line leaves out).  ``config`` and ``mix`` stand in for the cell's
    own files where given (the control, the tests' small sizes)."""
    config = config or manifest.config(cell["config"])
    mix = mix or manifest.traffic(cell["traffic"])
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        records = asyncio.run(manifest.deployment(config["deployment"]).run(
            config, mix, seed, seconds, trace, device, workdir))
        counts = reference.check(config, mix, seed, records["clients"])
        e2e, attempted, failed = e2e_metrics(records)
        e2e["setup_s"] = records["window"][0] - t_start
        units = {m["name"]: m["unit"] for s in ("end_to_end", "per_layer")
                 for m in bench[s]}
        section = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in manifest.metrics_of(bench, cell["name"], section):
            name = m["name"]
            value = (manifest.reader(name).read(records, config) if trace
                     else e2e.get(name))
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        servers = records["servers"]
        dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
               "kind": servers[0].get("device_name", device),
               "count": cell["chips"],
               "memory_peak_bytes": sum(s.get("memory_peak_bytes", 0)
                                        for s in servers)}
        out = {"correct": reference.within_limits(counts),
               "attempted": attempted, "failed": failed,
               "metrics": metrics, "device": dev}
        if trace:
            busy = tracefile.device_busy_s(records)
            dev["busy_s"] = busy if busy is not None else 0.0
            dev["window_s"] = records["window"][1] - records["window"][0]
            out["breakdown"] = tracefile.breakdown(records)
        out["foreign_modules"] = sorted(
            {m for r in servers + records["clients"]
             for m in r["foreign_modules"]})
        out["cuda_in_clients"] = any(c["cuda_initialized"]
                                     for c in records["clients"])
        out["diagnostics"] = diagnostics(records,
                                         e2e.pop("acked_each_second"))
        if trace:
            out["diagnostics"]["traced run's end-to-end numbers"] = e2e
        out["examples"] = counts.pop("examples")
        out["checks"] = {k: {"value": v, "limit": reference.LIMITS[k]}
                         for k, v in counts.items()}
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"

    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   "cuda")
    foreign = sorted(set(out.pop("foreign_modules")) | set(foreign_modules()))
    if foreign or out.pop("cuda_in_clients"):
        print(f"benchmark: modules of JAX or the JAX package loaded, or "
              f"CUDA in a client process: {foreign}", file=sys.stderr)
        return 3
    for kind, examples in out.pop("examples").items():
        for e in examples:
            print(f"mismatch {kind}: {e}", file=sys.stderr)
    for what, value in out.pop("diagnostics").items():
        print(f"{what}: {json.dumps(value)}", file=sys.stderr)
    checks = out.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
