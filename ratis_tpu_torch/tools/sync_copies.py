"""Refresh the port's verbatim copies of the JAX package's host modules.

The port imports nothing of ``ratis_tpu``: every host module its slice
runs (server, divisions, log, transports, client, protocol) is a copy whose
only change is the package name.  This script makes those copies, so a fix
to a host module in ``ratis_tpu/`` reaches the port by running it again::

    python -m ratis_tpu_torch.tools.sync_copies          # rewrite copies
    python -m ratis_tpu_torch.tools.sync_copies --check  # exit 1 on drift

It reads ``ratis_tpu/`` as text and imports none of it.  Modules whose
device code the port replaces are in ``CHANGED`` and are never touched.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = ROOT / "ratis_tpu"
DST = ROOT / "ratis_tpu_torch"

# module paths relative to the package root, copied byte for byte apart
# from the package rename
VERBATIM = (
    "chaos/__init__.py", "chaos/faults.py", "chaos/link.py",
    "chaos/scenario.py", "chaos/scenarios.py",
    "client/__init__.py", "client/client.py",
    "conf/__init__.py", "conf/properties.py", "conf/reconfiguration.py",
    "engine/__init__.py", "engine/roles.py", "engine/state.py",
    "metrics/__init__.py", "metrics/registry.py",
    "metrics/server_metrics.py",
    "metrics/prometheus.py", "metrics/timeseries.py", "metrics/flight.py",
    "metrics/aggregate.py",
    "models/__init__.py", "models/arithmetic.py", "models/counter.py",
    "models/filestore.py",
    "ops/__init__.py", "ops/reference.py", "ops/upkeep.py",
    "placement/__init__.py", "placement/actuate.py",
    "placement/controller.py", "placement/policy.py",
    "protocol/__init__.py", "protocol/admin.py", "protocol/exceptions.py",
    "protocol/group.py", "protocol/ids.py", "protocol/logentry.py",
    "protocol/message.py", "protocol/peer.py", "protocol/raftrpc.py",
    "protocol/requests.py", "protocol/routing.py", "protocol/termindex.py",
    "retry/__init__.py", "retry/policies.py",
    "server/__init__.py", "server/admin.py", "server/config.py",
    "server/datastream.py",
    "server/election.py", "server/leader.py",
    "server/messagestream.py", "server/read.py", "server/shards.py",
    "server/state.py", "server/statemachine.py", "server/storage.py",
    "server/upkeep.py", "server/watch.py", "server/watchdog.py",
    "server/log/__init__.py", "server/log/base.py", "server/log/memory.py",
    "server/serving/__init__.py", "server/serving/admission.py",
    "server/serving/readbatch.py",
    "shell/__init__.py", "shell/__main__.py", "shell/cli.py",
    "tools/loadgen.py", "tools/parse_log.py",
    "trace/__init__.py",
    "transport/__init__.py", "transport/base.py",
    "transport/datastream.py", "transport/grpc.py",
    "transport/simulated.py",
    "util/__init__.py", "util/gcdiscipline.py", "util/injection.py",
    "util/lifecycle.py", "util/sliding_window.py", "util/timeduration.py",
)

# copies whose code the port changes (device code, the engine's device
# key, the package docstring, the mesh as slices of one device, the chaos
# harness's engine device and the port's harness properties, the
# durable logs' flush wait, shielded from a cancelled caller, the
# membership console's engine device, a write whose leader stepped
# down during its state machine's transaction answered NotLeader, and
# snapshot installs on the in-memory log staged in each group's state
# machine storage, not in one directory all groups share, the TCP
# server's close, which closes connections accepted while it runs, the
# engine's profiler session on torch.profiler, the retry cache, whose
# entries age from their reply, not from the request (a write pending past
# the expiry was applied twice), and the dev tools pointed
# at the port: the load profiler on its harness and --device, the three
# drift gates on its package, the conf gate also reading the README's
# port section, and the host loops' tracing: server.replicate split into
# its three waits, spans and torch.profiler ranges for the loops' units of
# work, the pause monitor's loop lag, the collector's pauses, the socket
# flushes' counts and the counts in the tracer's snapshot); maintained by
# hand
CHANGED = (
    "__init__.py", "chaos/campaign.py", "chaos/cluster.py", "conf/keys.py",
    "engine/engine.py", "engine/ledger.py",
    "ops/ledger.py", "ops/quorum.py", "parallel/__init__.py",
    "parallel/mesh.py", "server/division.py", "server/log/segmented.py",
    "server/log/shared.py", "server/server.py", "server/snapshot.py",
    "tools/chaos_replay.py", "transport/tcp.py",
    "tools/membership_console.py", "tools/profile_load.py",
    "tools/check_conf_docs.py", "tools/check_hot_loops.py",
    "tools/check_metrics_docs.py", "server/retrycache.py",
    "trace/tracer.py", "trace/export.py", "metrics/hops.py",
    "server/replication.py", "server/pause_monitor.py",
    "transport/coalesce.py",
)

_NAME = re.compile(r"\bratis_tpu\.")


def rewrite(text: str) -> str:
    """The one change a verbatim copy carries: the package name."""
    return _NAME.sub("ratis_tpu_torch.", text)


def drifted() -> list[str]:
    """Verbatim copies that differ from a fresh rewrite of their source."""
    out = []
    for rel in VERBATIM:
        dst = DST / rel
        want = rewrite((SRC / rel).read_text())
        if not dst.exists() or dst.read_text() != want:
            out.append(rel)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="report drifted copies and exit 1; write nothing")
    args = ap.parse_args(argv)
    stale = drifted()
    if args.check:
        for rel in stale:
            print(f"drifted: {rel}")
        return 1 if stale else 0
    for rel in stale:
        dst = DST / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(rewrite((SRC / rel).read_text()))
        print(f"copied: {rel}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
