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
    "metrics/__init__.py", "metrics/hops.py", "metrics/registry.py",
    "metrics/server_metrics.py",
    "models/__init__.py", "models/arithmetic.py", "models/counter.py",
    "ops/__init__.py", "ops/reference.py", "ops/upkeep.py",
    "protocol/__init__.py", "protocol/admin.py", "protocol/exceptions.py",
    "protocol/group.py", "protocol/ids.py", "protocol/logentry.py",
    "protocol/message.py", "protocol/peer.py", "protocol/raftrpc.py",
    "protocol/requests.py", "protocol/routing.py", "protocol/termindex.py",
    "retry/__init__.py", "retry/policies.py",
    "server/__init__.py", "server/admin.py", "server/config.py",
    "server/datastream.py",
    "server/division.py", "server/election.py", "server/leader.py",
    "server/messagestream.py", "server/pause_monitor.py", "server/read.py",
    "server/replication.py", "server/retrycache.py", "server/shards.py",
    "server/snapshot.py",
    "server/state.py", "server/statemachine.py", "server/storage.py",
    "server/watch.py", "server/watchdog.py",
    "server/log/__init__.py", "server/log/base.py", "server/log/memory.py",
    "server/log/segmented.py", "server/log/shared.py",
    "server/serving/__init__.py", "server/serving/admission.py",
    "server/serving/readbatch.py",
    "trace/__init__.py", "trace/tracer.py",
    "transport/__init__.py", "transport/base.py", "transport/coalesce.py",
    "transport/datastream.py", "transport/simulated.py", "transport/tcp.py",
    "util/__init__.py", "util/gcdiscipline.py", "util/injection.py",
    "util/lifecycle.py", "util/sliding_window.py", "util/timeduration.py",
)

# copies whose code the port changes (device code, the engine's device
# key, the package docstring, the mesh as slices of one device); maintained
# by hand
CHANGED = (
    "__init__.py", "conf/keys.py", "engine/engine.py", "engine/ledger.py",
    "ops/ledger.py", "ops/quorum.py", "parallel/__init__.py",
    "parallel/mesh.py", "server/server.py",
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
