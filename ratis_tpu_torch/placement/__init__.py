"""Placement subsystem: telemetry-driven rebalancing that closes the
control loop (reference analog: TiKV's Placement Driver pattern over
exactly this multi-raft shape — telemetry-scored leadership transfers
and read steering on a host carrying many groups).

Three pieces share one plan engine:

- :mod:`ratis_tpu_torch.placement.policy` — the pure scoring pass: a cluster
  snapshot (leadership counts, shed, per-peer health scores, laggards,
  hot groups) in, a typed explainable :class:`PlacementPlan` out.
- :mod:`ratis_tpu_torch.placement.actuate` — rate-limited execution through
  the existing admin transfer path plus the readIndex steering hook,
  every actuation journaled as a paired watchdog rebalance event.
- :mod:`ratis_tpu_torch.placement.controller` — the opt-in in-server policy
  loop (``raft.tpu.placement.enabled``; unset = nothing is created)
  with its ``placement_plane`` metric registry and ``GET /placement``.

The ``shell rebalance`` subcommand (ratis_tpu_torch.shell.cli) is the second
frontend: it builds the same snapshot from scraped endpoints and prints
the same plan the loop executes, with reasons.
"""

from ratis_tpu_torch.placement.policy import (ClusterSnapshot,  # noqa: F401
                                        PlacementPlan, PlacementPolicy,
                                        RepinShard, ServerView,
                                        SteerReads, TransferLeadership,
                                        view_from_payloads)
from ratis_tpu_torch.placement.actuate import PlacementActuator  # noqa: F401
from ratis_tpu_torch.placement.controller import (  # noqa: F401
    PlacementController)
