"""Chaos campaign subsystem: deterministic, seed-replayable fault
scenarios as a standing correctness gate.

The observability plane (watchdog + ``/events``) can *see* failures; this
package *causes* them, on purpose and reproducibly:

- :mod:`ratis_tpu_torch.chaos.link` — the transport link-fault shim: directed
  partitions, per-link latency/jitter/drop, consulted by the simulated,
  TCP, and gRPC transports when ``raft.tpu.chaos.enabled`` is set;
- :mod:`ratis_tpu_torch.chaos.faults` — the typed fault-step vocabulary shared
  by scenarios, the runner, and replay artifacts;
- :mod:`ratis_tpu_torch.chaos.cluster` — an in-process multi-group cluster
  harness with kill/restart (and tail log truncation on restart);
- :mod:`ratis_tpu_torch.chaos.scenario` — the scenario runner: executes a
  seed-deterministic fault schedule under write load, journals every
  injected fault and its observed recovery through the watchdog
  ``/events`` plane, and asserts the recovery SLOs (re-election
  convergence bound, zero lost acks, exactly-once apply, catch-up);
- :mod:`ratis_tpu_torch.chaos.scenarios` — the standing scenario library;
- :mod:`ratis_tpu_torch.chaos.campaign` — the ``chaos_1024`` campaign rung.

A failing scenario emits a self-contained ``(seed, scenario, journal)``
artifact that ``python -m ratis_tpu_torch.tools.chaos_replay`` re-runs exactly.

Reference analogs: RaftExceptionBaseTest, the kill/restart suites over
simulated RPC, and CodeInjectionForTesting
(ratis-common/.../util/CodeInjectionForTesting.java:29-60, mirrored by
``ratis_tpu_torch.util.injection``).
"""

from ratis_tpu_torch.chaos.link import LinkFaultTable, link_faults
from ratis_tpu_torch.chaos.scenario import ScenarioResult, run_scenario
from ratis_tpu_torch.chaos.scenarios import build_scenario, scenario_names

__all__ = ["LinkFaultTable", "link_faults", "ScenarioResult",
           "run_scenario", "build_scenario", "scenario_names"]
