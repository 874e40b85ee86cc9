"""Replay a recorded chaos artifact exactly.

A failing scenario writes a self-contained ``(seed, scenario, journal)``
artifact (``ratis_tpu_torch.chaos.scenario.write_artifact``).  This tool

1. re-derives the scenario's step schedule from ``(name, seed, config)``
   and asserts it is BYTE-IDENTICAL to the recorded one (the
   determinism contract — if this fails, the artifact was produced by a
   different code version and the replay would be meaningless);
2. rebuilds the same cluster shape (servers, groups, transport, state
   machine, durability) and re-runs the scenario;
3. reports the fresh result next to the recorded one and exits 0 iff
   the replay PASSED (a fixed bug replays green; an unfixed one
   reproduces).

Usage::

    python -m ratis_tpu_torch.tools.chaos_replay artifact.json
    python -m ratis_tpu_torch.tools.chaos_replay artifact.json --show
    python -m ratis_tpu_torch.tools.chaos_replay artifact.json --storage DIR
    python -m ratis_tpu_torch.tools.chaos_replay artifact.json --device cpu

Every engine of the rebuilt cluster runs on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile
from typing import Optional

from ratis_tpu_torch.chaos.faults import Step
from ratis_tpu_torch.chaos.scenario import ARTIFACT_VERSION, Scenario
from ratis_tpu_torch.chaos.scenarios import build_scenario


def load_artifact(path: str) -> dict:
    with open(path) as f:
        artifact = json.load(f)
    version = artifact.get("version")
    if version != ARTIFACT_VERSION:
        raise SystemExit(f"{path}: artifact version {version!r} != "
                         f"supported {ARTIFACT_VERSION}")
    return artifact


def rebuild_scenario(artifact: dict) -> Scenario:
    """Re-derive the schedule and assert bit-for-bit equality with the
    recorded one."""
    rec = artifact["scenario"]
    scenario = build_scenario(rec["name"], int(rec["seed"]),
                              rec.get("config"))
    recorded = tuple(Step.from_json(s) for s in rec.get("steps", []))
    if scenario.steps != recorded:
        lines = [f"  recorded: {s.to_json()}" for s in recorded]
        lines += [f"  derived:  {s.to_json()}" for s in scenario.steps]
        raise SystemExit(
            "schedule drift: the artifact's recorded steps do not match "
            "the schedule this code derives from (name, seed, config) — "
            "replay would not reproduce the recorded run\n"
            + "\n".join(lines))
    return scenario


async def replay(scenario: Scenario,
                 storage_root: Optional[str] = None,
                 device: str = "cuda") -> "ScenarioResult":
    from ratis_tpu_torch.chaos.cluster import ChaosCluster, chaos_properties
    from ratis_tpu_torch.chaos.scenario import run_scenario
    cfg = scenario.config
    own_tmp = None
    if cfg.get("durable") and storage_root is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ratis-chaos-replay-")
        storage_root = own_tmp.name
    groups = int(cfg.get("groups", 1))
    cluster = ChaosCluster(
        int(cfg.get("servers", 3)), groups,
        properties=chaos_properties(groups, seed=scenario.seed,
                                    device=device),
        transport=cfg.get("transport", "sim"),
        sm=cfg.get("sm", "recording"),
        storage_root=storage_root if cfg.get("durable") else None,
        seed=scenario.seed)
    try:
        await cluster.start()
        return await run_scenario(cluster, scenario)
    finally:
        await cluster.close()
        if own_tmp is not None:
            own_tmp.cleanup()


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="chaos_replay", description=__doc__.splitlines()[0])
    parser.add_argument("artifact", help="recorded chaos artifact JSON")
    parser.add_argument("--show", action="store_true",
                        help="print the schedule + recorded journal and "
                             "exit without running")
    parser.add_argument("--storage", default=None,
                        help="storage root for durable replays "
                             "(default: a fresh temp dir)")
    parser.add_argument("--device", default="cuda",
                        help="the engines' device: cuda (the kernels; the "
                             "default) or cpu")
    args = parser.parse_args(argv)

    artifact = load_artifact(args.artifact)
    scenario = rebuild_scenario(artifact)
    print(f"scenario {scenario.name} seed={scenario.seed} "
          f"({len(scenario.steps)} steps) — schedule matches artifact")
    if args.show:
        for s in scenario.steps:
            print(f"  t+{s.at_s:6.2f}s  {s.op:14s} {s.target} "
                  f"{dict(s.args) or ''}")
        print(f"recorded: passed={artifact['passed']} "
              f"error={artifact.get('error')}")
        for e in artifact.get("journal", []):
            print(f"  t+{e['t']:6.2f}s  {e['kind']}: {e['detail']}")
        return 0

    result = asyncio.run(replay(scenario, args.storage, args.device))
    print(f"recorded: passed={artifact['passed']} "
          f"error={artifact.get('error')}")
    print(f"replayed: passed={result.passed} error={result.error}")
    print(f"  slos={result.slos} checks={result.checks} "
          f"acked={result.acked} recovery_frac={result.recovery_frac}")
    for e in result.journal:
        print(f"  t+{e['t']:6.2f}s  {e['kind']}: {e['detail']}")
    return 0 if result.passed else 1


if __name__ == "__main__":
    sys.exit(main())
