"""The control that ``correct`` has to fail, and the faults the harness's
own tests plant under the timed path.

Every class here is the port's arithmetic state machine with one guarantee
of the configuration broken; a run takes one in place of the
configuration's ``state_machine.class``:

- ``LazyFollowerArithmetic`` (the control): a follower logs each entry
  and moves its applied index but leaves its state as it was, so only
  leaders apply; the configuration states that an acknowledged write is
  applied on every replica at read-back.  Skipping the followers' apply
  would save the host loops, the bottleneck, a good part of their work:
  the step that would tempt a later change;
- ``FrozenArithmetic``: every apply answers as usual but leaves the state
  as it was (a step that returns its state unchanged);
- ``HalfArithmetic``: entries at odd log indexes are left out of the state
  (half of the batch left out);
- ``AlteredArithmetic``: every answer, of a write or a read, gets one more
  character where the state machine produces it;
- ``TwiceArithmetic``: one write of the whole run is applied twice, on
  every replica, and answered as if once (a retry applied again);
- ``DroppedArithmetic``: one write of the whole run is answered as usual
  but left out of the state, on every replica.

The one write of the last two is the ``ONE_WRITE``-th that the group with
the least id applies: the second write of the load, after the group's
initial writes, with more of the group's writes after it.

Run the control on the card at a cell's own size, on a few seeds:

    python3 -m benchmark.controls --workload arith3x1024-write \\
        --seeds 11,12,13 --seconds 20

It prints each run's checks as one JSON line; each has to come out
``correct: false``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ratis_tpu_torch.models.arithmetic import ArithmeticStateMachine
from ratis_tpu_torch.protocol.message import Message

ONE_WRITE = 9  # 7 initial writes (the configuration's variables), then 2


def _broken(keep_state, alter: bool = False, twice=None):
    """The arithmetic machine with its apply's effect on the state undone
    wherever ``keep_state(machine, log_entry)`` says so, applied once more
    wherever ``twice(machine, log_entry)`` says so (answering the first
    application), and with every answer altered if ``alter``."""

    class Broken(ArithmeticStateMachine):
        async def initialize(self, server, group_id, storage_dir=None):
            self._server, self._group_id = server, group_id
            self._applies = 0
            await super().initialize(server, group_id, storage_dir)

        async def apply_transaction(self, trx):
            self._applies += 1
            saved = dict(self.variables)
            reply = await super().apply_transaction(trx)
            if keep_state(self, trx.log_entry):
                self.variables = saved
            if twice is not None and twice(self, trx.log_entry):
                await super().apply_transaction(trx)
            return _alter(reply) if alter else reply

        async def query(self, request):
            reply = await super().query(request)
            return _alter(reply) if alter else reply

    return Broken


def _alter(reply):
    return Message.value_of(reply.content + b"1")


def _follower(machine, entry) -> bool:
    division = machine._server.divisions.get(machine._group_id)
    return division is not None and not division.is_leader()


def _always(machine, entry) -> bool:
    return True


def _odd(machine, entry) -> bool:
    return entry is not None and entry.index % 2 == 1


def _never(machine, entry) -> bool:
    return False


def _one_write(machine, entry) -> bool:
    return machine._applies == ONE_WRITE and machine._group_id == min(
        machine._server.divisions, key=str)


LazyFollowerArithmetic = _broken(_follower)
FrozenArithmetic = _broken(_always)
HalfArithmetic = _broken(_odd)
AlteredArithmetic = _broken(_never, alter=True)
TwiceArithmetic = _broken(_never, twice=_one_write)
DroppedArithmetic = _broken(_one_write)

CONTROL = {"arithmetic": "LazyFollowerArithmetic"}


def with_machine(config: dict, name: str) -> dict:
    """``config`` with its state machine replaced by this module's
    ``name``."""
    out = json.loads(json.dumps(config))
    out["state_machine"]["class"] = f"benchmark.controls:{name}"
    return out


def main(argv=None) -> int:
    from benchmark import manifest, run
    ap = argparse.ArgumentParser(description="run a cell with the control "
                                 "state machine in place of the program's")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    config = manifest.config(cell["config"])
    config = with_machine(config, CONTROL[config["state_machine"]["kind"]])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(bench, cell, seed, args.seconds, False, "cuda",
                           config=config)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
