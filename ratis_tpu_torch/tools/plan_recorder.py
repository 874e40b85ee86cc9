"""What the engine's prepared calls were given while a path ran.

``ShapeRecorder`` is the check ``chip_smoke.py`` holds every served path
to, and the one each server process of the multi-process harness
(``tools/multiproc_bench.py``) and the smoke's chaos process run under
and report: the shapes the
kernels were launched at (phase 5 of the smoke checks the kernels again
at each), the members of every vote round tallied, one call into the
kernel library and one K4 launch per ledger sample, and the prepared
calls made off the thread that entered it.
"""

from __future__ import annotations

import collections
import threading

from ratis_tpu_torch.ops import ledger as tl
from ratis_tpu_torch.ops import quorum as tq


def kernel_launchers() -> dict:
    """Every kernel's launcher by id (each counts its launches in
    ``launches``, per process)."""
    return {"K1": tq.K1, "K2": tq.K2, "K3": tq.K3,
            "K3_public": tq.K3_PUBLIC, "K4": tl.K4, "K5": tq.K5,
            "K6": tq.K6, "K7a": tq.K7a, "K7b": tq.K7b, "K7c": tq.K7c}


class ShapeRecorder:
    """Records the shapes the engine hands K1 (E of the flat fast plan's
    runs), K2 (D, E of the refresh plan's runs), K3 (the rows R of the
    tally plan's runs, padding included) and K5 ((S, E) of the sliced fast
    plan's runs) while active (the plans' ``run`` are swapped for counting
    ones and restored on exit), and the members of every round the vote
    passes tallied (``members``: count of rounds by the size of their
    current conf; ``QuorumEngine._tally_rounds`` swapped likewise); and
    checks that every ledger sample taken meanwhile (the watchdogs', once
    a second on every server, the telemetry samplers' and each ``GET
    /lag``'s) made ONE call into the kernel library, its prepared call's
    ``k4_tick``, that launched K4 once (``LagLedger.sample`` and
    ``LedgerPlan.run`` swapped likewise; neither on the CPU, where the
    plain version runs): on exit it raises if a sample did not, or if
    none was taken.  ``off_home_calls`` counts, by plan,
    the prepared calls made on a thread other than the one that entered
    the recorder (a server's home loop: worker loops of a loop-sharded
    server reach only the engine's intake)."""

    def __init__(self):
        self.shapes = {"K1": collections.Counter(),
                       "K2": collections.Counter(),
                       "K3": collections.Counter(),
                       "K5": collections.Counter()}
        self.members = collections.Counter()
        # (capacity, peers, ledger table width) of the engines sampled
        self.engine_shapes = collections.Counter()
        # samples taken, and the (library calls, K4 launches) of those
        # that were not (1, 1)
        self.ledger_samples = 0
        self.ledger_faults = []
        self._ledger_calls = 0
        self.off_home_calls = collections.Counter()
        self._home = None

    def _on_thread(self, plan: str) -> None:
        if threading.get_ident() != self._home:
            self.off_home_calls[plan] += 1

    def __enter__(self):
        from ratis_tpu_torch.engine.engine import QuorumEngine
        from ratis_tpu_torch.engine.ledger import LagLedger
        shapes = self.shapes
        self._home = threading.get_ident()
        self.tally_rounds = tally_rounds = QuorumEngine._tally_rounds

        def rec_tally_rounds(engine, slots):
            self.members.update(
                engine.state.conf_cur[slots].sum(axis=1).tolist())
            return tally_rounds(engine, slots)
        self.fast, self.refresh, self.tally = (
            tq.FastPlan.run, tq.RefreshPlan.run, tq.TallyPlan.run)
        self.ledger_run, self.sample = tl.LedgerPlan.run, LagLedger.sample
        fast, refresh, tally = self.fast, self.refresh, self.tally
        ledger_run, sample = self.ledger_run, self.sample

        def rec_ledger_run(plan, *a):
            self._on_thread("LedgerPlan")
            tick = getattr(plan, "_tick", None)
            if tick is None:  # the plain version, on the CPU
                return ledger_run(plan, *a)

            def counting(*b):
                self._ledger_calls += 1
                return tick(*b)
            plan._tick = counting
            try:
                return ledger_run(plan, *a)
            finally:
                plan._tick = tick

        def rec_sample(ledger):
            self._ledger_calls = 0
            n = tl.K4.launches
            res = sample(ledger)
            got = (self._ledger_calls, tl.K4.launches - n)
            self.ledger_samples += 1
            e = ledger.engine
            self.engine_shapes[(e.state.capacity, e.state.max_peers,
                                ledger._table_width())] += 1
            # no library call and no launch where the engine is on the CPU
            if got != ((1, 1) if e.device.type == "cuda" else (0, 0)):
                self.ledger_faults.append(got)
            return res

        def rec_fast(plan, e, *rest):
            self._on_thread("FastPlan")
            if plan.sliced:
                shapes["K5"][(plan.n_slices, e)] += 1
            else:
                shapes["K1"][e] += 1
            return fast(plan, e, *rest)

        def rec_refresh(plan, d, e, *rest):
            self._on_thread("RefreshPlan")
            shapes["K2"][(d, e)] += 1
            return refresh(plan, d, e, *rest)

        def rec_tally(plan, r):
            self._on_thread("TallyPlan")
            shapes["K3"][r] += 1
            return tally(plan, r)

        tq.FastPlan.run = rec_fast
        tq.RefreshPlan.run = rec_refresh
        tq.TallyPlan.run = rec_tally
        tl.LedgerPlan.run = rec_ledger_run
        LagLedger.sample = rec_sample
        QuorumEngine._tally_rounds = rec_tally_rounds
        return self

    def __exit__(self, exc_type, *exc):
        from ratis_tpu_torch.engine.engine import QuorumEngine
        from ratis_tpu_torch.engine.ledger import LagLedger
        QuorumEngine._tally_rounds = self.tally_rounds
        tq.FastPlan.run = self.fast
        tq.RefreshPlan.run = self.refresh
        tq.TallyPlan.run = self.tally
        tl.LedgerPlan.run = self.ledger_run
        LagLedger.sample = self.sample
        if exc_type is None and (self.ledger_faults
                                 or self.ledger_samples == 0):
            raise AssertionError(
                f"ledger samples: {self.ledger_samples}, (library calls, "
                f"K4 launches) of those that were not one call and one "
                f"launch: {self.ledger_faults[:10]}")

    def engine(self) -> dict:
        """The most common engine shape of the samples (``engine_shape``'s
        keys), for a path whose cluster the recorder never sees."""
        (g, p, w), _ = self.engine_shapes.most_common(1)[0]
        return {"capacity": g, "peers": p, "ledger_width": w}

    def report(self) -> dict:
        """What was recorded so far, as JSON: each kernel's shapes
        (``str`` of the shape: launches), the vote rounds by members, the
        ledger samples and the faults among them, and the prepared calls
        off the home thread by plan."""
        return {"shapes": {k: {str(s): n for s, n in c.items()}
                           for k, c in self.shapes.items()},
                "vote_round_members": {str(m): n
                                       for m, n in self.members.items()},
                "ledger_samples": self.ledger_samples,
                "ledger_faults": self.ledger_faults[:10],
                "off_home_calls": dict(self.off_home_calls)}

    def merge(self, report: dict) -> None:
        """Add another process's ``report()`` to this recorder."""
        for k, shapes in report["shapes"].items():
            for text, n in shapes.items():
                shape = (tuple(int(x) for x in text.strip("()").split(","))
                         if k in ("K2", "K5") else int(text))
                self.shapes[k][shape] += n
        self.members.update({int(m): n for m, n
                             in report["vote_round_members"].items()})
        self.ledger_samples += report["ledger_samples"]
        self.ledger_faults += report["ledger_faults"]
        self.off_home_calls.update(report["off_home_calls"])
