"""Lockstep differential: the JAX QuorumEngine against the port's.

Two engines, the JAX package's ``QuorumEngine(use_device=True)`` (jitted
XLA on the CPU) and the port's ``QuorumEngine(use_device=True,
device="cpu")`` (the kernels' plain-torch versions), take ONE seeded random
intake script: attach/detach, acks (scalar and batched), flush advances and
regressions, deadline re-arms, conf and role changes (dirty-row refreshes),
vote rounds with replies and early expiry, a backlog above the dispatch
chunk cap, and an epoch rebase.  A detached row's queued events are
dropped from the JAX engine's rings before its detach, as the port's
detach drops them (``detach_both``).  After EVERY tick the listener callbacks,
the vote results, the host mirrors and the device-resident state must be
equal.
"""

import asyncio
import random

import numpy as np

from ratis_tpu.engine.engine import QuorumEngine as JaxEngine
from ratis_tpu_torch.engine.engine import QuorumEngine as TorchEngine
from ratis_tpu_torch.engine.state import (ROLE_CANDIDATE, ROLE_FOLLOWER,
                                          ROLE_LEADER, ROLE_LISTENER)
from ratis_tpu_torch.ops.quorum import DeviceState

P = 4
MIRRORS = ("role", "match_index", "last_ack_ms", "flush_index",
           "commit_index", "election_deadline_ms", "vote_deadline_ms",
           "vote_grants", "vote_rejects", "conf_cur", "conf_old")


class FakeClock:
    def __init__(self):
        self.t = 0

    def now_ms(self):
        return self.t

    def advance_epoch(self, delta_ms):
        self.t -= delta_ms


class Recorder:
    def __init__(self):
        self.events = []

    async def on_election_timeout(self):
        self.events.append("timeout")

    async def on_commit_advance(self, c):
        self.events.append(("commit", c))

    async def on_leadership_stale(self):
        self.events.append("stale")


def _engines():
    kw = dict(max_groups=16, max_peers=P, scalar_fallback_threshold=10**9,
              leadership_timeout_ms=300, use_device=True)
    j, t = JaxEngine(**kw), TorchEngine(device="cpu", **kw)
    for e in (j, t):
        e.clock = FakeClock()
    return j, t


def _assert_same(j, t, step):
    for name in MIRRORS:
        np.testing.assert_array_equal(getattr(t.state, name),
                                      getattr(j.state, name),
                                      err_msg=f"step {step}: mirror {name}")
    assert (j._dev is None) == (t._dev is None), step
    if t._dev is not None:
        for name, a, b in zip(DeviceState._fields, j._dev, t._dev):
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(a),
                err_msg=f"step {step}: device {name}")


def detach_both(j, t, slot: int) -> None:
    """Detach ``slot`` from both engines.  The port's detach drops the
    row's queued acks and vote replies, so a division attached to the same
    row before the next tick never takes them; the JAX engine keeps them
    (its next tick scatters a released row's acks over the row's next
    owner), so they are dropped from its rings here first, and the two
    engines then hold the same state."""
    j._ack_ring = [a for a in j._ack_ring if a[0] != slot]
    j._vote_ring = [v for v in j._vote_ring if v[0] != slot]
    j.detach(slot)
    t.detach(slot)


# the engine counters that name the kind of each tick
TICK_KINDS = ("fast_ticks", "refresh_ticks", "batched_dispatches")


def _lockstep(on_step=None) -> None:
    """The lockstep script; ``on_step(j, t, step)`` after every step's
    ticks and checks."""
    async def run():
        rng = random.Random(2024)
        j, t = _engines()
        engines = (j, t)
        recs = {}       # slot -> (jax recorder, torch recorder)
        futs = []       # (step, slot, jax future, torch future)

        def both(fn):
            for e in engines:
                fn(e)

        def attach():
            rj, rt = Recorder(), Recorder()
            sj, st = j.attach(rj), t.attach(rt)
            assert sj == st
            recs[sj] = (rj, rt)
            role = rng.choice([ROLE_LEADER, ROLE_LEADER, ROLE_FOLLOWER,
                               ROLE_LISTENER, ROLE_CANDIDATE])
            n = rng.randint(1, P)
            cur = np.arange(P) < n
            prio = np.array([rng.choice([0, 0, 2]) for _ in range(P)],
                            np.int32)
            flush, dl = rng.randint(-1, 10), rng.randint(1, 400)

            def setup(e):
                s = e.state
                s.set_conf(sj, 0, cur, np.zeros(P, bool), prio,
                           int(prio[0]))
                s.role[sj] = role
                s.flush_index[sj] = flush
                s.first_leader_index[sj] = 0
                if role == ROLE_FOLLOWER:
                    s.election_deadline_ms[sj] = e.clock.t + dl
            both(setup)

        for _ in range(10):
            attach()

        for step in range(60):
            # step 45 jumps past the rebase threshold: the epoch shifts
            # and the device state re-uploads on both engines
            dt = JaxEngine._REBASE_THRESHOLD_MS if step == 45 else 41
            for e in engines:
                e.clock.t += dt
            now = j.clock.t
            slots = sorted(recs)
            for _ in range(rng.randint(0, 8)):
                g, p, m = rng.choice(slots), rng.randint(0, P - 1), \
                    rng.randint(-1, 14)
                both(lambda e: e.on_ack(g, p, m))
            if rng.random() < 0.3:
                rows = [(rng.choice(slots), rng.randint(0, P - 1),
                         rng.randint(0, 14)) for _ in range(5)]
                both(lambda e: e.on_ack_batch(rows))
            if rng.random() < 0.4:
                g, f = rng.choice(slots), rng.randint(-1, 16)
                both(lambda e: e.on_flush(g, f))   # may regress: dirty row
            if rng.random() < 0.3:
                g = rng.choice(slots)
                if j.state.role[g] == ROLE_FOLLOWER:
                    d = now + rng.randint(1, 300)
                    both(lambda e: e.on_deadline(g, d))
            if rng.random() < 0.2:
                g = rng.choice(slots)
                role = rng.choice([ROLE_LEADER, ROLE_FOLLOWER])
                old = np.arange(P) < rng.randint(0, P)

                def change(e):
                    s = e.state
                    s.role[g] = role
                    s.conf_old[g] = old
                    s.mark_dirty(g)
                    if role == ROLE_FOLLOWER:
                        s.election_deadline_ms[g] = now + 50
                both(change)
            if rng.random() < 0.15:
                g = rng.choice(slots)
                if g not in j._vote_rounds:
                    dl = now + rng.randint(50, 200)
                    futs.append((step, g, j.begin_vote_round(g, dl),
                                 t.begin_vote_round(g, dl)))
            for g in list(j._vote_rounds):
                if rng.random() < 0.5:
                    p, granted = rng.randint(1, P - 1), rng.random() < 0.6
                    both(lambda e: e.on_vote_reply(g, p, granted))
                if rng.random() < 0.1:
                    both(lambda e: e.expire_vote_round(g))
            if step == 20:
                # backlog above the chunk cap: dispatched in chunks
                big = [(rng.choice(slots), rng.randint(0, P - 1),
                        rng.randint(0, 20))
                       for _ in range(JaxEngine._MAX_EVENT_BUCKET + 700)]
                both(lambda e: e.on_ack_batch(big))
            if step == 30:
                g = slots[0]
                detach_both(j, t, g)
                recs.pop(g)
                attach()
            before = t.metrics["batched_dispatches"]
            await j.tick()
            await t.tick()
            await asyncio.sleep(0)
            if step == 20:  # the backlog went out in more than one chunk
                assert t.metrics["batched_dispatches"] - before >= 2
            _assert_same(j, t, step)
            for slot, (rj, rt) in recs.items():
                assert rj.events == rt.events, (step, slot)
            for s_, g, fj, ft in futs:
                assert fj.done() == ft.done(), (step, s_, g)
                if fj.done():
                    assert fj.cancelled() == ft.cancelled(), (step, g)
                    if not fj.cancelled():
                        assert fj.result() == ft.result(), (step, g)
            if on_step is not None:
                on_step(j, t, step)

        # the script reached what it claims to cover
        assert t.metrics["fast_ticks"] > 0 and t.metrics["refresh_ticks"] > 0
        assert t.clock.t < JaxEngine._REBASE_THRESHOLD_MS  # rebased
        results = {f.result() for _, _, f, _ in futs
                   if f.done() and not f.cancelled()}
        assert len(results) >= 2, results
        seen = {x if isinstance(x, str) else x[0]
                for rj, _ in recs.values() for x in rj.events}
        assert seen == {"commit", "timeout", "stale"}, seen
        for e in engines:
            await e.close()

    asyncio.run(run())


def test_lockstep_engine_differential():
    _lockstep()


def test_engine_tick_kinds_match_jax():
    """The port's engine takes the same kind of tick as the JAX engine on
    every step: after each step the fast ticks, refresh ticks and batched
    dispatches so far are equal.  On a served path the refresh ticks come
    from role and conf changes (commits advance inline at ack intake, the
    tick drives timeouts and staleness), so their share is the
    reference's own."""
    seen = []

    def on_step(j, t, step):
        got = {k: (j.metrics[k], t.metrics[k]) for k in TICK_KINDS}
        assert all(a == b for a, b in got.values()), (step, got)
        seen.append(got)

    _lockstep(on_step)
    assert len(seen) == 60
    last = seen[-1]
    assert last["fast_ticks"][1] > 0 and last["refresh_ticks"][1] > 0
    assert last["batched_dispatches"][1] >= \
        last["fast_ticks"][1] + last["refresh_ticks"][1]


def test_cpu_engine_keeps_torch_on_one_intra_op_thread():
    """An engine on the CPU runs the plain versions on its event loop's
    thread over [G, P] tensors; with torch's intra-op pool each reduction
    there waited on the pool beside other busy processes and the loop
    paused for seconds (the chaos scenarios' port half missed its
    re-election SLO), so the engine keeps torch on one intra-op
    thread."""
    import torch
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(4)
        TorchEngine(max_groups=64, device="cpu")
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(before)
