"""The plain reference judges a made-up run: a sound one passes, and each
planted fault is caught."""

import copy

import pytest

from benchmark import generator
from benchmark.reference import arithmetic as ref
from benchmark.reference.check import LIMITS, check, within_limits

SEED = 2 ** 31 + 17
MIX = {"clients": 3, "read_share": 0.5,
       "read_groups": {"distribution": "zipf", "s": 0.99}}
CONFIG = {"groups": 6, "servers": 3,
          "state_machine": {"kind": "arithmetic", "variables": 7,
                            "operand_mod": 97}}
SM = CONFIG["state_machine"]


def _sound_run(ops_each: int = 40, fault: str = None, at: int = None) -> list:
    """Client results of a run in which every operation takes effect
    atomically when it is sent and is answered a tick later; with
    ``fault``, client 0's write number ``at`` is applied twice
    (``"twice"``) or left out of the state (``"drop"``) and answered as if
    applied once."""
    state = {g: ref.initial(SM) for g in range(CONFIG["groups"])}
    t = 0.0
    initial = {}
    for g in range(CONFIG["groups"]):
        for op in generator.initial_writes(SEED, SM, g):
            state[g], answer = ref.apply(SM, state[g], op.payload)
            initial.setdefault(str(g), []).append([t, t + 0.5, True, answer])
            t += 1.0
    gens = {i: generator.ClientOps(SEED, i, CONFIG, MIX)
            for i in range(MIX["clients"])}
    ops = {str(i): [] for i in gens}
    writes0 = 0
    for _ in range(ops_each):
        for i, gen in gens.items():
            op = gen.next()
            if op.kind == generator.WRITE:
                new, answer = ref.apply(SM, state[op.group], op.payload)
                if i == 0:
                    if writes0 == at and fault == "twice":
                        new, _ = ref.apply(SM, new, op.payload)
                    elif writes0 == at and fault == "drop":
                        new = state[op.group]
                    writes0 += 1
                state[op.group] = new
            else:
                answer = ref.query(SM, state[op.group], op.payload)
            ops[str(i)].append([op.kind, op.group, t, t + 0.5, True, answer])
            t += 1.0
    readback = [[g, s, True, ref.query(SM, state[g],
                                       generator.readback_payload(SM))]
                for g in range(CONFIG["groups"])
                for s in range(CONFIG["servers"])]
    return [{"ops": ops, "initial": initial, "readback": readback}]


def test_a_sound_run_passes():
    counts = check(CONFIG, MIX, SEED, _sound_run())
    assert within_limits(counts), counts
    assert set(LIMITS) <= set(counts)


@pytest.mark.parametrize("fault", ["twice", "drop"])
@pytest.mark.parametrize("at", [0, 3])
def test_one_write_applied_twice_or_left_out_is_caught(fault, at):
    """Client 0's first or fourth write, with more of its group's writes
    after it: every replica of the group departs from the fold."""
    counts = check(CONFIG, MIX, SEED, _sound_run(fault=fault, at=at))
    assert counts["replica_mismatches"] == CONFIG["servers"], counts


def test_the_last_acknowledged_write_left_out_is_caught():
    """The replicas read back as if client 0's last acknowledged write had
    never been applied."""
    writes = sum(1 for r in _sound_run()[0]["ops"]["0"]
                 if r[0] == generator.WRITE)
    counts = check(CONFIG, MIX, SEED, _sound_run(fault="drop",
                                                 at=writes - 1))
    assert counts["replica_mismatches"] == CONFIG["servers"], counts


def test_a_wrong_replica_is_caught():
    run = _sound_run()
    run[0]["readback"][4][3] = "12345.0"
    assert check(CONFIG, MIX, SEED, run)["replica_mismatches"] == 1


def test_a_replica_never_read_back_is_caught():
    run = _sound_run()
    del run[0]["readback"][2]
    assert check(CONFIG, MIX, SEED, run)["replica_mismatches"] == 1


def test_a_stale_read_is_caught():
    """A read answered with its variable's value from before a write that
    was acknowledged before the read was sent."""
    run = _sound_run()
    ops = []  # (send time, op, record) of every client, in send order
    for i, recs in run[0]["ops"].items():
        gen = generator.ClientOps(SEED, int(i), CONFIG, MIX)
        ops += [(rec[2], gen.next(), rec) for rec in recs]
    state = {g: ref.initial(SM) for g in range(CONFIG["groups"])}
    for g in state:
        for op in generator.initial_writes(SEED, SM, g):
            state[g], _ = ref.apply(SM, state[g], op.payload)
    before = {}  # (group, variable read) -> its value before its last write
    for _, op, rec in sorted(ops, key=lambda x: x[0]):
        if op.kind == generator.WRITE:
            var = op.payload.split(b"=")[0]
            before[(op.group, var)] = ref.query(SM, state[op.group], var)
            state[op.group], _ = ref.apply(SM, state[op.group], op.payload)
        elif (op.group, op.payload) in before:
            rec[5] = before[(op.group, op.payload)]
            break
    assert check(CONFIG, MIX, SEED, run)["read_mismatches"] == 1


def test_an_altered_write_answer_and_a_failed_op_are_caught():
    run = _sound_run()
    w = next(r for r in run[0]["ops"]["2"] if r[0] == generator.WRITE)
    w[5] = w[5] + "1"
    counts = check(CONFIG, MIX, SEED, copy.deepcopy(run))
    assert counts["write_reply_mismatches"] == 1
    w[4] = False
    counts = check(CONFIG, MIX, SEED, run)
    assert counts["failed_ops"] == 1 and not within_limits(counts)


def test_a_record_that_departs_from_the_seed_is_caught():
    run = _sound_run()
    run[0]["ops"]["0"][3][1] = (run[0]["ops"]["0"][3][1] + 1) % 6
    assert check(CONFIG, MIX, SEED, run)["log_mismatches"] == 1
