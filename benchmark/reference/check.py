"""The check that decides ``correct``: a run's answers against the plain
reference.

The reference draws every client's operations again from the seed
(``benchmark/generator.py``), folds each group's writes in their log order
(one owner writes a group, one write at a time, so log order is send
order) through the state machine written out in ``arithmetic.py``, and
judges:

- ``failed_ops``: operations that never got a successful answer (no reply
  within the drain after the window, or an error after the client's
  retries), at set-up, in the warm-up or in the window;
- ``write_reply_mismatches``: acknowledged writes whose answer is not the
  reference's answer for that write applied once, in its place;
- ``read_mismatches``: reads whose answer no linearizable history allows:
  it has to be the value after k of the group's writes, for some k from
  the writes acknowledged before the read was sent up to the writes sent
  before its answer came back (times on the host's monotonic clock, which
  every process of the run shares);
- ``replica_mismatches``: replicas whose read-back (a stale read at the
  group's last acknowledged index, on that server) is not the fold of the
  group's acknowledged writes, and replicas never read back;
- ``log_mismatches``: clients whose record departs from the operations
  the seed gives them.

A group with a failed write is not judged past that write (its state is
then unknown); the failure itself is counted.  Every limit is 0.
"""

from __future__ import annotations

import bisect

from benchmark import generator
from benchmark.reference import MACHINES

# the guarantees this check holds a run to, as a configuration states them
GUARANTEES = {
    "write": "an acknowledged write is on a majority's log, applied exactly "
             "once in its group's log order, and applied on every replica "
             "at read-back",
    "read": "linearizable: a read sees every write acknowledged before it "
            "was sent"}
LIMITS = {"failed_ops": 0, "write_reply_mismatches": 0,
          "read_mismatches": 0, "replica_mismatches": 0,
          "log_mismatches": 0}
EXAMPLES = 3


def check(config: dict, mix: dict, seed: int, clients: list) -> dict:
    """``clients``: every client process's result (``benchmark/clients.py``).
    Returns {name: count} for each of ``LIMITS`` and ``examples`` (a few
    of each kind of mismatch, for the run's error output)."""
    sm = config["state_machine"]
    ref = MACHINES[sm["kind"]]
    groups, servers = config["groups"], config["servers"]
    counts = dict.fromkeys(LIMITS, 0)
    examples: dict = {}

    def bad(kind: str, what) -> None:
        counts[kind] += 1
        if len(examples.setdefault(kind, [])) < EXAMPLES:
            examples[kind].append(what)

    # each group's writes in log order: (payload, send, reply, ok, answer)
    writes: dict[int, list] = {g: [] for g in range(groups)}
    reads: list = []
    for res in clients:
        for g, recs in sorted(res["initial"].items(), key=lambda kv:
                              int(kv[0])):
            ops = generator.initial_writes(seed, sm, int(g))
            if len(recs) != len(ops):
                bad("log_mismatches", ("initial", int(g), len(recs)))
            for op, rec in zip(ops, recs):
                writes[op.group].append((op.payload, *rec))
    for res in clients:
        for i, recs in res["ops"].items():
            gen = generator.ClientOps(seed, int(i), config, mix)
            for rec in recs:
                op = gen.next()
                kind, g, rest = rec[0], rec[1], rec[2:]
                if (op.kind, op.group) != (kind, g):
                    bad("log_mismatches", ("client", int(i), op, kind, g))
                    break
                if op.kind == generator.WRITE:
                    writes[g].append((op.payload, *rest))
                else:
                    reads.append((g, op.payload, *rest))

    # the fold: states[g][k] is the state after the group's first k writes
    states: dict[int, list] = {}
    sends: dict[int, list] = {}
    acks: dict[int, list] = {}
    for g, ws in writes.items():
        st = [ref.initial(sm)]
        for payload, send, reply, ok, answer in ws:
            if not ok:
                bad("failed_ops", ("write", g, len(st) - 1, answer))
                break
            new, expected = ref.apply(sm, st[-1], payload)
            if not ref.same(answer, expected):
                bad("write_reply_mismatches",
                    (g, len(st) - 1, payload.decode(), answer, expected))
            st.append(new)
        states[g] = st
        done = ws[:len(st) - 1]
        sends[g] = [w[1] for w in done]
        acks[g] = [w[2] for w in done]
        # writes after a failed one are not judged; failed ones among them
        # still count
        for payload, send, reply, ok, answer in ws[len(st):]:
            if not ok:
                bad("failed_ops", ("write", g, None, answer))

    for g, payload, send, reply, ok, answer in reads:
        if not ok:
            bad("failed_ops", ("read", g, answer))
            continue
        n_known = len(states[g]) - 1
        if n_known < len(writes[g]) and bisect.bisect_left(
                sends[g], reply) >= n_known:
            continue  # the history past a failed write is unknown
        lo = bisect.bisect_left(acks[g], send)
        hi = bisect.bisect_left(sends[g], reply)
        if not any(ref.same(answer, ref.query(sm, states[g][k], payload))
                   for k in range(lo, min(hi, n_known) + 1)):
            bad("read_mismatches",
                (g, payload.decode(), answer,
                 [ref.query(sm, states[g][k], payload)
                  for k in range(lo, min(hi, n_known) + 1)][:4]))

    readback = generator.readback_payload(sm)
    seen = set()
    for res in clients:
        for g, server, ok, answer in res["readback"]:
            seen.add((g, server))
            if len(states[g]) - 1 < len(writes[g]):
                continue  # a failed write: counted above
            expected = ref.query(sm, states[g][-1], readback)
            if not ok or not ref.same(answer, expected):
                bad("replica_mismatches", (g, server, ok, answer, expected))
    for g in range(groups):
        for server in range(servers):
            if (g, server) not in seen:
                bad("replica_mismatches", (g, server, "never read back"))
    counts["examples"] = examples
    return counts


def within_limits(counts: dict) -> bool:
    return all(counts[k] <= LIMITS[k] for k in LIMITS)

