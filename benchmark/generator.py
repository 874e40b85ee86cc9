"""The benchmark's one traffic generator.

Every client's operations come from the run's seed, the configuration's
state machine and the traffic mix's parameters (``benchmark/traffic/<mix>
.json``), and nothing else, so the client processes and the reference
(``benchmark/reference/check.py``) draw the same sequence:

- client ``i`` of ``C`` owns the groups ``{g : g mod C = i}`` and writes
  them in turn, one write at a time, so each group's writes come from one
  closed loop and their log order is their send order;
- an operation is a read with probability ``read_share``; a read's group
  is drawn from the mix's distribution over group ranks (rank r is group r;
  zipf(s) weighs rank r as (r + 1)^-s);
- payloads follow the arithmetic state machine, with V its variables and
  M its operand modulus: a write ``v{j}=(v{j}+{d})%M`` (j = a mod V, d =
  1 + b mod (M - 1)) moves a variable by a step that is never 0 mod M, so
  its answer and the state after it depend on every earlier write to that
  variable: a write applied twice, or one left out anywhere in a group's
  history, changes what the group reads back; a read is ``v{c%V}``.

Before the load every group gets one write to each of its variables
(``initial_writes``, ``v{j}={n}`` with n < M), so every read finds its
variable.  After the load each replica of each group is read back with
``readback_payload``: the variables, each under M, packed into one exact
number.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

WRITE, READ, INITIAL = "w", "r", "i"


class Op(NamedTuple):
    kind: str
    group: int
    payload: bytes


def seed_key(seed: int) -> int:
    """The seed as numpy's seed sequences take it: any whole number,
    negative ones included, mapped onto 64 bits."""
    return int(seed) % (1 << 64)


def owned_groups(client: int, clients: int, groups: int) -> range:
    return range(client, groups, clients)


def zipf_cdf(groups: int, s: float) -> np.ndarray:
    w = (np.arange(groups, dtype=np.float64) + 1.0) ** -s
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def _operand_base(sm: dict) -> int:
    """The packing base of the read-back: a power of ten above every value
    a variable can hold (0..M-1)."""
    return 10 ** len(str(sm["operand_mod"]))


def write_payload(sm: dict, a: int, b: int) -> bytes:
    j, m = a % sm["variables"], sm["operand_mod"]
    return f"v{j}=(v{j}+{1 + b % (m - 1)})%{m}".encode()


def read_payload(sm: dict, c: int) -> bytes:
    return f"v{c % sm['variables']}".encode()


def readback_payload(sm: dict) -> bytes:
    base = _operand_base(sm)
    return "+".join(f"v{j}*{base ** j}"
                    for j in range(sm["variables"])).encode()


def initial_writes(seed: int, sm: dict, group: int) -> list[Op]:
    """The writes a group gets before the load: one to each variable."""
    rng = np.random.default_rng([seed_key(seed), 2, group])
    b = rng.integers(0, 1 << 31, size=sm["variables"])
    return [Op(INITIAL, group, f"v{j}={int(b[j]) % sm['operand_mod']}"
               .encode()) for j in range(sm["variables"])]


class ClientOps:
    """The operations of client ``client``, in the order it sends them."""

    def __init__(self, seed: int, client: int, config: dict, mix: dict):
        self.sm = config["state_machine"]
        groups = config["groups"]
        self.owned = owned_groups(client, mix["clients"], groups)
        self.read_share = float(mix["read_share"])
        reads = mix["read_groups"]
        if reads["distribution"] != "zipf":
            raise ValueError(f"read distribution {reads['distribution']!r}")
        self.cdf = zipf_cdf(groups, float(reads["s"]))
        self.rng = np.random.default_rng([seed_key(seed), 1, client])
        self.writes = 0

    def next(self) -> Op:
        u, x = self.rng.random(2)
        a, b = (int(v) for v in self.rng.integers(0, 1 << 31, size=2))
        if u < self.read_share:
            group = int(np.searchsorted(self.cdf, x, side="right"))
            return Op(READ, min(group, len(self.cdf) - 1),
                      read_payload(self.sm, a))
        group = self.owned[self.writes % len(self.owned)]
        self.writes += 1
        return Op(WRITE, group, write_payload(self.sm, a, b))
