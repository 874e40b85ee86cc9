"""A replicated variable map (the ratis-examples arithmetic machine),
for the writes the generator makes: ``v<j>=<n>`` assigns n to variable j,
``v<j>=(v<j>+<d>)%<m>`` moves it by d modulo m, and each answers the new
value; a read ``v<j>`` answers the variable; the read-back
``v0*1+v1*B+...`` answers every variable packed in base B.  Values are
floats, as the machine evaluates them."""

import re

_ASSIGN = re.compile(r"^v(\d+)=(\d+)$")
_STEP = re.compile(r"^v(\d+)=\(v(\d+)\+(\d+)\)%(\d+)$")
_READ = re.compile(r"^v(\d+)$")
_READBACK = re.compile(r"^v(\d+)\*(\d+)$")


def initial(sm: dict) -> dict:
    return {}


def apply(sm: dict, state: dict, payload: bytes) -> tuple[dict, str]:
    text = payload.decode()
    m = _ASSIGN.match(text)
    if m is not None:
        var, value = int(m.group(1)), int(m.group(2))
    else:
        m = _STEP.match(text)
        if m is None or m.group(1) != m.group(2):
            raise ValueError(f"not an arithmetic write: {payload!r}")
        var = int(m.group(1))
        if var not in state:
            raise ValueError(f"v{var} undefined before {payload!r}")
        value = (int(state[var]) + int(m.group(3))) % int(m.group(4))
    out = dict(state)
    out[var] = float(value)
    return out, repr(float(value))


def query(sm: dict, state: dict, payload: bytes) -> str:
    text = payload.decode()
    m = _READ.match(text)
    if m is not None:
        var = int(m.group(1))
        return repr(state[var]) if var in state else "undefined"
    total = 0
    for term in text.split("+"):
        m = _READBACK.match(term)
        if m is None:
            raise ValueError(f"not an arithmetic read: {payload!r}")
        var = int(m.group(1))
        if var not in state:
            return "undefined"
        total += int(state[var]) * int(m.group(2))
    return repr(float(total))


def same(answer: str, expected: str) -> bool:
    """Answers are the machine's ``repr`` of a float: equal as numbers."""
    if answer == expected:
        return True
    try:
        return float(answer) == float(expected)
    except ValueError:
        return False
