"""Arithmetic state machine: replicated variable map with expression eval.

Capability parity with the reference arithmetic example
(ratis-examples/src/main/java/org/apache/ratis/examples/arithmetic/
ArithmeticStateMachine.java): transactions assign ``var = expression``
where the expression may reference previously assigned variables; queries
evaluate a variable (or expression) against the current map.  Expressions
are parsed with :mod:`ast` restricted to arithmetic nodes — never ``eval``.
Snapshot = the whole variable map (reference serializes the map the same
way).
"""

from __future__ import annotations

import ast
import asyncio
import math
import operator
import msgpack
from typing import Dict

from ratis_tpu_torch.protocol.message import Message
from ratis_tpu_torch.server.statemachine import (BaseStateMachine,
                                           TransactionContext)

_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}
_UNARYOPS = {ast.USub: operator.neg, ast.UAdd: operator.pos}
_FUNCS = {"sqrt": math.sqrt}


def _encode_value(v):
    if isinstance(v, complex):
        return {"__complex__": [v.real, v.imag]}
    raise TypeError(f"unserializable snapshot value {v!r}")


def _decode_value(v):
    if isinstance(v, dict) and "__complex__" in v:
        re_, im = v["__complex__"]
        return complex(re_, im)
    return v


def evaluate(expression: str, variables: Dict[str, float]) -> float:
    """Safely evaluate an arithmetic expression over the variable map."""
    tree = ast.parse(expression, mode="eval")

    def _eval(node: ast.AST) -> float:
        if isinstance(node, ast.Expression):
            return _eval(node.body)
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, (int, float)):
                raise ValueError(f"non-numeric constant {node.value!r}")
            return float(node.value)
        if isinstance(node, ast.Name):
            if node.id not in variables:
                raise ValueError(f"undefined variable {node.id!r}")
            return variables[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](_eval(node.left), _eval(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
            return _UNARYOPS[type(node.op)](_eval(node.operand))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _FUNCS and len(node.args) == 1 \
                and not node.keywords:
            return _FUNCS[node.func.id](_eval(node.args[0]))
        raise ValueError(f"disallowed expression node {type(node).__name__}")

    return _eval(tree)


class ArithmeticStateMachine(BaseStateMachine):
    """Transactions: ``b"x = y + 1"``; queries: ``b"x"`` (any expression)."""

    def __init__(self) -> None:
        super().__init__()
        self.variables: Dict[str, float] = {}

    async def start_transaction(self, request) -> TransactionContext:
        """Reject malformed assignments before they consume a log entry
        (counter/filestore pattern).  Only syntax is checked — variable
        existence depends on entries still in flight, so name resolution
        stays at apply time."""
        trx = TransactionContext(client_request=request,
                                 log_data=request.message.content)
        try:
            var, _, expression = request.message.content.decode().partition("=")
            if not var.strip().isidentifier():
                raise ValueError(
                    f"invalid assignment target {var.strip()!r}")
            ast.parse(expression.strip(), mode="eval")
        except Exception as e:
            trx.exception = e
        return trx

    async def apply_transaction(self, trx: TransactionContext) -> Message:
        e = trx.log_entry
        assignment = (e.smlog.log_data if e is not None and e.smlog is not None
                      else (trx.log_data or b"")).decode()
        var, _, expression = assignment.partition("=")
        var = var.strip()
        if not var.isidentifier():
            raise ValueError(f"invalid assignment target {var!r}")
        value = evaluate(expression.strip(), self.variables)
        self.variables[var] = value
        if e is not None:
            self.update_last_applied_term_index(e.term, e.index)
        return Message.value_of(repr(value))

    async def query(self, request: Message) -> Message:
        value = evaluate(request.content.decode().strip(), self.variables)
        return Message.value_of(repr(value))

    async def query_stale(self, request: Message, min_index: int) -> Message:
        return await self.query(request)

    async def take_snapshot(self) -> int:
        ti = self.get_last_applied_term_index()
        if ti.index < 0:
            return -1
        storage = self.get_state_machine_storage()
        if storage.directory is None:
            return -1  # volatile group: nothing durable to snapshot to
        path = storage.snapshot_path(ti.term, ti.index)
        # msgpack, not pickle: snapshot files can be installed over the
        # network from another peer, so the format must not execute code.
        # evaluate() can yield complex (e.g. (-2) ** 0.5) — tag those.
        data = msgpack.packb(dict(self.variables), use_bin_type=True,
                             default=_encode_value)
        await asyncio.to_thread(self._write_snapshot, path, data)
        return ti.index

    @staticmethod
    def _write_snapshot(path, data: bytes) -> None:
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(data)
        tmp.replace(path)

    async def restore_from_snapshot(self, snapshot) -> None:
        if snapshot is None or not snapshot.files:
            return
        import pathlib
        data = pathlib.Path(snapshot.files[0].path).read_bytes()
        try:
            raw = msgpack.unpackb(data, raw=False, strict_map_key=False)
        except Exception as e:
            raise ValueError(
                "arithmetic snapshot is not msgpack (unsupported legacy "
                "format?): " + str(e)) from e
        self.variables = {k: _decode_value(v) for k, v in raw.items()}
        self.set_last_applied_term_index(snapshot.term_index)
