"""Terminal expressions: typed constants, ``Null``, ``Sequence`` and
``RandInt32``.

Port of ``supersonic_tpu/exprs/terminal.py`` (reference: expression/
infrastructure/terminal_expressions.h:36-71 and the typed const factories
of expression/core/).  A STRING or BINARY constant is a one-entry
dictionary whose every row holds code 0.
"""
from __future__ import annotations

import torch

from ..dictionary import Dictionary
from ..schema import Attribute
from ..types import DataType, is_variable_length, torch_dtype
from .base import BoundExpression, EvalContext, Expression, ExprValue


def _infer_type(value) -> DataType:
    if isinstance(value, bool):
        return DataType.BOOL
    if isinstance(value, int):
        return DataType.INT32 if -(2**31) <= value < 2**31 else DataType.INT64
    if isinstance(value, float):
        return DataType.DOUBLE
    if isinstance(value, str):
        return DataType.STRING
    if isinstance(value, bytes):
        return DataType.BINARY
    raise TypeError(f"cannot infer DataType for {value!r}")


def _lane_value(value, t: DataType):
    """A constant as the scalar its device lane holds (UINT64 as int64
    bits, UINT32 modulo 2^32)."""
    if t == DataType.BOOL:
        return bool(value)
    if t == DataType.UINT64:
        v = int(value) & ((1 << 64) - 1)
        return v - (1 << 64) if v >= 1 << 63 else v
    if t == DataType.UINT32:
        return int(value) & 0xFFFFFFFF
    return value


class Const(Expression):
    def __init__(self, value, type_: DataType | None = None):
        self.value = value
        self.type_ = type_ or _infer_type(value)

    def do_bind(self, schema, dicts):
        t = self.type_
        dtype = torch_dtype(t)
        dictionary = None
        if is_variable_length(t):
            dictionary = Dictionary((self.value,))
            raw = 0
        else:
            raw = _lane_value(self.value, t)

        def fn(ctx: EvalContext) -> ExprValue:
            table = ctx.table
            return ExprValue(torch.full((table.capacity,), raw, dtype=dtype,
                                        device=table.device), None)

        return BoundExpression(Attribute(str(self.value), t, nullable=False),
                               fn, dictionary, is_constant=True)


def ConstInt32(v):  return Const(v, DataType.INT32)
def ConstInt64(v):  return Const(v, DataType.INT64)
def ConstUint32(v): return Const(v, DataType.UINT32)
def ConstUint64(v): return Const(v, DataType.UINT64)
def ConstFloat(v):  return Const(v, DataType.FLOAT)
def ConstDouble(v): return Const(v, DataType.DOUBLE)
def ConstBool(v):   return Const(v, DataType.BOOL)
def ConstString(v): return Const(v, DataType.STRING)
def ConstDate(v):   return Const(v, DataType.DATE)
def ConstDateTime(v): return Const(v, DataType.DATETIME)


def ConstBinary(v):
    """reference: terminal_expressions.h ConstBinary."""
    return Const(v, DataType.BINARY)


def ConstDataType(v):
    """A DATA_TYPE-valued constant (reference: terminal_expressions.h; the
    13th DataType, held as its enum code)."""
    code = list(DataType).index(v) if isinstance(v, DataType) else int(v)
    return Const(code, DataType.DATA_TYPE)


def TypedConst(type_: DataType, value):
    """reference: terminal_expressions.h TypedConst<type>(value)."""
    return Const(value, type_)


class Null(Expression):
    """Typed all-NULL column (reference: terminal_expressions.h Null)."""

    def __init__(self, type_: DataType):
        self.type_ = type_

    def do_bind(self, schema, dicts):
        t = self.type_
        dtype = torch_dtype(t)

        def fn(ctx: EvalContext) -> ExprValue:
            table = ctx.table
            return ExprValue(
                torch.zeros(table.capacity, dtype=dtype, device=table.device),
                torch.zeros(table.capacity, dtype=torch.bool,
                            device=table.device))

        dictionary = Dictionary(()) if is_variable_length(t) else None
        return BoundExpression(Attribute("NULL", t, nullable=True), fn,
                               dictionary)


class Sequence(Expression):
    """0, 1, 2, ... per row, over the whole capacity (reference:
    terminal_expressions.h:58)."""

    def do_bind(self, schema, dicts):
        def fn(ctx: EvalContext) -> ExprValue:
            table = ctx.table
            return ExprValue(torch.arange(table.capacity, dtype=torch.int64,
                                          device=table.device), None)

        return BoundExpression(Attribute("SEQUENCE", DataType.INT64, False),
                               fn)


def seeded_generator(seed: int, device) -> torch.Generator:
    """A fresh torch generator on ``device`` seeded with ``seed``: the same
    stream on every evaluation on that device.  The streams of the CPU and
    of CUDA differ, and neither is the JAX package's threefry stream."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class RandInt32(Expression):
    """Pseudo-random int32 in [0, 2^31 - 1) per row (reference:
    terminal_expressions.h:66), deterministic per (seed, device): only the
    distribution contract matters, not the stream (the reference uses
    MTRandom, the JAX package threefry)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def do_bind(self, schema, dicts):
        seed = self.seed

        def fn(ctx: EvalContext) -> ExprValue:
            table = ctx.table
            g = seeded_generator(seed, table.device)
            return ExprValue(torch.randint(
                0, 2**31 - 1, (table.capacity,), generator=g,
                dtype=torch.int32, device=table.device), None)

        return BoundExpression(Attribute("RANDINT32", DataType.INT32, False),
                               fn)
