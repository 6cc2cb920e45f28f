"""Terminal expressions: typed constants, ``Null`` and ``Sequence``.

Port of ``Const``, ``Null`` and ``Sequence`` from
``supersonic_tpu/exprs/terminal.py`` (reference: expression/infrastructure/
terminal_expressions.h:36-71).
"""
from __future__ import annotations

import torch

from ..dictionary import Dictionary
from ..schema import Attribute
from ..types import (DataType, check_column_type,
                     is_variable_length, torch_dtype)
from .base import BoundExpression, EvalContext, Expression, ExprValue


def _infer_type(value) -> DataType:
    if isinstance(value, bool):
        return DataType.BOOL
    if isinstance(value, int):
        return DataType.INT32 if -(2**31) <= value < 2**31 else DataType.INT64
    if isinstance(value, float):
        return DataType.DOUBLE
    raise NotImplementedError(
        f"constant {value!r}: only INT32, INT64, FLOAT, DOUBLE and BOOL are "
        "ported (ROADMAP.md queue 1 item 14)")


class Const(Expression):
    def __init__(self, value, type_: DataType | None = None):
        self.value = value
        self.type_ = type_ or _infer_type(value)

    def do_bind(self, schema, dicts):
        t = self.type_
        check_column_type(t)
        if is_variable_length(t):
            raise NotImplementedError(
                f"{t.value} constants are not ported yet (ROADMAP.md queue 1 "
                "item 14)")
        dtype = torch_dtype(t)
        raw = bool(self.value) if t == DataType.BOOL else self.value

        def fn(ctx: EvalContext) -> ExprValue:
            table = ctx.table
            return ExprValue(torch.full((table.capacity,), raw, dtype=dtype,
                                        device=table.device), None)

        return BoundExpression(Attribute(str(self.value), t, nullable=False),
                               fn, None, is_constant=True)


def ConstInt32(v):  return Const(v, DataType.INT32)
def ConstInt64(v):  return Const(v, DataType.INT64)
def ConstFloat(v):  return Const(v, DataType.FLOAT)
def ConstDouble(v): return Const(v, DataType.DOUBLE)
def ConstBool(v):   return Const(v, DataType.BOOL)


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
