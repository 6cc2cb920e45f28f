"""Terminal expressions: typed constants.

Port of the ``Const`` part of ``supersonic_tpu/exprs/terminal.py``
(reference: expression/infrastructure/terminal_expressions.h:36-71).
"""
from __future__ import annotations

import torch

from ..schema import Attribute
from ..types import DataType, check_column_type, torch_dtype
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
