"""Arithmetic expressions (reference: expression/core/arithmetic_expressions.h).

Port of ``supersonic_tpu/exprs/arithmetic.py``.  Division and modulus come
in the reference's error policies:
  * Signaling: a division by zero fails the evaluation (a device error
    flag, read at the host sync).
  * Nulling: offending rows become NULL.
  * Quiet: offending rows hold garbage (but the computation is safe).
Integer division truncates toward zero, as C++ does.  No row can trap: a
zero divisor and ``INT_MIN / -1`` never reach the division, and every row
gets the value the JAX package gives it (``INT_MIN / -1`` is ``INT_MIN``,
``INT_MIN % -1`` is 0).  A UINT32 result wraps modulo 2^32 and UINT64
division and modulus are unsigned (types.py carries both in int64 lanes).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..schema import Attribute
from ..types import (DataType, common_numeric_type, convert, is_integer,
                     u64_divmod, wrap_u32)
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   expr_name, fold_constants, merge_valid, wrap)


class _BinaryNumeric(Expression):
    op_name = "?"
    result_type_fn: Callable | None = None  # (common) -> result type

    def __init__(self, left, right):
        self.left = wrap(left)
        self.right = wrap(right)

    def compute(self, a: torch.Tensor, b: torch.Tensor, ctx: EvalContext,
                valid, result_type: DataType):
        """Returns (values, extra_valid_or_None)."""
        raise NotImplementedError

    def do_bind(self, schema, dicts):
        lb = self.left.do_bind(schema, dicts)
        rb = self.right.do_bind(schema, dicts)
        common = common_numeric_type(lb.type, rb.type)
        result_type = (self.result_type_fn(common)
                       if self.result_type_fn else common)
        name = expr_name(self.op_name, [lb, rb])
        outer = self

        def fn(ctx: EvalContext) -> ExprValue:
            lv = lb.evaluate(ctx)
            rv = rb.evaluate(ctx)
            a = convert(lv.values, lb.type, result_type)
            b = convert(rv.values, rb.type, result_type)
            valid = merge_valid(lv.valid, rv.valid)
            values, extra_valid = outer.compute(a, b, ctx, valid, result_type)
            if result_type == DataType.UINT32:
                values = wrap_u32(values)
            return ExprValue(values, merge_valid(valid, extra_valid))

        nullable = lb.nullable or rb.nullable or self._adds_nulls()
        return fold_constants(
            BoundExpression(Attribute(name, result_type, nullable), fn),
            [lb, rb])

    def _adds_nulls(self) -> bool:
        return False


class Plus(_BinaryNumeric):
    op_name = "ADD"
    def compute(self, a, b, ctx, valid, rt):
        return a + b, None


class Minus(_BinaryNumeric):
    op_name = "SUBTRACT"
    def compute(self, a, b, ctx, valid, rt):
        return a - b, None


class Multiply(_BinaryNumeric):
    op_name = "MULTIPLY"
    def compute(self, a, b, ctx, valid, rt):
        return a * b, None


def _to_double(_common: DataType) -> DataType:
    return DataType.DOUBLE


class DivideSignaling(_BinaryNumeric):
    """Real division -> DOUBLE; fails on divisor == 0 (reference:
    DIVIDE_SIGNALING)."""
    op_name = "DIVIDE_SIGNALING"
    result_type_fn = staticmethod(_to_double)

    def compute(self, a, b, ctx, valid, rt):
        zero = b == 0
        ctx.flag_error("division by zero",
                       zero if valid is None else (zero & valid))
        return a / torch.where(zero, 1.0, b), None


class DivideNulling(_BinaryNumeric):
    op_name = "DIVIDE_NULLING"
    result_type_fn = staticmethod(_to_double)

    def compute(self, a, b, ctx, valid, rt):
        zero = b == 0
        return a / torch.where(zero, 1.0, b), ~zero

    def _adds_nulls(self):
        return True


class DivideQuiet(_BinaryNumeric):
    op_name = "DIVIDE_QUIET"
    result_type_fn = staticmethod(_to_double)

    def compute(self, a, b, ctx, valid, rt):
        return a / b, None  # float division: inf/nan are the 'garbage'


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C++ ``a / b`` on integers for a nonzero ``b``, without a trap: a -1
    divisor negates (wrapping, so ``INT_MIN / -1`` is ``INT_MIN``)."""
    neg1 = b == -1
    q = torch.div(a, torch.where(neg1, 1, b), rounding_mode="trunc")
    return torch.where(neg1, -a, q)


class _IntSafeDiv:
    @staticmethod
    def div(a, b, integer: bool, u64: bool = False):
        """(quotient, zero divisor): the JAX package's values row for row,
        a zero divisor included (0, or 1 for a negative signed dividend);
        ``u64``: UINT64 bits, divided unsigned."""
        zero = b == 0
        if u64:
            q = u64_divmod(a, torch.where(zero, 1, b))[0]
            return torch.where(zero, 0, q), zero
        if integer:
            q = _trunc_div(a, torch.where(zero, 1, b))
            return torch.where(zero, (a < 0).to(q.dtype), q), zero
        return a / torch.where(zero, 1.0, b), zero


class CppDivideSignaling(_BinaryNumeric):
    """C++ '/' semantics: integer division on ints (reference: CPP_DIVIDE)."""
    op_name = "CPP_DIVIDE_SIGNALING"

    def compute(self, a, b, ctx, valid, rt):
        q, zero = _IntSafeDiv.div(a, b, is_integer(rt),
                                  rt == DataType.UINT64)
        ctx.flag_error("division by zero",
                       zero if valid is None else (zero & valid))
        return q, None


class CppDivideNulling(_BinaryNumeric):
    op_name = "CPP_DIVIDE_NULLING"

    def compute(self, a, b, ctx, valid, rt):
        q, zero = _IntSafeDiv.div(a, b, is_integer(rt),
                                  rt == DataType.UINT64)
        return q, ~zero

    def _adds_nulls(self):
        return True


def _cpp_mod(a, b, rt: DataType):
    """(C++ ``a % b`` with 1 in place of a zero divisor, zero divisor)."""
    zero = b == 0
    safe = torch.where(zero, 1, b)
    if rt == DataType.UINT64:
        return u64_divmod(a, safe)[1], zero
    return a - _trunc_div(a, safe) * safe, zero


class ModulusSignaling(_BinaryNumeric):
    """C++ '%' (truncated) modulus (reference: MODULUS_SIGNALING)."""
    op_name = "MODULUS_SIGNALING"

    def compute(self, a, b, ctx, valid, rt):
        r, zero = _cpp_mod(a, b, rt)
        ctx.flag_error("modulus by zero",
                       zero if valid is None else (zero & valid))
        return r, None


class ModulusNulling(_BinaryNumeric):
    op_name = "MODULUS_NULLING"

    def compute(self, a, b, ctx, valid, rt):
        r, zero = _cpp_mod(a, b, rt)
        return r, ~zero

    def _adds_nulls(self):
        return True


# Default aliases matching the reference's default policy choices.
Divide = DivideSignaling
CppDivide = CppDivideSignaling
Modulus = ModulusSignaling


class Negate(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        t = cb.type
        if t in (DataType.UINT32, DataType.UINT64):
            t = DataType.INT64

        def fn(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            return ExprValue(-convert(v.values, cb.type, t), v.valid)

        return fold_constants(BoundExpression(
            Attribute(f"NEGATE({cb.name})", t, cb.nullable), fn), [cb])


CppDivideQuiet = CppDivide  # reference: OPERATOR_CPP_DIVIDE_QUIET
