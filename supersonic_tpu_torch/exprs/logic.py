"""Ternary (three-valued) boolean logic and the bitwise operators.

Port of ``supersonic_tpu/exprs/logic.py`` (reference: expression/core/
elementary_expressions.h:47-60); the bitwise operators over UINT32 wrap
modulo 2^32 and a UINT64 right shift is logical:
  AND: FALSE & NULL = FALSE,  TRUE & NULL = NULL
  OR : TRUE | NULL = TRUE,    FALSE | NULL = NULL
  XOR/NOT: NULL if any input NULL.
Both sides are always evaluated; the results are those of short-circuiting,
since evaluation order is unobservable.
"""
from __future__ import annotations

from ..schema import Attribute
from ..types import DataType, common_numeric_type, convert, u64_shr, wrap_u32
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   expr_name, merge_valid, wrap)


def _require_bool(b: BoundExpression, op: str):
    if b.type != DataType.BOOL:
        raise TypeError(f"{op} requires BOOL, got {b.type} ({b.name})")


class _BinaryLogic(Expression):
    op_name = "?"

    def __init__(self, left, right):
        self.left = wrap(left)
        self.right = wrap(right)

    @staticmethod
    def combine(a, av, b, bv):
        """(value, valid) of the ternary op given (value, valid) pairs."""
        raise NotImplementedError

    def do_bind(self, schema, dicts):
        lb = self.left.do_bind(schema, dicts)
        rb = self.right.do_bind(schema, dicts)
        _require_bool(lb, self.op_name)
        _require_bool(rb, self.op_name)
        name = expr_name(self.op_name, [lb, rb])
        combine = self.combine
        nullable = lb.nullable or rb.nullable

        def fn(ctx: EvalContext) -> ExprValue:
            lv = lb.evaluate(ctx)
            rv = rb.evaluate(ctx)
            value, valid = combine(lv.values, lv.valid_or_true(),
                                   rv.values, rv.valid_or_true())
            return ExprValue(value, valid if nullable else None)

        return BoundExpression(Attribute(name, DataType.BOOL, nullable), fn)


class And(_BinaryLogic):
    op_name = "AND"

    @staticmethod
    def combine(a, av, b, bv):
        value = (a & av) & (b & bv)
        # valid unless (NULL and the other side isn't FALSE)
        false_a = av & ~a
        false_b = bv & ~b
        valid = (av & bv) | false_a | false_b
        return value, valid


class Or(_BinaryLogic):
    op_name = "OR"

    @staticmethod
    def combine(a, av, b, bv):
        true_a = av & a
        true_b = bv & b
        value = true_a | true_b
        valid = (av & bv) | true_a | true_b
        return value, valid


class Xor(_BinaryLogic):
    op_name = "XOR"

    @staticmethod
    def combine(a, av, b, bv):
        return a ^ b, av & bv


class AndNot(_BinaryLogic):
    """!a && b (reference: AND_NOT)."""
    op_name = "AND_NOT"

    @staticmethod
    def combine(a, av, b, bv):
        value = (~a & av) & (b & bv)
        false_na = av & a        # NOT a is FALSE
        false_b = bv & ~b
        valid = (av & bv) | false_na | false_b
        return value, valid


class Not(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        _require_bool(cb, "NOT")

        def fn(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            return ExprValue(~v.values, v.valid)

        return BoundExpression(
            Attribute(f"NOT({cb.name})", DataType.BOOL, cb.nullable), fn)


# Bitwise variants over integers (reference: BITWISE_AND etc.)
class _BinaryBitwise(Expression):
    op_name = "?"

    def __init__(self, left, right):
        self.left = wrap(left)
        self.right = wrap(right)

    @staticmethod
    def op(a, b):
        raise NotImplementedError

    @classmethod
    def op_u64(cls, a, b):
        """``op`` over UINT64 bits (the same but for a right shift)."""
        return cls.op(a, b)

    def do_bind(self, schema, dicts):
        lb = self.left.do_bind(schema, dicts)
        rb = self.right.do_bind(schema, dicts)
        common = common_numeric_type(lb.type, rb.type)
        op = self.op_u64 if common == DataType.UINT64 else self.op
        name = expr_name(self.op_name, [lb, rb])

        def fn(ctx: EvalContext) -> ExprValue:
            lv = lb.evaluate(ctx)
            rv = rb.evaluate(ctx)
            out = op(convert(lv.values, lb.type, common),
                     convert(rv.values, rb.type, common))
            if common == DataType.UINT32:
                out = wrap_u32(out)  # a left shift past bit 31
            return ExprValue(out, merge_valid(lv.valid, rv.valid))

        return BoundExpression(
            Attribute(name, common, lb.nullable or rb.nullable), fn)


class BitwiseAnd(_BinaryBitwise):
    op_name = "BITWISE_AND"
    op = staticmethod(lambda a, b: a & b)


class BitwiseOr(_BinaryBitwise):
    op_name = "BITWISE_OR"
    op = staticmethod(lambda a, b: a | b)


class BitwiseXor(_BinaryBitwise):
    op_name = "BITWISE_XOR"
    op = staticmethod(lambda a, b: a ^ b)


class ShiftLeft(_BinaryBitwise):
    op_name = "SHIFT_LEFT"
    op = staticmethod(lambda a, b: a << b)


class ShiftRight(_BinaryBitwise):
    op_name = "SHIFT_RIGHT"
    op = staticmethod(lambda a, b: a >> b)

    @classmethod
    def op_u64(cls, a, b):
        return u64_shr(a, b)  # logical, as the JAX package's uint64


class BitwiseNot(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        u32 = cb.type == DataType.UINT32

        def fn(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            return ExprValue(wrap_u32(~v.values) if u32 else ~v.values,
                             v.valid)

        return BoundExpression(
            Attribute(f"BITWISE_NOT({cb.name})", cb.type, cb.nullable), fn)


class BitwiseAndNot(_BinaryBitwise):
    """a & ~b (reference: OPERATOR_BITWISE_ANDNOT, operators.h AndNot)."""

    op_name = "BITWISE_AND_NOT"
    op = staticmethod(lambda a, b: a & ~b)
