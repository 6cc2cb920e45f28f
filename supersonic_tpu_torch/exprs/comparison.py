"""Comparison expressions (reference: expression/core/comparison_expressions.h).

Port of the six comparisons of ``supersonic_tpu/exprs/comparison.py`` over
the port's numeric and BOOL types: both sides promote to their common
numeric type first (reference: operators.h safe cross-type compares).  A
NULL on either side gives a NULL result, which a filter counts as false.
"""
from __future__ import annotations

from ..schema import Attribute
from ..types import DataType, common_numeric_type, is_numeric, torch_dtype
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   expr_name, merge_valid, wrap)


def _comparable_pair(lb: BoundExpression, rb: BoundExpression):
    """fn(ctx) -> (a, b, valid) with a, b of one dtype."""
    lt, rt = lb.type, rb.type
    if is_numeric(lt) and is_numeric(rt):
        dt = torch_dtype(common_numeric_type(lt, rt))
    elif lt == rt == DataType.BOOL:
        dt = torch_dtype(DataType.BOOL)
    else:
        raise TypeError(f"cannot compare {lt} with {rt}")

    def get(ctx):
        lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
        return (lv.values.to(dt), rv.values.to(dt),
                merge_valid(lv.valid, rv.valid))
    return get


class _Comparison(Expression):
    op_name = "?"

    def __init__(self, left, right):
        self.left = wrap(left)
        self.right = wrap(right)

    @staticmethod
    def cmp(a, b):
        raise NotImplementedError

    def do_bind(self, schema, dicts):
        lb = self.left.do_bind(schema, dicts)
        rb = self.right.do_bind(schema, dicts)
        get = _comparable_pair(lb, rb)
        cmp = self.cmp

        def fn(ctx: EvalContext) -> ExprValue:
            a, b, valid = get(ctx)
            return ExprValue(cmp(a, b), valid)

        return BoundExpression(
            Attribute(expr_name(self.op_name, [lb, rb]), DataType.BOOL,
                      lb.nullable or rb.nullable), fn)


class Equal(_Comparison):
    op_name = "EQUAL"
    cmp = staticmethod(lambda a, b: a == b)


class NotEqual(_Comparison):
    op_name = "NOT_EQUAL"
    cmp = staticmethod(lambda a, b: a != b)


class Less(_Comparison):
    op_name = "LESS"
    cmp = staticmethod(lambda a, b: a < b)


class LessOrEqual(_Comparison):
    op_name = "LESS_OR_EQUAL"
    cmp = staticmethod(lambda a, b: a <= b)


class Greater(_Comparison):
    op_name = "GREATER"
    cmp = staticmethod(lambda a, b: a > b)


class GreaterOrEqual(_Comparison):
    op_name = "GREATER_OR_EQUAL"
    cmp = staticmethod(lambda a, b: a >= b)
