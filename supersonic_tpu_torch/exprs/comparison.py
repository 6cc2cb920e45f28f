"""Comparison expressions (reference: expression/core/comparison_expressions.h).

Port of the six comparisons of ``supersonic_tpu/exprs/comparison.py`` over
the port's numeric, BOOL, DATE, DATETIME and ENUM types: numeric sides
promote to their common numeric type first (reference: operators.h safe
cross-type compares).  STRING and BINARY comparisons are item 14.  A
NULL on either side gives a NULL result, which a filter counts as false.
"""
from __future__ import annotations

from ..schema import Attribute
from ..types import DataType, common_numeric_type, is_numeric, torch_dtype
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   expr_name, merge_valid, wrap)


def _comparable_pair(lb: BoundExpression, rb: BoundExpression):
    """fn(ctx) -> (a, b, valid) with a, b of one dtype.  An ENUM compares
    as its INT32 value number; two sides of one other type (BOOL, DATE,
    DATETIME) compare as they are, and a DATE against a DATETIME as
    microseconds."""
    lt, rt = lb.type, rb.type
    if DataType.STRING in (lt, rt) or DataType.BINARY in (lt, rt):
        raise TypeError(f"cannot compare {lt} with {rt}: STRING and BINARY "
                        "comparisons are ROADMAP.md queue 1 item 14")
    lt, rt = [DataType.INT32 if t == DataType.ENUM else t for t in (lt, rt)]
    scale = (1, 1)
    if is_numeric(lt) and is_numeric(rt):
        dt = torch_dtype(common_numeric_type(lt, rt))
    elif lt == rt:
        dt = torch_dtype(lt)
    elif {lt, rt} == {DataType.DATE, DataType.DATETIME}:
        dt = torch_dtype(DataType.DATETIME)
        day = 86_400_000_000  # DATE days as DATETIME microseconds
        scale = (day if lt == DataType.DATE else 1,
                 day if rt == DataType.DATE else 1)
    else:
        raise TypeError(f"cannot compare {lt} with {rt}")

    def get(ctx):
        lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
        a, b = lv.values.to(dt), rv.values.to(dt)
        if scale != (1, 1):
            a, b = a * scale[0], b * scale[1]
        return a, b, merge_valid(lv.valid, rv.valid)
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
