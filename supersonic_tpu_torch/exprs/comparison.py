"""Comparison expressions (reference: expression/core/comparison_expressions.h).

Port of ``supersonic_tpu/exprs/comparison.py``.  Numeric sides promote to
their common numeric type first (reference: operators.h safe cross-type
compares); UINT64 bits compare unsigned through their ``u64_key``.  STRING
and BINARY sides compare their dictionary codes, which is order-correct
since dictionaries are sorted: two sides of one dictionary compare as they
are, two of different dictionaries through bind-time remaps into their
merged dictionary (one ``take_small`` each).  A NULL on either side gives
a NULL result, which a filter counts as false.
"""
from __future__ import annotations

import torch

from ..dictionary import merge as dict_merge
from ..kernels.lut_gather import BoundLut, take_small
from ..schema import Attribute
from ..types import (DataType, common_numeric_type, convert, is_numeric,
                     torch_dtype, u64_key)
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   expr_name, merge_valid, wrap)

_STRINGS = (DataType.STRING, DataType.BINARY)
US_PER_DAY = 86_400_000_000


def _comparable_pair(lb: BoundExpression, rb: BoundExpression):
    """fn(ctx) -> (a, b, valid) with a, b of one dtype whose signed order is
    the values' order.  An ENUM compares as its INT32 value number; two
    sides of one other type (BOOL, DATE, DATETIME) compare as they are, and
    a DATE against a DATETIME as microseconds."""
    lt, rt = lb.type, rb.type
    if lt in _STRINGS or rt in _STRINGS:
        if lt != rt:
            raise TypeError(f"cannot compare {lt} with {rt}")
        if lb.dictionary is not None and lb.dictionary is rb.dictionary:
            def get(ctx):
                lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
                return lv.values, rv.values, merge_valid(lv.valid, rv.valid)
            return get
        if lb.dictionary is None or rb.dictionary is None:
            raise TypeError("string comparison requires bound dictionaries")
        _, ra, rbm = dict_merge(lb.dictionary, rb.dictionary)
        ra, rbm = BoundLut(ra), BoundLut(rbm)

        def get(ctx):
            lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
            return (take_small(ra, lv.values), take_small(rbm, rv.values),
                    merge_valid(lv.valid, rv.valid))
        return get
    lt, rt = [DataType.INT32 if t == DataType.ENUM else t for t in (lt, rt)]
    scale = (1, 1)
    if is_numeric(lt) and is_numeric(rt):
        common = common_numeric_type(lt, rt)
    elif lt == rt:
        common = lt
    elif {lt, rt} == {DataType.DATE, DataType.DATETIME}:
        common = DataType.DATETIME
        scale = (US_PER_DAY if lt == DataType.DATE else 1,
                 US_PER_DAY if rt == DataType.DATE else 1)
    else:
        raise TypeError(f"cannot compare {lt} with {rt}")
    dt = torch_dtype(common)
    unsigned = common == DataType.UINT64

    def get(ctx):
        lv, rv = lb.evaluate(ctx), rb.evaluate(ctx)
        a = convert(lv.values, lt, common) if is_numeric(lt) \
            else lv.values.to(dt)
        b = convert(rv.values, rt, common) if is_numeric(rt) \
            else rv.values.to(dt)
        if scale != (1, 1):
            a, b = a * scale[0], b * scale[1]
        if unsigned:
            a, b = u64_key(a), u64_key(b)
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


class In(Expression):
    """needle IN (candidates...) (reference: comparison_expressions.h:88),
    SQL's three values: TRUE if a candidate equals the needle; else NULL if
    the needle or a candidate is NULL; else FALSE."""

    def __init__(self, needle, *candidates):
        self.needle = wrap(needle)
        self.candidates = [wrap(c) for c in candidates]

    def do_bind(self, schema, dicts):
        nb = self.needle.do_bind(schema, dicts)
        cbs = [c.do_bind(schema, dicts) for c in self.candidates]
        getters = [_comparable_pair(nb, cb) for cb in cbs]
        nullable = nb.nullable or any(c.nullable for c in cbs)

        def fn(ctx: EvalContext) -> ExprValue:
            cap = ctx.table.capacity
            dev = ctx.table.device
            matched = torch.zeros(cap, dtype=torch.bool, device=dev)
            null_candidate = torch.zeros(cap, dtype=torch.bool, device=dev)
            for get, cb in zip(getters, cbs):
                a, b, _ = get(ctx)
                cv = cb.evaluate(ctx)
                eq = a == b
                if cv.valid is not None:
                    matched = matched | (eq & cv.valid)
                    null_candidate = null_candidate | ~cv.valid
                else:
                    matched = matched | eq
            if not nullable:
                return ExprValue(matched, None)
            valid = matched | ~null_candidate
            needle_valid = nb.evaluate(ctx).valid
            if needle_valid is not None:
                valid = valid & needle_valid
            return ExprValue(matched, valid)

        return BoundExpression(Attribute(f"IN({nb.name})", DataType.BOOL,
                                         nullable), fn)


def _parity(op_name: str, odd: bool):
    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)

            def fn(ctx):
                v = cb.evaluate(ctx)
                x = v.values
                # the low bit; a float takes C's fmod, as jnp's % of 2 does
                # for the values that matter (a zero remainder is even)
                r = (torch.fmod(x, 2) != 0) if x.is_floating_point() \
                    else (x.to(torch.int64) & 1) != 0
                return ExprValue(r if odd else ~r, v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", DataType.BOOL,
                          cb.nullable), fn)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


IsOdd = _parity("IS_ODD", True)
IsEven = _parity("IS_EVEN", False)
