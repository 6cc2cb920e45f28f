"""Regexp expressions (reference: expression/core/regexp_expressions.h,
RE2-backed RegexpPartialMatch / RegexpFullMatch / RegexpExtract /
RegexpReplace).

Port of ``supersonic_tpu/exprs/regexp.py``: the pattern is a bind-time
constant, so each is a host pass of Python ``re`` over the DICTIONARY
producing a property or remap LUT, and evaluation is one gather
(``take_small``).  Python ``re`` and RE2 agree on the constructs the
reference's tests use; RE2's linear-time guarantee only bears on bind time
here.
"""
from __future__ import annotations

import re

import numpy as np

from ..dictionary import transform
from ..kernels.lut_gather import BoundLut, take_small
from ..schema import Attribute
from ..types import DataType
from .base import BoundExpression, Expression, ExprValue, merge_valid, wrap
from .string import (_dict_transform_expr, _property_expr, _require_string,
                     _resolve_const)


def _compile(pattern):
    return re.compile(_resolve_const(pattern, "REGEXP pattern"))


class RegexpPartialMatch(Expression):
    """TRUE if the pattern matches anywhere in the string."""

    def __init__(self, child, pattern):
        self.child = child
        self.pattern = _compile(pattern)

    def do_bind(self, schema, dicts):
        pat = self.pattern
        return _property_expr(
            "REGEXP_PARTIAL_MATCH", lambda s: pat.search(s) is not None,
            DataType.BOOL, np.bool_)(self.child).do_bind(schema, dicts)


class RegexpFullMatch(Expression):
    def __init__(self, child, pattern):
        self.child = child
        self.pattern = _compile(pattern)

    def do_bind(self, schema, dicts):
        pat = self.pattern
        return _property_expr(
            "REGEXP_FULL_MATCH", lambda s: pat.fullmatch(s) is not None,
            DataType.BOOL, np.bool_)(self.child).do_bind(schema, dicts)


class RegexpReplace(Expression):
    """Every match replaced by the substitute (reference: RegexpReplace)."""

    def __init__(self, child, pattern, substitute):
        self.child = child
        self.pattern = _compile(pattern)
        self.substitute = _resolve_const(substitute, "REGEXP substitute")

    def do_bind(self, schema, dicts):
        pat, sub = self.pattern, self.substitute
        return _dict_transform_expr(
            "REGEXP_REPLACE", lambda s: pat.sub(sub, s)
        )(self.child).do_bind(schema, dicts)


class RegexpExtract(Expression):
    """The first capture group of the first match (the whole match without
    a group); NULL without a match (reference: RegexpExtract is nulling)."""

    def __init__(self, child, pattern):
        self.child = child
        self.pattern = _compile(pattern)

    def do_bind(self, schema, dicts):
        cb = wrap(self.child).do_bind(schema, dicts)
        d = _require_string(cb, "REGEXP_EXTRACT")
        pat = self.pattern

        def extract(s):
            m = pat.search(s)
            if m is None:
                return None
            return m.group(1) if pat.groups else m.group(0)

        extracted = [extract(v) for v in d.values]
        nd, remap = transform(d, lambda v: extract(v) or "")
        ok = np.array([e is not None for e in extracted], dtype=bool)
        lut = BoundLut(remap)
        lut_ok = BoundLut(ok if ok.size else np.zeros(1, dtype=bool))

        def fn(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(take_small(lut, v.values),
                             merge_valid(v.valid, take_small(lut_ok,
                                                             v.values)))

        return BoundExpression(
            Attribute(f"REGEXP_EXTRACT({cb.name})", cb.type, True), fn, nd)
