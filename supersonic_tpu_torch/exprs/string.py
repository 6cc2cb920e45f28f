"""String expressions over dictionary-encoded columns.

Port of ``supersonic_tpu/exprs/string.py`` (reference: expression/core/
string_expressions.h: Length, the Trim family, ToUpper/ToLower, Substring,
Concat, StringOffset, StringReplace, ...).  The device sees int32 codes:
each per-value string function runs once over the DICTIONARY on the host
at bind, and evaluation is one gather (``take_small``) through the
resulting remap or property LUT, uploaded once.  Two non-constant string
inputs combine through a cross-product table of their dictionaries, built
at bind under a size budget.  ``ToString`` of an unbounded numeric column
renders per row after the run (``DeferredRender``).
"""
from __future__ import annotations

import datetime
from typing import Callable, Optional

import numpy as np
import torch

from ..dictionary import (CrossSizeError, DeferredDictionary, Dictionary,
                          cross, property_lut, transform)
from ..kernels.lut_gather import BoundLut, take_small
from ..schema import Attribute
from ..types import DataType, TypeError_, to_carrier
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   defer_render, merge_valid, wrap)
from .terminal import Const

_STRINGS = (DataType.STRING, DataType.BINARY)


def _require_string(b: BoundExpression, op: str) -> Dictionary:
    if b.type not in _STRINGS:
        raise TypeError_(f"{op} requires STRING input, got {b.type}")
    if b.dictionary is None:
        raise TypeError_(f"{op}: input has no bound dictionary")
    return b.dictionary


def _dict_transform_expr(op_name: str, fn: Callable):
    """Unary string -> string op as a bind-time dictionary transform."""

    class _Op(Expression):
        def __init__(self, child, *args):
            self.child = wrap(child)
            self.args = args

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            d = _require_string(cb, op_name)
            f = (lambda v: fn(v, *self.args)) if self.args else fn
            nd, remap = transform(d, f)
            lut = BoundLut(remap)

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                return ExprValue(take_small(lut, v.values), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", cb.type, cb.nullable),
                g, nd)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


ToUpper = _dict_transform_expr("TO_UPPER", lambda s: s.upper())
ToLower = _dict_transform_expr("TO_LOWER", lambda s: s.lower())
Ltrim = _dict_transform_expr("LTRIM", lambda s: s.lstrip())
Rtrim = _dict_transform_expr("RTRIM", lambda s: s.rstrip())
Trim = _dict_transform_expr("TRIM", lambda s: s.strip())


def _property_expr(op_name: str, fn: Callable, out_type: DataType, np_dtype):
    """Unary string -> scalar op as a property LUT gather."""

    class _Op(Expression):
        def __init__(self, child, *args):
            self.child = wrap(child)
            self.args = args

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            d = _require_string(cb, op_name)
            f = (lambda v: fn(v, *self.args)) if self.args else fn
            lut = BoundLut(to_carrier(property_lut(d, f, np_dtype), out_type))

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                return ExprValue(take_small(lut, v.values), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", out_type, cb.nullable), g)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


Length = _property_expr("LENGTH", len, DataType.UINT32, np.uint32)


def _resolve_const(expr, name: str):
    e = wrap(expr)
    if not isinstance(e, Const):
        raise TypeError_(
            f"{name} argument must be a constant (dictionary transforms "
            "are bind-time; see module docstring)")
    return e.value


class Substring(Expression):
    """SUBSTRING(str, pos[, len]): 1-based ``pos``, negative from the end,
    as the reference; ``pos`` and ``len`` are constants."""

    def __init__(self, child, pos, length=None):
        self.child = wrap(child)
        self.pos = _resolve_const(pos, "SUBSTRING pos")
        self.length = None if length is None else _resolve_const(
            length, "SUBSTRING len")

    def do_bind(self, schema, dicts):
        pos, length = self.pos, self.length

        def sub(s):
            n = len(s)
            if pos > 0:
                start = pos - 1
            elif pos < 0:
                start = max(n + pos, 0)
            else:
                return s[:0]
            end = n if length is None else min(start + max(length, 0), n)
            return s[start:end]

        return _dict_transform_expr("SUBSTRING", sub)(self.child).do_bind(
            schema, dicts)


SubstringSignaling = Substring  # reference: OPERATOR_SUBSTRING_SIGNALING


def TrailingSubstring(child, pos):
    """SUBSTRING(str, pos) to the end of the string (reference:
    string_expressions.cc:132 BoundTrailingSubstring)."""
    return Substring(child, pos)


PAIR_CROSS_MAX = 1 << 20


def _pair_index(ctx, ab, bb, na: int, nb: int):
    """(row's index into an |a| x |b| pair table, merged validity)."""
    va = ab.evaluate(ctx)
    vb = bb.evaluate(ctx)
    idx = va.values.clamp(0, na - 1) * nb + vb.values.clamp(0, nb - 1)
    return idx.to(torch.int32), merge_valid(va.valid, vb.valid)


def _pair_property_expr(op_name: str, fn: Callable, out_type: DataType,
                        np_dtype):
    """Binary (string, string) -> scalar op over two non-constant columns:
    the |da| x |db| table is computed on the host at bind, evaluation is
    one gather; budget-guarded like ``dictionary.cross``."""

    class _Op(Expression):
        def __init__(self, a, b):
            self.a = wrap(a)
            self.b = wrap(b)

        def do_bind(self, schema, dicts):
            ab = self.a.do_bind(schema, dicts)
            bb = self.b.do_bind(schema, dicts)
            da = _require_string(ab, op_name)
            db = _require_string(bb, op_name)
            na, nb = max(len(da), 1), max(len(db), 1)
            if na * nb > PAIR_CROSS_MAX:
                raise TypeError_(
                    f"{op_name}: pair table {len(da)}x{len(db)} exceeds "
                    f"budget {PAIR_CROSS_MAX}; materialize and re-encode")
            av = da.values or ("",)
            bv = db.values or ("",)
            lut_np = np.empty(na * nb, dtype=np_dtype)
            for i, x in enumerate(av):
                for j, y in enumerate(bv):
                    lut_np[i * nb + j] = fn(x, y)
            lut = BoundLut(to_carrier(lut_np, out_type))

            def g(ctx: EvalContext) -> ExprValue:
                idx, valid = _pair_index(ctx, ab, bb, na, nb)
                return ExprValue(take_small(lut, idx), valid)

            return BoundExpression(
                Attribute(f"{op_name}({ab.name}, {bb.name})", out_type,
                          ab.nullable or bb.nullable), g)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


class StringReplace(Expression):
    """STRING_REPLACE(haystack, needle, substitute): the needle may be a
    column (a pair cross dictionary); the substitute is a constant."""

    def __init__(self, haystack, needle, substitute):
        self.haystack = wrap(haystack)
        self.needle = wrap(needle)
        self.substitute = _resolve_const(substitute, "STRING_REPLACE sub")

    def do_bind(self, schema, dicts):
        sub = self.substitute
        if isinstance(self.needle, Const):
            needle = self.needle.value
            return _dict_transform_expr(
                "STRING_REPLACE", lambda s: s.replace(needle, sub)
            )(self.haystack).do_bind(schema, dicts)
        hb = self.haystack.do_bind(schema, dicts)
        nb_ = self.needle.do_bind(schema, dicts)
        dh = _require_string(hb, "STRING_REPLACE")
        dn = _require_string(nb_, "STRING_REPLACE")
        try:
            nd, lut_np = cross(dh, dn,
                               fn=lambda s, n: s.replace(n, sub) if n else s,
                               max_size=PAIR_CROSS_MAX)
        except CrossSizeError as e:
            raise TypeError_(f"STRING_REPLACE: {e}") from None
        lut = BoundLut(lut_np)
        lh, ln = max(len(dh), 1), max(len(dn), 1)

        def g(ctx: EvalContext) -> ExprValue:
            idx, valid = _pair_index(ctx, hb, nb_, lh, ln)
            return ExprValue(take_small(lut, idx), valid)

        return BoundExpression(
            Attribute(f"STRING_REPLACE({hb.name}, {nb_.name})", hb.type,
                      hb.nullable or nb_.nullable), g, nd)


def _needle_expr(op_name: str, one: Callable, pair: Callable,
                 out_type: DataType, np_dtype):
    """An op of (haystack, needle): a property LUT for a constant needle,
    a pair table for a needle column."""

    class _Op(Expression):
        def __init__(self, haystack, needle):
            self.haystack = wrap(haystack)
            self.needle = wrap(needle)

        def do_bind(self, schema, dicts):
            if isinstance(self.needle, Const):
                needle = self.needle.value
                return _property_expr(
                    op_name, lambda s: one(s, needle), out_type, np_dtype
                )(self.haystack).do_bind(schema, dicts)
            return _pair_property_expr(op_name, pair, out_type, np_dtype)(
                self.haystack, self.needle).do_bind(schema, dicts)

    return _Op


# STRING_OFFSET: 1-based position, 0 if absent (reference: StringOffset)
StringOffset = _needle_expr("STRING_OFFSET", lambda s, n: s.find(n) + 1,
                            lambda s, n: s.find(n) + 1, DataType.INT32,
                            np.int32)
StringOffset.__name__ = "StringOffset"
StringContains = _needle_expr("CONTAINS", lambda s, n: n in s,
                              lambda s, n: n in s, DataType.BOOL, np.bool_)
StringContains.__name__ = "StringContains"
# case-insensitive CONTAINS (reference: string_expressions.h:94-98, both
# sides lowercased)
StringContainsCI = _needle_expr(
    "CONTAINS_CI", lambda s, n: str(n).lower() in s.lower(),
    lambda s, n: n.lower() in s.lower(), DataType.BOOL, np.bool_)
StringContainsCI.__name__ = "StringContainsCI"


class Concat(Expression):
    """CONCAT(args...): variadic string concatenation (reference:
    string_bound_expressions.cc BoundConcatExpression; NULL iff an input is
    NULL).  Non-constant pieces combine left to right through cross-product
    dictionaries built at bind (``dictionary.cross``), one gather each;
    constant pieces fold into the neighbouring transform.  A cross product
    past ``CROSS_MAX`` entries has no dense encoding and bind fails,
    pointing at ops/host.py::concat_columns."""

    CROSS_MAX = 1 << 20

    def __init__(self, *args):
        self.args = [wrap(a) for a in args]

    def do_bind(self, schema, dicts):
        bounds = [a.do_bind(schema, dicts) for a in self.args]

        def const_text(i: int):
            v = self.args[i].value if isinstance(self.args[i], Const) \
                else None
            if v is None:
                raise TypeError_("CONCAT constant argument must be Const")
            if isinstance(v, bool):
                return "true" if v else "false"
            return v if isinstance(v, (str, bytes)) else str(v)

        var_idx = [i for i, b in enumerate(bounds) if not b.is_constant]
        for i in var_idx:
            if bounds[i].type not in _STRINGS:
                raise TypeError_(
                    "CONCAT of a non-constant numeric column requires "
                    "ToString (no dense device encoding)")
            _require_string(bounds[i], "CONCAT")
        if not var_idx:
            return Const("".join(const_text(i) for i in range(len(bounds)))
                         ).do_bind(schema, dicts)

        is_bytes = bounds[var_idx[0]].type == DataType.BINARY

        def norm(t):
            if is_bytes and isinstance(t, str):
                return t.encode()
            if not is_bytes and isinstance(t, bytes):
                return t.decode()
            return t

        empty = b"" if is_bytes else ""
        # fold the pieces left to right: (dictionary, eval) of the prefix;
        # constant text waits in ``pending`` for the next transform or cross
        state_dict = state_eval = None
        nullable = False
        pending = empty
        for i, b in enumerate(bounds):
            if b.is_constant:
                pending = pending + norm(const_text(i))
                continue
            d = b.dictionary
            if state_dict is None:
                if pending != empty:
                    nd, remap = transform(d, lambda s, pre=pending: pre + s)
                    lut = BoundLut(remap)

                    def ev(ctx, b=b, lut=lut):
                        v = b.evaluate(ctx)
                        return take_small(lut, v.values), v.valid

                    state_dict, state_eval = nd, ev
                else:
                    def ev(ctx, b=b):
                        v = b.evaluate(ctx)
                        return v.values, v.valid

                    state_dict, state_eval = d, ev
            else:
                try:
                    nd, lut_np = cross(
                        state_dict, d,
                        fn=lambda x, y, sep=pending: x + sep + y,
                        max_size=self.CROSS_MAX)
                except CrossSizeError as e:
                    raise TypeError_(
                        f"CONCAT: {e}; materialize and re-encode via "
                        "ops/host.py::concat_columns") from None
                lut = BoundLut(lut_np)

                def ev(ctx, prev=state_eval, b=b, lut=lut,
                       lb=max(len(d), 1), sd=max(len(state_dict), 1)):
                    pc, pv = prev(ctx)
                    v = b.evaluate(ctx)
                    idx = (pc.clamp(0, sd - 1) * lb
                           + v.values.clamp(0, lb - 1)).to(torch.int32)
                    return take_small(lut, idx), merge_valid(pv, v.valid)

                state_dict, state_eval = nd, ev
            nullable = nullable or b.nullable
            pending = empty
        if pending != empty:
            nd, remap = transform(state_dict, lambda s, post=pending: s + post)
            lut = BoundLut(remap)

            def ev(ctx, prev=state_eval, lut=lut):
                c, v = prev(ctx)
                return take_small(lut, c), v

            state_dict, state_eval = nd, ev

        final_eval = state_eval

        def g(ctx: EvalContext) -> ExprValue:
            c, v = final_eval(ctx)
            return ExprValue(c, v)

        name = f"CONCAT({', '.join(b.name for b in bounds)})"
        return BoundExpression(
            Attribute(name, DataType.BINARY if is_bytes else DataType.STRING,
                      nullable), g, state_dict)


Concatenate = Concat  # reference: OPERATOR_CONCATENATE


def ConcatWithSeparator(separator: str, *args):
    """CONCAT with a separator between the arguments (reference:
    string_expressions.h:36-41, declared there but not implemented):
    ``Concat`` with interleaved constants, the same NULL semantics."""
    parts = []
    for i, a in enumerate(args):
        if i:
            parts.append(Const(separator))
        parts.append(a)
    return Concat(*parts)


_INT_TYPES = (DataType.INT32, DataType.INT64, DataType.UINT32,
              DataType.UINT64, DataType.DATE, DataType.DATETIME)


class ToString(Expression):
    """TOSTRING (reference: string_expressions.h:29; printer formats of
    types_infrastructure.cc:45-110: integers in decimal, BOOL "TRUE" /
    "FALSE", DATE "%Y/%m/%d", DATETIME "%Y/%m/%d-%H:%M:%S").

    STRING/BINARY pass through; ENUM and BOOL take a fixed dictionary; an
    integer, DATE or DATETIME column with ``domain=(lo, hi)`` (inclusive)
    takes a dictionary built at bind and one gather, and a live row outside
    the domain raises through an error flag.  Any other numeric column
    (FLOAT and DOUBLE included) renders per row after the run
    (``DeferredRender``): in-plan composable, but not a sort, group or join
    key."""

    DOMAIN_MAX = 1 << 20

    def __init__(self, child, domain: Optional[tuple] = None):
        self.child = wrap(child)
        self.domain = domain

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        t = cb.type
        nm = f"TOSTRING({cb.name})"
        if t in _STRINGS:
            return cb
        if t in (DataType.BOOL, DataType.ENUM):
            if t == DataType.BOOL:
                d = Dictionary(("FALSE", "TRUE"))
            elif cb.attr.enum is None:
                raise TypeError_("TOSTRING of ENUM without a value map")
            else:
                d = Dictionary(tuple(cb.attr.enum.names))

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                return ExprValue(v.values.to(torch.int32), v.valid)

            return BoundExpression(
                Attribute(nm, DataType.STRING, cb.nullable), g, d)
        if t in _INT_TYPES and self.domain is not None:
            lo, hi = int(self.domain[0]), int(self.domain[1])
            size = hi - lo + 1
            if size <= 0 or size > self.DOMAIN_MAX:
                raise TypeError_(
                    f"TOSTRING domain [{lo}, {hi}] outside the "
                    f"{self.DOMAIN_MAX}-entry dictionary budget")
            if t == DataType.DATE:
                epoch = datetime.date(1970, 1, 1)
                values = tuple(
                    (epoch + datetime.timedelta(days=x)).strftime("%Y/%m/%d")
                    for x in range(lo, hi + 1))
            elif t == DataType.DATETIME:
                epoch_dt = datetime.datetime(1970, 1, 1)
                values = tuple(
                    (epoch_dt + datetime.timedelta(microseconds=x))
                    .strftime("%Y/%m/%d-%H:%M:%S")
                    for x in range(lo, hi + 1))
            else:
                values = tuple(str(x) for x in range(lo, hi + 1))
            d = Dictionary(values)

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                codes = v.values.to(torch.int64) - lo
                ctx.flag_error(
                    f"TOSTRING({cb.name}) value outside declared domain",
                    v.valid_or_true() & ((codes < 0) | (codes >= size)))
                return ExprValue(codes.clamp(0, size - 1).to(torch.int32),
                                 v.valid)

            return BoundExpression(
                Attribute(nm, DataType.STRING, cb.nullable), g, d)
        if t in _INT_TYPES + (DataType.FLOAT, DataType.DOUBLE):
            d = DeferredDictionary()

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                ok = ctx.table.row_mask() & v.valid_or_true()
                return ExprValue(defer_render(ctx, d, nm, "tostring", t,
                                              v.values, ok), v.valid)

            return BoundExpression(
                Attribute(nm, DataType.STRING, cb.nullable), g, d)
        raise TypeError_(f"TOSTRING of {t} has no device encoding")
