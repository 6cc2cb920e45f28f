"""Elementary expressions: casts, If/Case, IsNull/IfNull, string parsing.

Port of ``supersonic_tpu/exprs/elementary.py`` (reference: expression/
core/elementary_expressions.h:24-124, elementary_bound_expressions.cc).
Both branches of a conditional are evaluated and merged with masks.  A
float-to-integer cast truncates, saturates at the type's range and takes
NaN to 0 on every device, as XLA's convert does (types.py::convert).
STRING branches merge their dictionaries at bind; each branch's codes move
into the merged dictionary through a LUT uploaded once (``take_small``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..dictionary import Dictionary, merge as dict_merge
from ..kernels.lut_gather import BoundLut, take_small
from ..schema import Attribute
from ..types import (DataType, TypeError_, common_numeric_type, convert,
                     is_integer, is_numeric, physical_dtype, to_carrier)
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   fold_constants, merge_valid, wrap)

_STRINGS = (DataType.STRING, DataType.BINARY)


def _remap(lut: np.ndarray):
    """values -> lut[values] (clipped into range), one ``take_small``."""
    bound = BoundLut(lut if lut.size else np.zeros(1, np.int32))
    return lambda v: take_small(bound, v)


def unify_branches(bounds: Sequence[BoundExpression]):
    """Common result type of several branches: (result type, convert
    functions, merged dictionary), where ``convert[i](values)`` maps branch
    i's values into the result space.  STRING/BINARY branches merge their
    dictionaries and remap each branch's codes."""
    types = [b.type for b in bounds]
    if all(t in _STRINGS for t in types):
        if len(set(types)) != 1:
            raise TypeError_("cannot unify STRING with BINARY")
        merged = bounds[0].dictionary or Dictionary(())
        remaps = [np.arange(max(len(merged), 1), dtype=np.int32)]
        for b in bounds[1:]:
            merged, ra, rb = dict_merge(merged, b.dictionary or Dictionary(()))
            remaps = [ra[r] if r.size else r for r in remaps]
            remaps.append(rb)
        return types[0], [_remap(r) for r in remaps], merged
    if len(set(types)) == 1:
        return types[0], [lambda v: v for _ in bounds], None
    if all(is_numeric(t) for t in types):
        rt = types[0]
        for t in types[1:]:
            rt = common_numeric_type(rt, t)
        return rt, [lambda v, src=t: convert(v, src, rt) for t in types], None
    raise TypeError_(f"cannot unify branch types {types}")


class If(Expression):
    """IF(cond, then, else); a NULL condition selects ``else`` (reference:
    IF)."""

    nulling = False

    def __init__(self, condition, then, otherwise):
        self.condition = wrap(condition)
        self.then = wrap(then)
        self.otherwise = wrap(otherwise)

    def do_bind(self, schema, dicts):
        cb = self.condition.do_bind(schema, dicts)
        if cb.type != DataType.BOOL:
            raise TypeError_("IF condition must be BOOL")
        tb = self.then.do_bind(schema, dicts)
        eb = self.otherwise.do_bind(schema, dicts)
        rt, convs, rdict = unify_branches([tb, eb])
        nulling = self.nulling
        nullable = tb.nullable or eb.nullable or (nulling and cb.nullable)

        def fn(ctx: EvalContext) -> ExprValue:
            cv = cb.evaluate(ctx)
            tv = tb.evaluate(ctx)
            ev = eb.evaluate(ctx)
            take_then = cv.values & cv.valid_or_true()
            values = torch.where(take_then, convs[0](tv.values),
                                 convs[1](ev.values))
            valid = torch.where(take_then, tv.valid_or_true(),
                                ev.valid_or_true())
            if nulling and cv.valid is not None:
                valid = valid & cv.valid
            return ExprValue(values, valid if nullable else None)

        name = f"IF({cb.name}, {tb.name}, {eb.name})"
        return BoundExpression(Attribute(name, rt, nullable), fn, rdict)


class NullingIf(If):
    """IF that yields NULL on a NULL condition (reference: NULLING_IF)."""
    nulling = True


class Case(Expression):
    """CASE(selector, default, when1, then1, ...) (reference: CASE,
    elementary_expressions.h:24-44): the first ``when`` equal to the
    selector picks its ``then``, else ``default``."""

    def __init__(self, *args):
        if len(args) < 2 or len(args) % 2 != 0:
            raise TypeError_(
                "CASE needs selector, default, then when/then pairs")
        self.args = [wrap(a) for a in args]

    def do_bind(self, schema, dicts):
        from .comparison import _comparable_pair

        sel = self.args[0].do_bind(schema, dicts)
        default = self.args[1].do_bind(schema, dicts)
        whens = [a.do_bind(schema, dicts) for a in self.args[2::2]]
        thens = [a.do_bind(schema, dicts) for a in self.args[3::2]]
        getters = [_comparable_pair(sel, w) for w in whens]
        rt, convs, rdict = unify_branches([default] + thens)
        nullable = any(b.nullable for b in [default] + thens)

        def fn(ctx: EvalContext) -> ExprValue:
            dv = default.evaluate(ctx)
            values = convs[0](dv.values)
            valid = dv.valid_or_true()
            taken = torch.zeros(values.shape[0], dtype=torch.bool,
                                device=values.device)
            sel_valid = sel.evaluate(ctx).valid_or_true()
            for get, wb, tb, conv in zip(getters, whens, thens, convs[1:]):
                a, b, _ = get(ctx)
                match = ((a == b) & sel_valid & wb.evaluate(ctx)
                         .valid_or_true() & ~taken)
                tv = tb.evaluate(ctx)
                values = torch.where(match, conv(tv.values), values)
                valid = torch.where(match, tv.valid_or_true(), valid)
                taken = taken | match
            return ExprValue(values, valid if nullable else None)

        return BoundExpression(Attribute(f"CASE({sel.name})", rt, nullable),
                               fn, rdict)


class IsNull(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def fn(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            if v.valid is None:
                return ExprValue(torch.zeros(v.values.shape[0],
                                             dtype=torch.bool,
                                             device=v.values.device), None)
            return ExprValue(~v.valid, None)

        return BoundExpression(
            Attribute(f"IS_NULL({cb.name})", DataType.BOOL, False), fn)


class IfNull(Expression):
    """IFNULL(a, b): a where a is valid, else b (reference: IF_NULL)."""

    def __init__(self, a, b):
        self.a = wrap(a)
        self.b = wrap(b)

    def do_bind(self, schema, dicts):
        ab = self.a.do_bind(schema, dicts)
        bb = self.b.do_bind(schema, dicts)
        rt, convs, rdict = unify_branches([ab, bb])
        nullable = ab.nullable and bb.nullable

        def fn(ctx: EvalContext) -> ExprValue:
            av = ab.evaluate(ctx)
            bv = bb.evaluate(ctx)
            use_a = av.valid_or_true()
            values = torch.where(use_a, convs[0](av.values),
                                 convs[1](bv.values))
            valid = use_a | bv.valid_or_true()
            return ExprValue(values, valid if nullable else None)

        return BoundExpression(
            Attribute(f"IFNULL({ab.name}, {bb.name})", rt, nullable), fn,
            rdict)


class CastTo(Expression):
    """Explicit cast (reference: CastTo / cast_bound_expression.cc): the
    JAX package's ``astype``, a DATE to DATETIME in microseconds."""

    def __init__(self, type_: DataType, child):
        self.type_ = type_
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        dst = self.type_
        src = cb.type
        if src == dst:
            return cb
        if not (is_numeric(src) or src in (DataType.BOOL, DataType.DATE,
                                           DataType.DATETIME)):
            raise TypeError_(f"cannot CAST {src} to {dst}")

        def fn(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            vals = convert(v.values, src, dst)
            if src == DataType.DATE and dst == DataType.DATETIME:
                vals = vals * 86_400_000_000
            return ExprValue(vals, v.valid)

        return fold_constants(BoundExpression(
            Attribute(f"CAST_{dst.value}({cb.name})", dst, cb.nullable), fn),
            [cb])


def _parse_lut(d: Dictionary, dst: DataType):
    """Host parse of every dictionary value: (values LUT, ok LUT)."""
    n = max(len(d), 1)
    vals = np.zeros(n, dtype=physical_dtype(dst))
    ok = np.zeros(n, dtype=bool)
    for i, s in enumerate(d.values):
        try:
            text = s.decode() if isinstance(s, (bytes, bytearray)) else s
            if dst == DataType.BOOL:
                low = text.strip().lower()
                if low in ("true", "yes", "1"):
                    vals[i], ok[i] = True, True
                elif low in ("false", "no", "0"):
                    vals[i], ok[i] = False, True
            elif dst in (DataType.FLOAT, DataType.DOUBLE):
                vals[i], ok[i] = float(text), True
            else:
                vals[i], ok[i] = int(text, 10), True
        except (ValueError, AttributeError):
            pass
    return BoundLut(to_carrier(vals, dst)), BoundLut(ok)


class _ParseString(Expression):
    nulling = True  # failures -> NULL; else an error flag

    def __init__(self, type_: DataType, child):
        self.type_ = type_
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        if cb.type not in _STRINGS:
            raise TypeError_("ParseString requires a STRING input")
        if cb.dictionary is None:
            raise TypeError_("ParseString input has no bound dictionary")
        vals_lut, ok_lut = _parse_lut(cb.dictionary, self.type_)
        nulling = self.nulling

        def fn(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            parsed = take_small(vals_lut, v.values)
            ok = take_small(ok_lut, v.values)
            if not nulling:
                ctx.flag_error("string parse failure",
                               ~ok if v.valid is None else (~ok & v.valid))
                return ExprValue(parsed, v.valid)
            return ExprValue(parsed, merge_valid(v.valid, ok))

        return BoundExpression(
            Attribute(f"PARSE({cb.name})", self.type_,
                      cb.nullable or nulling), fn)


class ParseStringNulling(_ParseString):
    nulling = True


class ParseStringQuiet(_ParseString):
    """Failed rows hold 0 and stay valid."""

    nulling = False

    def do_bind(self, schema, dicts):
        bound = super().do_bind(schema, dicts)
        inner = bound._fn

        def fn(ctx: EvalContext) -> ExprValue:
            n = len(ctx.error_flags)
            out = inner(ctx)
            del ctx.error_flags[n:]  # quiet: drop the parse flag
            return out

        return BoundExpression(bound.attr, fn, bound.dictionary)


CastQuiet = CastTo  # numeric casts wrap or saturate as the JAX package's


def _cast_policy(policy: str):
    """CAST with overflow handling (reference: cast_bound_expression.cc
    CAST_QUIET / CAST_NULLING / CAST_SIGNALING): a value outside the
    integer destination's range (NaN included) is NULL or fails."""

    class _Cast(Expression):
        def __init__(self, type_: DataType, child):
            self.type_ = type_
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            inner = CastTo(self.type_, self.child).do_bind(schema, dicts)
            cb = self.child.do_bind(schema, dicts)
            dst = self.type_
            if not is_integer(dst) or dst == cb.type:
                return inner
            info = np.iinfo(physical_dtype(dst))
            lo, hi = float(info.min), float(info.max)

            def f(ctx):
                v = cb.evaluate(ctx)
                out = inner.evaluate(ctx)
                x = convert(v.values, cb.type, DataType.DOUBLE)
                ok = (x >= lo) & (x <= hi)
                if policy == "signaling":
                    ctx.flag_error("CAST overflow",
                                   ~ok if v.valid is None else (~ok & v.valid))
                    return out
                return ExprValue(out.values, merge_valid(out.valid, ok))

            return BoundExpression(
                Attribute(inner.name, dst, inner.nullable
                          or policy == "nulling"), f, inner.dictionary)

    _Cast.__name__ = f"Cast{policy.title()}"
    return _Cast


CastNulling = _cast_policy("nulling")
CastSignaling = _cast_policy("signaling")


class Copy(Expression):
    """Materializing column copy (reference: OPERATOR_COPY): a no-op, since
    evaluation never writes into its inputs."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        return self.child.do_bind(schema, dicts)
