"""Math expressions (reference: expression/core/math_expressions.h,
math_evaluators.h): the exp/log family, sqrt/pow, the roundings, abs,
float classification, trig/hyperbolic.

Port of ``supersonic_tpu/exprs/math.py``.  Error policies follow the
reference naming: Signaling variants flag domain errors (a device error
flag, raised at the host sync), Nulling variants yield NULL, Quiet variants
yield whatever IEEE gives (NaN/inf).  ``Round``, ``RoundToInt``,
``RoundWithPrecision`` and ``RoundWithMultiplier`` round halves away from
zero, as C++ ``round`` does, by the JAX package's formulas (torch's
``round`` rounds halves to even).  ``RandomDouble`` draws from a torch
generator seeded per evaluation: deterministic per (seed, device), and not
the JAX package's threefry stream.
"""
from __future__ import annotations

import math as _math
from typing import Callable

import torch

from ..schema import Attribute
from ..types import DataType, TypeError_, convert, is_floating, is_numeric
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   merge_valid, wrap)


def _double(b: BoundExpression, v: torch.Tensor) -> torch.Tensor:
    return convert(v, b.type, DataType.DOUBLE)


def _unary_float(op_name: str, fn: Callable, domain=None,
                 policy: str = "quiet", out_type: DataType | None = None):
    """Factory of unary DOUBLE-valued expressions; ``domain(x)`` gives the
    rows inside the function's domain (None: a total function)."""

    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            if not is_numeric(cb.type):
                raise TypeError(f"{op_name} requires numeric input")
            rt = out_type or DataType.DOUBLE
            nullable = cb.nullable or (policy == "nulling"
                                       and domain is not None)

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                x = _double(cb, v.values)
                ok = None
                if domain is not None:
                    ok = domain(x)
                    if policy == "signaling":
                        ctx.flag_error(f"{op_name} domain error",
                                       ~ok if v.valid is None
                                       else (~ok & v.valid))
                    if policy != "nulling":
                        ok = None
                y = convert(fn(x), DataType.DOUBLE, rt)
                return ExprValue(y, merge_valid(v.valid, ok))

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", rt, nullable), f)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


def _positive(x):
    return x > 0


# exp / log family
Exp = _unary_float("EXP", torch.exp)
Ln = _unary_float("LN", torch.log, domain=_positive)
LnNulling = _unary_float("LN_NULLING", torch.log, domain=_positive,
                         policy="nulling")
LnSignaling = _unary_float("LN_SIGNALING", torch.log, domain=_positive,
                           policy="signaling")
Log10 = _unary_float("LOG10", torch.log10, domain=_positive)
Log10Nulling = _unary_float("LOG10_NULLING", torch.log10, domain=_positive,
                            policy="nulling")
Log10Signaling = _unary_float("LOG10_SIGNALING", torch.log10,
                              domain=_positive, policy="signaling")
Log2 = _unary_float("LOG2", torch.log2, domain=_positive)
Log2Nulling = _unary_float("LOG2_NULLING", torch.log2, domain=_positive,
                           policy="nulling")
Log2Signaling = _unary_float("LOG2_SIGNALING", torch.log2, domain=_positive,
                             policy="signaling")
Sqrt = _unary_float("SQRT", torch.sqrt, domain=lambda x: x >= 0)
SqrtNulling = _unary_float("SQRT_NULLING", torch.sqrt,
                           domain=lambda x: x >= 0, policy="nulling")
SqrtSignaling = _unary_float("SQRT_SIGNALING", torch.sqrt,
                             domain=lambda x: x >= 0, policy="signaling")
LnQuiet = Ln
Log10Quiet = Log10
Log2Quiet = Log2
SqrtQuiet = Sqrt  # reference: OPERATOR_SQRT_QUIET

# trig
Sin = _unary_float("SIN", torch.sin)
Cos = _unary_float("COS", torch.cos)
Tan = _unary_float("TAN", torch.tan)
Cot = _unary_float("COT", lambda x: 1.0 / torch.tan(x))
Asin = _unary_float("ASIN", torch.asin)
Acos = _unary_float("ACOS", torch.acos)
Atan = _unary_float("ATAN", torch.atan)
Sinh = _unary_float("SINH", torch.sinh)
Cosh = _unary_float("COSH", torch.cosh)
Tanh = _unary_float("TANH", torch.tanh)
Asinh = _unary_float("ASINH", torch.asinh)
Acosh = _unary_float("ACOSH", torch.acosh)
Atanh = _unary_float("ATANH", torch.atanh)
ToDegrees = _unary_float("TO_DEGREES", lambda x: x * (180.0 / _math.pi))
ToRadians = _unary_float("TO_RADIANS", lambda x: x * (_math.pi / 180.0))


class Log(Expression):
    """LOG(base, x) (reference: math_expressions.h Log)."""

    def __init__(self, base, x):
        self.base = wrap(base)
        self.x = wrap(x)

    def do_bind(self, schema, dicts):
        bb = self.base.do_bind(schema, dicts)
        xb = self.x.do_bind(schema, dicts)

        def f(ctx):
            b = bb.evaluate(ctx)
            x = xb.evaluate(ctx)
            y = torch.log(_double(xb, x.values)) / torch.log(
                _double(bb, b.values))
            return ExprValue(y, merge_valid(b.valid, x.valid))

        return BoundExpression(
            Attribute(f"LOG({bb.name}, {xb.name})", DataType.DOUBLE,
                      bb.nullable or xb.nullable), f)


LogQuiet = Log


class LogNulling(Expression):
    """LOG(base, x), NULL outside the domain (x > 0, base > 0, base != 1)
    (reference: math_expressions.h:49-52)."""

    def __init__(self, base, x):
        self.base = wrap(base)
        self.x = wrap(x)

    def do_bind(self, schema, dicts):
        bb = self.base.do_bind(schema, dicts)
        xb = self.x.do_bind(schema, dicts)

        def f(ctx):
            b = bb.evaluate(ctx)
            x = xb.evaluate(ctx)
            bd, xd = _double(bb, b.values), _double(xb, x.values)
            ok = (xd > 0) & (bd > 0) & (bd != 1.0)
            y = torch.log(torch.where(ok, xd, 1.0)) / torch.log(
                torch.where(ok, bd, 2.0))
            return ExprValue(y, merge_valid(b.valid, x.valid, ok))

        return BoundExpression(
            Attribute(f"LOG_NULLING({bb.name}, {xb.name})", DataType.DOUBLE,
                      True), f)


def _pow_expr(policy: str):
    """POWER(base, exponent) in the reference's three failure policies
    (expression_traits.h:1329-1370): the domain error is a negative base
    with a non-integer exponent."""

    class _Pow(Expression):
        def __init__(self, base, exponent):
            self.base = wrap(base)
            self.exponent = wrap(exponent)

        def do_bind(self, schema, dicts):
            bb = self.base.do_bind(schema, dicts)
            eb = self.exponent.do_bind(schema, dicts)
            nullable = bb.nullable or eb.nullable or policy == "nulling"

            def f(ctx):
                b = bb.evaluate(ctx)
                e = eb.evaluate(ctx)
                bd, ed = _double(bb, b.values), _double(eb, e.values)
                y = torch.pow(bd, ed)
                valid = merge_valid(b.valid, e.valid)
                if policy != "quiet":
                    bad = (bd < 0) & (ed != torch.floor(ed))
                    if policy == "nulling":
                        valid = merge_valid(valid, ~bad)
                    else:
                        ctx.flag_error(
                            f"POW({bb.name}, {eb.name}): negative base "
                            "with non-integer exponent",
                            bad if valid is None else (bad & valid))
                return ExprValue(y, valid)

            return BoundExpression(
                Attribute(f"POW({bb.name}, {eb.name})", DataType.DOUBLE,
                          nullable), f)

    _Pow.__name__ = f"Pow{policy.title()}"
    return _Pow


PowQuiet = _pow_expr("quiet")
PowNulling = _pow_expr("nulling")
PowSignaling = _pow_expr("signaling")
Pow = PowQuiet
PowerSignaling = PowSignaling
PowerNulling = PowNulling
PowerQuiet = PowQuiet


def _away(x: torch.Tensor) -> torch.Tensor:
    """C++ round(): halves away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _round(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``Round`` formula, operation for operation."""
    fl = torch.floor(x)
    return torch.where(x - fl == 0.5, torch.where(x >= 0, fl + 1, fl),
                       torch.round(x))


def _rounding(op_name: str, fn: Callable):
    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            # integers are already round (the reference returns them)
            if not is_floating(cb.type):
                return cb

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                return ExprValue(fn(v.values), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", cb.type, cb.nullable), f)

    _Op.__name__ = op_name.title()
    return _Op


Round = _rounding("ROUND", _round)
Ceil = _rounding("CEIL", torch.ceil)
Floor = _rounding("FLOOR", torch.floor)
Trunc = _rounding("TRUNC", torch.trunc)


def _to_int_expr(op_name: str, fn):
    """float -> INT64 rounding family (reference: math_evaluators.h:87-103,
    a C cast of ceil/floor; saturating as XLA's convert)."""

    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)

            def f(ctx):
                v = cb.evaluate(ctx)
                y = fn(_double(cb, v.values))
                return ExprValue(convert(y, DataType.DOUBLE, DataType.INT64),
                                 v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", DataType.INT64,
                          cb.nullable), f)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


RoundToInt = _to_int_expr("ROUND_TO_INT", _away)  # C++ lround
CeilToInt = _to_int_expr("CEIL_TO_INT", torch.ceil)
FloorToInt = _to_int_expr("FLOOR_TO_INT", torch.floor)
TruncToInt = _to_int_expr("TRUNC_TO_INT", torch.trunc)


class RoundWithPrecision(Expression):
    def __init__(self, child, precision: int):
        self.child = wrap(child)
        self.precision = precision

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        scale = 10.0 ** self.precision
        # the JAX package's compiled form: XLA turns its division by the
        # constant scale into a product by the reciprocal
        inv = 1.0 / scale

        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(_away(_double(cb, v.values) * scale) * inv,
                             v.valid)

        return BoundExpression(
            Attribute(f"ROUND_WITH_PRECISION({cb.name})", DataType.DOUBLE,
                      cb.nullable), f)


class RoundWithMultiplier(Expression):
    """ROUND_WITH_MULTIPLIER(arg, mult) = round(arg * mult) / mult
    (reference: math_evaluators.h:117)."""

    def __init__(self, child, multiplier):
        self.child = wrap(child)
        self.multiplier = wrap(multiplier)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        mb = self.multiplier.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            m = mb.evaluate(ctx)
            mm = _double(mb, m.values)
            return ExprValue(_away(_double(cb, v.values) * mm) / mm,
                             merge_valid(v.valid, m.valid))

        return BoundExpression(
            Attribute(f"ROUND_WITH_MULTIPLIER({cb.name})", DataType.DOUBLE,
                      cb.nullable or mb.nullable), f)


class Abs(Expression):
    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        # an unsigned value is its own absolute value (and a UINT64 lane's
        # sign bit is a value bit)
        unsigned = cb.type in (DataType.UINT32, DataType.UINT64)

        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(v.values if unsigned else torch.abs(v.values),
                             v.valid)

        return BoundExpression(Attribute(f"ABS({cb.name})", cb.type,
                                         cb.nullable), f)


def _classify(op_name: str, fn: Callable):
    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                x = v.values
                if not x.is_floating_point():
                    x = _double(cb, x)
                return ExprValue(fn(x), v.valid)

            return BoundExpression(
                Attribute(f"{op_name}({cb.name})", DataType.BOOL,
                          cb.nullable), f)

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


IsNaN = _classify("IS_NAN", torch.isnan)
IsInf = _classify("IS_INF", torch.isinf)
IsFinite = _classify("IS_FINITE", torch.isfinite)
# normal = finite, not zero, not subnormal (std::isnormal)
IsNormal = _classify(
    "IS_NORMAL",
    lambda x: torch.isfinite(x) & (torch.abs(x) >= torch.finfo(x.dtype).tiny))


class Atan2(Expression):
    """ATAN2(x, y) -> atan2(x, y) (reference: math_expressions.h:63)."""

    def __init__(self, x, y):
        self.x = wrap(x)
        self.y = wrap(y)

    def do_bind(self, schema, dicts):
        xb = self.x.do_bind(schema, dicts)
        yb = self.y.do_bind(schema, dicts)

        def f(ctx):
            xv = xb.evaluate(ctx)
            yv = yb.evaluate(ctx)
            return ExprValue(torch.atan2(_double(xb, xv.values),
                                         _double(yb, yv.values)),
                             merge_valid(xv.valid, yv.valid))

        return BoundExpression(
            Attribute(f"ATAN2({xb.name}, {yb.name})", DataType.DOUBLE,
                      xb.nullable or yb.nullable), f)


class Format(Expression):
    """FORMAT(number, precision) -> STRING, fixed point, the precision
    clamped at >= 0 (reference: math_expressions.h:115, math_evaluators.h:
    39-59 snprintf "%.*f").  A constant number folds to a constant string;
    a column renders per row after the run (``DeferredRender``)."""

    def __init__(self, number, precision):
        self.number = wrap(number)
        self.precision = wrap(precision)

    def do_bind(self, schema, dicts):
        from ..dictionary import DeferredDictionary
        from .base import defer_render
        from .terminal import Const

        nb = self.number.do_bind(schema, dicts)
        pb = self.precision.do_bind(schema, dicts)
        if not pb.is_constant or not isinstance(self.precision, Const):
            raise TypeError_(
                "FORMAT precision must be a constant (host-side rendering "
                "is bound per precision)")
        prec = max(int(self.precision.value), 0)
        if nb.is_constant and isinstance(self.number, Const):
            return Const(f"%.{prec}f" % float(self.number.value)).do_bind(
                schema, dicts)
        d = DeferredDictionary()
        nm = f"FORMAT({nb.name}, {prec})"

        def g(ctx) -> ExprValue:
            v = nb.evaluate(ctx)
            ok = ctx.table.row_mask() & v.valid_or_true()
            codes = defer_render(ctx, d, nm, "format", nb.type, v.values,
                                 ok, precision=prec)
            return ExprValue(codes, v.valid)

        return BoundExpression(
            Attribute(nm, DataType.STRING, nb.nullable), g, d)


FormatSignaling = Format  # reference: OPERATOR_FORMAT_SIGNALING


def Pi():
    """DOUBLE constant pi (reference: math_expressions.h Pi)."""
    from .terminal import Const

    return Const(_math.pi, DataType.DOUBLE)


class RandomDouble(Expression):
    """Uniform [0, 1) DOUBLE per row (reference: math_expressions.h:128-130,
    declared there but not implemented), deterministic per (seed, device)
    as ``RandInt32``."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def do_bind(self, schema, dicts):
        from .terminal import seeded_generator

        seed = self.seed

        def fn(ctx: EvalContext) -> ExprValue:
            table = ctx.table
            return ExprValue(torch.rand(
                table.capacity, generator=seeded_generator(seed, table.device),
                dtype=torch.float64, device=table.device), None)

        return BoundExpression(
            Attribute("RANDOM_DOUBLE", DataType.DOUBLE, False), fn)
