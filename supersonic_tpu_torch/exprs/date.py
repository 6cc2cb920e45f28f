"""Date/time expressions.

Port of ``supersonic_tpu/exprs/date.py`` (reference: expression/core/
date_expressions.h, date_evaluators.cc).  DATE is int32 days since the
Unix epoch, DATETIME int64 microseconds since the epoch, UTC.  The
``*Local`` variants follow the reference's localtime_r against the
engine's configured timezone (exprs/tz.py: ``set_local_timezone`` or the
TZ environment variable, UTC by default): bind captures the compiled zone,
evaluation shifts to local-civil microseconds with one 3-lane
``lut_gather`` and reuses the UTC field math.

Civil-calendar math is Howard Hinnant's days <-> civil algorithms with
floor division (``torch.div(..., rounding_mode="floor")``), so instants
before the epoch take the same fields as in the JAX package.  A day count
from int64 microseconds lies within +-1.07e8, so the fields are computed
in int32 lanes (half the bytes of the JAX package's int64, the same
values); the expressions of one evaluation over the same column share one
local shift and one civil split (``EvalContext.memo_of``).
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..dictionary import DeferredDictionary, Dictionary
from ..kernels.lut_gather import BoundLut, take_small
from ..schema import Attribute
from ..types import DataType, TypeError_
from . import tz as _tz
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   defer_render, fold_constants, merge_valid, wrap)

US_PER_SEC = 1_000_000
US_PER_DAY = 86_400 * US_PER_SEC


def _fdiv(a, b):
    """Floor division (jnp's ``//``)."""
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z):
    """days since the epoch -> (year, month, day) (Hinnant), in int32: the
    day counts here come from int64 microseconds, within +-1.07e8."""
    z = z.to(torch.int32) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                       # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                 # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1         # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)     # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    y = y.to(torch.int64)
    m = m.to(torch.int64)
    d = d.to(torch.int64)
    y = torch.where(m <= 2, y - 1, y)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _to_us(b: BoundExpression, values: torch.Tensor) -> torch.Tensor:
    """DATE or DATETIME column -> int64 microseconds since the epoch."""
    if b.type == DataType.DATE:
        return values.to(torch.int64) * US_PER_DAY
    if b.type == DataType.DATETIME:
        return values.to(torch.int64)
    raise TypeError_(f"expected DATE/DATETIME, got {b.type}")


def _days(us):
    return _fdiv(us, US_PER_DAY)


def _local_us(b: BoundExpression, values: torch.Tensor, tzt):
    """Microseconds of a DATE/DATETIME column, shifted to local civil time
    under ``tzt`` (None: UTC)."""
    us = _to_us(b, values)
    return us if tzt is None else _tz.local_shift(us, tzt)


def _split(ctx, us):
    """(days, (year, month, day)) of int64 microseconds, once an
    evaluation."""
    def compute():
        days = _days(us).to(torch.int32)
        return days, _civil_from_days(days)
    return ctx.memo_of("civil", us, compute)


def _year_day(ctx, us):
    days, (y, _, _) = _split(ctx, us)
    one = torch.ones_like(y)
    return days - _days_from_civil(y, one, one) + 1


# op name -> field of local-civil (or UTC) microseconds
_FIELDS = {
    "YEAR": lambda ctx, us: _split(ctx, us)[1][0],
    "MONTH": lambda ctx, us: _split(ctx, us)[1][1],
    "DAY": lambda ctx, us: _split(ctx, us)[1][2],
    "QUARTER": lambda ctx, us: _fdiv(_split(ctx, us)[1][1] + 2, 3),
    # reference weekday: 0 = Monday .. 6 = Sunday (date_evaluators.cc);
    # day 0 (1970-01-01) was a Thursday
    "WEEKDAY": lambda ctx, us: torch.remainder(_split(ctx, us)[0] + 3, 7),
    "YEARDAY": _year_day,
    "HOUR": lambda ctx, us: torch.remainder(
        _fdiv(us, 3600 * US_PER_SEC), 24),
    "MINUTE": lambda ctx, us: torch.remainder(
        _fdiv(us, 60 * US_PER_SEC), 60),
    "SECOND": lambda ctx, us: torch.remainder(_fdiv(us, US_PER_SEC), 60),
    "MICROSECOND": lambda ctx, us: torch.remainder(us, US_PER_SEC),
}


def _field_expr(op_name: str, local: bool = False):
    """A field of a DATE/DATETIME as INT32; ``local``: of the local-civil
    time under the timezone bound (exprs/tz.py; under UTC exactly the UTC
    op, since POSIX localtime is gmtime of t + utcoff(t))."""
    compute = _FIELDS[op_name]
    name = f"{op_name}_LOCAL" if local else op_name

    class _Op(Expression):
        def __init__(self, child):
            self.child = wrap(child)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            tzt = _tz.current_tables() if local else None

            def f(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                us = ctx.memo_of(("us", cb.type, tzt and tzt.name), v.values,
                                 lambda: _local_us(cb, v.values, tzt))
                return ExprValue(compute(ctx, us).to(torch.int32), v.valid)

            return fold_constants(BoundExpression(
                Attribute(f"{name}({cb.name})", DataType.INT32, cb.nullable),
                f), [cb])

    _Op.__name__ = name.title().replace("_", "")
    return _Op


Year = _field_expr("YEAR")
Month = _field_expr("MONTH")
Day = _field_expr("DAY")
Quarter = _field_expr("QUARTER")
Weekday = _field_expr("WEEKDAY")
YearDay = _field_expr("YEARDAY")
Hour = _field_expr("HOUR")
Minute = _field_expr("MINUTE")
Second = _field_expr("SECOND")
Microsecond = _field_expr("MICROSECOND")
YearLocal = _field_expr("YEAR", True)
MonthLocal = _field_expr("MONTH", True)
DayLocal = _field_expr("DAY", True)
QuarterLocal = _field_expr("QUARTER", True)
WeekdayLocal = _field_expr("WEEKDAY", True)
YearDayLocal = _field_expr("YEARDAY", True)
HourLocal = _field_expr("HOUR", True)
MinuteLocal = _field_expr("MINUTE", True)
SecondLocal = _field_expr("SECOND", True)
MicrosecondLocal = _field_expr("MICROSECOND", True)


class UnixTimestamp(Expression):
    """DATETIME -> seconds since the epoch (INT64)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(_fdiv(_to_us(cb, v.values), US_PER_SEC), v.valid)

        return fold_constants(BoundExpression(
            Attribute(f"UNIXTIMESTAMP({cb.name})", DataType.INT64,
                      cb.nullable), f), [cb])


class FromUnixTime(Expression):
    """seconds since the epoch -> DATETIME."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(v.values.to(torch.int64) * US_PER_SEC, v.valid)

        return fold_constants(BoundExpression(
            Attribute(f"FROMUNIXTIME({cb.name})", DataType.DATETIME,
                      cb.nullable), f), [cb])


def _makedate_us(y, m, d):
    """The reference's mkgmtime_int64 (date_evaluators.cc:36-58): the
    month normalizes over any integer (month 13 is next January) and the
    day extrapolates linearly (Feb 30 is Mar 2)."""
    y64 = y.to(torch.int64)
    m64 = m.to(torch.int64)
    real_y = y64 + _fdiv(m64 - 1, 12)
    real_m = torch.remainder(m64 - 1, 12) + 1
    return _days_from_civil(real_y, real_m, d) * US_PER_DAY


class MakeDate(Expression):
    """MAKEDATE(year, month, day) -> DATETIME at 0:00 UTC of that date
    (reference: date_expressions.h:53-56, date_evaluators.cc:36-68); a
    result before the epoch fails the evaluation (MakeDateFailer,
    date_evaluators.cc:271-287)."""

    def __init__(self, year, month, day):
        self.year = wrap(year)
        self.month = wrap(month)
        self.day = wrap(day)

    def do_bind(self, schema, dicts):
        yb = self.year.do_bind(schema, dicts)
        mb = self.month.do_bind(schema, dicts)
        db = self.day.do_bind(schema, dicts)
        nullable = yb.nullable or mb.nullable or db.nullable

        def f(ctx):
            y, m, d = yb.evaluate(ctx), mb.evaluate(ctx), db.evaluate(ctx)
            us = _makedate_us(y.values, m.values, d.values)
            valid = merge_valid(y.valid, m.valid, d.valid)
            ctx.flag_error("MAKEDATE result before the epoch",
                           us < 0 if valid is None else (valid & (us < 0)))
            return ExprValue(us, valid)

        return fold_constants(BoundExpression(
            Attribute("MAKEDATE", DataType.DATETIME, nullable), f),
            [yb, mb, db])


class MakeDatetime(Expression):
    """MAKEDATETIME(y, mo, d, h, mi, s) -> DATETIME (reference:
    date_bound_expressions.cc:61-142): the date part normalizes as
    MakeDate's, a date part before the epoch makes the row NULL, and hour,
    minute and second add unchecked.  Always nullable."""

    def __init__(self, year, month, day, hour, minute, second):
        self.parts = [wrap(x) for x in (year, month, day, hour, minute,
                                        second)]

    def do_bind(self, schema, dicts):
        bs = [p.do_bind(schema, dicts) for p in self.parts]

        def f(ctx):
            vs = [b.evaluate(ctx) for b in bs]
            y, m, d, hh, mm, ss = [v.values.to(torch.int64) for v in vs]
            date_us = _makedate_us(y, m, d)
            us = date_us + (hh * 3600 + mm * 60 + ss) * US_PER_SEC
            return ExprValue(us, merge_valid(*(v.valid for v in vs),
                                             date_us >= 0))

        return fold_constants(BoundExpression(
            Attribute("MAKEDATETIME", DataType.DATETIME, True), f), bs)


def _add_expr(op_name: str, unit_us: int):
    class _Op(Expression):
        def __init__(self, child, amount):
            self.child = wrap(child)
            self.amount = wrap(amount)

        def do_bind(self, schema, dicts):
            cb = self.child.do_bind(schema, dicts)
            ab = self.amount.do_bind(schema, dicts)

            def f(ctx):
                v = cb.evaluate(ctx)
                a = ab.evaluate(ctx)
                us = _to_us(cb, v.values) + a.values.to(torch.int64) * unit_us
                return ExprValue(us, merge_valid(v.valid, a.valid))

            return fold_constants(BoundExpression(
                Attribute(f"{op_name}({cb.name})", DataType.DATETIME,
                          cb.nullable or ab.nullable), f), [cb, ab])

    _Op.__name__ = op_name.title().replace("_", "")
    return _Op


AddDays = _add_expr("ADD_DAYS", US_PER_DAY)
AddMinutes = _add_expr("ADD_MINUTES", 60 * US_PER_SEC)


class AddMonths(Expression):
    """ADD_MONTHS (reference: date_evaluators.cc:71-83): the day of the
    month is not clamped (2020-01-31 + 1 month is 2020-03-02), the time of
    day is kept, and a date part before the epoch collapses to mkgmtime's
    -1 s sentinel, quietly."""

    def __init__(self, child, months):
        self.child = wrap(child)
        self.months = wrap(months)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        mb = self.months.do_bind(schema, dicts)

        def f(ctx):
            v = cb.evaluate(ctx)
            mm = mb.evaluate(ctx)
            us = ctx.memo_of(("us", cb.type, None), v.values,
                             lambda: _to_us(cb, v.values))
            days, (y, m, d) = _split(ctx, us)
            tod = us - days.to(torch.int64) * US_PER_DAY
            md = _makedate_us(y, m + mm.values.to(torch.int64), d)
            md = torch.where(md < 0, -US_PER_SEC, md)
            return ExprValue(md + tod, merge_valid(v.valid, mm.valid))

        return fold_constants(BoundExpression(
            Attribute(f"ADD_MONTHS({cb.name})", DataType.DATETIME,
                      cb.nullable or mb.nullable), f), [cb, mb])


class DateToDatetime(Expression):
    """DATE -> DATETIME at midnight (reference: OPERATOR_DATE_TO_DATETIME)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        if cb.type == DataType.DATETIME:
            return cb
        if cb.type != DataType.DATE:
            raise TypeError_(f"DATE_TO_DATETIME requires DATE, got {cb.type}")

        def f(ctx):
            v = cb.evaluate(ctx)
            return ExprValue(v.values.to(torch.int64) * US_PER_DAY, v.valid)

        return fold_constants(BoundExpression(
            Attribute(f"DATE_TO_DATETIME({cb.name})", DataType.DATETIME,
                      cb.nullable), f), [cb])


# --- DateFormat ---------------------------------------------------------------

# finest strftime directive -> bucket granularity in seconds; directives not
# listed (unknown extensions) conservatively get 1 s
_FMT_GRANULE = {
    'S': 1, 'T': 1, 'X': 1, 'c': 1, 's': 1, 'r': 1,
    'M': 60, 'R': 60,
    'H': 3600, 'I': 3600, 'p': 3600, 'P': 3600, 'k': 3600, 'l': 3600,
}
for _c in "aAbBCdDeFgGjmuUVwWxyYnt" + "zZ":  # date-only fields; %z/%Z are
    _FMT_GRANULE[_c] = 86_400  # constant under gmtime (the local form
#                                rejects them at bind)


def _format_granule_sec(fmt: str) -> int:
    """Seconds per output bucket: two instants of one bucket render alike
    under ``fmt``."""
    g = 86_400
    i = 0
    while i < len(fmt):
        if fmt[i] == '%' and i + 1 < len(fmt):
            c = fmt[i + 1]
            if c in ('E', 'O') and i + 2 < len(fmt):  # glibc modifiers
                c = fmt[i + 2]
                i += 1
            if c != '%':
                g = min(g, _FMT_GRANULE.get(c, 1))
            i += 2
        else:
            i += 1
    return g


class DateFormat(Expression):
    """DATEFORMAT(datetime, format) (reference: date_expressions.h:157-176,
    date_evaluators.cc:227-265: strftime of gmtime_r into a 33-byte buffer,
    so a rendering longer than 32 characters is the empty string; a DATE is
    00:00:00 of that date).

    With ``domain=(lo, hi)`` (DATE: days; DATETIME: microseconds; lo >= 0)
    the output space is the range of the format's buckets (day, hour,
    minute or second by its finest directive): a dictionary rendered at
    bind with the C library's strftime, one gather at evaluation, and an
    error flag for a live row outside the domain.  ``local=True``
    (DateFormatLocal) first shifts to local-civil microseconds (exprs/
    tz.py) and rejects %z/%Z.  Without a domain the column renders per row
    after the run (``DeferredRender``; not a key)."""

    DOMAIN_MAX = 1 << 20

    def __init__(self, child, format, domain=None, local=False):
        from .terminal import Const

        self.child = wrap(child)
        if isinstance(format, Const):
            format = format.value
        if not isinstance(format, str):
            raise TypeError_(
                "DATEFORMAT: format must be a constant string on device "
                "(non-constant formats: ops/host.py::to_string per row)")
        self.format = format
        self.domain = domain
        self.local = local

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        if cb.type not in (DataType.DATE, DataType.DATETIME):
            raise TypeError_(
                f"DATEFORMAT requires DATE/DATETIME, got {cb.type}")
        fmt = self.format
        tzt = _tz.current_tables() if self.local else None
        if tzt is not None and any(
                fmt[i] == '%' and i + 1 < len(fmt) and fmt[i + 1] in 'zZ'
                for i in range(len(fmt))):
            raise TypeError_(
                "DATEFORMAT_LOCAL with %z/%Z has no device encoding "
                "(zone names need per-row rendering: ops/host.py)")
        if self.domain is None:
            d = DeferredDictionary()

            def g(ctx: EvalContext) -> ExprValue:
                v = cb.evaluate(ctx)
                ok = ctx.table.row_mask() & v.valid_or_true()
                raw = v.values.to(torch.int64)
                if cb.type == DataType.DATETIME and tzt is not None:
                    raw = _tz.local_shift(raw, tzt)
                codes = defer_render(ctx, d, f"DATEFORMAT({cb.name})",
                                     "dateformat", cb.type, raw, ok, fmt=fmt)
                return ExprValue(codes, v.valid)

            return BoundExpression(
                Attribute(f"DATEFORMAT({cb.name})", DataType.STRING,
                          cb.nullable), g, d)
        lo, hi = int(self.domain[0]), int(self.domain[1])
        if lo < 0:
            raise TypeError_(
                "DATEFORMAT device path requires domain lo >= 0 "
                "(the reference truncates pre-epoch instants toward zero)")
        if cb.type == DataType.DATE:
            g_in, g_sec = 1, 86_400           # a bucket is a day value
        else:
            g_sec = _format_granule_sec(fmt)
            g_in = g_sec * US_PER_SEC         # a bucket is us // g_in
        # a local shift moves an instant by at most +-15 h
        pad = (15 * 3600 * US_PER_SEC) // g_in + 1 if tzt is not None else 0
        blo, bhi = lo // g_in - pad, hi // g_in + pad
        size = bhi - blo + 1
        if size <= 0 or size > self.DOMAIN_MAX:
            raise TypeError_(
                f"DATEFORMAT domain needs {size} dictionary entries, over "
                f"the {self.DOMAIN_MAX} budget — coarsen the format or "
                f"materialize via ops/host.py::to_string")

        def _render(bucket: int) -> str:
            s = _time.strftime(fmt, _time.gmtime(bucket * g_sec))
            return s if len(s) <= 32 else ""  # the reference's 33 bytes

        # the renderings, deduplicated into a sorted (order-preserving)
        # dictionary, and a bucket -> code LUT
        rendered = [_render(b) for b in range(blo, bhi + 1)]
        uniq = sorted(set(rendered))
        code_of = {s: i for i, s in enumerate(uniq)}
        remap = BoundLut(np.fromiter((code_of[s] for s in rendered),
                                     dtype=np.int32, count=size))
        d = Dictionary(tuple(uniq))
        lut_name = f"DATEFORMAT{'_LOCAL' if self.local else ''}"

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            raw = v.values.to(torch.int64)
            if cb.type == DataType.DATE:
                bucket = raw
            else:
                us = _tz.local_shift(raw, tzt) if tzt is not None else raw
                bucket = _fdiv(us, g_in)
            ctx.flag_error(
                f"{lut_name}({cb.name}) value outside declared domain",
                v.valid_or_true() & ((raw < lo) | (raw > hi)))
            return ExprValue(take_small(remap, bucket - blo), v.valid)

        return BoundExpression(
            Attribute(f"{lut_name}({cb.name})", DataType.STRING,
                      cb.nullable), f, d)


def DateFormatLocal(child, format, domain=None):
    """Reference: date_expressions.h:175 (localtime_r rendering)."""
    return DateFormat(child, format, domain=domain, local=True)


# --- singular adds and the const/Now factories (date_expressions.h:55-150) --

def AddDay(child):
    """Add one day (reference: date_expressions.h AddDay)."""
    from .terminal import Const

    return AddDays(child, Const(1))


def AddMinute(child):
    """Add one minute (reference: date_expressions.h AddMinute)."""
    from .terminal import Const

    return AddMinutes(child, Const(1))


def AddMonth(child):
    """Add one month (reference: date_expressions.h AddMonth)."""
    from .terminal import Const

    return AddMonths(child, Const(1))


def ConstDateTimeFromMicrosecondsSinceEpoch(value):
    """reference: date_expressions.h:36-39."""
    from .terminal import Const

    return Const(int(value), DataType.DATETIME)


def ConstDateTimeFromSecondsSinceEpoch(value):
    """reference: date_expressions.h:32-35 (whole seconds)."""
    from .terminal import Const

    return Const(int(value) * US_PER_SEC, DataType.DATETIME)


def Now():
    """DATETIME constant of the time Now() is called (reference:
    date_expressions.h:41-43)."""
    from .terminal import Const

    return Const(int(_time.time() * US_PER_SEC), DataType.DATETIME)


def ParseDateTime(format, e):
    """Declared at date_expressions.h:80 but not implemented in the
    reference; rejected here for the same surface (parse a DATETIME from a
    string with ParseStringNulling/ParseStringQuiet)."""
    raise TypeError_(
        "ParseDateTime is unimplemented in the reference engine; use "
        "ParseStringNulling/ParseStringQuiet with output type DATETIME")
