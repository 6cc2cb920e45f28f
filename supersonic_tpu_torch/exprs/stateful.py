"""Stateful (cross-row, order-dependent) expressions.

Port of ``supersonic_tpu/exprs/stateful.py`` (reference: expression/core/
stateful_expressions.h:39-69: Changed, RunningSum, Smudge, SmudgeIf,
RunningMinWithFlush).  The reference carries state from row to row; here
each is a whole-column scan (ops/segscan.py, ``torch.cumsum``).  Live rows
are a dense prefix, so the padding past them never reaches a live row's
state.
"""
from __future__ import annotations

import torch

from ..ops.keys import monotone_code
from ..ops.segscan import seg_carry_first, seg_cummax, seg_cummin
from ..schema import Attribute
from ..types import DataType, TypeError_, wrap_u32
from .base import BoundExpression, EvalContext, Expression, ExprValue, wrap


def _seen(valid: torch.Tensor) -> torch.Tensor:
    """True from the first True row of ``valid`` on."""
    return torch.cumsum(valid, 0, dtype=torch.int32) > 0


class Changed(Expression):
    """TRUE where the value differs from the previous row's (the first row
    is TRUE); NULL equals NULL (reference: Changed)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            code = monotone_code(v.values, cb.type)
            valid = v.valid_or_true()
            prev_code = torch.roll(code, 1)
            prev_valid = torch.roll(valid, 1)
            same = ((code == prev_code) & (valid == prev_valid)) \
                | (~valid & ~prev_valid)
            same[:1] = False  # the first row (none in an empty table)
            return ExprValue(~same, None)

        return BoundExpression(
            Attribute(f"CHANGED({cb.name})", DataType.BOOL, False), f)


class RunningSum(Expression):
    """Cumulative sum in the input's type (integers wrap): NULL inputs
    count as zero, and the output is NULL only before the first non-NULL
    value (reference contract: stateful_expressions.h:41-45).  No segment
    restarts, so it is one ``torch.cumsum``."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            x = v.values
            if v.valid is not None:
                x = torch.where(v.valid, x, torch.zeros_like(x))
            if x.is_floating_point():
                sums = torch.cumsum(x, 0)
            else:
                sums = torch.cumsum(x, 0, dtype=torch.int64).to(x.dtype)
                if cb.type == DataType.UINT32:
                    sums = wrap_u32(sums)
            return ExprValue(sums, None if v.valid is None
                             else _seen(v.valid))

        return BoundExpression(
            Attribute(f"RUNNING_SUM({cb.name})", cb.type, cb.nullable), f)


def _forward_fill(values: torch.Tensor, valid: torch.Tensor):
    """(last ``valid`` value so far, whether one was seen): the segmented
    carry-first with ``valid`` as the reset."""
    return seg_carry_first(values, valid), _seen(valid)


class Smudge(Expression):
    """Copy the last non-NULL value down into NULL rows (reference:
    Smudge); leading NULLs stay NULL."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            filled, seen = _forward_fill(v.values, v.valid_or_true())
            return ExprValue(filled, seen if cb.nullable else None)

        return BoundExpression(
            Attribute(f"SMUDGE({cb.name})", cb.type, cb.nullable), f)


class SmudgeIf(Expression):
    """Where the condition is TRUE, the value (and validity) of the last
    row that kept its own (reference: SmudgeIf)."""

    def __init__(self, child, condition):
        self.child = wrap(child)
        self.condition = wrap(condition)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        db = self.condition.do_bind(schema, dicts)
        if db.type != DataType.BOOL:
            raise TypeError_("SmudgeIf condition must be BOOL")

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            c = db.evaluate(ctx)
            keep = ~(c.values & c.valid_or_true())  # rows keeping their own
            valid = v.valid_or_true()
            filled_vals, any_kept = _forward_fill(v.values, keep)
            filled_valid = seg_carry_first(valid, keep)
            return ExprValue(torch.where(keep, v.values, filled_vals),
                             torch.where(keep, valid,
                                         filled_valid & any_kept))

        return BoundExpression(
            Attribute(f"SMUDGE_IF({cb.name})", cb.type, True), f)


def _min_identity(values: torch.Tensor):
    """The largest value of the lane's dtype (+inf for floats)."""
    if values.is_floating_point():
        return float("inf")
    if values.dtype == torch.bool:
        return True
    return torch.iinfo(values.dtype).max


class RunningMinWithFlush(Expression):
    """Running minimum that restarts after rows where ``flush`` is TRUE
    (reference: RunningMinWithFlush): each row's output is the minimum of
    the values since the last flush, the row's own included.  A UINT64
    input compares unsigned (through its ``monotone_code``)."""

    def __init__(self, flush, child):
        self.flush = wrap(flush)
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        fb = self.flush.do_bind(schema, dicts)
        cb = self.child.do_bind(schema, dicts)
        if fb.type != DataType.BOOL:
            raise TypeError_("RunningMinWithFlush flush must be BOOL")
        u64 = cb.type == DataType.UINT64

        def f(ctx: EvalContext) -> ExprValue:
            v = cb.evaluate(ctx)
            fl = fb.evaluate(ctx)
            valid = v.valid_or_true()
            x = monotone_code(v.values, cb.type) if u64 else v.values
            x = torch.where(valid, x, _min_identity(x))
            # a segment restarts AFTER a flushed row
            reset = torch.roll(fl.values & fl.valid_or_true(), 1)
            m = seg_cummin(x, reset)
            if u64:
                m = monotone_code(m, cb.type)
            seen = seg_cummax(valid, reset)
            return ExprValue(m, seen if cb.nullable else None)

        return BoundExpression(
            Attribute(f"RUNNING_MIN_WITH_FLUSH({cb.name})", cb.type,
                      cb.nullable), f)
