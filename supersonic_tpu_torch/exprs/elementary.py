"""Elementary expressions: ``IsNull`` and ``IfNull``.

Port of ``unify_branches``, ``IsNull`` and ``IfNull`` from
``supersonic_tpu/exprs/elementary.py`` (reference: expression/core/
elementary_expressions.h:24-124, elementary_bound_expressions.cc).  ``If``,
``Case`` and the casts are ROADMAP.md queue 1 item 14.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..dictionary import Dictionary, merge as dict_merge
from ..schema import Attribute
from ..types import (DataType, TypeError_, common_numeric_type, is_numeric,
                     torch_dtype)
from .base import (BoundExpression, EvalContext, Expression, ExprValue,
                   wrap)


def _remap(lut: np.ndarray):
    """values -> lut[values] (clipped into range), one ``lut_gather``."""
    from ..kernels.lut_gather import lut_gather

    def conv(v: torch.Tensor) -> torch.Tensor:
        return lut_gather([torch.from_numpy(lut).to(v.device)], v,
                          lut.shape[0])[0]
    return conv


def unify_branches(bounds: Sequence[BoundExpression]):
    """Common result type of several branches: (result type, convert
    functions, merged dictionary), where ``convert[i](values)`` maps branch
    i's values into the result space.  STRING/BINARY branches merge their
    dictionaries and remap each branch's codes."""
    types = [b.type for b in bounds]
    if all(t in (DataType.STRING, DataType.BINARY) for t in types):
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
        dt = torch_dtype(rt)
        return rt, [lambda v, dt=dt: v.to(dt) for _ in bounds], None
    raise TypeError_(f"cannot unify branch types {types}")


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
