"""Row hashing and fingerprint expressions.

Port of ``supersonic_tpu/exprs/hashing.py`` (reference: expression/ext/
hashing/hashing_expressions.h:37-40: ``Hash(expr)`` and
``Fingerprint(exprs...)``).  The values are the JAX package's, bit for bit:
the engine's 32-bit mixers (parallel/hashing.py) over each value's
``monotone_code``, widened to UINT64.
"""
from __future__ import annotations

import torch

from ..ops.keys import monotone_code
from ..parallel.hashing import NULL_HASH, _fold32, _mix32, as_u32
from ..schema import Attribute
from ..types import DataType
from .base import BoundExpression, EvalContext, Expression, ExprValue, wrap


def _hash_one(bound, ctx: EvalContext) -> torch.Tensor:
    """A value's hash word (int32 bits), NULL as the sentinel."""
    v = bound.evaluate(ctx)
    h = _mix32(_fold32(monotone_code(v.values, bound.type)))
    if v.valid is not None:
        h = torch.where(v.valid, h, NULL_HASH)
    return h


class Hash(Expression):
    """Per-value hash -> UINT64; NULL hashes to a fixed sentinel
    (reference: types_infrastructure.h:440, NULL -> 0xdeadbabe)."""

    def __init__(self, child):
        self.child = wrap(child)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)

        def fn(ctx: EvalContext) -> ExprValue:
            return ExprValue(as_u32(_hash_one(cb, ctx)), None)

        return BoundExpression(
            Attribute(f"HASH({cb.name})", DataType.UINT64, False), fn)


class Fingerprint(Expression):
    """Combined row fingerprint over one or more expressions -> UINT64
    (reference: Fingerprint; combine h = h * 29 + item,
    types_infrastructure.h:410-440)."""

    def __init__(self, *children):
        self.children = [wrap(c) for c in children]

    def do_bind(self, schema, dicts):
        bounds = [c.do_bind(schema, dicts) for c in self.children]
        name = f"FINGERPRINT({', '.join(b.name for b in bounds)})"

        def fn(ctx: EvalContext) -> ExprValue:
            h = None
            for b in bounds:
                hb = _hash_one(b, ctx)
                h = hb if h is None else h * 29 + hb
            return ExprValue(as_u32(_mix32(h)), None)

        return BoundExpression(Attribute(name, DataType.UINT64, False), fn)


SupersonicFingerprint = Fingerprint  # reference: hashing_expressions.h:28


class SupersonicHash(Expression):
    """HASH(e, seed) -> UINT64 (reference: hashing_expressions.h:35-36):
    the seed's hash folded into the value's mix."""

    def __init__(self, child, seed):
        self.child = wrap(child)
        self.seed = wrap(seed)

    def do_bind(self, schema, dicts):
        cb = self.child.do_bind(schema, dicts)
        sb = self.seed.do_bind(schema, dicts)

        def fn(ctx: EvalContext) -> ExprValue:
            h = _hash_one(cb, ctx)
            s = sb.evaluate(ctx)
            sh = _mix32(_fold32(monotone_code(s.values, sb.type)))
            return ExprValue(as_u32(_mix32(h ^ sh)), None)

        return BoundExpression(
            Attribute(f"HASH({cb.name}, {sb.name})", DataType.UINT64,
                      False), fn)
