"""Compute: evaluate an expression list over the input.

Port of ``supersonic_tpu/ops/compute.py`` (reference: cursor/core/
compute.cc:38).  Each expression runs eagerly over the whole capacity-padded
input; the output keeps the input's row count.  Like the JAX package, it
forwards no planner statistics: a computed column has no known range.
"""
from __future__ import annotations

from typing import Sequence

from ..batch import Column, Table
from ..exprs.base import Expression
from ..schema import TupleSchema
from .base import BindContext, BoundOperation, Operation, RunContext


class Compute(Operation):
    def __init__(self, expressions: Sequence[Expression] | Expression,
                 child: Operation):
        if isinstance(expressions, Expression):
            expressions = [expressions]
        self.expressions = list(expressions)
        self.child = child

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        bounds = [e.bind(cb.schema, cb.dicts) for e in self.expressions]
        schema = TupleSchema([b.attr for b in bounds])
        dicts = {b.attr.name: b.dictionary for b in bounds
                 if b.dictionary is not None}

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            ectx = rctx.eval_context(t)
            cols = {}
            for b in bounds:
                v = b.evaluate(ectx)
                cols[b.attr.name] = Column(
                    v.values, v.valid if b.attr.nullable else None)
            return Table(schema, cols, t.num_rows, t.device, dicts,
                         cap_hint=t.capacity)

        return BoundOperation(schema, dicts, fn, cb.capacity)
