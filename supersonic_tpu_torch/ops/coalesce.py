"""Coalesce: the column-wise zip of N children (reference: cursor/core/
coalesce.cc:50: schemas concatenated, duplicate names rejected, children
driven in lockstep).  Port of ``supersonic_tpu/ops/coalesce.py``: a
shorter child's columns are padded to the largest capacity, and the row
count is the least of the children's.
"""
from __future__ import annotations

import torch

from ..batch import Column, Table
from .base import BindContext, BoundOperation, Operation, RunContext


class Coalesce(Operation):
    def __init__(self, *children: Operation):
        self.children = list(children)

    def bind(self, ctx: BindContext) -> BoundOperation:
        cbs = [c.bind(ctx) for c in self.children]
        schema = cbs[0].schema
        for cb in cbs[1:]:
            schema = schema.concat(cb.schema)  # raises on duplicate names
        dicts = {}
        for cb in cbs:
            dicts.update(cb.dicts)
        cap = max(cb.capacity for cb in cbs)

        def pad(x: torch.Tensor) -> torch.Tensor:
            if x.shape[0] == cap:
                return x
            return torch.cat([x, x.new_zeros(cap - x.shape[0])])

        def fn(rctx: RunContext) -> Table:
            tables = [cb.run(rctx) for cb in cbs]
            n = tables[0].num_rows
            for t in tables[1:]:
                if isinstance(n, int) and isinstance(t.num_rows, int):
                    n = min(n, t.num_rows)
                else:
                    n = torch.minimum(torch.as_tensor(n, device=t.device),
                                      torch.as_tensor(t.num_rows,
                                                      device=t.device))
            cols = {}
            for t in tables:
                for name in t.schema.names():
                    c = t.columns[name]
                    cols[name] = Column(pad(c.values), None if c.valid is None
                                        else pad(c.valid))
            return Table(schema, cols, n, tables[0].device, dicts,
                         cap_hint=cap)

        return BoundOperation(schema, dicts, fn, cap)
