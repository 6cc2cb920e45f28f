"""Limit: an offset and a row-count window (reference: cursor/core/
limit.cc:42).  Port of ``supersonic_tpu/ops/limit.py``: one
``gather_table`` (one ``lut_gather`` launch on the card) at
``offset + position``; the positions past the window point past the
input's capacity and fall outside ``num_rows``.
"""
from __future__ import annotations

import torch

from ..batch import Table, gather_table
from .base import BindContext, BoundOperation, Operation, RunContext


class Limit(Operation):
    def __init__(self, offset: int, limit: int, child: Operation):
        self.offset = offset
        self.limit = limit
        self.child = child

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        offset, limit = self.offset, self.limit
        out_cap = min(cb.capacity, max(limit, 1))

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            if isinstance(t.num_rows, int):
                n = min(max(t.num_rows - offset, 0), limit)
            else:
                n = (t.num_rows - offset).clamp(0, limit)
            if len(cb.schema) == 0:
                return Table(cb.schema, {}, n, t.device, dict(t.dicts),
                             cap_hint=out_cap)
            pos = torch.arange(out_cap, device=t.device)
            idx = torch.where(pos < n, pos + offset, t.capacity)
            return gather_table(t, idx.to(torch.int32), n)

        return BoundOperation(cb.schema, cb.dicts, fn, out_cap,
                              stats=dict(cb.stats))
