"""Filter: BOOL predicate -> compacted survivors.

Port of ``supersonic_tpu/ops/filter.py`` (reference: cursor/core/
filter.cc:65-230; NULL counts as false, filter.cc:169-198).  Survivors move
through the compaction kernel (kernels/compaction.py) in one pass, every
column and validity mask together.  Sort, GroupAggregate and HashJoin fuse
a child Filter instead (``unwrap_filters`` + ``keep_mask``): the predicate
becomes their keep mask and nothing is compacted.
"""
from __future__ import annotations

import torch

from ..batch import Column, Table
from ..exprs.base import Expression
from ..types import DataType, TypeError_
from .base import BindContext, BoundOperation, Operation, RunContext


def compact_arrays(payload: list[torch.Tensor], mask: torch.Tensor,
                   out_cap: int) -> list[torch.Tensor]:
    """Stable-compact rows where ``mask`` is True to a dense prefix of each
    payload array."""
    from ..kernels.compaction import compact_kernel

    return compact_kernel(payload, mask, out_cap)[0]


def compact_by_mask(table: Table, mask: torch.Tensor,
                    out_capacity: int | None = None) -> Table:
    """Move rows where mask is True into a dense prefix."""
    from ..kernels.compaction import compact_kernel

    out_cap = out_capacity or table.capacity
    payload: list[torch.Tensor] = []
    layout: list[tuple[str, bool]] = []  # (name, has_valid)
    for name in table.schema.names():
        c = table.columns[name]
        payload.append(c.values)
        if c.valid is not None:
            payload.append(c.valid)
        layout.append((name, c.valid is not None))
    moved, count = compact_kernel(payload, mask, out_cap)
    cols: dict[str, Column] = {}
    i = 0
    for name, has_valid in layout:
        vals = moved[i]
        i += 1
        valid = None
        if has_valid:
            valid = moved[i]
            i += 1
        cols[name] = Column(vals, valid)
    return Table(table.schema, cols, count, table.device, dict(table.dicts),
                 cap_hint=out_cap)


def unwrap_filters(op):
    """Peel Filter wrappers off a plan node: (inner_child, [predicates])."""
    preds = []
    while isinstance(op, Filter):
        preds.append(op.predicate)
        op = op.child
    return op, preds


def bind_predicates(preds, cb):
    bounds = []
    for p in preds:
        b = p.bind(cb.schema, cb.dicts)
        if b.type != DataType.BOOL:
            raise TypeError_(f"filter predicate must be BOOL, got {b.type}")
        bounds.append(b)
    return bounds


def keep_mask(bound_preds, rctx, t: Table) -> torch.Tensor:
    """row_mask AND all predicates (NULL counts as false)."""
    keep = t.row_mask()
    ectx = rctx.eval_context(t)
    for b in bound_preds:
        v = b.evaluate(ectx)
        keep = keep & v.values
        if v.valid is not None:
            keep = keep & v.valid
    return keep


class Filter(Operation):
    def __init__(self, predicate: Expression, child: Operation,
                 out_capacity: int | None = None):
        self.predicate = predicate
        self.child = child
        self.out_capacity = out_capacity

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        preds = bind_predicates([self.predicate], cb)
        out_cap = self.out_capacity or cb.capacity

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            return compact_by_mask(t, keep_mask(preds, rctx, t), out_cap)

        return BoundOperation(cb.schema, cb.dicts, fn, out_cap,
                              stats=dict(cb.stats))
