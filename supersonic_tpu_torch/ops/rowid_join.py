"""RowidMergeJoin and ForeignFilter, the reference's streaming FK joins.

Port of ``supersonic_tpu/ops/rowid_join.py`` (reference: cursor/core/
rowid_merge_join.cc:62, an inner join of a left FK column against the
right side's row ids that enforces referential integrity, and
cursor/core/foreign_filter.cc:55, a semi-join of an ascending FK column
against an ascending unique key column that rewrites the FK to the
filter's row ids).  The first is one ``gather_table`` (one ``lut_gather``
launch on the card); the second a binary search (``torch.searchsorted``
stands in for the JAX package's gather-based lower bound, which is no
kernel) and one compaction.
"""
from __future__ import annotations

import torch

from ..batch import Column, Table, gather_table
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext
from .filter import compact_by_mask
from .project import Projector


def _attrs(schema, pairs) -> list:
    return [Attribute(dst, schema.lookup(src).type, schema.lookup(src).nullable,
                      schema.lookup(src).enum) for src, dst in pairs]


class RowidMergeJoin(Operation):
    """The left ``fk`` column's values ARE right row ids; the output is the
    projected left columns and the right columns at fk.  A live row whose
    fk lies outside [0, right rows) raises "rowid join referential
    integrity" (the reference CHECK-fails)."""

    def __init__(self, fk_column: str, lhs: Operation, rhs: Operation,
                 lhs_projector=None, rhs_projector=None):
        self.fk_column = fk_column
        self.lhs = lhs
        self.rhs = rhs
        self.lhs_projector = lhs_projector or Projector.all()
        self.rhs_projector = rhs_projector or Projector.all()

    def bind(self, ctx: BindContext) -> BoundOperation:
        lb = self.lhs.bind(ctx)
        rb = self.rhs.bind(ctx)
        if lb.schema.lookup(self.fk_column).type not in (DataType.INT64,
                                                         DataType.INT32):
            raise SchemaError("RowidMergeJoin fk must be an integer column")
        lpairs = self.lhs_projector.resolve(lb.schema)
        rpairs = self.rhs_projector.resolve(rb.schema)
        out_schema = TupleSchema(_attrs(lb.schema, lpairs)
                                 + _attrs(rb.schema, rpairs))
        out_dicts = {d: lb.dicts[s] for s, d in lpairs if s in lb.dicts}
        out_dicts.update({d: rb.dicts[s] for s, d in rpairs
                          if s in rb.dicts})
        fk_name = self.fk_column

        def fn(rctx: RunContext) -> Table:
            lt = lb.run(rctx)
            rt = rb.run(rctx)
            fk = lt.columns[fk_name].values.to(torch.int32)
            live = lt.row_mask()
            bad = live & ((fk < 0) | (fk >= rt.num_rows))
            rctx.error_flags.append(("rowid join referential integrity",
                                     bad.any()))
            rgath = gather_table(rt, torch.where(live, fk, rt.capacity),
                                 lt.num_rows)
            cols = {d: lt.columns[s] for s, d in lpairs}
            cols.update({d: rgath.columns[s] for s, d in rpairs})
            return Table(out_schema, cols, lt.num_rows, lt.device, out_dicts,
                         cap_hint=lt.capacity)

        return BoundOperation(out_schema, out_dicts, fn, lb.capacity)


class ForeignFilter(Operation):
    """Keep the lhs rows whose ``fk`` appears in the rhs ``key`` column
    (ascending, unique), with fk rewritten to the rhs row id of its match
    (reference: foreign_filter.h:21-40; the output schema is the lhs's)."""

    def __init__(self, fk_column: str, key_column: str,
                 lhs: Operation, rhs: Operation):
        self.fk_column = fk_column
        self.key_column = key_column
        self.lhs = lhs
        self.rhs = rhs

    def bind(self, ctx: BindContext) -> BoundOperation:
        lb = self.lhs.bind(ctx)
        rb = self.rhs.bind(ctx)
        lb.schema.lookup(self.fk_column)
        rb.schema.lookup(self.key_column)
        out_schema = lb.schema
        fk_name, key_name = self.fk_column, self.key_column

        def fn(rctx: RunContext) -> Table:
            lt = lb.run(rctx)
            rt = rb.run(rctx)
            fk_col = lt.columns[fk_name]
            keys = rt.columns[key_name].values
            # padding rows would break the ascending order: they take the
            # dtype's largest value before the search
            big = (float("inf") if keys.is_floating_point()
                   else torch.iinfo(keys.dtype).max)
            keys = torch.where(rt.row_mask(), keys, big)
            dt = torch.promote_types(keys.dtype, fk_col.values.dtype)
            fk = fk_col.values.to(dt)
            pos = torch.searchsorted(keys.to(dt), fk).clamp(
                0, rt.capacity - 1)
            hit = (pos < rt.num_rows) & (keys[pos] == fk)
            cols = dict(lt.columns)
            cols[fk_name] = Column(pos.to(fk_col.values.dtype), fk_col.valid)
            remapped = Table(out_schema, cols, lt.num_rows, lt.device,
                             dict(lt.dicts), cap_hint=lt.capacity)
            return compact_by_mask(remapped, hit & lt.row_mask(),
                                   lt.capacity)

        return BoundOperation(out_schema, dict(lb.dicts), fn, lb.capacity)
