"""MergeUnionAll: k-way merge of same-schema sorted inputs.

Port of ``supersonic_tpu/ops/merge.py`` (reference: cursor/core/
merge_union_all.cc:127, a priority queue over the children whose ties go
by child index, then by row order in the child).  Each child is sorted by
the merge order; the merge is a left fold of pairwise merges through the
merge kernel (kernels/merge_sorted.py), child i always entering as side A
before child i + 1, so equal keys keep child order.  Key lanes are the
sort's key operands (ops/keys.py) as signed integers, NaN and -0.0
canonicalized (``sortable_words``): the same rows on the CPU and the card.
The merged key lanes ride into the next fold step; the last step writes
only the columns.  STRING/BINARY dictionaries merge at bind
(``union.bind_dictionaries``) and each child's codes are remapped first, so
codes compare as values.  Live counts stay on the device.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..batch import Column, Table
from ..kernels.merge_sorted import MAX_KEYS, merge_sorted
from ..schema import SchemaError
from .base import (BindContext, BoundOperation, Operation, RunContext,
                   not_ported)
from .keys import key_lanes
from .sort import SortOrder
from .union import bind_dictionaries, remap_codes, union_schema


class MergeUnionAll(Operation):
    def __init__(self, order: SortOrder | Sequence,
                 children: Sequence[Operation]):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.children = list(children)
        if not self.children:
            raise SchemaError("MergeUnionAll needs at least one input")

    def bind(self, ctx: BindContext) -> BoundOperation:
        cbs = [c.bind(ctx) for c in self.children]
        schema = union_schema(cbs, "MergeUnionAll")
        key_lanes_n = sum(1 + schema.lookup(k.name).nullable
                          for k in self.order.keys)
        if key_lanes_n > MAX_KEYS:
            not_ported(f"MergeUnionAll over {key_lanes_n} key lanes (the "
                       f"merge kernel compares {MAX_KEYS})", "13")
        dicts, remaps = bind_dictionaries(schema, cbs)
        names, ascs = self.order.names(), self.order.ascendings()
        out_cap = sum(cb.capacity for cb in cbs)

        def side(t: Table, remap: dict):
            """(key lanes, payload lanes) of one child: every column, and a
            validity lane for each nullable output column."""
            cols = remap_codes(t, remap)
            for a in schema:
                c = cols[a.name]
                if a.nullable and c.valid is None:
                    cols[a.name] = Column(c.values, torch.ones(
                        t.capacity, dtype=torch.bool, device=t.device))
            view = Table(schema, cols, t.num_rows, t.device, dicts)
            keys = key_lanes(view, names, ascs, words=True)
            pays = []
            for a in schema:
                pays.append(cols[a.name].values)
                if a.nullable:
                    pays.append(cols[a.name].valid)
            return keys, pays

        def fn(rctx: RunContext) -> Table:
            tables = [cb.run(rctx) for cb in cbs]
            keys, pays = side(tables[0], remaps[0])
            rows, cap = tables[0].num_rows, tables[0].capacity
            for i, (t, remap) in enumerate(zip(tables[1:], remaps[1:])):
                bk, bp = side(t, remap)
                keys, pays = merge_sorted(
                    keys, pays, bk, bp, cap + t.capacity, rows, t.num_rows,
                    keep_keys=i < len(tables) - 2)
                rows, cap = rows + t.num_rows, cap + t.capacity
            lanes = iter(pays)
            cols = {}
            for a in schema:
                vals = next(lanes)
                cols[a.name] = Column(vals, next(lanes) if a.nullable else None)
            return Table(schema, cols, rows, tables[0].device, dicts,
                         cap_hint=cap)

        return BoundOperation(schema, dicts, fn, out_cap)
