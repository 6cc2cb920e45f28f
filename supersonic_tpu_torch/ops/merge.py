"""MergeUnionAll: k-way merge of same-schema sorted inputs.

Port of ``supersonic_tpu/ops/merge.py`` (reference: cursor/core/
merge_union_all.cc:127, a priority queue over the children whose ties go
by child index, then by row order in the child).  Each child is sorted by
the merge order; the merge is a left fold of pairwise merges through the
merge kernel (kernels/merge_sorted.py), child i always entering as side A
before child i + 1, so equal keys keep child order.  Each step hands the
kernel the columns and validity lanes as they are, with a description of
the merge order over them (``MergeKey``: the key's lane, ASC or DESC, its
validity lane); the kernel codes the keys itself, NaN and -0.0
canonicalized as ``kernels/merge_sorted.py::key_words`` does for the plain
version, so the CPU and the card give the same rows and no key lane is ever
written.
STRING/BINARY dictionaries merge at bind (``union.bind_dictionaries``) and
each child's codes are remapped first, so codes compare as values.  Live
counts stay on the device.  An order of more compare words than the
kernel takes (``MAX_KEYS``) concatenates the children and sorts them
once, stably (``sort_permutation``: monotone codes, so NaN sorts last as
the JAX merge's ``lax.sort`` does).  A UINT64 key column rides the merge as its
``monotone_code`` (the sign bit flipped, an involution) and flips back
after it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..batch import Column, Table, gather_table
from ..kernels.merge_sorted import (MAX_KEYS, MergeKey, compare_words,
                                    merge_sorted)
from ..schema import SchemaError
from ..types import DataType, u64_key
from .base import BindContext, BoundOperation, Operation, RunContext
from .sort import SortOrder, sort_permutation
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
        # lanes of a side: every column, then its validity if nullable
        lane_of, lane = {}, 0
        for a in schema:
            lane_of[a.name] = lane
            lane += 1 + a.nullable
        keys = [MergeKey(lane_of[k.name], k.ascending,
                         lane_of[k.name] + 1 if schema.lookup(k.name).nullable
                         else None) for k in self.order.keys]
        by_sort = compare_words(keys) > MAX_KEYS
        u64 = {k.name for k in self.order.keys
               if schema.lookup(k.name).type == DataType.UINT64}
        dicts, remaps = bind_dictionaries(schema, cbs)
        out_cap = sum(cb.capacity for cb in cbs)

        def side(t: Table, remap: dict) -> list:
            """The lanes of one child, codes remapped."""
            cols = remap_codes(t, remap)
            lanes = []
            for a in schema:
                c = cols[a.name]
                lanes.append(u64_key(c.values) if a.name in u64 else c.values)
                if a.nullable:
                    lanes.append(c.valid if c.valid is not None else
                                 torch.ones(t.capacity, dtype=torch.bool,
                                            device=t.device))
            return lanes

        def sorted_concat(tables) -> Table:
            """More compare words than the kernel takes: the children's
            rows one after another, then one stable sort by the merge
            order (as the JAX package's ``lax.sort`` route), so ties keep
            (child, row) order."""
            dev = tables[0].device
            remapped = [remap_codes(t, remap)
                        for t, remap in zip(tables, remaps)]
            cols = {}
            for a in schema:
                parts = [r[a.name] for r in remapped]
                cols[a.name] = Column(
                    torch.cat([p.values for p in parts]),
                    torch.cat([p.valid if p.valid is not None else
                               torch.ones(p.values.shape[0],
                                          dtype=torch.bool, device=dev)
                               for p in parts]) if a.nullable else None)
            rows = tables[0].num_rows
            for t in tables[1:]:
                rows = rows + t.num_rows
            cat = Table(schema, cols, rows, dev, dicts, cap_hint=out_cap)
            live = torch.cat([t.row_mask() for t in tables])
            perm = sort_permutation(cat, self.order, pad_mask=~live)
            return gather_table(cat, perm.to(torch.int32), rows)

        def fn(rctx: RunContext) -> Table:
            tables = [cb.run(rctx) for cb in cbs]
            if by_sort:
                return sorted_concat(tables)
            lanes = side(tables[0], remaps[0])
            rows, cap = tables[0].num_rows, tables[0].capacity
            for t, remap in zip(tables[1:], remaps[1:]):
                lanes = merge_sorted(lanes, side(t, remap), keys,
                                     cap + t.capacity, rows, t.num_rows)
                rows, cap = rows + t.num_rows, cap + t.capacity
            cols = {a.name: Column(
                u64_key(lanes[lane_of[a.name]]) if a.name in u64
                else lanes[lane_of[a.name]],
                lanes[lane_of[a.name] + 1] if a.nullable else None)
                for a in schema}
            return Table(schema, cols, rows, tables[0].device, dicts,
                         cap_hint=cap)

        return BoundOperation(schema, dicts, fn, out_cap)
