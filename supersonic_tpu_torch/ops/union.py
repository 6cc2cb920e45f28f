"""UnionAll: plain row concatenation of same-schema children.

Port of ``supersonic_tpu/ops/union.py`` (the reference ships only the
sorted MergeUnionAll, cursor/core/merge_union_all.cc, and reserves a
PARALLEL_UNION cursor id without implementing it, cursor/proto/
cursors.proto:25).  Output capacity is the sum of the children's; each
child's rows are written at the running count of the live rows before it,
a device scalar, so nothing waits on the host.  STRING/BINARY dictionaries
merge at bind; each child's codes move into the merged dictionary through
one ``lut_gather`` of its bind-time remap.  MergeUnionAll shares that
dictionary merge and remap.
"""
from __future__ import annotations

import numpy as np
import torch

from ..batch import Column, Table
from ..dictionary import merge as dict_merge
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import is_variable_length, torch_dtype
from .base import BindContext, BoundOperation, Operation, RunContext


def bind_dictionaries(schema: TupleSchema, cbs) -> tuple[dict, list]:
    """Merge the children's STRING/BINARY dictionaries: (merged dicts,
    per child {column: int32 remap, old code -> merged code}).  A child
    whose codes keep their meaning gets no remap."""
    dicts: dict = {}
    remaps: list[dict] = [dict() for _ in cbs]
    for a in schema:
        if not is_variable_length(a.type):
            continue
        merged = cbs[0].dicts[a.name]
        maps = [np.arange(max(len(merged), 1), dtype=np.int32)]
        for cb in cbs[1:]:
            merged, ra, rb = dict_merge(merged, cb.dicts[a.name])
            maps = [ra[m] for m in maps]
            maps.append(rb)
        dicts[a.name] = merged
        for j, m in enumerate(maps):
            if not np.array_equal(m, np.arange(m.shape[0])):
                remaps[j][a.name] = m
    return dicts, remaps


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, copied without a host sync."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def remap_codes(table: Table, remap: dict) -> dict[str, Column]:
    """The table's columns with each remapped column's codes moved into the
    merged dictionary (clipped into the remap's range, so codes of dead
    rows stay harmless)."""
    from ..kernels.lut_gather import lut_gather

    cols = dict(table.columns)
    for name, lut in remap.items():
        c = cols[name]
        code = lut_gather([_upload(lut, table.device)], c.values,
                          lut.shape[0])[0]
        cols[name] = Column(code, c.valid)
    return cols


def union_schema(cbs, what: str) -> TupleSchema:
    """The children's common schema, nullable where any child's column is;
    raises unless they agree on names and types."""
    first = cbs[0].schema
    for cb in cbs[1:]:
        if cb.schema.names() != first.names():
            raise SchemaError(f"{what} schema mismatch: {cb.schema.names()} "
                              f"vs {first.names()}")
        for a, b in zip(first, cb.schema):
            if a.type != b.type:
                raise SchemaError(
                    f"{what} column {a.name}: {a.type} vs {b.type}")
    return TupleSchema([
        Attribute(a.name, a.type,
                  any(cb.schema.attribute(i).nullable for cb in cbs), a.enum)
        for i, a in enumerate(first)])


class UnionAll(Operation):
    def __init__(self, *children: Operation):
        if not children:
            raise SchemaError("UNION ALL needs at least one input")
        self.children = list(children)

    def bind(self, ctx: BindContext) -> BoundOperation:
        cbs = [c.bind(ctx) for c in self.children]
        schema = union_schema(cbs, "UNION ALL")
        dicts, remaps = bind_dictionaries(schema, cbs)
        cap = sum(cb.capacity for cb in cbs)

        def fn(rctx: RunContext) -> Table:
            tables = [cb.run(rctx) for cb in cbs]
            dev = tables[0].device
            vals = {a.name: torch.empty(cap, dtype=torch_dtype(a.type),
                                        device=dev) for a in schema}
            oks = {a.name: torch.empty(cap, dtype=torch.bool, device=dev)
                   for a in schema if a.nullable}
            # child j covers [offset, offset + capacity): its dead rows land
            # where the next child's live rows then overwrite them
            offset = 0
            for t, remap in zip(tables, remaps):
                cols = remap_codes(t, remap)
                idx = torch.arange(t.capacity, device=dev) + offset
                live = t.row_mask()
                for a in schema:
                    c = cols[a.name]
                    vals[a.name].index_copy_(0, idx, c.values)
                    if a.nullable:
                        oks[a.name].index_copy_(
                            0, idx, live if c.valid is None else c.valid & live)
                offset = offset + t.num_rows
            cols = {a.name: Column(vals[a.name], oks.get(a.name))
                    for a in schema}
            return Table(schema, cols, offset, dev, dicts, cap_hint=cap)

        return BoundOperation(schema, dicts, fn, cap)
