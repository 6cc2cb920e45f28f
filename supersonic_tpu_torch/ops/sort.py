"""Sort: multi-column ORDER BY with ASC/DESC and NULL ordering.

Port of ``Sort``, ``sort_permutation`` and ``sort_table`` from
``supersonic_tpu/ops/sort.py`` (reference: cursor/core/sort.cc:150-322).
The permutation comes from stable ``torch.sort`` passes over monotone key
codes (ops/keys.py), least significant key first, which is a stable
lexicographic sort; the rows then move with one ``gather_table``.
``sort_table`` codes FLOAT keys by the total order of their bits, as the
JAX package's does; ``sort_permutation`` keeps monotone codes.  The JAX
package's operand packing existed to shorten ``lax.sort``'s operand list
and has no counterpart here.  NULLs sort first ascending and last
descending (sort.cc:44-47); padding and rows a fused Filter or a masked
join dropped sort last and fall outside ``num_rows``.

``ExtendedSort`` adds case-insensitive STRING keys (a dictionary remap LUT
read through ``take_small``) and a limit; ``SortWithTempDirPrefix`` sorts
in device memory when its working set fits ``memory_limit``, else through
the external sort of ``io/external.py`` as a lazy leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .. import tracing
from ..batch import Column, Table, gather_table, pad_table
from ..dictionary import transform as dict_transform
from ..kernels.lut_gather import BoundLut, take_small
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType, physical_dtype
from .base import (BindContext, BoundOperation, Operation, RunContext,
                   placeholder)
from .keys import key_operands


@dataclass(frozen=True)
class SortKey:
    """One ORDER BY key (reference: SortOrder entry, ordering.h:24-60)."""

    name: str
    ascending: bool = True
    case_sensitive: bool = True  # ExtendedSort only


class SortOrder:
    def __init__(self, keys: Sequence[SortKey | tuple | str]):
        norm = []
        for k in keys:
            if isinstance(k, SortKey):
                norm.append(k)
            elif isinstance(k, str):
                norm.append(SortKey(k))
            else:
                norm.append(SortKey(*k))
        self.keys: list[SortKey] = norm

    def names(self) -> list[str]:
        return [k.name for k in self.keys]

    def ascendings(self) -> list[bool]:
        return [k.ascending for k in self.keys]


def sort_permutation(table: Table, order: SortOrder, pad_mask=None,
                     float_bits: bool = False) -> torch.Tensor:
    """int64 row permutation realizing the sort (reference:
    SortPermutation, sort.cc:781).  Stable: equal keys keep input order.
    Keys take monotone codes (-0.0 equals +0.0, NaN last), as the JAX
    package's ``key_operands`` do; ``float_bits`` codes FLOAT keys as
    ``sort_table`` does."""
    ops = key_operands(table, order.names(), order.ascendings(), pad_mask,
                       float_bits)
    perm = torch.arange(table.capacity, device=table.device)
    for op in reversed(ops):
        perm = perm[torch.sort(op[perm], stable=True).indices]
    return perm


def _shadow(table: Table, key_override) -> Table:
    """``table`` with the values of some key columns replaced (for their
    codes only)."""
    if not key_override:
        return table
    cols = dict(table.columns)
    for name, vals in key_override.items():
        cols[name] = cols[name]._replace(values=vals)
    return Table(table.schema, cols, table.num_rows, table.device,
                 table.dicts, cap_hint=table.capacity)


def sort_table(table: Table, order: SortOrder, pad_mask=None,
               num_rows=None, key_override=None) -> Table:
    """The whole Table in sort order; ``pad_mask`` marks rows to drop
    (default: rows past num_rows), which then sort last.  A FLOAT key
    orders by the signed IEEE total order of its bits (``keys.f32_code``,
    the JAX ``sort_table``'s ``_f32_code``): -0.0 before +0.0, a NaN by its
    sign bit and payload; DESC reverses it.  ``key_override`` maps key
    columns to the values their codes come from (ExtendedSort's
    case-folded codes); the output keeps the table's own values."""
    perm = sort_permutation(_shadow(table, key_override), order, pad_mask,
                            float_bits=True)
    return gather_table(table, perm.to(torch.int32),
                        table.num_rows if num_rows is None else num_rows)


class Sort(Operation):
    """reference: Sort(sort_order, result_projector, mem_limit, child)
    (sort.h)."""

    def __init__(self, order: SortOrder | Sequence, child: Operation,
                 result_projector=None):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.child = child
        self.result_projector = result_projector

    def bind(self, ctx: BindContext) -> BoundOperation:
        from .aggregate import GroupAggregate
        from .hash_join import bind_fused

        def plain_bind(op):
            # an aggregate child skips its insertion-order re-rank (tie
            # order among equal sort keys becomes key order; the
            # reference's unstable std::sort promises none either)
            if (isinstance(op, GroupAggregate)
                    and op.options.max_unique_keys_in_result is None):
                return op.bind(ctx, _unordered=True)
            return op.bind(ctx)

        # the fused Filters' and a masked join's keep becomes the pad mask
        cb, run_child = bind_fused(self.child, ctx, plain_bind)
        for k in self.order.keys:
            cb.schema.lookup(k.name)
        order = self.order
        proj_pairs = (self.result_projector.resolve(cb.schema)
                      if self.result_projector else None)
        if proj_pairs is not None:
            out_schema = TupleSchema([
                Attribute(dst, cb.schema.lookup(src).type,
                          cb.schema.lookup(src).nullable,
                          cb.schema.lookup(src).enum)
                for src, dst in proj_pairs])
            out_dicts = {dst: cb.dicts[src] for src, dst in proj_pairs
                         if src in cb.dicts}
        else:
            out_schema, out_dicts = cb.schema, cb.dicts

        def fn(rctx: RunContext) -> Table:
            t, keep = run_child(rctx)
            if keep is not None:
                sorted_t = sort_table(t, order, pad_mask=~keep,
                                      num_rows=keep.sum())
            else:
                sorted_t = sort_table(t, order)
            if proj_pairs is None:
                return sorted_t
            cols = {dst: sorted_t.columns[src] for src, dst in proj_pairs}
            return Table(out_schema, cols, sorted_t.num_rows, t.device,
                         out_dicts, cap_hint=sorted_t.capacity)

        if proj_pairs is not None:
            out_stats = {dst: cb.stats[src] for src, dst in proj_pairs
                         if src in cb.stats}
        else:
            out_stats = dict(cb.stats)
        return BoundOperation(out_schema, out_dicts, fn, cb.capacity,
                              stats=out_stats)


def _limit_rows(n, limit: int):
    return min(n, limit) if isinstance(n, int) else n.clamp(max=limit)


class ExtendedSort(Operation):
    """Sort with per-key case-insensitivity and an optional row limit
    (reference: ExtendedSort / specification_builder.cc, which injects a
    ToLower key transform; here a dictionary remap LUT of the folded
    values' codes)."""

    def __init__(self, order: SortOrder | Sequence, child: Operation,
                 limit: Optional[int] = None):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.child = child
        self.limit = limit

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        order = self.order
        luts: dict = {}
        for k in order.keys:
            attr = cb.schema.lookup(k.name)
            if not k.case_sensitive:
                if attr.type not in (DataType.STRING, DataType.BINARY):
                    raise SchemaError(
                        f"case-insensitive sort key {k.name!r} must be STRING")
                _, remap = dict_transform(cb.dicts[k.name],
                                          lambda v: v.lower())
                luts[k.name] = BoundLut(remap)
        limit = self.limit
        out_cap = min(cb.capacity, limit) if limit else cb.capacity

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            override = {name: take_small(lut, t.columns[name].values)
                        for name, lut in luts.items()}
            if (limit is not None and len(t.schema)
                    and out_cap * 4 <= cb.capacity):
                # top K: order the keys alone, then gather the K rows
                perm = sort_permutation(_shadow(t, override), order)
                return gather_table(t, perm[:out_cap].to(torch.int32),
                                    _limit_rows(t.num_rows, limit))
            sorted_t = sort_table(t, order, key_override=override)
            if limit is None:
                return sorted_t
            cols = {name: Column(c.values[:out_cap],
                                 None if c.valid is None
                                 else c.valid[:out_cap])
                    for name, c in sorted_t.columns.items()}
            return Table(t.schema, cols, _limit_rows(t.num_rows, limit),
                         t.device, dict(t.dicts), cap_hint=out_cap)

        return BoundOperation(cb.schema, cb.dicts, fn, out_cap,
                              stats=dict(cb.stats))


def sort_working_set_bytes(schema: TupleSchema, capacity: int,
                           num_keys: int) -> int:
    """The JAX package's estimate of the device memory a sort of
    ``capacity`` rows takes: every column and a validity byte a nullable
    column, plus 8 bytes a key code, held as input and as output.  Kept as
    it is, since ``SortWithTempDirPrefix``'s route and run size follow
    from it."""
    row = 0
    for a in schema:
        row += int(physical_dtype(a.type).itemsize) + int(a.nullable)
    row += 8 * max(num_keys, 1)
    return 2 * capacity * row


class SortWithTempDirPrefix(Operation):
    """Sort under the reference's ``buffer_memory_limit`` (sort.h:89-98):
    an input past the limit sorts externally over spilled runs
    (sort.cc:467-571).

    Without a ``memory_limit``, or when ``sort_working_set_bytes`` fits
    it, this is ``Sort``.  Otherwise the child binds once and the sort
    becomes a lazy leaf: at execution its producer runs the child, feeds
    runs of the limit's rows (slices of the child's device columns)
    through ``io/external.ExternalSorter`` (sorted on the device, spilled
    under ``temporary_directory_prefix``, merged on the host), and the
    sorted table comes back to the device as the leaf."""

    def __init__(self, order, child, result_projector=None,
                 memory_limit=None, temporary_directory_prefix=None):
        self.order = order if isinstance(order, SortOrder) else SortOrder(order)
        self.child = child
        self.result_projector = result_projector
        self.memory_limit = memory_limit
        self.temp_prefix = temporary_directory_prefix

    def bind(self, ctx: BindContext) -> BoundOperation:
        if self.memory_limit is None:
            return Sort(self.order, self.child,
                        self.result_projector).bind(ctx)
        # the route from the child's shape, bound in a throwaway context
        probe = self.child.bind(BindContext())
        need = sort_working_set_bytes(probe.schema, probe.capacity,
                                      len(self.order.keys))
        if need <= int(self.memory_limit):
            return Sort(self.order, self.child,
                        self.result_projector).bind(ctx)
        from ..io.external import ExternalSorter
        from .base import materialize_bound

        cb = self.child.bind(ctx)
        row_bytes = max(1, need // max(2 * cb.capacity, 1) * 2)
        run_rows = max(1, int(self.memory_limit) // row_bytes)
        order, temp_prefix = self.order, self.temp_prefix
        out_cap, schema = cb.capacity, cb.schema

        def producer(leaves, cancel) -> Table:
            src = materialize_bound(cb, leaves, cancel)
            n = int(tracing.to_host(src.num_rows, "sort.num_rows"))
            with ExternalSorter(schema, order, run_rows, temp_prefix,
                                device=src.device) as sorter:
                for start in range(0, n, run_rows):
                    if cancel is not None:
                        cancel.check()
                    stop = min(start + run_rows, n)
                    sorter.write_arrays(
                        {a.name: (src.columns[a.name].values[start:stop],
                                  None if src.columns[a.name].valid is None
                                  else src.columns[a.name].valid[start:stop])
                         for a in schema}, dict(src.dicts), stop - start)
                return pad_table(sorter.result(capacity=out_cap), out_cap)

        idx = ctx.register_lazy_leaf(
            placeholder(schema, out_cap, cb.dicts), producer)
        proj_pairs = (None if self.result_projector is None
                      else self.result_projector.resolve(schema))
        if proj_pairs is None:
            out_schema, out_dicts = schema, dict(cb.dicts)
        else:
            out_schema = TupleSchema([
                Attribute(dst, schema.lookup(src_n).type,
                          schema.lookup(src_n).nullable,
                          schema.lookup(src_n).enum)
                for src_n, dst in proj_pairs])
            out_dicts = {dst: cb.dicts[src_n] for src_n, dst in proj_pairs
                         if src_n in cb.dicts}

        def fn(rctx: RunContext) -> Table:
            t = rctx.leaf_tables[idx]
            if proj_pairs is None:
                return t
            return Table(out_schema,
                         {dst: t.columns[src_n] for src_n, dst in proj_pairs},
                         t.num_rows, t.device,
                         {dst: t.dicts[src_n] for src_n, dst in proj_pairs
                          if src_n in t.dicts}, cap_hint=out_cap)

        return BoundOperation(out_schema, out_dicts, fn, out_cap)
