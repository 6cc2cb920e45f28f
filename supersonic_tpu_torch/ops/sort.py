"""Sort: multi-column ORDER BY with ASC/DESC and NULL ordering.

Port of ``Sort``, ``sort_permutation`` and ``sort_table`` from
``supersonic_tpu/ops/sort.py`` (reference: cursor/core/sort.cc:150-322).
The permutation comes from stable ``torch.sort`` passes over monotone key
codes (ops/keys.py), least significant key first, which is a stable
lexicographic sort; the rows then move with one ``gather_table``.  The JAX
package's operand packing existed to shorten ``lax.sort``'s operand list
and has no counterpart here.  NULLs sort first ascending and last
descending (sort.cc:44-47); padding and rows a fused Filter or a masked
join dropped sort last and fall outside ``num_rows``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..batch import Table, gather_table
from ..schema import Attribute, TupleSchema
from .base import BindContext, BoundOperation, Operation, RunContext
from .keys import key_operands


@dataclass(frozen=True)
class SortKey:
    """One ORDER BY key (reference: SortOrder entry, ordering.h:24-60)."""

    name: str
    ascending: bool = True
    case_sensitive: bool = True  # ExtendedSort only (not ported)


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


def sort_permutation(table: Table, order: SortOrder,
                     pad_mask=None) -> torch.Tensor:
    """int64 row permutation realizing the sort (reference:
    SortPermutation, sort.cc:781).  Stable: equal keys keep input order."""
    ops = key_operands(table, order.names(), order.ascendings(), pad_mask)
    perm = torch.arange(table.capacity, device=table.device)
    for op in reversed(ops):
        perm = perm[torch.sort(op[perm], stable=True).indices]
    return perm


def sort_table(table: Table, order: SortOrder, pad_mask=None,
               num_rows=None) -> Table:
    """The whole Table in sort order; ``pad_mask`` marks rows to drop
    (default: rows past num_rows), which then sort last."""
    perm = sort_permutation(table, order, pad_mask)
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
        from .filter import bind_predicates, keep_mask, unwrap_filters
        from .hash_join import binds_masked
        inner, preds = unwrap_filters(self.child)
        # a UNIQUE join child (INNER or LEFT_OUTER) binds masked and its
        # keep mask becomes the pad mask; a NOT_UNIQUE one binds unmasked;
        # an aggregate child skips its insertion-order re-rank
        # (tie order among equal sort keys becomes key order; the
        # reference's unstable std::sort promises none either)
        masked_join = binds_masked(inner)
        if masked_join:
            cb = inner.bind(ctx, _masked=True)
        elif (isinstance(inner, GroupAggregate)
              and inner.options.max_unique_keys_in_result is None):
            cb = inner.bind(ctx, _unordered=True)
        else:
            cb = inner.bind(ctx)
        bound_preds = bind_predicates(preds, cb)
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
            if masked_join:
                t, keep = cb.run(rctx)
            else:
                t, keep = cb.run(rctx), None
            if bound_preds:
                pk = keep_mask(bound_preds, rctx, t)
                keep = pk if keep is None else (keep & pk)
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
