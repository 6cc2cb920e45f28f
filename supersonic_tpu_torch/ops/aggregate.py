"""GroupAggregate over a dense key domain.

Port of the dense path of ``supersonic_tpu/ops/aggregate.py``
(``_dense_domain`` and ``_dense_grouped_aggregate``; reference:
cursor/core/aggregate_groups.cc, column_aggregator.cc).  When the group
keys have planner statistics whose composite range holds at most 2048
slots, every aggregate is one request of ONE keyed segment-reduce launch
(kernels/segment_reduce.py), which reads the raw key lanes and codes the
slots itself; the K slots are then finalized and re-ranked
to the reference's insertion order (first occurrence), unless the consumer
re-orders the rows anyway (Sort binds its child ``_unordered``).

The JAX package binds an aggregate over a UNIQUE join first through its
aggregate pushdown rewrite; the port binds every plan directly, which
gives the same rows (the pushdown is ROADMAP.md queue 1 item 8).  Keys
without dense statistics (the sort-based path), DISTINCT, CONCAT,
``max_unique_keys_in_result`` and memory quotas raise
``NotImplementedError``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..batch import Column, Table
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType, torch_dtype
from .base import BindContext, BoundOperation, Operation, RunContext, not_ported


class Aggregation(enum.Enum):
    """reference: proto/supersonic.proto:64-72."""

    SUM = "SUM"
    MIN = "MIN"
    MAX = "MAX"
    COUNT = "COUNT"
    CONCAT = "CONCAT"
    FIRST = "FIRST"
    LAST = "LAST"


@dataclass(frozen=True)
class AggSpec:
    """One aggregation element (reference: aggregate.h:47-158)."""

    aggregation: Aggregation
    input: Optional[str]       # None only for COUNT(*)
    output: str
    output_type: Optional[DataType] = None
    distinct: bool = False


class AggregationSpecification:
    def __init__(self, specs: Sequence[AggSpec | tuple] = ()):
        self.specs: list[AggSpec] = []
        for s in specs:
            self.add(s if isinstance(s, AggSpec) else AggSpec(*s))

    def add(self, spec: AggSpec) -> "AggregationSpecification":
        self.specs.append(spec)
        return self

    def add_aggregation(self, agg: Aggregation, input_: Optional[str],
                        output: str, **kw) -> "AggregationSpecification":
        return self.add(AggSpec(agg, input_, output, **kw))


@dataclass(frozen=True)
class GroupAggregateOptions:
    """reference: aggregate.h:160-205.  ``estimated_result_row_count`` is
    the output capacity; a result with more groups raises "aggregate
    result overflow"."""

    estimated_result_row_count: Optional[int] = None
    max_unique_keys_in_result: Optional[int] = None
    memory_quota: Optional[int] = None
    enforce_quota: bool = False


def _resolve_output_attr(spec: AggSpec, schema: TupleSchema) -> Attribute:
    if spec.aggregation == Aggregation.COUNT:
        return Attribute(spec.output, spec.output_type or DataType.UINT64,
                         nullable=False)
    if spec.input is None:
        raise SchemaError(f"{spec.aggregation} needs an input column")
    in_attr = schema.lookup(spec.input)
    return Attribute(spec.output, spec.output_type or in_attr.type,
                     nullable=True)


_DENSE_DOMAIN_MAX = 2048  # segment_reduce MAX_SEGMENTS
_KEY_TYPES = (DataType.INT32, DataType.INT64)


def _dense_domain(cb, names, key_attrs, specs, schema_in):
    """(dims, K): per key (name, attr, kmin, K_i) with a composite domain of
    K <= 2048 slots, from the child's planner statistics."""
    dims, K = [], 1
    for name, key_attr in zip(names, key_attrs):
        if key_attr.nullable or key_attr.type not in _KEY_TYPES:
            not_ported(f"group-by on a {'nullable ' if key_attr.nullable else ''}"
                       f"{key_attr.type.value} key", "8")
        dom = cb.stats.get(name)
        if dom is None:
            not_ported("group-by without dense key statistics (sort path)",
                       "8")
        K_i = dom[1] - dom[0] + 1
        dims.append((name, key_attr, dom[0], K_i))
        K *= K_i
    if K > _DENSE_DOMAIN_MAX:
        not_ported(f"group-by over {K} key slots (sort path above "
                   f"{_DENSE_DOMAIN_MAX})", "8")
    for s in specs:
        if s.aggregation in (Aggregation.COUNT, Aggregation.FIRST,
                             Aggregation.LAST):
            continue
        if s.aggregation == Aggregation.CONCAT:
            not_ported("CONCAT aggregation", "12")
        in_t = schema_in.lookup(s.input).type
        out_t = _resolve_output_attr(s, schema_in).type
        if in_t not in (DataType.FLOAT, DataType.INT32) or out_t != in_t:
            # the kernel accumulates in f32/i32; 64-bit inputs and outputs
            # need the sort path's exact accumulation
            not_ported(f"dense {s.aggregation.value} of {in_t.value} into "
                       f"{out_t.value}", "8")
    return dims, K


def _dense_grouped_aggregate(t: Table, dims, specs, schema_in, out_dicts,
                             out_schema, out_cap, K, rctx: RunContext,
                             keep=None, ordered=True):
    """Dense-domain group-by: one keyed segment-reduce launch over the raw
    key lanes, ``keep`` and the row count (the kernel codes the slots, drops
    and counts the live rows outside the planned domain), then O(K)
    finalization.  A plan with more key dimensions than the kernel takes
    (``MAX_KEYS``) is bound to pass one composite int32 slot lane instead,
    computed here (-1 outside the domain, so the kernel counts those rows
    all the same)."""
    from ..kernels.segment_reduce import MAX_KEYS, segment_reduce_keyed

    dev = t.device
    cap = t.capacity
    if len(dims) <= MAX_KEYS:
        keys = [(t.columns[name].values, kmin, K_i)
                for name, _attr, kmin, K_i in dims]
    else:
        gid, in_domain = None, None
        for name, _attr, kmin, K_i in dims:
            v = t.columns[name].values.long() - kmin
            ok = (v >= 0) & (v < K_i)
            vc = v.clamp(0, K_i - 1)
            gid = vc if gid is None else gid * K_i + vc
            in_domain = ok if in_domain is None else (in_domain & ok)
        keys = [(torch.where(in_domain, gid, -1).to(torch.int32), 0, K)]

    # every aggregate is one request of one launch, deduplicated by key
    reqs: list = []
    memo: dict = {}

    def ask(key, values, valid, mode):
        if key not in memo:
            memo[key] = len(reqs)
            reqs.append((values, valid, mode))

    def valid_key(s):
        c = t.columns[s.input]
        if c.valid is None:
            return ("count_all",)
        ask(("valid", s.input), None, c.valid, "count")
        return ("valid", s.input)

    ask(("count_all",), None, None, "count")
    first = ("firstpos",)
    if ordered:
        ask(first, None, None, "firstpos")
    for s in specs:
        agg = s.aggregation
        if agg == Aggregation.COUNT and s.input is None:
            continue
        c = t.columns[s.input]
        if agg == Aggregation.COUNT:
            valid_key(s)
        elif agg == Aggregation.SUM:
            valid_key(s)
            ask(("sum", s.input), c.values, c.valid, "sum")
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            # FLOAT and INT32 inputs only (_dense_domain): the kernel counts
            # -0.0 as +0.0, as monotone_code does
            mode = "min" if agg == Aggregation.MIN else "max"
            valid_key(s)
            ask((mode, s.input), c.values, c.valid, mode)
        elif agg == Aggregation.FIRST:
            ask(first, None, None, "firstpos")
        elif agg == Aggregation.LAST:
            ask(("lastpos",), None, None, "lastpos")
    results, bad = segment_reduce_keyed(keys, reqs, K, keep=keep,
                                        num_rows=t.num_rows)
    rctx.error_flags.append(("aggregate key exceeds planned dense domain",
                             bad > 0))

    def got(key):
        return results[memo[key]]

    count_all = got(("count_all",))
    present = count_all > 0
    num_groups = present.sum()
    rctx.error_flags.append(("aggregate result overflow",
                             num_groups > out_cap))

    cols_k: dict[str, Column] = {}
    # decode slot j back into each key dimension's value (mixed radix)
    rem = torch.arange(K, device=dev)
    for name, attr, kmin, K_i in reversed(dims):
        cols_k[name] = Column(((rem % K_i) + kmin).to(torch_dtype(attr.type)),
                              None)
        rem = rem // K_i
    for s in specs:
        odt = torch_dtype(_resolve_output_attr(s, schema_in).type)
        agg = s.aggregation
        if agg == Aggregation.COUNT and s.input is None:
            cols_k[s.output] = Column(count_all.to(odt), None)
            continue
        c = t.columns[s.input]
        vkey = ("count_all",) if c.valid is None else ("valid", s.input)
        if agg == Aggregation.COUNT:
            cols_k[s.output] = Column(got(vkey).to(odt), None)
        elif agg == Aggregation.SUM:
            cols_k[s.output] = Column(got(("sum", s.input)).to(odt),
                                      got(vkey) > 0)
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            mode = "min" if agg == Aggregation.MIN else "max"
            cols_k[s.output] = Column(got((mode, s.input)).to(odt),
                                      got(vkey) > 0)
        else:  # FIRST / LAST: the value at the first / last live position
            p = got(first if agg == Aggregation.FIRST else ("lastpos",))
            safe = p.clamp(0, cap - 1).long()
            fvalid = present if c.valid is None else (present & c.valid[safe])
            cols_k[s.output] = Column(c.values[safe].to(odt), fvalid)

    # re-rank to insertion order: present slots by first occurrence, absent
    # slots last (without the re-rank: present slots in slot order)
    slot_order = (got(first).long() if ordered
                  else torch.arange(K, device=dev))
    rank_key = torch.where(present, slot_order, (1 << 40) + slot_order)
    perm = torch.sort(rank_key, stable=True).indices[:out_cap]

    def fit(arr):
        arr = arr[perm]
        if arr.shape[0] < out_cap:
            arr = torch.cat([arr, torch.zeros(out_cap - arr.shape[0],
                                              dtype=arr.dtype, device=dev)])
        return arr

    cols = {a.name: Column(fit(cols_k[a.name].values),
                           None if cols_k[a.name].valid is None
                           else fit(cols_k[a.name].valid))
            for a in out_schema}
    return Table(out_schema, cols, num_groups.clamp(max=out_cap), dev,
                 out_dicts, cap_hint=out_cap)


class GroupAggregate(Operation):
    """reference: GroupAggregate (aggregate_groups.cc:980); result order =
    key insertion order (RowHashSet append order)."""

    def __init__(self, group_by: Sequence[str], specification, child,
                 options: GroupAggregateOptions | None = None):
        self.group_by = list(group_by)
        self.spec = (specification
                     if isinstance(specification, AggregationSpecification)
                     else AggregationSpecification(specification))
        self.child = child
        self.options = options or GroupAggregateOptions()

    def bind(self, ctx: BindContext,
             _unordered: bool = False) -> BoundOperation:
        # _unordered: the consumer re-orders the rows anyway (Sort), so the
        # insertion-order re-rank and its firstpos request are dropped
        from .filter import bind_predicates, keep_mask, unwrap_filters
        from .hash_join import HashJoin, KeyUniqueness
        opts = self.options
        specs = self.spec.specs
        if opts.max_unique_keys_in_result or opts.memory_quota is not None:
            not_ported("max_unique_keys_in_result and memory quotas", "12")
        if any(s.distinct for s in specs):
            not_ported("DISTINCT aggregation", "12")
        if not self.group_by:
            not_ported("GroupAggregate without group keys", "12")
        inner, preds = unwrap_filters(self.child)
        # a UNIQUE join child binds masked: its keep mask (the matches for
        # INNER, the kept lhs rows for LEFT_OUTER) becomes ours; a
        # NOT_UNIQUE child expands, so it binds unmasked
        masked_join = (isinstance(inner, HashJoin)
                       and inner.uniqueness == KeyUniqueness.UNIQUE)
        cb = inner.bind(ctx, _masked=True) if masked_join else inner.bind(ctx)
        bound_preds = bind_predicates(preds, cb)
        names = self.group_by
        key_attrs = [cb.schema.lookup(n) for n in names]
        agg_attrs = [_resolve_output_attr(s, cb.schema) for s in specs]
        out_schema = TupleSchema(key_attrs + agg_attrs)
        out_dicts = {n: cb.dicts[n] for n in names if n in cb.dicts}
        out_cap = opts.estimated_result_row_count or cb.capacity
        schema_in = cb.schema
        dims, K = _dense_domain(cb, names, key_attrs, specs, schema_in)

        def fn(rctx: RunContext) -> Table:
            if masked_join:
                t, keep = cb.run(rctx)
            else:
                t, keep = cb.run(rctx), None
            if bound_preds:
                pk = keep_mask(bound_preds, rctx, t)
                keep = pk if keep is None else (keep & pk)
            return _dense_grouped_aggregate(
                t, dims, specs, schema_in, out_dicts, out_schema, out_cap, K,
                rctx, keep=keep, ordered=not _unordered)

        out_stats = ({names[0]: cb.stats[names[0]]}
                     if names[0] in cb.stats else {})
        return BoundOperation(out_schema, out_dicts, fn, out_cap,
                              stats=out_stats)
