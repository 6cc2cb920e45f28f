"""GroupAggregate: the dense path, the sort path and the aggregate pushdown.

Port of ``supersonic_tpu/ops/aggregate.py`` (``_dense_domain``,
``_dense_grouped_aggregate``, ``_pass_key``, ``_grouped_aggregate``,
``GroupAggregate.bind`` and ``_try_aggregate_pushdown``; reference:
cursor/core/aggregate_groups.cc, column_aggregator.cc).  The result order
is the reference's insertion order (first occurrence of each key), unless
the consumer re-orders the rows anyway (Sort binds its child
``_unordered``).

  * Dense path: when the group keys have a planned composite domain of at
    most 2048 slots (integer keys with planner statistics, STRING/BINARY
    keys by dictionary size) and every input fits the kernel's 32-bit
    accumulators, every aggregate is one request of ONE keyed
    segment-reduce launch (kernels/segment_reduce.py), which reads the raw
    key lanes and codes the slots itself; the K slots are then finalized
    and re-ranked.
  * Sort path, every other group-by: a stable sort of the kept rows by
    their group codes (ops/keys.py::group_code_columns) puts each group in
    one run; runs begin where adjacent codes differ (so NULL equals NULL,
    -0.0 equals +0.0, and each NaN key is a group of its own); the
    compaction kernel extracts each run's first and last sorted row.
    COUNTs and integer SUMs are diffs of cumsums at the run ends (int64
    sums are exact modulo 2^64, so an integer SUM wraps as the reference's
    does in its output type); float SUMs add each run in f64
    (``_run_sums``: two levels of ``torch.segment_reduce``, so a long run
    spreads over many thread blocks), so only a group that holds a NaN or
    an inf gets one; MIN and MAX read the first row of a run in a
    value-ordered sort (NULLs and NaNs last); FIRST and LAST read the run's
    first and last row in input order.  The JAX package's limb and emulated-64-bit
    scans, its sort-operand packing and its ``approx_max_k`` extraction
    work around the TPU and have no counterpart.
  * Aggregate pushdown (``GroupAggregate._try_aggregate_pushdown``): a plan
    rewrite that pregroups the probe side of an INNER or LEFT_OUTER join
    by the join key, joins the partials and aggregates them again.

DISTINCT, CONCAT, ``max_unique_keys_in_result``, memory quotas and a
group-by without keys raise ``NotImplementedError`` (ROADMAP.md queue 1
item 12).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..batch import Column, Table, gather_arrays
from ..kernels import MAX_ARRAYS
from ..kernels.compaction import compact_kernel
from ..kernels.merge_sorted import sortable_words
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType, torch_dtype
from .base import BindContext, BoundOperation, Operation, RunContext, not_ported
from .keys import descending_code, group_code_columns, monotone_code


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
# inputs the kernel's 32-bit accumulators take (a BOOL as a 0/1 int32)
_I32_INPUTS = (DataType.FLOAT, DataType.INT32, DataType.BOOL, DataType.STRING,
               DataType.BINARY)


def _dense_domain(cb, names, key_attrs, specs, schema_in):
    """(dims, K) when the group keys have a planned composite domain of at
    most 2048 slots: per key (name, attr, kmin, K_i), from the dictionary
    size of a STRING/BINARY key or the planner statistics of an INT32/INT64
    key.  None sends the group-by to the sort path, as the JAX package
    does: a nullable key, a key without statistics, more slots, a 64-bit or
    DOUBLE input of SUM/MIN/MAX, or a SUM into an 8-byte output (SUM
    aggregates in its output type, which the kernel's 32-bit accumulators
    do not hold).  Every other output type is the kernel's result cast, as
    in the JAX package's dense path."""
    dims, K = [], 1
    for name, key_attr in zip(names, key_attrs):
        if key_attr.nullable:
            return None
        if key_attr.type in (DataType.STRING, DataType.BINARY):
            d = cb.dicts.get(name)
            if d is None:
                return None
            dom = (0, max(len(d) - 1, 0))
        elif key_attr.type in (DataType.INT32, DataType.INT64):
            dom = cb.stats.get(name)
            if dom is None:
                return None
        else:
            return None
        K_i = dom[1] - dom[0] + 1
        dims.append((name, key_attr, dom[0], K_i))
        K *= K_i
        if K > _DENSE_DOMAIN_MAX:
            return None
    for s in specs:
        if s.aggregation in (Aggregation.COUNT, Aggregation.FIRST,
                             Aggregation.LAST):
            continue  # any type: counts, or one gather of K rows at the end
        if schema_in.lookup(s.input).type not in _I32_INPUTS:
            return None
        if (s.aggregation == Aggregation.SUM
                and torch_dtype(_resolve_output_attr(s, schema_in).type)
                .itemsize == 8):
            return None
    return dims, K


def _i32(values: torch.Tensor) -> torch.Tensor:
    """A BOOL lane as the 0/1 int32 the kernel accumulates."""
    return values.to(torch.int32) if values.dtype == torch.bool else values


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
            ask(("sum", s.input), _i32(c.values), c.valid, "sum")
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            # 32-bit inputs only (_dense_domain): the kernel counts -0.0 as
            # +0.0, as monotone_code does
            mode = "min" if agg == Aggregation.MIN else "max"
            valid_key(s)
            ask((mode, s.input), _i32(c.values), c.valid, mode)
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


def _pass_key(spec: AggSpec):
    """The sorted pass a spec reads: None for the stable base pass, or
    (input, "asc" / "desc") for a value-ordered pass (MIN / MAX)."""
    if spec.aggregation == Aggregation.MIN:
        return (spec.input, "asc")
    if spec.aggregation == Aggregation.MAX:
        return (spec.input, "desc")
    return None


def _sorted_rows(operands, keep, num_rows, cap: int, dev):
    """(input row at each sorted position, live row count): the live
    rows, stably sorted by the operand tuple (most significant first), come
    first; positions past the count hold row 0.  One stable ``torch.sort``
    pass an operand, least significant first, floats by their total order
    (NaNs last and tied, -0.0 tied with +0.0, as ``lax.sort`` orders them).
    Live rows are ``keep``'s; without one, the first ``num_rows``, and a
    host row count sorts only those rows (the result is then that long).
    Else the compaction kernel moves the live rows to the front, in sorted
    order; its rows past the count are unspecified on the card, so they
    are replaced by row 0 here, once for every reader."""
    host_rows = keep is None and isinstance(num_rows, int)
    n = num_rows if host_rows else cap
    perm = None
    for op in reversed(operands):
        key = sortable_words(op[:n])
        if perm is None:
            perm = torch.sort(key, stable=True).indices
        else:
            perm = perm[torch.sort(key[perm], stable=True).indices]
    if host_rows:
        return perm, n
    if keep is None:
        keep = torch.arange(cap, device=dev) < num_rows
    (perm,), count = compact_kernel([perm], keep[perm], cap)
    return torch.where(torch.arange(cap, device=dev) < count, perm, 0), count


def _extract(lanes: dict, mask: torch.Tensor, out_cap: int) -> dict:
    """The rows of every lane where ``mask`` holds, compacted to a dense
    prefix of ``out_cap`` rows: one compaction launch a group of up to
    ``MAX_ARRAYS`` lanes."""
    names = list(lanes)
    moved: list = []
    for i in range(0, len(names), MAX_ARRAYS):
        moved += compact_kernel([lanes[n] for n in names[i:i + MAX_ARRAYS]],
                                mask, out_cap)[0]
    return dict(zip(names, moved))


_SUM_TILE = 32768  # rows: the most one block of a float SUM's first level adds


def _run_sums(values: torch.Tensor, lengths: torch.Tensor,
              tile: int = _SUM_TILE) -> torch.Tensor:
    """The f64 sum of each run of ``values``: the runs lie back to back
    from row 0, ``lengths`` rows each (a run of none sums to 0).  Every run
    is cut at each multiple of ``tile`` rows into pieces; a 1-D
    ``torch.segment_reduce`` sums the pieces (CUB's segmented reduce on the
    card, one thread block a piece), then a 2-D one sums each run's pieces
    (one thread a run, in order).  So a run of millions of rows (a
    group-by into a few groups) is spread over many blocks, a million short
    runs cost one block each once, only a group's own values reach its sum
    (a NaN or an inf stays in its group), and the order of the additions,
    so the bits, repeat from run to run."""
    G = lengths.shape[0]
    if G == 0:
        return values.new_zeros(0)
    dev = values.device
    lengths = lengths.long()
    end = torch.cumsum(lengths, 0)
    start = end - lengths
    first = start // tile
    npieces = torch.where(lengths > 0, (end - 1) // tile - first + 1, 0)
    # each run's first piece, plus one a tile edge crossed: at most P pieces;
    # the spare ones belong to a run G of no rows
    P = G + -(-values.shape[0] // tile)
    spare = (P - npieces.sum()).reshape(1)
    owner = torch.repeat_interleave(torch.arange(G + 1, device=dev),
                                    torch.cat([npieces, spare]),
                                    output_size=P)
    run = owner.clamp(max=G - 1)
    k = first[run] + torch.arange(P, device=dev) - (
        torch.cumsum(npieces, 0) - npieces)[run]
    lo = torch.maximum(start[run], k * tile)
    hi = torch.minimum(end[run], (k + 1) * tile)
    pieces = torch.segment_reduce(values, "sum", unsafe=True,
                                  lengths=torch.where(owner < G, hi - lo, 0))
    return torch.segment_reduce(pieces[:, None], "sum", lengths=npieces,
                                unsafe=True)[:, 0]


def _is_int(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and dtype != torch.bool


def _grouped_aggregate(t: Table, names, specs, schema_in, out_dicts,
                       out_schema, out_cap: int, rctx: RunContext,
                       rerank: bool, keep=None):
    """Sort-path group-by (``_grouped_aggregate`` of the JAX package, whose
    semantics it keeps; the module docstring has the design).  ``keep``
    (a fused Filter or a masked join) marks the live rows; without it, the
    first ``num_rows``.  Groups come out in first-occurrence order, or in
    key order without ``rerank``."""
    dev = t.device
    cap = t.capacity
    codes = []
    for nr, c in group_code_columns(t, names):
        codes += [c] if nr is None else [nr, c]
    perm, live_count = _sorted_rows(codes, keep, t.num_rows, cap, dev)
    L = perm.shape[0]
    pos = torch.arange(L, device=dev)
    live_s = pos < live_count
    # a run starts where any code differs from the row before (NaN != NaN)
    differs = torch.ones(L, dtype=torch.bool, device=dev)
    if L > 1:
        same = None
        for c in codes:
            cs = c[perm]
            eq = cs[1:] == cs[:-1]
            same = eq if same is None else (same & eq)
        differs[1:] = ~same
    boundary = live_s & differs
    next_starts = torch.zeros_like(boundary)
    next_starts[:-1] = boundary[1:]
    is_end = live_s & (next_starts | (pos == live_count - 1))
    num_groups = boundary.sum()
    rctx.error_flags.append(("aggregate result overflow",
                             num_groups > out_cap))

    # lanes read at each run's last and first sorted position
    ends: dict = {"pos": pos, "row": perm}
    starts: dict = {"row": perm}
    sorted_cols: dict = {}

    def sorted_col(name):
        if name not in sorted_cols:
            c = t.columns[name]
            sorted_cols[name] = (c.values[perm],
                                 None if c.valid is None else c.valid[perm])
        return sorted_cols[name]

    def valid_count_key(name):
        if t.columns[name].valid is None:
            return None  # every live row counts: the run's length
        key = ("valid", name)
        if key not in ends:
            ends[key] = torch.cumsum(sorted_col(name)[1], 0,
                                     dtype=torch.int32)
        return key

    f64_sums = {}
    for s in specs:
        agg = s.aggregation
        if s.input is None:
            continue  # COUNT(*)
        if agg in (Aggregation.COUNT, Aggregation.SUM):
            valid_count_key(s.input)
        if agg == Aggregation.SUM:
            vals, valid = sorted_col(s.input)
            odt = torch_dtype(_resolve_output_attr(s, schema_in).type)
            if _is_int(vals.dtype) and _is_int(odt):
                key = ("isum", s.input)
                if key not in ends:
                    v = vals.long()
                    if valid is not None:
                        v = torch.where(valid, v, 0)
                    ends[key] = torch.cumsum(v, 0)  # exact modulo 2^64
            elif s.input not in f64_sums:
                v = vals.double()
                if valid is not None:
                    v = torch.where(valid, v, 0.0)
                f64_sums[s.input] = v
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            pkey = _pass_key(s)
            if pkey not in starts:
                c = t.columns[s.input]
                vcode = monotone_code(c.values,
                                      schema_in.lookup(s.input).type)
                if pkey[1] == "desc":
                    vcode = descending_code(vcode)
                # NULL values last within the run
                vrank = [] if c.valid is None else [(~c.valid).to(torch.int32)]
                starts[pkey] = _sorted_rows(codes + vrank + [vcode], keep,
                                            t.num_rows, cap, dev)[0]

    e = _extract(ends, is_end, out_cap)
    st = _extract(starts, boundary, out_cap)
    present = torch.arange(out_cap, device=dev) < num_groups

    def diff(x):
        """Per group, from a cumsum read at the run ends."""
        x = torch.where(present, x, 0)
        prev = torch.cat([x.new_zeros(1), x[:-1]])
        return torch.where(present, x - prev, 0)

    count_all = diff(e["pos"] + 1)  # the run lengths

    def count_of(name):
        key = valid_count_key(name)
        return count_all if key is None else diff(e[key])

    def rows(lane):
        return torch.where(present, lane, 0).to(torch.int32)

    start_row, end_row = rows(st["row"]), rows(e["row"])

    def at(idx, name):
        """(values, validity) of an input column at int32 rows."""
        c = t.columns[name]
        if c.valid is None:
            return gather_arrays([c.values], idx)[0], None
        return tuple(gather_arrays([c.values, c.valid], idx))

    cols: dict[str, Column] = {}
    for n in names:
        vals, valid = at(start_row, n)
        cols[n] = Column(vals, valid)
    for s in specs:
        odt = torch_dtype(_resolve_output_attr(s, schema_in).type)
        agg = s.aggregation
        if s.input is None:
            cols[s.output] = Column(count_all.to(odt), None)
            continue
        if agg == Aggregation.COUNT:
            cols[s.output] = Column(count_of(s.input).to(odt), None)
        elif agg == Aggregation.SUM:
            if s.input in f64_sums:
                # each run added on its own in f64, rounded once to odt
                sv = _run_sums(f64_sums[s.input], count_all)
            else:
                sv = diff(e[("isum", s.input)])
            cols[s.output] = Column(sv.to(odt), count_of(s.input) > 0)
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            # the run's first row in the value order, which puts NULLs
            # last: NULL only where the group holds no value (and, as in
            # the JAX package, the k-th NaN-key group takes the k-th NaN-key
            # row of that order)
            vals, valid = at(rows(st[_pass_key(s)]), s.input)
            cols[s.output] = Column(vals.to(odt), present if valid is None
                                    else (present & valid))
        else:  # FIRST / LAST: the run's first / last row in input order
            vals, valid = at(start_row if agg == Aggregation.FIRST
                             else end_row, s.input)
            cols[s.output] = Column(vals.to(odt), present if valid is None
                                    else (present & valid))

    if rerank:
        # insertion order: present groups by first-occurrence row
        first = torch.where(present, st["row"],
                            L + torch.arange(out_cap, device=dev))
        order = torch.sort(first).indices
        cols = {n: Column(c.values[order],
                          None if c.valid is None else c.valid[order])
                for n, c in cols.items()}
    cols = {a.name: cols[a.name] for a in out_schema}
    return Table(out_schema, cols, num_groups.clamp(max=out_cap), dev,
                 out_dicts, cap_hint=out_cap)


class GroupAggregate(Operation):
    """reference: GroupAggregate (aggregate_groups.cc:980); result order =
    key insertion order (RowHashSet append order).

    ``_pushdown_disabled`` (the JAX package's attribute; set on the class
    here) makes ``bind`` skip ``_try_aggregate_pushdown`` and bind the plan
    directly.  The port binds directly by default: on the H100 the direct
    binding is the faster one on every plan measured, the headline query
    and a NOT_UNIQUE join that fans each probe row out eightfold (PERF.md
    section 6).  An instance may set the attribute either way."""

    _pushdown_disabled = True

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
        _unordered = _unordered or getattr(self, "_always_unordered", False)
        if not getattr(self, "_pushdown_disabled", False):
            pushed = self._try_aggregate_pushdown(ctx, _unordered)
            if pushed is not None:
                return pushed
        opts = self.options
        specs = self.spec.specs
        if opts.max_unique_keys_in_result or opts.memory_quota is not None:
            not_ported("max_unique_keys_in_result and memory quotas", "12")
        if any(s.distinct for s in specs):
            not_ported("DISTINCT aggregation", "12")
        if any(s.aggregation == Aggregation.CONCAT for s in specs):
            not_ported("CONCAT aggregation", "12")
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
        # STRING/BINARY outputs (MIN/MAX/FIRST/LAST) carry the input's
        # dictionary: the codes pass through untransformed
        for s in specs:
            if s.input is not None and s.input in cb.dicts:
                out_dicts[s.output] = cb.dicts[s.input]
        out_cap = opts.estimated_result_row_count or cb.capacity
        schema_in = cb.schema
        dense = _dense_domain(cb, names, key_attrs, specs, schema_in)

        def fn(rctx: RunContext) -> Table:
            if masked_join:
                t, keep = cb.run(rctx)
            else:
                t, keep = cb.run(rctx), None
            if bound_preds:
                pk = keep_mask(bound_preds, rctx, t)
                keep = pk if keep is None else (keep & pk)
            if dense is not None:
                dims, K = dense
                return _dense_grouped_aggregate(
                    t, dims, specs, schema_in, out_dicts, out_schema,
                    out_cap, K, rctx, keep=keep, ordered=not _unordered)
            return _grouped_aggregate(
                t, names, specs, schema_in, out_dicts, out_schema, out_cap,
                rctx, rerank=not _unordered, keep=keep)

        out_stats = ({names[0]: cb.stats[names[0]]}
                     if names[0] in cb.stats else {})
        return BoundOperation(out_schema, out_dicts, fn, out_cap,
                              stats=out_stats)

    def _try_aggregate_pushdown(self, ctx: BindContext,
                                _unordered: bool) -> Optional[BoundOperation]:
        """Aggregate pushdown through an INNER or LEFT_OUTER join (the JAX
        package's star-schema rewrite): when the group keys come from the
        join's build side and every aggregate reads only probe-side
        columns, pregroup the probe side by its join key, join the (far
        fewer) partials, and aggregate them again.  SUM becomes a SUM of
        partial SUMs, COUNT a SUM of partial COUNTs, MIN and MAX themselves;
        insertion order is the MIN of each partial's first probe position
        (``Sequence`` over the probe leaf), then a Sort.  It applies where
        both join children are (Filter*)(ScanTable) and the probe key's
        range is at most a quarter of the probe capacity.  Returns None
        where it does not apply, and where the rewrite needs a part the
        port lacks (a STRING/BINARY join key, ROADMAP.md queue 1 item 11;
        the ordered NOT_UNIQUE rewrite, whose build side carries a computed
        position without statistics, so its join needs the merge probe,
        item 7); the direct binding then answers."""
        from ..exprs import Sequence as SequenceExpr, col
        from .compute import Compute
        from .filter import Filter, unwrap_filters
        from .hash_join import HashJoin, JoinType, KeyUniqueness
        from .project import Projector
        from .scan import ScanTable, table_stats
        from .sort import Sort, SortKey

        opts = self.options
        specs = self.spec.specs
        if (opts.memory_quota is not None or opts.max_unique_keys_in_result
                or not self.group_by):
            return None
        inner, preds = unwrap_filters(self.child)
        if preds or not isinstance(inner, HashJoin):
            return None
        if inner.join_type not in (JoinType.INNER, JoinType.LEFT_OUTER):
            return None
        left_outer = inner.join_type == JoinType.LEFT_OUTER
        for s in specs:
            if s.distinct or s.aggregation not in (
                    Aggregation.SUM, Aggregation.MIN, Aggregation.MAX,
                    Aggregation.COUNT):
                return None
        lleaf, lpreds = unwrap_filters(inner.lhs)
        rleaf, _ = unwrap_filters(inner.rhs)
        if not (isinstance(lleaf, ScanTable) and isinstance(rleaf, ScanTable)):
            return None
        lschema, rschema = lleaf.table.schema, rleaf.table.schema
        try:
            lpairs = inner.lhs_projector.resolve(lschema)
            rpairs = inner.rhs_projector.resolve(rschema)
        except SchemaError:
            return None
        ldst = {dst: src for src, dst in lpairs}
        rdst = {dst: src for src, dst in rpairs}
        if not all(k in rdst for k in self.group_by):
            return None
        for s in specs:
            if s.input is not None and s.input not in ldst:
                return None
        if any(n.startswith("__pre") or n == "__rank"
               for n in (list(ldst) + list(rdst) + list(lschema.names())
                         + list(rschema.names()))):
            return None
        # probe-side key statistics bound the pregroup output
        lstats = table_stats(lleaf.table)
        rng = 1
        for k in inner.lhs_keys:
            try:
                a = lschema.lookup(k)
            except SchemaError:
                return None
            if a.type not in (DataType.INT32, DataType.INT64):
                # the JAX package ranges a STRING/BINARY key by its
                # dictionary; the port's join takes none (item 11)
                return None
            if k not in lstats:
                return None
            lo, hi = lstats[k]
            rng *= hi - lo + 1
            if rng > (1 << 24):
                return None
        lcap = lleaf.table.capacity
        if rng <= 0 or rng * 4 > lcap:
            return None
        if not _unordered and inner.uniqueness != KeyUniqueness.UNIQUE:
            return None  # the ordered NOT_UNIQUE rewrite (item 7)

        # --- the rewritten plan ---
        pre_specs: list[AggSpec] = []
        final_specs: list[AggSpec] = []
        for i, s in enumerate(specs):
            pname = f"__pre{i}"
            if s.aggregation == Aggregation.SUM:
                pre_specs.append(AggSpec(Aggregation.SUM, ldst[s.input],
                                         pname, output_type=s.output_type))
                final_specs.append(AggSpec(Aggregation.SUM, pname, s.output,
                                           output_type=s.output_type))
            elif s.aggregation == Aggregation.COUNT:
                # partial counts fit an INT32 column below 2^31 probe rows;
                # the final SUM aggregates in the 64-bit output type
                pt = DataType.INT32 if lcap < 2**31 - 1 else DataType.INT64
                pre_specs.append(AggSpec(
                    Aggregation.COUNT,
                    None if s.input is None else ldst[s.input], pname,
                    output_type=pt))
                final_specs.append(AggSpec(
                    Aggregation.SUM, pname, s.output,
                    output_type=s.output_type or DataType.UINT64))
            else:  # MIN / MAX decompose into themselves
                pre_specs.append(AggSpec(s.aggregation, ldst[s.input], pname))
                final_specs.append(AggSpec(s.aggregation, pname, s.output,
                                           output_type=s.output_type))
        pre_child = inner.lhs
        if not _unordered:
            # first-occurrence positions over the probe LEAF rows (monotone
            # in the filtered order, so MIN over kept rows ranks groups the
            # same); the Compute goes under the probe-side Filters, which
            # the pregroup then fuses
            pre_child = Compute([col(n) for n in lschema.names()]
                                + [SequenceExpr().as_("__prepos")], lleaf)
            for p in lpreds:
                pre_child = Filter(p, pre_child)
            pre_specs.append(AggSpec(Aggregation.MIN, "__prepos", "__prefp"))
            final_specs.append(AggSpec(Aggregation.MIN, "__prefp", "__fp"))
        pregroup = GroupAggregate(
            list(inner.lhs_keys), pre_specs, pre_child,
            GroupAggregateOptions(estimated_result_row_count=rng))
        pregroup._pushdown_disabled = True
        # the join re-orders the partials anyway
        pregroup._always_unordered = True
        part_names = [s.output for s in pre_specs]
        # NOT_UNIQUE: each build row matches at most one partial, so the
        # rewritten join emits at most the build capacity (+ one row per
        # unmatched partial under LEFT_OUTER)
        join_cap = (None if inner.uniqueness == KeyUniqueness.UNIQUE
                    else rleaf.table.capacity + (rng if left_outer else 0))
        new_join = HashJoin(
            inner.join_type, list(inner.lhs_keys), list(inner.rhs_keys),
            pregroup, inner.rhs, inner.uniqueness,
            lhs_projector=Projector.named(*part_names),
            rhs_projector=inner.rhs_projector, out_capacity=join_cap,
            allow_dense_lookup=inner.allow_dense_lookup)
        final = GroupAggregate(
            list(self.group_by), final_specs, new_join,
            GroupAggregateOptions(
                estimated_result_row_count=opts.estimated_result_row_count))
        final._pushdown_disabled = True
        plan: Operation = final
        if not _unordered:
            plan = Sort([SortKey("__fp", ascending=True)], final)
        bound = plan.bind(ctx)

        # --- schema fix-up: the direct binding's output schema (column
        # order, COUNT non-nullable), without the __fp helper ---
        join_attrs = []
        for src, dst in lpairs:
            a = lschema.lookup(src)
            join_attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
        for src, dst in rpairs:
            a = rschema.lookup(src)
            # LEFT_OUTER forces rhs outputs nullable (hash_join.cc:78-87)
            join_attrs.append(Attribute(dst, a.type,
                                        a.nullable or left_outer, a.enum))
        join_schema = TupleSchema(join_attrs)
        key_attrs = [join_schema.lookup(n) for n in self.group_by]
        agg_attrs = [_resolve_output_attr(s, join_schema) for s in specs]
        out_schema = TupleSchema(key_attrs + agg_attrs)
        out_names = out_schema.names()
        out_dicts = {n: d for n, d in bound.dicts.items() if n in out_names}

        def fn(rctx: RunContext) -> Table:
            t = bound.run(rctx)
            cols = {}
            for a in out_schema:
                c = t.columns[a.name]
                if not a.nullable and c.valid is not None:
                    c = Column(c.values, None)
                cols[a.name] = c
            return Table(out_schema, cols, t.num_rows, t.device, out_dicts,
                         cap_hint=bound.capacity)

        out_stats = {}
        if self.group_by[0] in bound.stats:
            out_stats[self.group_by[0]] = bound.stats[self.group_by[0]]
        return BoundOperation(out_schema, out_dicts, fn, bound.capacity,
                              stats=out_stats)
