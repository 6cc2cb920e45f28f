"""Aggregation: GroupAggregate (dense path, sort path), its best-effort
and hybrid variants, ScalarAggregate and AggregateClusters.

Port of ``supersonic_tpu/ops/aggregate.py`` (reference: cursor/core/
aggregate_groups.cc, aggregate_scalar.cc, aggregate_clusters.cc,
column_aggregator.cc).  The result order
is the reference's insertion order (first occurrence of each key), unless
the consumer re-orders the rows anyway (Sort binds its child
``_unordered``).

  * Dense path: when the group keys have a planned composite domain of at
    most 2048 slots (integer, DATE and DATETIME keys with planner
    statistics, STRING/BINARY keys by dictionary size, ENUM keys by their
    value map) and every aggregate fits the kernel's accumulators (32-bit
    words, and 64-bit sum words for a DOUBLE or INT64 SUM), every aggregate
    is one request of ONE keyed segment-reduce launch
    (kernels/segment_reduce.py), which reads the raw key lanes and codes
    the slots itself; the K slots are then finalized and re-ranked.  The
    JAX package sends every SUM into an 8-byte output to its sort path,
    because the TPU has no 64-bit accumulators; the port takes those on
    the dense path (the rows are the same, the float sums within rounding).
  * Sort path, every other group-by: it first takes the live rows alone
    (``_live_table``).  A host row count and no keep mask take a prefix;
    otherwise the live count is read on the host, the one sync of the
    path (``agg.num_rows``), since every later pass needs a length and
    eager PyTorch gives none without the host, and a keep mask's live row
    ids are compacted once and the columns gathered at them.  So a
    group-by over a filter or a join that keeps a few of its capacity's
    rows sorts those rows and no others.  A stable sort of the live rows
    by their group codes (ops/keys.py::group_code_columns) puts each group
    in one run; runs begin where adjacent codes differ (so NULL equals NULL,
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

The sort path also carries the options: DISTINCT SUM/COUNT ride the
value-ordered pass and count a row only where its value code differs from
the previous row's in the run; ``max_unique_keys_in_result`` folds the
groups past it into its last group; a memory quota is a budget of result
rows (strict: overflow raises; best-effort: later rows pass through as
groups of their own); CONCAT gives each group's run id, and ``execute``
assembles the strings on the host (``DeferredConcat``, ops/host.py);
a group-by without keys is one group over the live rows (none on empty
input); AggregateClusters takes runs of adjacent keys in input order
without a base sort.  ``HybridGroupAggregate`` under a memory quota
pregroups in chunks, spills through the external sort (io/external.py)
and combines the sorted partials by AggregateClusters.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..batch import Column, Table, gather_arrays, gather_table
from ..dictionary import DeferredDictionary
from ..kernels import MAX_ARRAYS
from ..kernels.compaction import compact_kernel
from ..kernels.merge_sorted import sortable_words
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import (DataType, physical_dtype, torch_dtype, u64_key,
                     wrap_u32)
from .base import BindContext, BoundOperation, Operation, RunContext
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


def _normalize_spec(specification) -> AggregationSpecification:
    if isinstance(specification, AggregationSpecification):
        return specification
    return AggregationSpecification(specification)


@dataclass(frozen=True)
class GroupAggregateOptions:
    """reference: aggregate.h:160-205.  ``estimated_result_row_count`` is
    the output capacity; a result with more groups raises "aggregate
    result overflow".  ``max_unique_keys_in_result`` clamps the result:
    later groups fold into the last one kept (aggregate_groups.cc:
    501-510).  ``memory_quota`` bytes become a budget of result rows
    (``_quota_rows``): a strict GroupAggregate with more groups raises
    (aggregate_groups.cc:420-427); BestEffortGroupAggregate aggregates the
    first budget of keys fully and passes every later row through as a
    group of its own, with a warning (aggregate.h:233-246), unless
    ``enforce_quota`` makes it strict too."""

    estimated_result_row_count: Optional[int] = None
    max_unique_keys_in_result: Optional[int] = None
    memory_quota: Optional[int] = None
    enforce_quota: bool = False


def _quota_rows(memory_quota: int, out_schema: TupleSchema) -> int:
    """A ``memory_quota`` in bytes as a budget of result rows: the quota
    over the output row's width (each value's bytes, plus one byte for each
    nullable column's validity)."""
    width = 0
    for a in out_schema:
        width += np.dtype(physical_dtype(a.type)).itemsize + a.nullable
    return max(1, int(memory_quota) // max(width, 1))


def _resolve_output_attr(spec: AggSpec, schema: TupleSchema) -> Attribute:
    if spec.aggregation == Aggregation.COUNT:
        return Attribute(spec.output, spec.output_type or DataType.UINT64,
                         nullable=False)
    if spec.input is None:
        raise SchemaError(f"{spec.aggregation} needs an input column")
    in_attr = schema.lookup(spec.input)
    if spec.aggregation == Aggregation.CONCAT:
        # CONCAT of any input type is a STRING (column_aggregator.cc:
        # 496-530, aggregation_operators.h:235)
        if (spec.output_type or DataType.STRING) != DataType.STRING:
            raise SchemaError("CONCAT output type must be STRING")
        return Attribute(spec.output, DataType.STRING, nullable=True)
    return Attribute(spec.output, spec.output_type or in_attr.type,
                     nullable=True)


def _output_dicts(cb, names, specs) -> dict:
    """The dictionaries of an aggregate's output: the group keys', the
    input's for a STRING/BINARY MIN/MAX/FIRST/LAST (the codes pass through
    untransformed), and a DeferredDictionary for each CONCAT, whose codes
    are group run ids until ``execute`` resolves the strings."""
    out = {n: cb.dicts[n] for n in names if n in cb.dicts}
    for s in specs:
        if s.input is not None and s.input in cb.dicts:
            out[s.output] = cb.dicts[s.input]
        if s.aggregation == Aggregation.CONCAT:
            out[s.output] = DeferredDictionary()
    return out


_DENSE_DOMAIN_MAX = 2048  # segment_reduce MAX_SEGMENTS
# inputs the kernel's 32-bit accumulators take (a BOOL as a 0/1 int32)
_I32_INPUTS = (DataType.FLOAT, DataType.INT32, DataType.BOOL, DataType.DATE,
               DataType.ENUM, DataType.STRING, DataType.BINARY)
# SUMs into an 8-byte output the kernel's 64-bit sum words take: output ->
# inputs (a 4-byte input widened a row, a BOOL as a 0/1 int32)
_SUM64_INPUTS = {
    DataType.DOUBLE: (DataType.DOUBLE, DataType.FLOAT),
    DataType.INT64: (DataType.INT64, DataType.INT32, DataType.BOOL,
                     DataType.DATE),
}


def _sum64(spec: AggSpec, schema_in: TupleSchema) -> bool:
    """Whether a SUM aggregates in the kernel's 64-bit sum words: its
    output type is 8 bytes wide and its input one the words take."""
    if spec.aggregation != Aggregation.SUM:
        return False
    out_t = _resolve_output_attr(spec, schema_in).type
    return schema_in.lookup(spec.input).type in _SUM64_INPUTS.get(out_t, ())


def _dense_domain(cb, names, key_attrs, specs, schema_in, options=None):
    """(dims, K) when the group keys have a planned composite domain of at
    most 2048 slots: per key (name, attr, kmin, K_i), from the value map of
    an ENUM key, the dictionary size of a STRING/BINARY key or the planner
    statistics of an INT32/INT64/UINT32/DATE/DATETIME key.  None sends the
    group-by to the sort path: a ``max_unique_keys_in_result`` clamp, a
    DISTINCT or CONCAT aggregate, a nullable key, a key without
    statistics, more slots, a 64-bit or DOUBLE input of MIN/MAX, or a SUM
    the kernel's words do not hold.  SUM aggregates in its output type: a
    DOUBLE or FLOAT input into a DOUBLE output, and an INT64, INT32, BOOL
    or DATE input into an INT64 output, take the kernel's 64-bit sum words
    (``_sum64``); another SUM into an 8-byte output (UINT64, DOUBLE from an
    integer, INT64 from a float) and a 64-bit or DOUBLE input into a
    narrower output take the sort path.  Every other output type is the
    kernel's result cast, as in the JAX package's dense path.

    Where the port differs from the JAX package's route: the JAX package
    refuses every SUM into an 8-byte output, because the TPU has no 64-bit
    accumulators; the H100 has f64 and i64 in registers and shared memory,
    so the port's kernel sums those in 64-bit words and TPC-H Q1's DOUBLE
    sums, or an INT64 SUM into a few groups, stay dense.  A UINT32 input
    lies in int64 lanes here, so it takes the sort path (the JAX package
    sums it densely).  The rows are the same on either route."""
    if options is not None and options.max_unique_keys_in_result:
        return None
    if any(s.distinct for s in specs):
        return None
    dims, K = [], 1
    for name, key_attr in zip(names, key_attrs):
        if key_attr.nullable:
            return None
        if key_attr.type == DataType.ENUM:
            dom = (0, max(len(key_attr.enum.names) - 1, 0))
        elif key_attr.type in (DataType.STRING, DataType.BINARY):
            d = cb.dicts.get(name)
            if d is None:
                return None
            dom = (0, max(len(d) - 1, 0))
        elif key_attr.type in (DataType.INT32, DataType.INT64,
                               DataType.UINT32, DataType.DATE,
                               DataType.DATETIME):
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
        if s.aggregation == Aggregation.CONCAT:
            return None
        if _sum64(s, schema_in):
            continue
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
    all the same).  A SUM into an 8-byte output asks for a 64-bit sum word
    (``sum64``); its result is then cast to the output type as any other."""
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
            # a 64-bit sum word where the output is 8 bytes (_sum64)
            mode = "sum64" if _sum64(s, schema_in) else "sum"
            valid_key(s)
            ask((mode, s.input), _i32(c.values), c.valid, mode)
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
            mode = "sum64" if _sum64(s, schema_in) else "sum"
            cols_k[s.output] = Column(got((mode, s.input)).to(odt),
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


def _wrap_u32_sums(cols: dict, out_schema: TupleSchema) -> dict:
    """UINT32 outputs reduced modulo 2^32: a SUM aggregates in its output
    type, and the int64 sums here hold the exact total."""
    return {n: (Column(wrap_u32(c.values), c.valid)
                if out_schema.lookup(n).type == DataType.UINT32 else c)
            for n, c in cols.items()}


def _pass_key(spec: AggSpec):
    """The sorted pass a spec reads: None for the stable base pass, or
    (input, "asc" / "desc") for a value-ordered pass (MIN / MAX, and a
    DISTINCT SUM or COUNT, whose duplicates are then neighbours)."""
    if spec.aggregation == Aggregation.MIN:
        return (spec.input, "asc")
    if spec.aggregation == Aggregation.MAX:
        return (spec.input, "desc")
    if spec.distinct and spec.aggregation in (Aggregation.SUM,
                                              Aggregation.COUNT):
        return (spec.input, "asc")
    return None


@dataclass
class DeferredConcat:
    """The host work of one CONCAT aggregate (reference: the per-group
    byte assembly of AggregationOperator<CONCAT>, aggregation_operators.h:
    235-283; "," separator, NULLs skipped, an all-NULL group NULL).  The
    output column holds group run ids, codes into ``dict_obj`` (a
    DeferredDictionary made at bind); ``aux`` holds the device tensors the
    host reads after the run: per row in group order ``gid``, ``vals`` and
    ``valid`` (live and not NULL), and ``num_groups``.  ``execute``
    resolves ``dict_obj`` from them (ops/host.py)."""

    name: str
    dict_obj: object
    separator: str
    distinct: bool
    input_type: DataType
    input_dict: object  # the input column's Dictionary, or None
    aux: dict


def _sorted_rows(operands, n: int, dev):
    """The input row at each sorted position of rows 0 to ``n`` - 1,
    stably sorted by the operand tuple (most significant first).  One
    stable ``torch.sort`` pass an operand, least significant first, floats
    by their total order (NaNs last and tied, -0.0 tied with +0.0, as
    ``lax.sort`` orders them); no operand keeps the input order."""
    perm = torch.arange(n, device=dev) if not operands else None
    for op in reversed(operands):
        key = sortable_words(op[:n])
        if perm is None:
            perm = torch.sort(key, stable=True).indices
        else:
            perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _live_table(t: Table, keep, names) -> Table:
    """The columns ``names`` of ``t`` at its live rows alone, in input
    order: a table whose rows are all live and whose row count is a host
    int.  The live rows are ``keep``'s, or without one the first
    ``num_rows``.  A host row count takes a prefix of each lane, with no
    sync.  Any other count is read on the host once (sync
    ``agg.num_rows``): the sort path's passes need a length, and eager
    PyTorch gives none without the host.  A device count then takes a
    prefix too; under ``keep`` the compaction kernel packs the live row ids
    (one stable pass over the capacity), and one gather reads the columns
    at them.  So every later pass runs over the live rows only."""
    names = list(dict.fromkeys(names))
    cols = {n: t.columns[n] for n in names}
    schema = TupleSchema([t.schema.lookup(n) for n in names])
    cap, n, dev = t.capacity, t.num_rows, t.device
    if keep is not None:
        (ids,), count = compact_kernel(
            [torch.arange(cap, dtype=torch.int32, device=dev)], keep, cap)
        n = tracing.count_to_host(count, "agg.num_rows", cap)
        if n:
            return gather_table(Table(schema, cols, n, dev, t.dicts),
                                ids[:n], n)
    elif not isinstance(n, int):
        n = tracing.count_to_host(n, "agg.num_rows", cap)
    cols = {name: Column(c.values[:n], None if c.valid is None
                         else c.valid[:n]) for name, c in cols.items()}
    return Table(schema, cols, n, dev, t.dicts, cap_hint=n)


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


def _extreme(dtype: torch.dtype, largest: bool):
    """MIN's (``largest``) or MAX's identity in ``dtype``."""
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


def _fold_overflow(cols: dict, specs, K: int, num_groups, cap: int):
    """``max_unique_keys_in_result`` (aggregate_groups.cc:501-510): groups
    K and later, in insertion order, fold into group K - 1.  SUM and COUNT
    add, MIN and MAX fold, validity ORs; FIRST and LAST keep group K - 1's
    value.  A K past the capacity folds nothing."""
    if K - 1 >= cap:
        return
    rank = torch.arange(cap, device=num_groups.device)
    overflow = (rank >= K) & (rank < num_groups)
    for s in specs:
        c = cols[s.output]
        vals, valid = c.values.clone(), c.valid
        agg = s.aggregation
        v_eff = vals if valid is None else torch.where(valid, vals, 0)
        if agg in (Aggregation.SUM, Aggregation.COUNT):
            extra = torch.where(overflow, v_eff, 0).sum()
            vals[K - 1] += extra.to(vals.dtype)
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            ok = overflow if valid is None else (overflow & valid)
            is_min = agg == Aggregation.MIN
            pad = _extreme(vals.dtype, is_min)
            tail = torch.where(ok, vals, pad)
            tail = tail.amin() if is_min else tail.amax()
            fold = torch.minimum if is_min else torch.maximum
            vals[K - 1] = fold(vals[K - 1], tail)
        if valid is not None and agg in (Aggregation.SUM, Aggregation.MIN,
                                         Aggregation.MAX):
            valid = valid.clone()
            valid[K - 1] |= (overflow & valid).any()
        cols[s.output] = Column(vals, valid)


def _grouped_aggregate(t: Table, names, specs, schema_in, out_dicts,
                       out_schema, out_cap: int, rctx: RunContext,
                       rerank: bool, keep=None, max_keys=None,
                       pre_sorted: bool = False, soft_key_limit=None):
    """Sort-path group-by (``_grouped_aggregate`` of the JAX package, whose
    semantics it keeps; the module docstring has the design).  ``keep``
    (a fused Filter or a masked join) marks the live rows; without it, the
    first ``num_rows``.  Every pass after ``_live_table`` runs over the
    live rows alone.  Groups come out in first-occurrence order, or in key
    order without ``rerank``.

    ``pre_sorted`` (AggregateClusters): runs are adjacent equal keys in
    input order, so equal keys that are not adjacent stay groups of their
    own; there is no base sort, value passes sort by (run id, value), and
    the caller passes no ``keep`` (the live rows are a prefix).
    ``max_keys``: groups past it fold into its last group, after the
    re-rank.  ``soft_key_limit`` (a best-effort memory quota): the first
    that many keys in sort order aggregate fully, and every later live row
    is a group of its own, with a warning flag."""
    dev = t.device
    cap = t.capacity
    t = _live_table(t, keep, list(names) + [s.input for s in specs
                                            if s.input is not None])
    L = t.num_rows  # every row of t is live, in input order
    codes = []
    for nr, c in group_code_columns(t, names):
        codes += [c] if nr is None else [nr, c]
    perm = _sorted_rows([] if pre_sorted else codes, L, dev)
    pos = torch.arange(L, device=dev)
    # a run starts where any code differs from the row before (NaN != NaN)
    boundary = pos == 0
    if L > 1 and codes:
        same = None
        for c in codes:
            cs = c[perm]
            eq = cs[1:] == cs[:-1]
            same = eq if same is None else (same & eq)
        boundary[1:] = ~same
    if soft_key_limit is not None:
        rctx.error_flags.append(
            ("warning: best-effort group-by exceeded memory_quota; result "
             "is partially aggregated", boundary.sum() > soft_key_limit))
        rank = torch.cumsum(boundary, 0) - 1
        boundary = boundary | (rank >= soft_key_limit)
    next_starts = torch.zeros_like(boundary)
    next_starts[:-1] = boundary[1:]
    is_end = next_starts | (pos == L - 1)
    num_groups = boundary.sum()
    if max_keys is None and soft_key_limit is None:
        rctx.error_flags.append(("aggregate result overflow",
                                 num_groups > out_cap))
    # a clamp or a best-effort quota may keep every group until the end
    ext_cap = (cap if max_keys is not None or soft_key_limit is not None
               else out_cap)

    # lanes read at each run's last and first sorted position
    ends: dict = {"pos": pos, "row": perm}
    starts: dict = {"row": perm}
    sorted_cols: dict = {}
    vperms: dict = {}  # value-ordered pass -> its sorted rows

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

    def value_pass(pkey):
        """The rows in (group, value) order: NULL values last in a run,
        MAX by the descending code."""
        if pkey not in vperms:
            c = t.columns[pkey[0]]
            vcode = monotone_code(c.values, schema_in.lookup(pkey[0]).type)
            if pkey[1] == "desc":
                vcode = descending_code(vcode)
            vrank = [] if c.valid is None else [(~c.valid).to(torch.int32)]
            if pre_sorted:
                # the run id of each row (the base order is the input's)
                group = [torch.cumsum(boundary, 0, dtype=torch.int32)]
                vperms[pkey] = _sorted_rows(group + vrank + [vcode], L, dev)
            else:
                vperms[pkey] = _sorted_rows(codes + vrank + [vcode], L, dev)
        return vperms[pkey]

    dweights: dict = {}

    def distinct_weight(name):
        """(values, weight) per value-ordered position of a DISTINCT SUM
        or COUNT of ``name``: a row weighs 1 if it is not NULL and its
        value code differs from the previous row's in the same run (NaN is
        never equal to NaN)."""
        if name not in dweights:
            pv = value_pass((name, "asc"))
            c = t.columns[name]
            vs = c.values[pv]
            ok = (torch.ones(L, dtype=torch.bool, device=dev)
                  if c.valid is None else c.valid[pv])
            code = monotone_code(vs, schema_in.lookup(name).type)
            dup = torch.zeros_like(ok)
            dup[1:] = ((~boundary[1:]) & (code[1:] == code[:-1])
                       & (ok[1:] == ok[:-1]))
            dweights[name] = (vs, ok & ~dup)
        return dweights[name]

    f64_sums = {}
    concat_out = {}
    for s in specs:
        agg = s.aggregation
        if s.input is None:
            continue  # COUNT(*)
        if agg == Aggregation.CONCAT:
            # rides the stable base pass: a group's rows in input order,
            # the reference's append order
            vals, valid = sorted_col(s.input)
            ok = (torch.ones(L, dtype=torch.bool, device=dev)
                  if valid is None else valid)
            key = ("concat", s.output)
            ends[key] = torch.cumsum(ok, 0, dtype=torch.int32)
            concat_out[s.output] = key
            rctx.deferred.append(DeferredConcat(
                name=s.output, dict_obj=out_dicts[s.output], separator=",",
                distinct=bool(s.distinct),
                input_type=schema_in.lookup(s.input).type,
                input_dict=t.dicts.get(s.input),
                aux={"gid": (torch.cumsum(boundary, 0) - 1).to(torch.int32),
                     "vals": vals, "valid": ok, "num_groups": num_groups}))
            continue
        if s.distinct and agg in (Aggregation.SUM, Aggregation.COUNT):
            dkey = ("distinct", s.input)
            vs, w = distinct_weight(s.input)
            if dkey not in ends:
                ends[dkey] = torch.cumsum(w, 0, dtype=torch.int32)
            if agg == Aggregation.SUM:
                odt = torch_dtype(_resolve_output_attr(s, schema_in).type)
                if _is_int(vs.dtype) and _is_int(odt):
                    ikey = ("disum", s.input)
                    if ikey not in ends:
                        ends[ikey] = torch.cumsum(
                            torch.where(w, vs.long(), 0), 0)
                elif dkey not in f64_sums:
                    f64_sums[dkey] = torch.where(w, vs.double(), 0.0)
            continue
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
                starts[pkey] = value_pass(pkey)

    e = _extract(ends, is_end, ext_cap)
    st = _extract(starts, boundary, ext_cap)
    present = torch.arange(ext_cap, device=dev) < num_groups

    def diff(x):
        """Per group, from a cumsum read at the run ends (rows past the
        groups hold junk, which only rows past the groups read)."""
        return torch.where(present, torch.diff(x, prepend=x.new_zeros(1)), 0)

    count_all = diff(e["pos"] + 1)  # the run lengths

    def count_of(name):
        key = valid_count_key(name)
        return count_all if key is None else diff(e[key])

    def rows(lane):
        return torch.where(present, lane, 0).to(torch.int32)

    start_row = rows(st["row"])

    def at(idx, cols_at):
        """[(values, validity)] of the input columns ``cols_at`` at int32
        rows, in one gather (zeros where no row is live: no group reads
        them)."""
        lanes = []
        for name in cols_at:
            c = t.columns[name]
            lanes += [c.values] if c.valid is None else [c.values, c.valid]
        got = iter(gather_arrays(lanes, idx) if L else
                   [x.new_zeros(idx.shape) for x in lanes])
        return [(next(got), None if t.columns[name].valid is None
                 else next(got)) for name in cols_at]

    cols = {n: Column(*vv) for n, vv in zip(names, at(start_row, names))}
    for s in specs:
        odt = torch_dtype(_resolve_output_attr(s, schema_in).type)
        agg = s.aggregation
        if s.input is None:
            cols[s.output] = Column(count_all.to(odt), None)
            continue
        if agg == Aggregation.CONCAT:
            cols[s.output] = Column(
                torch.arange(ext_cap, dtype=torch.int32, device=dev),
                diff(e[concat_out[s.output]]) > 0)
            continue
        distinct = s.distinct and agg in (Aggregation.SUM, Aggregation.COUNT)
        if distinct:
            n_vals = diff(e[("distinct", s.input)])
        if agg == Aggregation.COUNT:
            cols[s.output] = Column(
                (n_vals if distinct else count_of(s.input)).to(odt), None)
        elif agg == Aggregation.SUM:
            skey = ("distinct", s.input) if distinct else s.input
            if skey in f64_sums:
                # each run added on its own in f64, rounded once to odt
                sv = _run_sums(f64_sums[skey], count_all)
            else:
                sv = diff(e[("disum" if distinct else "isum", s.input)])
            cols[s.output] = Column(sv.to(odt), (n_vals if distinct
                                                 else count_of(s.input)) > 0)
        elif agg in (Aggregation.MIN, Aggregation.MAX):
            # the run's first row in the value order, which puts NULLs
            # last: NULL only where the group holds no value (and, as in
            # the JAX package, the k-th NaN-key group takes the k-th NaN-key
            # row of that order)
            (vals, valid), = at(rows(st[_pass_key(s)]), [s.input])
            cols[s.output] = Column(vals.to(odt), present if valid is None
                                    else (present & valid))
        else:  # FIRST / LAST: the run's first / last row in input order
            (vals, valid), = at(start_row if agg == Aggregation.FIRST
                                else rows(e["row"]), [s.input])
            cols[s.output] = Column(vals.to(odt), present if valid is None
                                    else (present & valid))

    if rerank:
        # insertion order: present groups by first-occurrence row, absent
        # slots after them (every row of t lies below L)
        first = torch.where(present, st["row"],
                            L + torch.arange(ext_cap, device=dev))
        order = torch.sort(first).indices
        cols = {n: Column(c.values[order],
                          None if c.valid is None else c.valid[order])
                for n, c in cols.items()}
    n_out = num_groups.clamp(max=out_cap)
    if max_keys is not None:
        _fold_overflow(cols, specs, max_keys, num_groups, ext_cap)
        n_out = num_groups.clamp(max=max_keys)
    cols = {a.name: cols[a.name] for a in out_schema}
    if ext_cap != out_cap:
        cols = {n: Column(c.values[:out_cap],
                          None if c.valid is None else c.valid[:out_cap])
                for n, c in cols.items()}
    return Table(out_schema, _wrap_u32_sums(cols, out_schema), n_out, dev,
                 out_dicts, cap_hint=out_cap)


class GroupAggregate(Operation):
    """reference: GroupAggregate (aggregate_groups.cc:980); result order =
    key insertion order (RowHashSet append order)."""

    best_effort = False

    def __init__(self, group_by: Sequence[str], specification, child,
                 options: GroupAggregateOptions | None = None):
        self.group_by = list(group_by)
        self.spec = _normalize_spec(specification)
        self.child = child
        self.options = options or GroupAggregateOptions()

    def bind(self, ctx: BindContext,
             _unordered: bool = False) -> BoundOperation:
        # _unordered: the consumer re-orders the rows anyway (Sort), so the
        # insertion-order re-rank and its firstpos request are dropped
        from .hash_join import bind_fused
        opts = self.options
        specs = self.spec.specs
        cb, run_child = bind_fused(self.child, ctx)
        names = self.group_by
        key_attrs = [cb.schema.lookup(n) for n in names]
        agg_attrs = [_resolve_output_attr(s, cb.schema) for s in specs]
        out_schema = TupleSchema(key_attrs + agg_attrs)
        out_dicts = _output_dicts(cb, names, specs)
        out_cap = opts.estimated_result_row_count or cb.capacity
        max_keys = opts.max_unique_keys_in_result
        if max_keys:
            out_cap = min(out_cap, max_keys)
            if any(s.aggregation == Aggregation.CONCAT for s in specs):
                raise SchemaError(
                    "CONCAT with max_unique_keys_in_result is not supported "
                    "(overflow-group append order is undefined across the "
                    "clamp)")
        soft_limit = None
        if opts.memory_quota is not None:
            qrows = _quota_rows(opts.memory_quota, out_schema)
            if self.best_effort and not opts.enforce_quota:
                if any(s.distinct for s in specs):
                    raise SchemaError(
                        "DISTINCT aggregates cannot be partially aggregated "
                        "under a best-effort memory_quota")
                if max_keys is not None:
                    raise SchemaError(
                        "max_unique_keys_in_result and a best-effort "
                        "memory_quota are mutually exclusive")
                soft_limit = qrows
                out_cap = cb.capacity  # later rows pass through as groups
            else:
                # strict: more groups raise "aggregate result overflow"
                out_cap = min(out_cap, qrows)
        schema_in = cb.schema
        dense = None
        if names and soft_limit is None:
            dense = _dense_domain(cb, names, key_attrs, specs, schema_in,
                                  opts)

        def fn(rctx: RunContext) -> Table:
            t, keep = run_child(rctx)
            if dense is not None:
                dims, K = dense
                return _dense_grouped_aggregate(
                    t, dims, specs, schema_in, out_dicts, out_schema,
                    out_cap, K, rctx, keep=keep, ordered=not _unordered)
            return _grouped_aggregate(
                t, names, specs, schema_in, out_dicts, out_schema, out_cap,
                rctx, rerank=not _unordered, keep=keep, max_keys=max_keys,
                soft_key_limit=soft_limit)

        out_stats = ({names[0]: cb.stats[names[0]]}
                     if names and names[0] in cb.stats else {})
        return BoundOperation(out_schema, out_dicts, fn, out_cap,
                              stats=out_stats,
                              route="sort" if dense is None else "dense")


class BestEffortGroupAggregate(GroupAggregate):
    """Best-effort pregroup (reference: aggregate_groups.cc:989,
    aggregate.h:233-246).  Without a ``memory_quota`` it is GroupAggregate.
    With one (and ``enforce_quota`` False) it degrades instead of raising:
    the first quota budget of distinct keys, in sort order, aggregate
    fully; every later row is a partial group of its own, so the output
    rows are correct partial aggregates but not key-unique, with the
    warning "best-effort group-by exceeded memory_quota"."""

    best_effort = True


class HybridGroupAggregate(GroupAggregate):
    """Disk-capable group-by (reference: HybridGroupAggregate,
    aggregate_groups.cc:1146; design :491-534).  Without a
    ``memory_quota`` the device group-by takes any cardinality, so it is
    exactly GroupAggregate.  With one, a result past the quota completes
    instead of raising, as the JAX package's does:

      1. the child's rows are pregrouped on the device in chunks of the
         quota's rows (``_quota_rows`` of the pregroup's schema), slices of
         the child's device columns, over the extended key: the group key
         and the DISTINCT inputs (hybrid_group_utils.h:20-66);
      2. the partial groups spill through ``io/external.ExternalSorter``
         (runs sorted on the device, merged on the host);
      3. the sorted partials combine in batches of the quota's rows whose
         ends snap back to an extended-key cluster start, by
         ``AggregateClusters`` with COUNT recombined through SUM
         (aggregate_groups.cc:545-590), then one clustered merge of the
         batches' outputs;
      4. dictionary columns are re-coded into the dictionaries declared at
         bind, and a result past ``estimated_result_row_count`` raises.

    The child binds once; the spill runs when the plan executes, as a
    lazy leaf, so bind has no side effects (the reference's hybrid cursor
    drains its child at the first ``Next()``, aggregate_groups.cc:
    332-431).  The output is in key order.  CONCAT, and FIRST/LAST beside
    a DISTINCT aggregate, raise SchemaError.
    ``temporary_directory_prefix``: reference aggregate.h:311."""

    def __init__(self, group_by: Sequence[str], specification, child,
                 options: GroupAggregateOptions | None = None,
                 temporary_directory_prefix=None):
        super().__init__(group_by, specification, child, options)
        self.temp_prefix = temporary_directory_prefix

    def bind(self, ctx: BindContext,
             _unordered: bool = False) -> BoundOperation:
        opts = self.options
        if opts.memory_quota is None:
            return super().bind(ctx, _unordered)
        from .base import placeholder

        names = list(self.group_by)
        specs = self.spec.specs
        has_distinct = any(s.distinct for s in specs)
        for s in specs:
            if s.aggregation == Aggregation.CONCAT:
                raise SchemaError(
                    "CONCAT partial aggregates cannot be combined across "
                    "spilled chunks (order-sensitive, variable-length); "
                    "use GroupAggregate within memory or "
                    "ops.host.group_concat")
            if has_distinct and s.aggregation in (
                    Aggregation.FIRST, Aggregation.LAST):
                raise SchemaError(
                    "FIRST/LAST cannot be combined with DISTINCT "
                    "aggregates under a spilling HybridGroupAggregate "
                    "(the extended-key disk sort loses input order)")
        cb = self.child.bind(ctx)
        ext_names = list(names)
        for s in specs:
            if s.distinct and s.input not in ext_names:
                ext_names.append(s.input)
        pre_spec = AggregationSpecification(
            [s for s in specs if not s.distinct])
        pre_schema = TupleSchema(
            [cb.schema.lookup(n) for n in ext_names]
            + [_resolve_output_attr(s, cb.schema) for s in pre_spec.specs])
        out_schema = TupleSchema(
            [cb.schema.lookup(n) for n in names]
            + [_resolve_output_attr(s, cb.schema) for s in specs])
        out_cap = min(opts.estimated_result_row_count or cb.capacity,
                      cb.capacity)
        out_dicts = {n: cb.dicts[n] for n in names if n in cb.dicts}
        for s in specs:
            if s.input is not None and s.input in cb.dicts:
                out_dicts[s.output] = cb.dicts[s.input]
        need = list(dict.fromkeys(
            ext_names + [s.input for s in specs
                         if s.input is not None and not s.distinct]))
        spill = _HybridSpill(
            names, ext_names, pre_spec, pre_schema, out_schema, out_dicts,
            out_cap, _quota_rows(opts.memory_quota, pre_schema),
            TupleSchema([cb.schema.lookup(n) for n in need]),
            _combine_specs(specs, keep_distinct=True),
            _combine_specs(specs, keep_distinct=False), self.temp_prefix)

        def producer(leaves, cancel) -> Table:
            from .base import materialize_bound

            return spill.run(materialize_bound(cb, leaves, cancel), cancel)

        idx = ctx.register_lazy_leaf(
            placeholder(out_schema, out_cap, out_dicts), producer)

        def fn(rctx: RunContext) -> Table:
            return rctx.leaf_tables[idx]

        return BoundOperation(out_schema, out_dicts, fn, out_cap)


def _combine_specs(specs, keep_distinct: bool) -> list:
    """Each aggregate over its own partial results: COUNT recombines
    through SUM, the rest re-aggregate as they are.  ``keep_distinct``
    (the batches, whose rows hold the DISTINCT inputs as key columns)
    keeps a DISTINCT aggregate over its input; the final merge adds the
    batches' disjoint DISTINCT results like any other."""
    out = []
    for s in specs:
        if keep_distinct and s.distinct:
            out.append(s)
        elif s.aggregation == Aggregation.COUNT:
            out.append(AggSpec(Aggregation.SUM, s.output, s.output,
                               s.output_type or DataType.UINT64))
        else:
            out.append(AggSpec(s.aggregation, s.output, s.output,
                               s.output_type))
    return out


def _check_flags(flags, what: str) -> None:
    from ..exprs.base import EvaluationError

    if not flags.shape[0]:
        return
    with tracing.sync("hybrid.flags", flags):
        fired = bool(flags.any())
    if fired:
        raise EvaluationError(
            f"evaluation failed: hybrid {what} raised device error flags")


def _rows(table: Table, start: int, stop: int, cap: int) -> dict:
    """Rows [start, stop) of ``table``'s columns, zero-padded to ``cap``
    rows (views where no padding is needed)."""
    def fit(x):
        x = x[start:stop]
        if x.shape[0] < cap:
            x = torch.cat([x, x.new_zeros(cap - x.shape[0])])
        return x

    return {n: Column(fit(c.values), None if c.valid is None
                      else fit(c.valid)) for n, c in table.columns.items()}


@dataclass
class _HybridSpill:
    """The execution of a spilling HybridGroupAggregate over its child's
    table (see HybridGroupAggregate): what its bind decided."""

    names: list            # the group key
    ext_names: list        # the group key and the DISTINCT inputs
    pre_spec: AggregationSpecification  # the non-DISTINCT aggregates
    pre_schema: TupleSchema  # the pregroup's output
    out_schema: TupleSchema
    out_dicts: dict        # the dictionaries declared at bind
    out_cap: int
    chunk_rows: int        # the quota's rows of pre_schema
    sub_schema: TupleSchema  # the child's columns the pregroup reads
    batch_specs: list      # _combine_specs of the batches
    merge_specs: list      # _combine_specs of the final merge
    temp_prefix: Optional[str]

    def run(self, src: Table, cancel) -> Table:
        from ..exprs.base import EvaluationError
        from ..io.external import ExternalSorter
        from .base import compile_plan, placeholder
        from .scan import ScanTable
        from .sort import SortOrder

        def poll():
            if cancel is not None:
                cancel.check()

        rows, dev = self.chunk_rows, src.device
        sub = Table(self.sub_schema,
                    {n: src.columns[n] for n in self.sub_schema.names()},
                    src.num_rows, dev,
                    {n: d for n, d in src.dicts.items()
                     if n in self.sub_schema.names()})
        n_in = int(tracing.to_host(src.num_rows, "hybrid.num_rows"))
        # one bound pregroup, run over every chunk: its leaf has no
        # planner statistics, so no chunk's key range binds the plan
        pre_run, _, _ = compile_plan(GroupAggregate(
            self.ext_names, self.pre_spec,
            ScanTable(placeholder(self.sub_schema, rows, sub.dicts)),
            GroupAggregateOptions(estimated_result_row_count=rows)))
        with ExternalSorter(self.pre_schema, SortOrder(self.ext_names), rows,
                            self.temp_prefix, device=dev) as sorter:
            for start in range(0, n_in, rows):
                poll()
                stop = min(start + rows, n_in)
                chunk = Table(self.sub_schema, _rows(sub, start, stop, rows),
                              stop - start, dev, sub.dicts, cap_hint=rows)
                pre_t, flags, _ = pre_run([chunk])
                _check_flags(flags, "pregroup")
                sorter.write(pre_t)
            merged = sorter.result()
        outputs = self._combine(merged, poll)
        if not outputs:
            final = Table.empty(self.out_schema, device=dev)
        elif len(outputs) == 1:
            final = outputs[0]
        else:
            from ..batch import concat_tables

            m_run, _, leaves = compile_plan(AggregateClusters(
                self.names, self.merge_specs,
                ScanTable(concat_tables(outputs))))
            final, flags, _ = m_run(leaves)
            _check_flags(flags, "merge")
        n_out = int(tracing.to_host(final.num_rows, "hybrid.num_rows"))
        if n_out > self.out_cap:
            raise EvaluationError(
                "evaluation failed: hybrid aggregate result exceeds the "
                f"declared capacity ({n_out} > {self.out_cap} rows; raise "
                "estimated_result_row_count)")
        return self._declared(final, n_out)

    def _combine(self, merged: Table, poll) -> list:
        """AggregateClusters over batches of at most ``chunk_rows`` sorted
        partial rows, each ending at an extended-key cluster start."""
        from .base import compile_plan, materialize_child, placeholder
        from .scan import ScanTable

        m_rows = int(tracing.to_host(merged.num_rows, "hybrid.num_rows"))
        if m_rows == 0:
            return []
        same = torch.ones(m_rows, dtype=torch.bool, device=merged.device)
        same[0] = False
        for nm in self.ext_names:  # NULL equals NULL
            c = merged.columns[nm]
            v = c.values[:m_rows]
            eq = v[1:] == v[:-1]
            if c.valid is not None:
                ok = c.valid[:m_rows]
                eq = (eq & ok[1:] & ok[:-1]) | (~ok[1:] & ~ok[:-1])
            same[1:] &= eq
        with tracing.sync("hybrid.nonzero", same):
            starts = torch.nonzero(~same).flatten()
        starts = tracing.to_host(starts, "hybrid.starts").numpy()
        cap = max(self.chunk_rows, 2)
        comb_run = None
        outputs = []
        start = 0
        while start < m_rows:
            poll()
            if start + cap >= m_rows:
                stop = m_rows
            else:  # the last cluster start inside the window
                j = int(np.searchsorted(starts, start + cap, side="right"))
                stop = int(starts[j - 1]) if starts[j - 1] > start else start
            if stop > start:
                batch = Table(self.pre_schema,
                              _rows(merged, start, stop, cap), stop - start,
                              merged.device, merged.dicts, cap_hint=cap)
                if comb_run is None:
                    comb_run, _, _ = compile_plan(AggregateClusters(
                        self.names, self.batch_specs,
                        ScanTable(placeholder(self.pre_schema, cap,
                                              merged.dicts))))
                out_t, flags, _ = comb_run([batch])
                _check_flags(flags, "combine")
            else:
                # one extended-key cluster wider than a batch: on its own
                j = int(np.searchsorted(starts, start, side="right"))
                stop = int(starts[j]) if j < len(starts) else m_rows
                batch = Table(self.pre_schema,
                              _rows(merged, start, stop, stop - start),
                              stop - start, merged.device, merged.dicts)
                out_t = materialize_child(AggregateClusters(
                    self.names, self.batch_specs, ScanTable(batch)))
            outputs.append(out_t)
            start = stop
        return outputs

    def _declared(self, final: Table, n_out: int) -> Table:
        """``final``'s rows in a table of the declared capacity, layout and
        dictionaries: dictionary columns re-coded into the bind's
        dictionaries (a merge may have built equal-content copies)."""
        from ..kernels.lut_gather import BoundLut, take_small

        cap, dev = self.out_cap, final.device
        cols = {}
        for a in self.out_schema:
            c = final.columns[a.name]
            v = c.values[:n_out]
            d0, d1 = self.out_dicts.get(a.name), final.dicts.get(a.name)
            if d0 is not None and d1 is not None and d1 is not d0:
                v = take_small(BoundLut(d1.codes_in(d0)), v)
            valid = None
            if a.nullable:
                valid = (torch.ones(n_out, dtype=torch.bool, device=dev)
                         if c.valid is None else c.valid[:n_out])
            cols[a.name] = Column(v, valid)
        return Table(self.out_schema,
                     _rows(Table(self.out_schema, cols, n_out, dev),
                           0, n_out, cap),
                     n_out, dev, dict(self.out_dicts), cap_hint=cap)


def _scalar_distinct(vals, valid, type_, cap: int, all_valid: bool):
    """DISTINCT of a scalar SUM or COUNT: (values, weight) in the order of
    one stable sort by (NULL last, value code), where a row weighs 1 if it
    is valid and its code differs from the previous row's (NaN never
    equals NaN; -0.0 equals +0.0).  ``all_valid`` (every row live, no
    NULL) drops the NULL rank from the sort."""
    code = monotone_code(vals, type_)
    ops = [code] if all_valid else [(~valid).to(torch.int32), code]
    perm = _sorted_rows(ops, cap, vals.device)
    sv, ok = vals[perm], valid[perm]
    sc = sv if code is vals else code[perm]
    dup = torch.zeros_like(ok)
    dup[1:] = sc[1:] == sc[:-1]
    return sv, ok & ~dup


class ScalarAggregate(Operation):
    """Aggregate the whole input into exactly one row, even an empty one
    (reference: aggregate_scalar.cc:17-58): SUM, MIN and MAX are NULL
    without a valid input row, COUNT is never NULL, FIRST and LAST read
    rows 0 and n - 1, CONCAT joins every row in input order.  Plain
    ``torch`` reductions: the JAX package computes them outside any
    kernel."""

    def __init__(self, specification, child):
        self.spec = _normalize_spec(specification)
        self.child = child

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        specs = self.spec.specs
        schema_in = cb.schema
        out_schema = TupleSchema([_resolve_output_attr(s, schema_in)
                                  for s in specs])
        out_dicts = _output_dicts(cb, [], specs)

        def fn(rctx: RunContext) -> Table:
            t = cb.run(rctx)
            live = t.row_mask()
            dev, cap = t.device, t.capacity
            cols = {}
            for s in specs:
                odt = torch_dtype(_resolve_output_attr(s, schema_in).type)
                agg = s.aggregation
                if agg == Aggregation.COUNT and s.input is None:
                    cols[s.output] = Column(live.sum().to(odt).reshape(1),
                                            None)
                    continue
                c = t.columns[s.input]
                vals = c.values
                valid = live if c.valid is None else (c.valid & live)
                weight = valid
                if s.distinct and agg in (Aggregation.SUM, Aggregation.COUNT):
                    vals, weight = _scalar_distinct(
                        vals, valid, schema_in.lookup(s.input).type, cap,
                        c.valid is None and isinstance(t.num_rows, int)
                        and t.num_rows == cap)
                some = weight.any().reshape(1)
                if agg == Aggregation.SUM:
                    total = torch.where(weight, vals, 0).sum()
                    cols[s.output] = Column(total.to(odt).reshape(1), some)
                elif agg == Aggregation.COUNT:
                    cols[s.output] = Column(weight.sum().to(odt).reshape(1),
                                            None)
                elif agg in (Aggregation.MIN, Aggregation.MAX):
                    is_min = agg == Aggregation.MIN
                    # UINT64 bits compare unsigned through their key
                    u64 = schema_in.lookup(s.input).type == DataType.UINT64
                    if u64:
                        vals = u64_key(vals)
                    v = torch.where(weight, vals,
                                    _extreme(vals.dtype, is_min))
                    v = v.amin() if is_min else v.amax()
                    if u64:
                        v = u64_key(v)
                    cols[s.output] = Column(v.to(odt).reshape(1), some)
                elif agg in (Aggregation.FIRST, Aggregation.LAST):
                    n = torch.as_tensor(t.num_rows, device=dev).reshape(1)
                    idx = (torch.zeros_like(n) if agg == Aggregation.FIRST
                           else (n - 1).clamp(min=0))
                    ok = n > 0
                    if c.valid is not None:
                        ok = ok & c.valid[idx]
                    cols[s.output] = Column(vals[idx].to(odt), ok)
                else:  # CONCAT: one group, the whole input in input order
                    rctx.deferred.append(DeferredConcat(
                        name=s.output, dict_obj=out_dicts[s.output],
                        separator=",", distinct=bool(s.distinct),
                        input_type=schema_in.lookup(s.input).type,
                        input_dict=t.dicts.get(s.input),
                        aux={"gid": torch.zeros(cap, dtype=torch.int32,
                                                device=dev),
                             "vals": vals, "valid": valid,
                             "num_groups": 1}))
                    cols[s.output] = Column(
                        torch.zeros(1, dtype=torch.int32, device=dev),
                        valid.any().reshape(1))
            return Table(out_schema, _wrap_u32_sums(cols, out_schema), 1, dev,
                         out_dicts, cap_hint=1)

        return BoundOperation(out_schema, out_dicts, fn, 1)


class AggregateClusters(Operation):
    """Streaming aggregate over key-clustered input (reference:
    aggregate_clusters.cc:338-646): a group is a run of adjacent equal
    keys in input order, so equal keys that are not adjacent are groups
    of their own; the output is in cluster order."""

    def __init__(self, group_by: Sequence[str], specification, child,
                 out_capacity: Optional[int] = None):
        self.group_by = list(group_by)
        self.spec = _normalize_spec(specification)
        self.child = child
        self.out_capacity = out_capacity

    def bind(self, ctx: BindContext) -> BoundOperation:
        cb = self.child.bind(ctx)
        names = self.group_by
        specs = self.spec.specs
        key_attrs = [cb.schema.lookup(n) for n in names]
        agg_attrs = [_resolve_output_attr(s, cb.schema) for s in specs]
        out_schema = TupleSchema(key_attrs + agg_attrs)
        out_dicts = _output_dicts(cb, names, specs)
        out_cap = self.out_capacity or cb.capacity
        schema_in = cb.schema

        def fn(rctx: RunContext) -> Table:
            return _grouped_aggregate(
                cb.run(rctx), names, specs, schema_in, out_dicts, out_schema,
                out_cap, rctx, rerank=False, pre_sorted=True)

        return BoundOperation(out_schema, out_dicts, fn, out_cap)


def AggregateClustersWithSpecifiedOutputBlockSize(group_by, specification,
                                                  block_size, child):
    """reference: aggregate.h; the block size caps the output of a view,
    here the output capacity."""
    return AggregateClusters(group_by, specification, child,
                             out_capacity=int(block_size))
