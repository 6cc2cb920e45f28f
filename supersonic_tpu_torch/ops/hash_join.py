"""Hash join: every JoinType, UNIQUE or NOT_UNIQUE rhs, over keys of every
column type the port carries.

Port of ``supersonic_tpu/ops/hash_join.py`` (reference:
cursor/core/hash_join.cc; NULL keys never match, hash_join.cc:67-76;
LEFT_OUTER emits a NULL rhs row for each unmatched lhs row and forces the
rhs outputs nullable, hash_join.cc:78-87, 801-806).  Key pairs must have
equal types, or be two integer types (INT32 and INT64 compare as int64).
STRING/BINARY keys with different dictionaries remap the build side only,
into the probe's dictionary: a build value the probe's dictionary lacks
maps to -1 and matches nothing.  The probe is chosen at bind from planner
statistics and guarded at run time by an error flag:

  * row-id probe (UNIQUE): the rhs key IS the row position plus a constant
    (a dense ascending primary key, rowid_merge_join.h:24-40).  The probe
    reads the projected rhs columns at (probe key - min) with one
    ``lut_gather`` launch; there is no index at all.
  * fat-LUT probe (UNIQUE, dense keys): one winning rhs row per key slot
    (the last, found by a scatter-max of row positions) is gathered into a
    table of each projected rhs column (and its validity, and a match
    flag) indexed by key slot, and the probe reads every lane with one
    ``lut_gather`` launch.
  * CSR probe (NOT_UNIQUE, dense keys): a stable sort of the rhs rows by
    key slot gives ``build_perm`` (equal keys keep the rhs order, the
    reference's match-list order), a search of the sorted slots gives each
    slot's start and count, and the probe reads (count, start) with one
    two-lane ``lut_gather`` launch.
  * merge probe, every key set without a dense domain (no statistics, a
    range past the budget, FLOAT/DOUBLE/BOOL keys, a dictionary past 2^24
    codes, ``allow_dense_lookup=False``): one stable sort of the build and
    probe key codes together gives, per probe row, the live build rows
    before its run (``lower``) and in it (``count``), scattered back to
    probe order; ``build_perm`` is the live build rows in sorted order.

  Keys are dense over statistics (INT32, INT64, DATE, DATETIME), over the
  probe dictionary's codes (STRING, BINARY) or over the value map (ENUM).
  The JAX package built the LUT and the CSR with marker sorts because TPU
  scatters are slow; a scatter and a sort are the direct ways on the card.

A UNIQUE join emits at most one row per lhs row: the matched build row, or
under the merge probe the first build row of the key in rhs order.  Under
GroupAggregate and Sort it binds MASKED: its output stays at lhs capacity
with a keep mask (the matches for INNER, every kept lhs row for
LEFT_OUTER).  Unmasked, a LEFT_OUTER join without a fused Filter is
zero-copy at lhs capacity, and otherwise the emitted rows move through the
compaction kernel into lanes no longer than the lhs.  That join reads its
row count on the host once (sync ``join.num_rows``): every later pass
needs a length, and eager PyTorch gives none without the host.  Its output
is the prefix of its survivors, with a host row count, so the operators
above it (another join, a Compute, an aggregate) run over those rows and
not over the lhs capacity.  The table keeps one row of capacity when none
survives, as every table of the port does.

A NOT_UNIQUE join emits ``count`` rows per kept lhs row (at least one for
LEFT_OUTER) at int64 offsets, raising "join result overflow" past its
capacity.  The compaction kernel packs the lhs rows that emit, the spread
kernel expands their lanes to the output rows (both in groups of at most
``MAX_ARRAYS`` lanes a launch), and the rhs columns are gathered from the
build-sorted rhs.  The JAX package's dup-packed and merge spread-fill
routes are TPU gather workarounds and are not carried.

RIGHT_OUTER and FULL_OUTER compose the operators above, as the JAX package
does (``HashJoin._bind_outer_rewrite``).  Keys compare by
``monotone_code``, as in the JAX package: a UINT32 key is dense over its
statistics, a UINT64 key takes the merge probe.
"""
from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch

from .. import tracing
from ..batch import Column, Table, gather_table
from ..kernels import MAX_ARRAYS
from ..kernels.compaction import compact_kernel
from ..kernels.lut_gather import lut_gather
from ..kernels.spread import I32_MAX, spread_kernel
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext
from .keys import monotone_code
from .project import Projector
from .union import remap_codes


class JoinType(enum.Enum):
    """reference: proto/supersonic.proto:77-83.  The reference implements
    only INNER and LEFT_OUTER (hash_join.h:37); RIGHT_OUTER is a mirrored
    LEFT_OUTER and FULL_OUTER a LEFT_OUTER plus NULL-padded anti rows."""

    INNER = "INNER"
    LEFT_OUTER = "LEFT_OUTER"
    RIGHT_OUTER = "RIGHT_OUTER"
    FULL_OUTER = "FULL_OUTER"


class KeyUniqueness(enum.Enum):
    UNIQUE = "UNIQUE"
    NOT_UNIQUE = "NOT_UNIQUE"


_INT_TYPES = (DataType.INT32, DataType.INT64, DataType.UINT32,
              DataType.UINT64)
# keys dense over planner statistics (JAX _DENSE_KEY_TYPES)
_STAT_KEY_TYPES = (DataType.INT32, DataType.INT64, DataType.UINT32,
                   DataType.DATE, DataType.DATETIME)
_DICT_KEY_TYPES = (DataType.STRING, DataType.BINARY)
_DENSE_RANGE_MAX = 1 << 24  # slots of a fat LUT or CSR (as the JAX package)


def _subset(t: Table, names) -> Table:
    """View of ``t`` restricted to ``names`` (no data movement)."""
    names = list(dict.fromkeys(names))
    attrs = [t.schema.lookup(n) for n in names]
    return Table(TupleSchema(attrs), {n: t.columns[n] for n in names},
                 t.num_rows, t.device,
                 {n: t.dicts[n] for n in names if n in t.dicts},
                 cap_hint=t.capacity)


def _any_null(table: Table, names) -> torch.Tensor:
    out = torch.zeros(table.capacity, dtype=torch.bool, device=table.device)
    for n in names:
        c = table.columns[n]
        if c.valid is not None:
            out = out | ~c.valid
    return out


def _key_codes(table: Table, names, types, cols=None):
    """Per key its comparison code (``monotone_code``: -0.0 as +0.0, BOOL
    as int32; ``types[i]`` is a torch dtype to promote to, or None), read
    from ``cols`` (default: the table's columns)."""
    cols = cols or table.columns
    codes = []
    for name, dt in zip(names, types):
        c = monotone_code(cols[name].values, table.schema.lookup(name).type)
        codes.append(c if dt is None else c.to(dt))
    return codes


def _composite_slot(codes, dims):
    """int64 composite slot, in-range mask, and in-range mask over the
    dimensions planned from statistics (the others cannot stray: a code the
    probe's dictionary lacks is -1 by design); the per-dimension clip keeps
    the slot in [0, prod(ranges)) for out-of-range values."""
    idx, inr, stat_inr = None, None, None
    for v, (kmin, rng_i, from_stats) in zip(codes, dims):
        v = v.long() - kmin
        ok = (v >= 0) & (v < rng_i)
        dc = v.clamp(0, rng_i - 1)
        idx = dc if idx is None else idx * rng_i + dc
        inr = ok if inr is None else (inr & ok)
        if from_stats:
            stat_inr = ok if stat_inr is None else (stat_inr & ok)
    return idx, inr, stat_inr


def _fat_lut_probe(rt: Table, srcs, scat: torch.Tensor, pslot: torch.Tensor,
                   pin: torch.Tensor, rng: int, nullable_out: bool):
    """Dense UNIQUE probe through a fat LUT.  ``scat``: int64 slot of each
    rhs row (``rng`` for dead rows, a dump slot no probe reads); ``pslot``:
    int32 slot of each probe row, in [0, rng); ``pin``: probe rows that may
    match.  Returns ({src: Column at probe capacity}, matched); with
    ``nullable_out`` (LEFT_OUTER) validity is masked to ``matched``.

    Each slot takes ONE rhs row, the last one (largest row position), and
    every lane of the slot is gathered from it: a rhs that breaks its UNIQUE
    promise gives the JAX package's rows (its marker sort keeps each slot's
    last build row), the same on every run, with a probe row's value and
    validity from the same rhs row."""
    dev = rt.device
    rows = torch.arange(scat.shape[0], dtype=torch.int32, device=dev)
    winner = torch.full((rng + 1,), -1, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, scat, rows, "amax")
    winner = winner[:rng]
    flag = winner >= 0
    at = winner.clamp(min=0).long()
    lanes, tags = [], []
    for src in dict.fromkeys(srcs):
        col = rt.columns[src]
        vals = col.values[at]
        lanes.append(torch.where(flag, vals, torch.zeros_like(vals)))
        tags.append(("val", src))
        if col.valid is not None:
            lanes.append(col.valid[at] & flag)
            tags.append(("valid", src))
    lanes.append(flag)
    gathered = lut_gather(lanes, pslot, rng)  # one launch, every lane
    got = dict(zip(tags, gathered))
    matched = pin & gathered[-1]
    out = {}
    for src in dict.fromkeys(srcs):
        valid = got.get(("valid", src))
        if nullable_out:
            valid = matched if valid is None else (valid & matched)
        out[src] = Column(got[("val", src)], valid)
    return out, matched


def _csr_probe(bslot: torch.Tensor, pslot: torch.Tensor, pin: torch.Tensor,
               rng: int):
    """Dense NOT_UNIQUE probe.  ``bslot``: int64 slot of each rhs row
    (``rng`` for dead rows, which sort last); ``pslot``: int32 slot of each
    probe row, in [0, rng); ``pin``: probe rows that may match.  Returns
    int32 (count, lower) per probe row, lower being its first position in
    slot order, and ``build_perm``, the int32 rhs rows in slot order."""
    sorted_slot, build_perm = torch.sort(bslot, stable=True)
    edges = torch.searchsorted(
        sorted_slot, torch.arange(rng + 1, device=bslot.device))
    start = edges[:-1].to(torch.int32)
    counts = (edges[1:] - edges[:-1]).to(torch.int32)
    g_cnt, g_start = lut_gather([counts, start], pslot, rng)  # one launch
    count = torch.where(pin, g_cnt, 0)
    lower = torch.where(pin, g_start, 0)
    return count, lower, build_perm.to(torch.int32)


def _merge_probe(bcodes, pcodes, blive: torch.Tensor, pin: torch.Tensor):
    """Probe without a dense key domain, the contract of ``_csr_probe``:
    int32 (count, lower) per probe row and ``build_perm``, the int32 live
    rhs rows in (key codes, rhs row) order, ``lower`` indexing it.

    Build and probe codes, concatenated (build rows first), take one stable
    sort by the key tuple: stable ``torch.sort`` passes from the last key to
    the first.  Inside a run of equal keys the build rows therefore precede
    the probe rows and keep the rhs order.  A run starts where an adjacent
    tuple differs by value (NaN differs from itself, so a NaN key matches
    nothing; -0.0 equals +0.0).  Dead and NULL-key build rows are sorted
    too, but count for nothing: a probe row's ``count`` is the live build
    rows of its run up to it, ``lower`` those before its run (a prefix sum,
    and each run's start carried over the run by a compaction and a
    gather by run id; ``torch.cummax`` scans a 1-D tensor in one thread
    block, 268 ms at 101M rows on the H100).  Both are scattered back to
    probe order by the sorted row ids; the compaction kernel cuts the live
    build rows' ids out of the sorted order."""
    rcap, lcap = blive.shape[0], pin.shape[0]
    dev = blive.device
    cat = [torch.cat([b, p]) for b, p in zip(bcodes, pcodes)]
    order, first = None, None
    for c in reversed(cat):
        first, o = torch.sort(c if order is None else c[order], stable=True)
        order = o if order is None else order[o]
    s_codes = [first] + [c[order] for c in cat[1:]]
    n = rcap + lcap
    order32 = order.to(torch.int32)
    # live build rows in sorted order: the build flags read through the
    # rhs-sized LUT (probe rows, past it, are masked)
    isb = (order32 < rcap) & lut_gather([blive], order32, rcap)[0]
    bprefix = torch.cumsum(isb, 0, dtype=torch.int32)
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        same = s_codes[0][1:] == s_codes[0][:-1]
        for c in s_codes[1:]:
            same &= c[1:] == c[:-1]
        boundary[1:] = ~same
    # the live build rows before each run: one value a run, cut out at the
    # run starts by the compaction kernel and read back by run id
    (starts,), _ = compact_kernel([bprefix - isb.to(torch.int32)], boundary,
                                  n)
    run_id = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    run_start = lut_gather([starts], run_id, n)[0]
    pair = torch.empty(n, 2, dtype=torch.int32, device=dev)
    pair[:, 0] = bprefix - run_start
    pair[:, 1] = run_start
    back = torch.empty(n, dtype=torch.int64, device=dev)
    back[order] = pair.view(torch.int64).view(n)  # one 8-byte scatter
    got = back[rcap:].view(torch.int32).view(lcap, 2)
    count = torch.where(pin, got[:, 0], 0)
    lower = torch.where(pin, got[:, 1], 0)
    build_perm = compact_kernel([order32], isb, rcap)[0][0]
    return count, lower, build_perm


def _expand(lt: Table, lsrcs, rt: Table, rsrcs, build_perm, lkeep, count,
            lower, out_cap: int, left_outer: bool, rctx: RunContext):
    """Multi-match expansion: ({src: Column} of the lhs sources and of the
    rhs sources at ``out_cap`` rows, row count).  Each kept lhs row emits
    ``count`` rows, or one NULL-rhs row when LEFT_OUTER finds no match.
    The lanes move in groups of at most ``MAX_ARRAYS`` a launch, every
    compaction against the same mask."""
    dev = lt.device
    lcap = lt.capacity
    eff = torch.where(lkeep, count.clamp(min=1), 0) if left_outer else count
    offsets = torch.cumsum(eff, 0, dtype=torch.int64)
    total = offsets[-1]
    rctx.error_flags.append(("join result overflow", total > out_cap))
    # a start at or past out_cap covers no output row: clamping keeps the
    # int32 starts exact wherever they are read
    base = (offsets - eff).clamp(max=out_cap).to(torch.int32)
    lanes, layout = [], []  # layout: (src, has_valid)
    for src in lsrcs:
        c = lt.columns[src]
        lanes.append(c.values)
        if c.valid is not None:
            lanes.append(c.valid)
        layout.append((src, c.valid is not None))
    d_lane = len(lanes)
    lanes.append(lower - base)  # output row j reads build position j + d
    if left_outer:
        lanes.append(count)
    lanes.append(base)
    emit = eff > 0
    packed = []
    for i in range(0, len(lanes), MAX_ARRAYS):
        moved, n_src = compact_kernel(lanes[i:i + MAX_ARRAYS], emit, lcap)
        packed += moved
    # dead sources start past every row, so the live count stays on device
    base_c = torch.where(torch.arange(lcap, device=dev) < n_src, packed[-1],
                         I32_MAX)
    spread = []
    for i in range(0, len(packed) - 1, MAX_ARRAYS):
        group = packed[i:min(i + MAX_ARRAYS, len(packed) - 1)]
        add = (d_lane - i,) if i <= d_lane < i + len(group) else ()
        spread += spread_kernel(group, base_c, out_cap, add_row=add)
    spread = iter(spread)
    lcols = {}
    for src, has_valid in layout:
        vals = next(spread)
        lcols[src] = Column(vals, next(spread) if has_valid else None)
    bpos = next(spread)
    # past the row count the rows are unspecified, so no live mask is needed
    hit = next(spread) > 0 if left_outer else None
    n_out = total.clamp(max=out_cap)
    rsorted = gather_table(_subset(rt, rsrcs), build_perm, rt.num_rows)
    rg = gather_table(rsorted, bpos, n_out)
    rcols = {}
    for src in rsrcs:
        c = rg.columns[src]
        valid = c.valid
        if left_outer:
            valid = hit if valid is None else (valid & hit)
        rcols[src] = Column(c.values, valid)
    return lcols, rcols, n_out


def bind_fused(child: Operation, ctx: BindContext, plain_bind=None):
    """Bind the child of a consumer that takes a keep mask in place of
    compacted rows (GroupAggregate, Sort).  Its Filters are peeled off and
    their predicates bound over what they wrap.  A UNIQUE INNER or
    LEFT_OUTER join binds masked: its keep mask (the matches for INNER, the
    kept lhs rows for LEFT_OUTER) comes with its rows at lhs capacity.
    Anything else binds through ``plain_bind(op)`` (default
    ``op.bind(ctx)``): a NOT_UNIQUE join expands, and the outer rewrites
    emit more rows than the lhs holds.  Returns (the bound child, run):
    ``run(rctx)`` gives (Table, the join's keep AND the predicates', or
    None when there is neither)."""
    from .filter import bind_predicates, keep_mask, unwrap_filters
    inner, preds = unwrap_filters(child)
    masked = (isinstance(inner, HashJoin)
              and inner.uniqueness == KeyUniqueness.UNIQUE
              and inner.join_type in (JoinType.INNER, JoinType.LEFT_OUTER))
    if masked:
        cb = inner.bind(ctx, _masked=True)
    elif plain_bind is not None:
        cb = plain_bind(inner)
    else:
        cb = inner.bind(ctx)
    bound_preds = bind_predicates(preds, cb)

    def run(rctx: RunContext):
        if masked:
            t, keep = cb.run(rctx)
        else:
            t, keep = cb.run(rctx), None
        if bound_preds:
            pk = keep_mask(bound_preds, rctx, t)
            keep = pk if keep is None else (keep & pk)
        return t, keep

    return cb, run


class HashJoin(Operation):
    """reference: HashJoinOperation (hash_join.h:35)."""

    def __init__(self, join_type: JoinType,
                 lhs_keys: Sequence[str], rhs_keys: Sequence[str],
                 lhs: Operation, rhs: Operation,
                 rhs_key_uniqueness: KeyUniqueness = KeyUniqueness.NOT_UNIQUE,
                 lhs_projector: Optional[Projector] = None,
                 rhs_projector: Optional[Projector] = None,
                 out_capacity: Optional[int] = None,
                 allow_dense_lookup: bool = True):
        if len(lhs_keys) != len(rhs_keys) or not lhs_keys:
            raise SchemaError("join key lists must be equal-length, non-empty")
        self.join_type = join_type
        self.lhs_keys = list(lhs_keys)
        self.rhs_keys = list(rhs_keys)
        self.lhs = lhs
        self.rhs = rhs
        self.uniqueness = rhs_key_uniqueness
        self.lhs_projector = lhs_projector or Projector.all()
        self.rhs_projector = rhs_projector or Projector.all()
        self.out_capacity = out_capacity
        self.allow_dense_lookup = allow_dense_lookup

    def bind(self, ctx: BindContext, _masked: bool = False) -> BoundOperation:
        # _masked (UNIQUE rhs only): produce the output at lhs capacity as
        # (Table, keep mask) without compacting, for bind_fused
        if self.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            if _masked:
                raise SchemaError(
                    "masked join binding supports INNER/LEFT_OUTER only")
            return self._bind_outer_rewrite(ctx)
        unique = self.uniqueness == KeyUniqueness.UNIQUE
        if _masked and not unique:
            raise SchemaError("masked join binding requires a UNIQUE rhs")
        left_outer = self.join_type == JoinType.LEFT_OUTER
        from .filter import bind_predicates, compact_by_mask, keep_mask, \
            unwrap_filters
        lhs_inner, lhs_preds = unwrap_filters(self.lhs)
        lb = lhs_inner.bind(ctx)
        bound_preds = bind_predicates(lhs_preds, lb)
        rb = self.rhs.bind(ctx)
        lpairs = self.lhs_projector.resolve(lb.schema)
        rpairs = self.rhs_projector.resolve(rb.schema)
        lsrcs = list(dict.fromkeys(s for s, _ in lpairs))
        rsrcs = list(dict.fromkeys(s for s, _ in rpairs))
        attrs = []
        for src, dst in lpairs:
            a = lb.schema.lookup(src)
            attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
        for src, dst in rpairs:
            a = rb.schema.lookup(src)
            # LEFT_OUTER forces rhs outputs nullable (hash_join.cc:78-87)
            attrs.append(Attribute(dst, a.type, a.nullable or left_outer,
                                   a.enum))
        out_schema = TupleSchema(attrs)
        out_dicts = {dst: lb.dicts[src] for src, dst in lpairs
                     if src in lb.dicts}
        out_dicts.update({dst: rb.dicts[src] for src, dst in rpairs
                          if src in rb.dicts})
        lhs_keys, rhs_keys = self.lhs_keys, self.rhs_keys
        # key types: equal, or two integer types compared as int64; a
        # STRING/BINARY build key moves into the probe's dictionary
        promote, remaps = [], {}
        for lk, rk in zip(lhs_keys, rhs_keys):
            la, ra = lb.schema.lookup(lk), rb.schema.lookup(rk)
            if la.type != ra.type and not (la.type in _INT_TYPES
                                           and ra.type in _INT_TYPES):
                raise SchemaError(
                    f"join key type mismatch {la.type}/{ra.type}")
            promote.append(torch.int64 if la.type != ra.type else None)
            if la.type in _DICT_KEY_TYPES and lb.dicts[lk] is not rb.dicts[rk]:
                remaps[rk] = rb.dicts[rk].codes_in(lb.dicts[lk])
        # the dense key domain, per key (kmin, range, from statistics): the
        # probe dictionary's codes, the ENUM value map, or planner statistics
        dims = []
        for lk, rk in zip(lhs_keys, rhs_keys):
            la, ra = lb.schema.lookup(lk), rb.schema.lookup(rk)
            if la.type in _DICT_KEY_TYPES:
                dims.append((0, max(len(lb.dicts[lk]), 1), False))
            elif la.type == DataType.ENUM:
                dims.append((0, max(len(la.enum.names), len(ra.enum.names),
                                    1), False))
            elif la.type in _STAT_KEY_TYPES and rk in rb.stats:
                kmin, kmax = rb.stats[rk]
                dims.append((kmin, kmax - kmin + 1, True))
            else:  # FLOAT, DOUBLE, BOOL, or no statistics
                dims = None
                break
        # UNIQUE bounds the output by the lhs; NOT_UNIQUE has no static
        # bound and defaults to lhs + rhs (overflow raises at execute)
        if _masked or (unique and left_outer):
            out_cap = lb.capacity
        elif self.out_capacity:
            out_cap = self.out_capacity
        else:
            out_cap = lb.capacity + (0 if unique else rb.capacity)
        for nm in lb.schema.names():
            if nm.startswith("__r"):
                raise SchemaError("column names '__r*' are reserved")

        # row-id probe: UNIQUE, single integer or DATE/DATETIME rhs key that
        # is a dense ascending primary key
        rowid_kmin = None
        rowid_stats = rb.stats.get(rhs_keys[0])
        if (self.allow_dense_lookup and unique and len(rhs_keys) == 1
                and not remaps and rhs_keys[0] in rb.rowid
                and rowid_stats is not None
                and lb.schema.lookup(lhs_keys[0]).type in _STAT_KEY_TYPES
                and rb.schema.lookup(rhs_keys[0]).type in _STAT_KEY_TYPES):
            rowid_kmin = rowid_stats[0]

        # fat-LUT / CSR probe: the composite key domain
        rng = 1
        if rowid_kmin is None and self.allow_dense_lookup and dims:
            for _kmin, r, _s in dims:
                rng *= r
            budget = _DENSE_RANGE_MAX
            if any(s for *_, s in dims):
                # statistics may be sparse: bound by the build side
                budget = min(max(4 * rb.capacity, 1 << 20), budget)
            lanes = 1 + 2 * max(len(rpairs), 1)
            if rng > budget or (unique
                                and rng * lanes > 4 * _DENSE_RANGE_MAX):
                dims = None
        else:
            dims = None
        merge = rowid_kmin is None and dims is None
        if merge and lb.capacity + rb.capacity > I32_MAX:
            raise SchemaError("merge-probe join positions past int32: "
                              f"{lb.capacity} + {rb.capacity} rows")

        def fn(rctx: RunContext):
            lt = lb.run(rctx)
            rt = rb.run(rctx)
            lkeep = (keep_mask(bound_preds, rctx, lt) if bound_preds
                     else lt.row_mask())
            pinert = _any_null(lt, lhs_keys) | ~lkeep
            rcap = rt.capacity
            count = lower = build_perm = None
            if rowid_kmin is not None:
                rk_col = rt.columns[rhs_keys[0]]
                expect = torch.arange(rcap, device=rt.device) + rowid_kmin
                bad = rk_col.values.long() != expect
                if rk_col.valid is not None:
                    bad = bad | ~rk_col.valid
                rctx.error_flags.append((
                    "join rhs key is not the planned row-id sequence",
                    (rt.row_mask() & bad).any()))
                pv = lt.columns[lhs_keys[0]].values.long() - rowid_kmin
                matched = ~pinert & (pv >= 0) & (pv < rt.num_rows)
                pidx = pv.clamp(0, rcap - 1).to(torch.int32)
                rg = gather_table(_subset(rt, rsrcs), pidx, lt.num_rows)
                rfetch = {}
                for src in rsrcs:
                    c = rg.columns[src]
                    valid = c.valid
                    if left_outer:
                        valid = matched if valid is None else (valid & matched)
                    rfetch[src] = Column(c.values, valid)
            else:
                bcols = remap_codes(rt, remaps) if remaps else None
                bcodes = _key_codes(rt, rhs_keys, promote, bcols)
                pcodes = _key_codes(lt, lhs_keys, promote)
                binert = _any_null(rt, rhs_keys) | ~rt.row_mask()
                if dims is not None:
                    bidx, binr, bstat = _composite_slot(bcodes, dims)
                    if bstat is not None:
                        rctx.error_flags.append((
                            "join build keys exceed planned dense range",
                            (~binert & ~bstat).any()))
                    bslot = torch.where(~binert & binr, bidx, rng)
                    pidx, pinr, _ = _composite_slot(pcodes, dims)
                    pslot, pin = pidx.to(torch.int32), pinr & ~pinert
                    if unique:
                        rfetch, matched = _fat_lut_probe(
                            rt, rsrcs, bslot, pslot, pin, rng, left_outer)
                    else:
                        count, lower, build_perm = _csr_probe(
                            bslot, pslot, pin, rng)
                else:
                    count, lower, build_perm = _merge_probe(
                        bcodes, pcodes, ~binert, ~pinert)
                    if unique:
                        # the first build row of the key, in rhs order
                        matched = count > 0
                        rsorted = gather_table(_subset(rt, rsrcs),
                                               build_perm, rt.num_rows)
                        rg = gather_table(rsorted, lower, lt.num_rows)
                        rfetch = {}
                        for src in rsrcs:
                            c = rg.columns[src]
                            valid = c.valid
                            if left_outer:
                                valid = (matched if valid is None
                                         else valid & matched)
                            rfetch[src] = Column(c.values, valid)
            if not unique:
                lcols, rcols, n_out = _expand(
                    lt, lsrcs, rt, rsrcs, build_perm, lkeep, count, lower,
                    out_cap, left_outer, rctx)
                cols = {dst: lcols[src] for src, dst in lpairs}
                cols.update({dst: rcols[src] for src, dst in rpairs})
                return Table(out_schema, cols, n_out, lt.device, out_dicts,
                             cap_hint=out_cap)
            if _masked or (left_outer and not bound_preds):
                # lhs columns zero-copy at lhs capacity
                cols = {dst: lt.columns[src] for src, dst in lpairs}
                cols.update({dst: rfetch[src] for src, dst in rpairs})
                out = Table(out_schema, cols, lt.num_rows, lt.device,
                            out_dicts, cap_hint=lt.capacity)
                if _masked:
                    return out, (lkeep if left_outer else matched)
                return out
            # compacted output: INNER keeps the matches, LEFT_OUTER under a
            # fused Filter every kept row; lhs columns and fetched rhs
            # columns ride one compaction, whose count is read once and
            # whose prefix of survivors is the output
            emit = lkeep if left_outer else matched
            lsub = _subset(lt, lsrcs)
            aug_attrs, aug_cols, rname = [], dict(lsub.columns), {}
            for i, src in enumerate(rsrcs):
                nm = f"__r{i}"
                ra = rb.schema.lookup(src)
                c = rfetch[src]
                aug_attrs.append(Attribute(nm, ra.type, c.valid is not None,
                                           ra.enum))
                aug_cols[nm] = c
                rname[src] = nm
            aug = Table(lsub.schema.concat(TupleSchema(aug_attrs)), aug_cols,
                        lt.num_rows, lt.device, dict(lsub.dicts),
                        cap_hint=lt.capacity)
            if out_cap < lt.capacity:
                rctx.error_flags.append((
                    "join result overflow", emit.sum() > out_cap))
            moved = compact_by_mask(aug, emit, min(out_cap, lt.capacity))
            n = tracing.count_to_host(moved.num_rows, "join.num_rows",
                                      lt.capacity)
            live = max(n, 1)
            kept = {nm: Column(c.values[:live], None if c.valid is None
                               else c.valid[:live])
                    for nm, c in moved.columns.items()}
            cols = {dst: kept[src] for src, dst in lpairs}
            cols.update({dst: kept[rname[src]] for src, dst in rpairs})
            return Table(out_schema, cols, n, lt.device, out_dicts,
                         cap_hint=live)

        out_stats = {dst: lb.stats[src] for src, dst in lpairs
                     if src in lb.stats}
        out_stats.update({dst: rb.stats[src] for src, dst in rpairs
                          if src in rb.stats})
        route = ("rowid" if rowid_kmin is not None else "merge" if merge
                 else "fat_lut" if unique else "csr")
        return BoundOperation(out_schema, out_dicts, fn, out_cap,
                              stats=out_stats, route=route)

    def _bind_outer_rewrite(self, ctx: BindContext) -> BoundOperation:
        """RIGHT_OUTER and FULL_OUTER from the join forms above (the
        reference declares both but implements neither, hash_join.h:37).

        RIGHT_OUTER(l, r) is LEFT_OUTER(r, l) with the output columns put
        back in (lhs..., rhs...) order; its build side, the original lhs,
        has unknown key multiplicity, so it is NOT_UNIQUE.

        FULL_OUTER(l, r) is LEFT_OUTER(l, r) and then the rhs rows without
        a live lhs key match, NULL-padded on the lhs: those come from a
        UNIQUE LEFT_OUTER join of the rhs against the distinct lhs keys
        carrying a non-NULL marker, whose unmatched rows surface a NULL
        marker.  UnionAll puts the two together."""
        from ..exprs import Const, IsNull, Null, col
        from .aggregate import GroupAggregate
        from .compute import Compute
        from .filter import Filter
        from .project import Project
        from .union import UnionAll

        # schemas only: a scratch context keeps the plan's leaves as they are
        lsch = self.lhs.bind(BindContext()).schema
        rsch = self.rhs.bind(BindContext()).schema
        lpairs = self.lhs_projector.resolve(lsch)
        rpairs = self.rhs_projector.resolve(rsch)
        order = [dst for _, dst in lpairs] + [dst for _, dst in rpairs]
        if self.join_type == JoinType.RIGHT_OUTER:
            mirrored = HashJoin(
                JoinType.LEFT_OUTER, self.rhs_keys, self.lhs_keys,
                self.rhs, self.lhs, KeyUniqueness.NOT_UNIQUE,
                lhs_projector=self.rhs_projector,
                rhs_projector=self.lhs_projector,
                out_capacity=self.out_capacity,
                allow_dense_lookup=self.allow_dense_lookup)
            return Project(Projector.named(*order), mirrored).bind(ctx)
        marker = "__full_outer_m"
        if marker in rsch.names() or marker in lsch.names():
            raise SchemaError(f"column name {marker!r} is reserved")
        left_part = HashJoin(
            JoinType.LEFT_OUTER, self.lhs_keys, self.rhs_keys,
            self.lhs, self.rhs, self.uniqueness,
            lhs_projector=self.lhs_projector,
            rhs_projector=self.rhs_projector,
            out_capacity=self.out_capacity,
            allow_dense_lookup=self.allow_dense_lookup)
        distinct_keys = GroupAggregate(self.lhs_keys, [], self.lhs)
        build = Compute([col(k) for k in self.lhs_keys]
                        + [Const(True).as_(marker)], distinct_keys)
        marker_join = HashJoin(
            JoinType.LEFT_OUTER, self.rhs_keys, self.lhs_keys,
            self.rhs, build, KeyUniqueness.UNIQUE,
            lhs_projector=self.rhs_projector,
            rhs_projector=Projector.named(marker),
            allow_dense_lookup=self.allow_dense_lookup)
        anti = Filter(IsNull(col(marker)), marker_join)
        pad = [Null(lsch.lookup(src).type).as_(dst) for src, dst in lpairs]
        pad += [col(dst) for _, dst in rpairs]
        return UnionAll(left_part, Compute(pad, anti)).bind(ctx)

