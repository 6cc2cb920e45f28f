"""Hash join: INNER and LEFT_OUTER, UNIQUE or NOT_UNIQUE rhs, over dense
integer keys.

Port of the dense part of ``supersonic_tpu/ops/hash_join.py`` (reference:
cursor/core/hash_join.cc; NULL keys never match, hash_join.cc:67-76;
LEFT_OUTER emits a NULL rhs row for each unmatched lhs row and forces the
rhs outputs nullable, hash_join.cc:78-87, 801-806).  The probe is chosen at
bind from planner statistics and guarded at run time by an error flag:

  * row-id probe (UNIQUE): the rhs key IS the row position plus a constant
    (a dense ascending primary key, rowid_merge_join.h:24-40).  The probe
    reads the projected rhs columns at (probe key - min) with one
    ``lut_gather`` launch; there is no index at all.
  * fat-LUT probe (UNIQUE): one winning rhs row per key slot (the last,
    found by a scatter-max of row positions) is gathered into a table of
    each projected rhs column (and its validity, and a match flag) indexed
    by key slot, and the probe reads every lane with one ``lut_gather``
    launch.
  * CSR probe (NOT_UNIQUE): a stable sort of the rhs rows by key slot gives
    ``build_perm`` (equal keys keep the rhs order, the reference's
    match-list order), a search of the sorted slots gives each slot's start
    and count, and the probe reads (count, start) with one two-lane
    ``lut_gather`` launch.
  The JAX package built the LUT and the CSR with marker sorts because TPU
  scatters are slow; a scatter and a sort are the direct ways on the card.

A UNIQUE join emits at most one row per lhs row.  Under GroupAggregate and
Sort it binds MASKED: its output stays at lhs capacity with a keep mask
(the matches for INNER, every kept lhs row for LEFT_OUTER).  Unmasked, a
LEFT_OUTER join without a fused Filter is zero-copy at lhs capacity, and
otherwise the emitted rows move through the compaction kernel.

A NOT_UNIQUE join emits ``count`` rows per kept lhs row (at least one for
LEFT_OUTER) at int64 offsets, raising "join result overflow" past its
capacity.  The compaction kernel packs the lhs rows that emit, the spread
kernel expands their lanes to the output rows, and the rhs columns are
gathered from the build-sorted rhs.  The JAX package's dup-packed and
merge spread-fill routes are TPU gather workarounds and are not carried.

RIGHT_OUTER and FULL_OUTER, the merge probe for keys without dense
statistics, and non-integer keys raise ``NotImplementedError`` (ROADMAP.md
queue 1 item 11).
"""
from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch

from ..batch import Column, Table, gather_table
from ..kernels import MAX_ARRAYS
from ..kernels.lut_gather import lut_gather
from ..kernels.spread import I32_MAX, spread_kernel
from ..schema import Attribute, SchemaError, TupleSchema
from ..types import DataType
from .base import BindContext, BoundOperation, Operation, RunContext, not_ported
from .project import Projector


class JoinType(enum.Enum):
    """reference: proto/supersonic.proto:77-83."""

    INNER = "INNER"
    LEFT_OUTER = "LEFT_OUTER"
    RIGHT_OUTER = "RIGHT_OUTER"
    FULL_OUTER = "FULL_OUTER"


class KeyUniqueness(enum.Enum):
    UNIQUE = "UNIQUE"
    NOT_UNIQUE = "NOT_UNIQUE"


_DENSE_KEY_TYPES = (DataType.INT32, DataType.INT64)
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


def _composite_slot(table: Table, key_names, dims):
    """int64 composite slot + in-range mask; the per-dimension clip keeps
    the slot in [0, prod(ranges)) for out-of-range values."""
    idx, inr = None, None
    for name, (kmin, rng_i) in zip(key_names, dims):
        v = table.columns[name].values.long() - kmin
        ok = (v >= 0) & (v < rng_i)
        dc = v.clamp(0, rng_i - 1)
        idx = dc if idx is None else idx * rng_i + dc
        inr = ok if inr is None else (inr & ok)
    return idx, inr


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


def _expand(lt: Table, lsrcs, rt: Table, rsrcs, build_perm, lkeep, count,
            lower, out_cap: int, left_outer: bool, rctx: RunContext):
    """Multi-match expansion: ({src: Column} of the lhs sources and of the
    rhs sources at ``out_cap`` rows, row count).  Each kept lhs row emits
    ``count`` rows, or one NULL-rhs row when LEFT_OUTER finds no match."""
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
    from ..kernels.compaction import compact_kernel
    packed, n_src = compact_kernel(lanes + [base], eff > 0, lcap)
    # dead sources start past every row, so the live count stays on device
    base_c = torch.where(torch.arange(lcap, device=dev) < n_src, packed[-1],
                         I32_MAX)
    spread = iter(spread_kernel(packed[:-1], base_c, out_cap,
                                add_row=(d_lane,)))
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
        # (Table, keep mask) without compacting; GroupAggregate and Sort
        # fold the mask into their own keep mask (the same fusion as
        # unwrap_filters)
        if self.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            not_ported(f"{self.join_type.value} join", "11")
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
        for lk, rk in zip(lhs_keys, rhs_keys):
            la, ra = lb.schema.lookup(lk), rb.schema.lookup(rk)
            if (la.type not in _DENSE_KEY_TYPES
                    or ra.type not in _DENSE_KEY_TYPES):
                not_ported(f"join on {la.type.value}/{ra.type.value} keys",
                           "11")
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
        if not unique:
            # one compaction moves the lhs lanes, d, LEFT_OUTER's count and
            # the starts
            lanes = sum(1 + lb.schema.lookup(s).nullable for s in lsrcs)
            if lanes + 2 + left_outer > MAX_ARRAYS:
                not_ported(f"NOT_UNIQUE join expanding {lanes} lhs lanes",
                           "11")

        # row-id probe: UNIQUE, single rhs key that is a dense ascending
        # primary key
        rowid_kmin = None
        rowid_stats = rb.stats.get(rhs_keys[0])
        if (self.allow_dense_lookup and unique and len(rhs_keys) == 1
                and rhs_keys[0] in rb.rowid and rowid_stats is not None):
            rowid_kmin = rowid_stats[0]

        # fat-LUT / CSR probe: composite key range from planner statistics
        dims = None
        if rowid_kmin is None and self.allow_dense_lookup:
            dims, total = [], 1
            for rk in rhs_keys:
                st = rb.stats.get(rk)
                if st is None:
                    dims = None
                    break
                dims.append((st[0], st[1] - st[0] + 1))
                total *= dims[-1][1]
            budget = min(max(4 * rb.capacity, 1 << 20), _DENSE_RANGE_MAX)
            lanes = 1 + 2 * max(len(rpairs), 1)
            if dims is not None and (
                    total > budget
                    or (unique and total * lanes > 4 * _DENSE_RANGE_MAX)):
                dims = None
        if rowid_kmin is None and dims is None:
            not_ported("join without dense key statistics (merge probe)", "7")
        rng = 1
        for _kmin, r in dims or ():
            rng *= r

        def fn(rctx: RunContext):
            lt = lb.run(rctx)
            rt = rb.run(rctx)
            lkeep = (keep_mask(bound_preds, rctx, lt) if bound_preds
                     else lt.row_mask())
            pinert = _any_null(lt, lhs_keys) | ~lkeep
            rcap = rt.capacity
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
                bidx, binr = _composite_slot(rt, rhs_keys, dims)
                binert = _any_null(rt, rhs_keys) | ~rt.row_mask()
                rctx.error_flags.append((
                    "join build keys exceed planned dense range",
                    (~binert & ~binr).any()))
                bslot = torch.where(~binert & binr, bidx, rng)
                pidx, pinr = _composite_slot(lt, lhs_keys, dims)
                pslot, pin = pidx.to(torch.int32), pinr & ~pinert
                if not unique:
                    count, lower, build_perm = _csr_probe(bslot, pslot, pin,
                                                          rng)
                    lcols, rcols, n_out = _expand(
                        lt, lsrcs, rt, rsrcs, build_perm, lkeep, count, lower,
                        out_cap, left_outer, rctx)
                    cols = {dst: lcols[src] for src, dst in lpairs}
                    cols.update({dst: rcols[src] for src, dst in rpairs})
                    return Table(out_schema, cols, n_out, lt.device,
                                 out_dicts, cap_hint=out_cap)
                rfetch, matched = _fat_lut_probe(rt, rsrcs, bslot, pslot, pin,
                                                 rng, left_outer)
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
            # columns ride one compaction
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
            moved = compact_by_mask(aug, emit, out_cap)
            cols = {dst: moved.columns[src] for src, dst in lpairs}
            cols.update({dst: moved.columns[rname[src]]
                         for src, dst in rpairs})
            return Table(out_schema, cols, moved.num_rows, lt.device,
                         out_dicts, cap_hint=out_cap)

        out_stats = {dst: lb.stats[src] for src, dst in lpairs
                     if src in lb.stats}
        out_stats.update({dst: rb.stats[src] for src, dst in rpairs
                          if src in rb.stats})
        return BoundOperation(out_schema, out_dicts, fn, out_cap,
                              stats=out_stats)
