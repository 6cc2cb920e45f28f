"""Hash join: INNER with a UNIQUE rhs over dense integer keys.

Port of the dense part of ``supersonic_tpu/ops/hash_join.py`` (reference:
cursor/core/hash_join.cc; NULL keys never match, hash_join.cc:67-76).  Two
probes, both chosen at bind from planner statistics and guarded at run
time by an error flag:

  * row-id probe: the rhs key IS the row position plus a constant (a dense
    ascending primary key, rowid_merge_join.h:24-40).  The probe reads the
    projected rhs columns at (probe key - min) with one ``lut_gather``
    launch; there is no index at all.
  * fat-LUT probe: the composite key range is small.  Each projected rhs
    column (and its validity, and a match flag) is scattered into a table
    indexed by key slot, and the probe reads every lane with one
    ``lut_gather`` launch.  The JAX package built these tables with a sort
    because TPU scatters are slow; a scatter is the direct way on the card.

Under GroupAggregate and Sort the join binds MASKED: its output stays at
lhs capacity with a keep mask, and nothing is compacted.  Unmasked, the
matched rows move through the compaction kernel.  Outer and NOT_UNIQUE
joins, and the merge probe for keys without dense statistics, raise
``NotImplementedError`` (ROADMAP.md queue 1 items 7 and 11).
"""
from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch

from ..batch import Column, Table, gather_table
from ..kernels.lut_gather import lut_gather
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
_DENSE_RANGE_MAX = 1 << 24  # slots of a fat LUT (as the JAX package)


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


def _fat_lut_probe(rt: Table, srcs, scat: torch.Tensor, pslot: torch.Tensor,
                   pin: torch.Tensor, rng: int):
    """Dense UNIQUE probe through a fat LUT.  ``scat``: int64 slot of each
    rhs row (``rng`` for dead rows, a dump slot no probe reads); ``pslot``:
    int32 slot of each probe row, in [0, rng); ``pin``: probe rows that may
    match.  Returns ({src: Column at probe capacity}, matched)."""
    dev = rt.device
    lanes, tags = [], []
    for src in dict.fromkeys(srcs):
        col = rt.columns[src]
        lut = torch.zeros(rng + 1, dtype=col.values.dtype, device=dev)
        lut[scat] = col.values
        lanes.append(lut)
        tags.append(("val", src))
        if col.valid is not None:
            vlut = torch.zeros(rng + 1, dtype=torch.bool, device=dev)
            vlut[scat] = col.valid
            lanes.append(vlut)
            tags.append(("valid", src))
    flag = torch.zeros(rng + 1, dtype=torch.bool, device=dev)
    flag[scat] = True
    lanes.append(flag)
    gathered = lut_gather(lanes, pslot, rng)  # one launch, every lane
    got = dict(zip(tags, gathered))
    matched = pin & gathered[-1]
    out = {}
    for src in dict.fromkeys(srcs):
        out[src] = Column(got[("val", src)], got.get(("valid", src)))
    return out, matched


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
        # _masked: produce the output at lhs capacity as (Table, keep mask)
        # without compacting; GroupAggregate and Sort fold the mask into
        # their own keep mask (the same fusion as unwrap_filters)
        if self.join_type != JoinType.INNER:
            not_ported(f"{self.join_type.value} join", "11")
        if self.uniqueness != KeyUniqueness.UNIQUE:
            not_ported("NOT_UNIQUE join", "11")
        from .filter import bind_predicates, compact_by_mask, keep_mask, \
            unwrap_filters
        lhs_inner, lhs_preds = unwrap_filters(self.lhs)
        lb = lhs_inner.bind(ctx)
        bound_preds = bind_predicates(lhs_preds, lb)
        rb = self.rhs.bind(ctx)
        lpairs = self.lhs_projector.resolve(lb.schema)
        rpairs = self.rhs_projector.resolve(rb.schema)
        rsrcs = list(dict.fromkeys(s for s, _ in rpairs))
        attrs = []
        for src, dst in lpairs:
            a = lb.schema.lookup(src)
            attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
        for src, dst in rpairs:
            a = rb.schema.lookup(src)
            attrs.append(Attribute(dst, a.type, a.nullable, a.enum))
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
        out_cap = lb.capacity if _masked else (self.out_capacity
                                               or lb.capacity)
        for nm in lb.schema.names():
            if nm.startswith("__r"):
                raise SchemaError("column names '__r*' are reserved")

        # row-id probe: single rhs key that is a dense ascending primary key
        rowid_kmin = None
        rowid_stats = rb.stats.get(rhs_keys[0])
        if (self.allow_dense_lookup and len(rhs_keys) == 1
                and rhs_keys[0] in rb.rowid and rowid_stats is not None):
            rowid_kmin = rowid_stats[0]

        # fat-LUT probe: composite key range from planner statistics
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
            lanes = 1 + 2 * max(len(rpairs), 1)
            budget = min(max(4 * rb.capacity, 1 << 20), _DENSE_RANGE_MAX)
            if dims is not None and (total > budget
                                     or total * lanes > 4 * _DENSE_RANGE_MAX):
                dims = None
        if rowid_kmin is None and dims is None:
            not_ported("join without dense key statistics (merge probe)", "7")

        def composite_slot(table: Table, key_names):
            """int64 composite slot + in-range mask; the per-dimension clip
            keeps the slot in [0, total) for out-of-range values."""
            idx, inr = None, None
            for name, (kmin, rng_i) in zip(key_names, dims):
                v = table.columns[name].values.long() - kmin
                ok = (v >= 0) & (v < rng_i)
                dc = v.clamp(0, rng_i - 1)
                idx = dc if idx is None else idx * rng_i + dc
                inr = ok if inr is None else (inr & ok)
            return idx, inr

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
                rfetch = {src: rg.columns[src] for src in rsrcs}
            else:
                rng = 1
                for _kmin, r in dims:
                    rng *= r
                bidx, binr = composite_slot(rt, rhs_keys)
                binert = _any_null(rt, rhs_keys) | ~rt.row_mask()
                rctx.error_flags.append((
                    "join build keys exceed planned dense range",
                    (~binert & ~binr).any()))
                scat = torch.where(~binert & binr, bidx, rng)
                pidx, pinr = composite_slot(lt, lhs_keys)
                rfetch, matched = _fat_lut_probe(
                    rt, rsrcs, scat, pidx.to(torch.int32), pinr & ~pinert,
                    rng)
            if _masked:
                cols = {dst: lt.columns[src] for src, dst in lpairs}
                cols.update({dst: rfetch[src] for src, dst in rpairs})
                return Table(out_schema, cols, lt.num_rows, lt.device,
                             out_dicts, cap_hint=lt.capacity), matched
            # compacted output: lhs columns and fetched rhs columns ride
            # one compaction
            lsub = _subset(lt, [s for s, _ in lpairs])
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
                    "join result overflow", matched.sum() > out_cap))
            moved = compact_by_mask(aug, matched, out_cap)
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
