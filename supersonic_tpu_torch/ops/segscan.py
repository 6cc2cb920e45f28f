"""Segmented prefix scans: inclusive scans that restart where ``reset``
is True (the first row always starts a segment).

Port of ``supersonic_tpu/ops/segscan.py``.  ``seg_cummin`` and
``seg_cummax`` (and a floating ``seg_cumsum``) are the JAX package's
two-level blocked Hillis-Steele scan: log2(TILE) shift-and-combine passes
within tiles of a [B, TILE] view, the same scan over the B tile carries,
and one combine of each tile with its exclusive carry, all plain PyTorch
over the whole column.  ``torch.cummax``/``cummin`` are not used: they scan
in one thread block on CUDA.  The segmented combine is the standard one,

    value[i] = r[i] ? value[i] : op(value[i - d], value[i])
    r[i]     = r[i] | r[i - d]

associative for op in {+, min, max}.

``seg_carry_first`` and an integer ``seg_cumsum`` need no scan of their
own: each segment's first row comes from one stable compaction of the
starts (the compaction kernel) read back at the row's segment number (one
``lut_gather``), and an integer sum is the running ``torch.cumsum`` less
its value before the segment's first row, exact modulo 2^64.
"""
from __future__ import annotations

import torch

TILE = 256


def _op(mode: str, a, b):
    if mode == "sum":
        return a + b
    if mode == "min":
        return torch.minimum(a, b)
    if mode == "max":
        return torch.maximum(a, b)
    raise ValueError(mode)


def _identity(mode: str, dtype):
    if mode == "sum":
        return 0
    if dtype == torch.bool:
        return mode == "min"
    if dtype.is_floating_point:
        return float("inf") if mode == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if mode == "min" else info.min


def _scan_rows(v: torch.Tensor, r: torch.Tensor, mode: str) -> None:
    """In place: the segmented scan along the last axis of [B, T] ``v``
    with reset flags ``r`` (Hillis-Steele; positions before the shift keep
    their value, as under an identity pad)."""
    T = v.shape[-1]
    d = 1
    while d < T:
        nv = torch.where(r[..., d:], v[..., d:],
                         _op(mode, v[..., :-d], v[..., d:]))
        nr = r[..., d:] | r[..., :-d]
        v[..., d:] = nv
        r[..., d:] = nr
        d *= 2


def _seg_scan(vals: torch.Tensor, reset: torch.Tensor,
              mode: str) -> torch.Tensor:
    n = vals.shape[0]
    if n == 0:
        return vals.clone()
    ident = _identity(mode, vals.dtype)
    T = min(TILE, n)
    n_pad = -(-n // T) * T
    v = torch.full((n_pad,), ident, dtype=vals.dtype, device=vals.device)
    r = torch.ones(n_pad, dtype=torch.bool, device=vals.device)
    v[:n] = vals
    r[:n] = reset
    r[0] = True
    v = v.view(-1, T)
    r = r.view(-1, T)
    _scan_rows(v, r, mode)
    # the scan over the tile carries (B elements), then each tile's
    # exclusive carry (tile 0 takes the identity)
    cv, cr = v[:, -1].clone(), r[:, -1].clone()
    _scan_rows(cv, cr, mode)
    carry = torch.cat([torch.full((1,), ident, dtype=vals.dtype,
                                  device=vals.device), cv[:-1]])
    out = torch.where(r, v, _op(mode, carry[:, None], v))
    return out.reshape(n_pad)[:n]


def _segment_starts(reset: torch.Tensor):
    """(int32 segment number of each row, the rows' segment-start mask)."""
    starts = reset.clone()
    if starts.shape[0]:
        starts[0] = True
    return (torch.cumsum(starts, 0, dtype=torch.int32) - 1), starts


def seg_carry_first(vals: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Each segment's first value, carried to every row of the segment."""
    from ..batch import gather_arrays
    from ..kernels.compaction import compact_kernel

    n = vals.shape[0]
    if n == 0:
        return vals.clone()
    seg, starts = _segment_starts(reset)
    firsts, _ = compact_kernel([vals], starts, n)
    return gather_arrays(firsts, seg)[0]


def seg_cumsum(vals: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented cumsum in ``vals``' dtype (integers wrap)."""
    if vals.dtype.is_floating_point:
        return _seg_scan(vals, reset, "sum")
    total = torch.cumsum(vals, 0, dtype=torch.int64)
    before = seg_carry_first(total - vals.to(torch.int64), reset)
    return (total - before).to(vals.dtype)


def seg_cummin(vals: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    return _seg_scan(vals, reset, "min")


def seg_cummax(vals: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    return _seg_scan(vals, reset, "max")
