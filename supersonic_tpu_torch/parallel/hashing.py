"""Device-side row hashing.

Port of ``supersonic_tpu/parallel/hashing.py``.  The values equal the JAX
package's bit for bit, so a plan that groups or sorts by a hash gives the
same rows in both packages.  The uint32 words ride in int32 lanes as their
bit patterns: sums and products wrap modulo 2^32 there as in uint32, and
each right shift is masked to the bits a logical shift keeps.  ``as_u32``
gives a word's value (0 .. 2^32 - 1) in an int64 lane.  The reference
hashes per type and combines as ``h = h * 29 + item`` with NULL as
0xdeadbabe (types_infrastructure.h:410-440); only a deterministic,
well-mixed hash is needed, not the reference's values.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
NULL_HASH = 0xDEADBABE - (1 << 32)  # 0xdeadbabe as int32 bits


def _i32(c: int) -> int:
    """A uint32 constant as its int32 bit pattern."""
    return c - (1 << 32) if c >= 1 << 31 else c


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words held as int32 bits -> their values in int64."""
    return x.to(torch.int64) & M32


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-held words."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of uint32 words held as int32 bits (the low 32 bits
    of a wider lane)."""
    x = x.to(torch.int32)
    x = x ^ _shr(x, 16)
    x = x * _i32(0x85EBCA6B)
    x = x ^ _shr(x, 13)
    x = x * _i32(0xC2B2AE35)
    return x ^ _shr(x, 16)


def _fold32(code: torch.Tensor) -> torch.Tensor:
    """A key code (integer or float) folded to a uint32 word (int32 bits),
    as the JAX package folds it: a float as the words of its f32 head and
    of the f32 residual of an f64 (head * 31 + residual); a 64-bit integer
    as its low word XOR its high word; anything narrower as its low
    word."""
    if code.is_floating_point():
        hi = code.to(torch.float32)
        if code.dtype == torch.float64:
            lo = (code - hi.to(torch.float64)).to(torch.float32)
        else:
            lo = torch.zeros_like(hi)
        return hi.view(torch.int32) * 31 + lo.view(torch.int32)
    if code.dtype == torch.int64:
        return (code ^ (code >> 32)).to(torch.int32)
    return code.to(torch.int32)


def combine_hash(codes: list[torch.Tensor],
                 null_ranks: list | None = None) -> torch.Tensor:
    """uint32 row hash (int32 bits) over several key-code columns,
    NULL-aware: ``null_ranks`` entries may be None for non-nullable
    columns; a NULL (rank 0) contributes 0xdeadbabe."""
    h = torch.zeros(codes[0].shape[0], dtype=torch.int32,
                    device=codes[0].device)
    for i, c in enumerate(codes):
        term = _mix32(_fold32(c))
        if null_ranks is not None and null_ranks[i] is not None:
            term = torch.where(null_ranks[i] == 0,
                               torch.full_like(term, NULL_HASH), term)
        h = h * 29 + term
    return _mix32(h)


def hash_of_pairs(pairs) -> torch.Tensor:
    """Row hash from ``ops.keys.group_code_columns``' (null_rank or None,
    code) pairs."""
    return combine_hash([c for _, c in pairs], [nr for nr, _ in pairs])


def partition_of(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """The partition (int32) of each row hash: its uint32 value modulo
    ``num_partitions``, as the JAX package computes it."""
    return (as_u32(h) % num_partitions).to(torch.int32)
