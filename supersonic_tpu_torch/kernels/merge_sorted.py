"""Merge of two sorted streams (kernel: ``csrc/merge_sorted.cu``).

Port of ``supersonic_tpu/kernels/merge_sorted.py::merge_sorted`` with its
``merge_path_splits``, the building block of MergeUnionAll.  Each side is a
list of lanes (columns and validity masks, 1-D, 1, 2, 4 or 8 bytes a row,
the same dtypes on both sides).  Side A has ``cap_a`` rows of which the
first ``a_rows`` are live, B ``cap_b`` rows of which ``b_rows`` are live; the
counts may be python ints or 0-d device tensors, so a plan never waits for
the device to learn them.  The key tuple is a list of ``MergeKey``s, most
significant first: the lane that holds the key (int32, int64, float32,
float64, bool, or a STRING/BINARY int32 code), ASC or DESC, and the bool
validity lane of a nullable key.  The kernel codes the keys from the raw
lanes itself, as ``key_words`` does for the plain version: a
nullable key compares a null rank first (NULL first ascending, last
descending) and its code zeroed under NULL; DESC integers are bit-inverted;
floats are negated for DESC, then NaN becomes +qNaN and -0.0 becomes +0.0
(so NaNs sort last and tie, and the zeros tie, as in ``lax.sort``).  Live
rows of each side must be sorted by the key tuple.  The output holds, at
``out_cap <= cap_a + cap_b`` rows, every lane merged: the live rows in
(key tuple, side, position) order, so equal key tuples put all of A before
all of B, then A's dead rows, then B's, each in position order.  Dead rows'
keys are never read, so they may hold anything.

The TPU kernel took at most 8 int32 key and 4-byte payload arrays per side,
coded beforehand, and a pad-rank key lane for the live counts; this one
takes up to 16 compare words (a key is one, a nullable key two) and any
number of lanes of 1, 2, 4 or 8 bytes, with the live counts as device
scalars: a splits launch, then a merge launch for each group of up to 32
lanes against the same splits (the merge is deterministic, so every group
takes the same rows).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tracing
from . import (MAX_ARRAYS, addr_array, check, check_cuda_inputs, int_array,
               launches, library, ptr_array, stream_of)

MAX_KEYS = 16  # compare words: a key is one, a nullable key two

# key lane dtype -> the kernel's word kind (csrc/merge_sorted.cu, WordKind)
_KIND = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3,
         torch.bool: 4}
_RANK = 5

# float dtype -> (same-width int dtype, bits of +qNaN, all bits but the sign)
_FLOAT_BITS = {
    torch.float32: (torch.int32, 0x7FC00000, 0x7FFFFFFF),
    torch.float64: (torch.int64, 0x7FF8000000000000, 0x7FFFFFFFFFFFFFFF),
}


class MergeKey(NamedTuple):
    """One key of the merge order: ``lane`` indexes each side's lanes;
    ``valid`` indexes the bool validity lane of a nullable key (None: the
    key has no NULLs)."""

    lane: int
    ascending: bool = True
    valid: Optional[int] = None


def compare_words(keys) -> int:
    """Compare words of a key tuple: one a key, two a nullable key."""
    return sum(1 + (k.valid is not None) for k in keys)


def sortable_words(op: torch.Tensor) -> torch.Tensor:
    """A key operand as one signed integer lane of the same order: int32
    and int64 stay, BOOL becomes int32, and f32/f64 become their signed
    total-order bits in int32/int64 after every NaN becomes +qNaN and -0.0
    becomes +0.0.  So NaNs sort last and equal each other and the zeros tie,
    as in ``lax.sort`` and ``torch.sort``, on either device; run it after
    the DESC negation, which flips the sign of NaNs and zeros."""
    if op.dtype == torch.bool:
        return op.to(torch.int32)
    if not op.is_floating_point():
        return op
    idt, qnan, magnitude = _FLOAT_BITS[op.dtype]
    bits = torch.where(op.isnan(), qnan,
                       torch.where(op == 0, 0, op.view(idt)))
    # negatives: flip all but the sign bit, so larger magnitudes rank lower
    return torch.where(bits >= 0, bits, bits ^ magnitude)


def key_words(values: torch.Tensor, valid, ascending: bool) -> list:
    """One key's compare words, [null rank?, code], as signed integer lanes:
    the merge kernel's order, from the raw values (int32, int64, float32,
    float64, bool or a STRING/BINARY code) and the bool validity (None: no
    NULLs).  The null rank is ``valid`` ascending and ``~valid`` descending
    (NULL first ascending, last descending); the code is bit-inverted for a
    DESC integer and negated for a DESC float, zeroed under NULL, then made
    ``sortable_words``, so -0.0 is canonicalized once, after the negation.
    The counterpart of ``_sortable_i32`` of ``supersonic_tpu/ops/merge.py``."""
    code = values.to(torch.int32) if values.dtype == torch.bool else values
    if not ascending:
        code = -code if code.is_floating_point() else ~code
    words = []
    if valid is not None:
        words.append((valid if ascending else ~valid).to(torch.int32))
        code = torch.where(valid, code, torch.zeros_like(code))
    return words + [sortable_words(code)]


def _live(rows, cap: int, device) -> torch.Tensor:
    """bool[cap]: True for the first ``rows`` positions."""
    return torch.arange(cap, device=device) < rows


def merge_lanes_ref(a_keys, a_pays, b_keys, b_pays, out_cap: int,
                    a_rows=None, b_rows=None):
    """Merge by coded key lanes (signed integers, most significant first):
    a stable lexicographic sort of the concatenation A‖B, one stable
    ``torch.sort`` pass per key lane from the least significant, then live
    rows first.  Dead rows' keys are zeroed first, so they keep their
    position order.  Returns (merged key lanes, merged payloads)."""
    cap_a, cap_b = a_keys[0].shape[0], b_keys[0].shape[0]
    dev = a_keys[0].device
    live = torch.cat([_live(cap_a if a_rows is None else a_rows, cap_a, dev),
                      _live(cap_b if b_rows is None else b_rows, cap_b, dev)])
    perm = torch.arange(cap_a + cap_b, device=dev)
    for ka, kb in reversed(list(zip(a_keys, b_keys))):
        k = torch.where(live, torch.cat([ka, kb]), 0)
        perm = perm[torch.sort(k[perm], stable=True).indices]
    perm = perm[torch.sort((~live[perm]).to(torch.int32), stable=True).indices]
    perm = perm[:out_cap]
    return ([torch.cat([a, b])[perm] for a, b in zip(a_keys, b_keys)],
            [torch.cat([a, b])[perm] for a, b in zip(a_pays, b_pays)])


def coded_words(lanes, keys) -> list:
    """The compare words of a key tuple over one side's lanes, as signed
    integer lanes (``key_words`` of each key, most significant first)."""
    words = []
    for k in keys:
        words += key_words(lanes[k.lane],
                           None if k.valid is None else lanes[k.valid],
                           k.ascending)
    return words


def merge_sorted_ref(a_lanes, b_lanes, keys, out_cap: int, a_rows=None,
                     b_rows=None):
    """Plain PyTorch version of ``merge_sorted``: the keys coded into
    signed integer lanes by ``key_words``, then ``merge_lanes_ref``."""
    return merge_lanes_ref(coded_words(a_lanes, keys), a_lanes,
                           coded_words(b_lanes, keys), b_lanes, out_cap,
                           a_rows, b_rows)[1]


def _check(a_lanes, b_lanes, keys, out_cap: int) -> None:
    if not a_lanes or len(b_lanes) != len(a_lanes):
        raise ValueError("merge_sorted: the same lanes on both sides")
    if not keys or compare_words(keys) > MAX_KEYS:
        raise ValueError(f"merge_sorted: 1 to {MAX_KEYS} compare words (a "
                         "nullable key counts two)")
    cap_a, cap_b = a_lanes[0].shape[0], b_lanes[0].shape[0]
    if not 0 <= out_cap <= cap_a + cap_b:
        raise ValueError("merge_sorted: out_cap must be in [0, cap_a + cap_b]")
    for lanes, cap in ((a_lanes, cap_a), (b_lanes, cap_b)):
        for t in lanes:
            if t.dim() != 1 or t.shape[0] != cap:
                raise ValueError("merge_sorted: the lanes of a side must be "
                                 "1-D and equally long")
    for pa, pb in zip(a_lanes, b_lanes):
        if pa.dtype != pb.dtype or pa.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"merge_sorted: unsupported lane dtypes "
                             f"{pa.dtype}, {pb.dtype}")
    n = len(a_lanes)
    for k in keys:
        if not 0 <= k.lane < n or a_lanes[k.lane].dtype not in _KIND:
            raise ValueError("merge_sorted: a key lane must be int32, int64, "
                             "float32, float64 or bool")
        if k.valid is not None and (not 0 <= k.valid < n or
                                    a_lanes[k.valid].dtype != torch.bool):
            raise ValueError("merge_sorted: a validity lane must be bool")


def _rows_scalar(rows, cap: int, device) -> torch.Tensor:
    """The live count as a 0-d int64 tensor on ``device``, without a host
    sync."""
    if rows is None:
        rows = cap
    if isinstance(rows, torch.Tensor):
        if rows.device != device:
            raise ValueError(f"merge_sorted: live count on {rows.device}, "
                             f"expected {device}")
        return rows.reshape(()).to(torch.int64)
    return torch.full((), int(rows), dtype=torch.int64, device=device)


def _key_args(a_lanes, b_lanes, keys) -> tuple:
    """The kernel's compare words: (count, kinds, descs, A value lanes,
    B value lanes, A validity lanes, B validity lanes), as C arrays."""
    kind, desc, av, bv, aok, bok = [], [], [], [], [], []
    for k in keys:
        d = 0 if k.ascending else 1
        if k.valid is not None:  # null rank first, read from the validity
            kind.append(_RANK)
            desc.append(d)
            av.append(a_lanes[k.valid].data_ptr())
            bv.append(b_lanes[k.valid].data_ptr())
            aok.append(0)
            bok.append(0)
        kind.append(_KIND[a_lanes[k.lane].dtype])
        desc.append(d)
        av.append(a_lanes[k.lane].data_ptr())
        bv.append(b_lanes[k.lane].data_ptr())
        aok.append(0 if k.valid is None else a_lanes[k.valid].data_ptr())
        bok.append(0 if k.valid is None else b_lanes[k.valid].data_ptr())
    return (len(kind), int_array(kind), int_array(desc), addr_array(av),
            addr_array(bv), addr_array(aok), addr_array(bok))


def tile_rows(a_lanes, keys) -> int:
    """Output rows of one merge tile for this key tuple."""
    words = _key_args(a_lanes, a_lanes, keys)
    return library().ss_merge_tile_rows(words[0], words[1])


def merge_sorted(a_lanes, b_lanes, keys, out_cap: int, a_rows=None,
                 b_rows=None):
    """Merge two sorted streams; see the module docstring.  Returns every
    lane merged, ``out_cap`` rows long.  CPU tensors take
    ``merge_sorted_ref``; CUDA tensors launch the kernel, without a host
    sync."""
    _check(a_lanes, b_lanes, keys, out_cap)
    dev = a_lanes[0].device
    if dev.type == "cpu":
        return merge_sorted_ref(a_lanes, b_lanes, keys, out_cap, a_rows,
                                b_rows)
    if dev.type != "cuda":
        raise ValueError(f"merge_sorted: unsupported device {dev}")
    check_cuda_inputs("merge_sorted", dev, list(a_lanes) + list(b_lanes))
    with tracing.span("kernel.merge_sorted"):
        return _launch(a_lanes, b_lanes, keys, out_cap, a_rows, b_rows)


def _launch(a_lanes, b_lanes, keys, out_cap: int, a_rows, b_rows):
    """``merge_sorted``'s outputs, marshalling and launches on CUDA."""
    dev = a_lanes[0].device
    cap_a, cap_b = a_lanes[0].shape[0], b_lanes[0].shape[0]
    outs = [torch.empty(out_cap, dtype=p.dtype, device=dev) for p in a_lanes]
    if out_cap == 0:
        return outs
    lib = library()
    na = _rows_scalar(a_rows, cap_a, dev)
    nb = _rows_scalar(b_rows, cap_b, dev)
    words = _key_args(a_lanes, b_lanes, keys)
    tile = lib.ss_merge_tile_rows(words[0], words[1])
    splits = torch.empty(-(-out_cap // tile) + 1, dtype=torch.int64,
                         device=dev)
    # the C side launches on the current device
    with torch.cuda.device(dev):
        stream = stream_of(a_lanes[0])
        check(lib.ss_merge_splits(
            *words, na.data_ptr(), nb.data_ptr(), cap_a, cap_b, out_cap,
            splits.data_ptr(), stream), "merge_sorted splits")
        launches["merge_sorted"] += 1
        # lane groups of at most MAX_ARRAYS, each merged against the splits
        for i in range(0, len(a_lanes), MAX_ARRAYS):
            grp = slice(i, i + MAX_ARRAYS)
            ap, bp, op = a_lanes[grp], b_lanes[grp], outs[grp]
            check(lib.ss_merge_sorted(
                *words, len(ap), ptr_array(ap), ptr_array(bp), ptr_array(op),
                int_array([p.element_size() for p in ap]), na.data_ptr(),
                nb.data_ptr(), out_cap, splits.data_ptr(), stream),
                "merge_sorted merge")
            launches["merge_sorted"] += 1
    return outs
