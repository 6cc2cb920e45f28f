"""Merge of two sorted streams (kernel: ``csrc/merge_sorted.cu``).

Port of ``supersonic_tpu/kernels/merge_sorted.py::merge_sorted`` with its
``merge_path_splits``, the building block of MergeUnionAll.  Each side has
key lanes (signed int32 or int64, most significant first) and payload lanes
of 1, 2, 4 or 8 bytes.  Side A has ``cap_a`` rows of which the first
``a_rows`` are live, B ``cap_b`` rows of which ``b_rows`` are live; the
counts may be python ints or 0-d device tensors, so a plan never waits for
the device to learn them.  Live rows of each side must be sorted by the key
tuple.  The output holds, at ``out_cap <= cap_a + cap_b`` rows, the live
rows in (key tuple, side, position) order, so equal key tuples put all of A
before all of B, then A's dead rows, then B's, each in position order.
Dead rows' keys are never read, so they may hold anything.

The TPU kernel took at most 8 int32 key and 4-byte payload arrays per side
and a pad-rank key lane for the live counts; this one takes up to 16 key
lanes of int32 or int64 and any number of payloads of 1, 2, 4 or 8 bytes,
with the live counts as device scalars: a splits launch, then a merge
launch for each group of up to 32 payloads against the same splits (the
merge is deterministic, so every group takes the same rows).
"""
from __future__ import annotations

import torch

from . import (MAX_ARRAYS, addr_array, check, check_cuda_inputs, int_array,
               launches, library, ptr_array, stream_of)

MAX_KEYS = 16
_KEY_DTYPES = (torch.int32, torch.int64)


def _live(rows, cap: int, device) -> torch.Tensor:
    """bool[cap]: True for the first ``rows`` positions."""
    return torch.arange(cap, device=device) < rows


def merge_sorted_ref(a_keys, a_pays, b_keys, b_pays, out_cap: int,
                     a_rows=None, b_rows=None):
    """Plain PyTorch version of ``merge_sorted``: a stable lexicographic
    sort of the concatenation A‖B, one stable ``torch.sort`` pass per key
    lane from the least significant, then live rows first.  Dead rows' keys
    are zeroed first, so they keep their position order."""
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


def _check(a_keys, a_pays, b_keys, b_pays, out_cap: int) -> None:
    if not 1 <= len(a_keys) <= MAX_KEYS or len(b_keys) != len(a_keys):
        raise ValueError(f"merge_sorted: 1 to {MAX_KEYS} key lanes, the same "
                         "on both sides")
    if len(b_pays) != len(a_pays):
        raise ValueError("merge_sorted: the same payloads on both sides")
    cap_a, cap_b = a_keys[0].shape[0], b_keys[0].shape[0]
    if not 0 <= out_cap <= cap_a + cap_b:
        raise ValueError("merge_sorted: out_cap must be in [0, cap_a + cap_b]")
    for ka, kb in zip(a_keys, b_keys):
        if ka.dtype not in _KEY_DTYPES or kb.dtype != ka.dtype:
            raise ValueError("merge_sorted: key lanes must be int32 or int64, "
                             "the same on both sides")
    for lanes, cap in ((list(a_keys) + list(a_pays), cap_a),
                       (list(b_keys) + list(b_pays), cap_b)):
        for t in lanes:
            if t.dim() != 1 or t.shape[0] != cap:
                raise ValueError("merge_sorted: the lanes of a side must be "
                                 "1-D and equally long")
    for pa, pb in zip(a_pays, b_pays):
        if pa.dtype != pb.dtype or pa.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"merge_sorted: unsupported payload dtypes "
                             f"{pa.dtype}, {pb.dtype}")


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


def merge_sorted(a_keys, a_pays, b_keys, b_pays, out_cap: int, a_rows=None,
                 b_rows=None, keep_keys: bool = True):
    """Merge two sorted streams; see the module docstring.  Returns
    (merged key lanes, merged payloads), each ``out_cap`` rows long (no key
    lanes when ``keep_keys`` is False).  CPU tensors take
    ``merge_sorted_ref``; CUDA tensors launch the kernel, without a host
    sync."""
    _check(a_keys, a_pays, b_keys, b_pays, out_cap)
    dev = a_keys[0].device
    if dev.type == "cpu":
        keys, pays = merge_sorted_ref(a_keys, a_pays, b_keys, b_pays, out_cap,
                                      a_rows, b_rows)
        return (keys if keep_keys else []), pays
    if dev.type != "cuda":
        raise ValueError(f"merge_sorted: unsupported device {dev}")
    check_cuda_inputs("merge_sorted", dev, list(a_keys) + list(a_pays)
                      + list(b_keys) + list(b_pays))
    nk = len(a_keys)
    cap_a, cap_b = a_keys[0].shape[0], b_keys[0].shape[0]
    out_keys = [torch.empty(out_cap, dtype=k.dtype, device=dev)
                for k in a_keys] if keep_keys else []
    out_pays = [torch.empty(out_cap, dtype=p.dtype, device=dev)
                for p in a_pays]
    if out_cap == 0:
        return out_keys, out_pays
    lib = library()
    na = _rows_scalar(a_rows, cap_a, dev)
    nb = _rows_scalar(b_rows, cap_b, dev)
    tile = lib.ss_merge_tile_rows(nk)
    splits = torch.empty(-(-out_cap // tile) + 1, dtype=torch.int64,
                         device=dev)
    key_w = [k.element_size() for k in a_keys]
    # a null output pointer leaves a key lane unwritten
    key_outs = [k.data_ptr() for k in out_keys] if keep_keys else [0] * nk
    # payload groups of at most MAX_ARRAYS; the first also writes the keys
    groups = [slice(i, i + MAX_ARRAYS)
              for i in range(0, len(a_pays), MAX_ARRAYS)] or [slice(0, 0)]
    # the C side launches on the current device
    with torch.cuda.device(dev):
        stream = stream_of(a_keys[0])
        check(lib.ss_merge_splits(
            nk, ptr_array(a_keys), ptr_array(b_keys), int_array(key_w),
            na.data_ptr(), nb.data_ptr(), cap_a, cap_b, out_cap,
            splits.data_ptr(), stream), "merge_sorted splits")
        launches["merge_sorted"] += 1
        for gi, grp in enumerate(groups):
            ap, bp, op = a_pays[grp], b_pays[grp], out_pays[grp]
            outs = (key_outs if gi == 0 else [0] * nk) + [
                p.data_ptr() for p in op]
            check(lib.ss_merge_sorted(
                nk, nk + len(ap), ptr_array(list(a_keys) + list(ap)),
                ptr_array(list(b_keys) + list(bp)), addr_array(outs),
                int_array(key_w + [p.element_size() for p in ap]),
                na.data_ptr(), nb.data_ptr(), out_cap, splits.data_ptr(),
                stream), "merge_sorted merge")
            launches["merge_sorted"] += 1
    return out_keys, out_pays
