"""Stable stream compaction (kernel: ``csrc/compaction.cu``).

Port of ``supersonic_tpu/kernels/compaction.py::compact_kernel``.  Rows
where ``mask`` is set move, in order, into a dense prefix of ``out_cap``
rows of each payload; the count is ``min(kept, out_cap)``.  Payloads of 1,
2, 4 or 8 bytes move natively: no word split.
"""
from __future__ import annotations

import torch

from . import (MAX_ARRAYS, check, check_cuda_inputs, int_array, launches,
               library, ptr_array, stream_of)


def compact_arrays_ref(payloads, mask: torch.Tensor, out_cap: int):
    """Plain PyTorch version: (list of [out_cap] arrays, 0-d int64 count).
    Rows past the count are zero."""
    kept = int(mask.sum())
    count = min(kept, out_cap)
    outs = []
    for p in payloads:
        out = torch.zeros(out_cap, dtype=p.dtype, device=p.device)
        out[:count] = p[mask][:count]
        outs.append(out)
    return outs, torch.tensor(count, dtype=torch.int64, device=mask.device)


def compact_kernel(payloads, mask: torch.Tensor, out_cap: int):
    """Stable-compact ``payloads`` where ``mask`` is True.

    Returns (list of [out_cap] arrays, 0-d int64 count tensor).  CPU
    tensors take ``compact_arrays_ref``; CUDA tensors launch the kernel,
    without a host sync.  On CUDA, rows past the count are unspecified.
    """
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError("compact_kernel: mask must be a 1-D bool tensor")
    n = mask.shape[0]
    if len(payloads) > MAX_ARRAYS:
        raise ValueError(f"compact_kernel: at most {MAX_ARRAYS} payloads")
    for p in payloads:
        if p.dim() != 1 or p.shape[0] != n:
            raise ValueError("compact_kernel: payloads must be 1-D, "
                             "as long as the mask")
        if p.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"compact_kernel: unsupported dtype {p.dtype}")
    if mask.device.type == "cpu":
        return compact_arrays_ref(payloads, mask, out_cap)
    if mask.device.type != "cuda":
        raise ValueError(f"compact_kernel: unsupported device {mask.device}")
    check_cuda_inputs("compact_kernel", mask.device, [mask] + list(payloads))
    lib = library()
    dev = mask.device
    outs = [torch.empty(out_cap, dtype=p.dtype, device=dev) for p in payloads]
    if n == 0:
        return outs, torch.zeros((), dtype=torch.int64, device=dev)
    nblocks = -(-n // lib.ss_compact_block_rows())
    counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    # the C side launches on the current device
    with torch.cuda.device(dev):
        stream = stream_of(mask)
        check(lib.ss_compact_count(mask.data_ptr(), n, counts.data_ptr(),
                                   stream), "compaction count")
        launches["compaction"] += 1
        incl = torch.cumsum(counts, 0, dtype=torch.int64)
        offsets = incl - counts
        if payloads:
            check(lib.ss_compact_scatter(
                mask.data_ptr(), n, offsets.data_ptr(), out_cap, len(payloads),
                ptr_array(payloads), ptr_array(outs),
                int_array([p.element_size() for p in payloads]), stream),
                "compaction scatter")
            launches["compaction"] += 1
    return outs, torch.clamp(incl[-1], max=out_cap)
