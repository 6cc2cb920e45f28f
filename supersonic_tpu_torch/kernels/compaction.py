"""Stable stream compaction (kernel: ``csrc/compaction.cu``).

Port of ``supersonic_tpu/kernels/compaction.py::compact_kernel``.  Rows
where ``mask`` is set move, in order, into a dense prefix of ``out_cap``
rows of each payload; the count is ``min(kept, out_cap)``.  Payloads of 1,
2, 4 or 8 bytes move natively: no word split.  The kernel makes one pass
over the mask in one launch (a single-pass scan of tiles of ``TILE_ROWS``
rows with decoupled look-back), after zeroing the tiles' status words.
"""
from __future__ import annotations

import torch

from .. import tracing
from . import (MAX_ARRAYS, check, check_cuda_inputs, int_array, launches,
               library, ptr_array, stream_of)

TILE_ROWS = 4096  # rows a block of the kernel takes (kTile of the source)


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


def scratch_words(n: int) -> int:
    """int64 words of the kernel's scratch for ``n`` rows: one status word a
    tile, then the tile counter."""
    return -(-n // TILE_ROWS) + 1


def vector_loads(tensors) -> bool:
    """Whether the kernel reads these inputs (the mask and the payloads) with
    16-byte loads: every one starts on a 16-byte boundary.  A view at another
    offset makes the whole call take the instance with element loads."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def kernel_launches(n: int, out_cap: int) -> int:
    """Kernel launches of one call on CUDA tensors: none when there is no
    row to read or none to keep, else one."""
    return int(n > 0 and out_cap > 0)


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
    with tracing.span("kernel.compaction"):
        return _launch(payloads, mask, n, out_cap)


def _launch(payloads, mask: torch.Tensor, n: int, out_cap: int):
    """``compact_kernel``'s outputs, marshalling and launch on CUDA."""
    dev = mask.device
    outs = [torch.empty(out_cap, dtype=p.dtype, device=dev) for p in payloads]
    if not kernel_launches(n, out_cap):
        return outs, torch.zeros((), dtype=torch.int64, device=dev)
    lib = library()
    count = torch.empty((), dtype=torch.int64, device=dev)
    words = scratch_words(n)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    # the C side launches on the current device
    with torch.cuda.device(dev):
        check(lib.ss_compact(
            mask.data_ptr(), n, out_cap,
            int(vector_loads([mask] + list(payloads))), len(payloads),
            ptr_array(payloads), ptr_array(outs),
            int_array([p.element_size() for p in payloads]),
            count.data_ptr(), scratch.data_ptr(), words, stream_of(mask)),
            "compaction")
        launches["compaction"] += 1
    return outs, count
