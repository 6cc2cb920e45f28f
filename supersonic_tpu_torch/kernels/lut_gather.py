"""Multi-lane gather from a lookup table (kernel: ``csrc/lut_gather.cu``).

Port of ``supersonic_tpu/kernels/lut_gather.py::lut_gather``:
``[lut[clip(idx, 0, K - 1)] for lut in luts]``.  The TPU kernel took only
32-bit lanes of LUTs up to 65536 entries; this one takes lanes of 1, 2, 4
and 8 bytes and any K below 2^31, staging the LUT in shared memory when it
fits and reading it through L2 otherwise.
"""
from __future__ import annotations

import torch

from . import (MAX_ARRAYS, check, check_cuda_inputs, int_array, launches,
               library, ptr_array, stream_of)


def lut_gather_ref(luts, idx: torch.Tensor, num_entries: int):
    """Plain PyTorch version of ``lut_gather``."""
    safe = idx.clamp(0, num_entries - 1).long()
    return [lut[safe] for lut in luts]


def lut_gather(luts, idx: torch.Tensor, num_entries: int):
    """Gather every 1-D ``lut`` (length >= num_entries) at int32 ``idx``,
    clipped to [0, num_entries).  Returns one array per LUT, as long as
    ``idx``.  CPU tensors take ``lut_gather_ref``; CUDA tensors launch the
    kernel."""
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("lut_gather: idx must be a 1-D int32 tensor")
    if num_entries < 1:
        raise ValueError("lut_gather: empty LUT")
    if len(luts) > MAX_ARRAYS:
        raise ValueError(f"lut_gather: at most {MAX_ARRAYS} LUTs")
    for lut in luts:
        if lut.dim() != 1 or lut.shape[0] < num_entries:
            raise ValueError("lut_gather: LUTs must be 1-D with at least "
                             "num_entries entries")
        if lut.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"lut_gather: unsupported dtype {lut.dtype}")
    if idx.device.type == "cpu":
        return lut_gather_ref(luts, idx, num_entries)
    if idx.device.type != "cuda":
        raise ValueError(f"lut_gather: unsupported device {idx.device}")
    check_cuda_inputs("lut_gather", idx.device, [idx] + list(luts))
    lib = library()
    n = idx.shape[0]
    outs = [torch.empty(n, dtype=lut.dtype, device=idx.device)
            for lut in luts]
    if n == 0 or not luts:
        return outs
    # the C side launches on the current device
    with torch.cuda.device(idx.device):
        check(lib.ss_lut_gather(
            idx.data_ptr(), n, num_entries, len(luts), ptr_array(luts),
            ptr_array(outs), int_array([t.element_size() for t in luts]),
            stream_of(idx)), "lut_gather")
        launches["lut_gather"] += 1
    return outs


def staged(luts, num_entries: int) -> bool:
    """Whether the kernel stages these LUTs in shared memory (the other
    route reads them through L2)."""
    widths = [t.element_size() for t in luts]
    return bool(library().ss_lut_gather_staged(num_entries, len(widths),
                                               int_array(widths)))
