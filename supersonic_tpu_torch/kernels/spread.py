"""Monotone run expansion, the inverse of compaction (kernel:
``csrc/spread.cu``).

Port of ``supersonic_tpu/kernels/spread.py::spread_kernel``, the expansion
step of multi-match joins.  ``base[i]`` is the first output row of source
``i``; output row ``j`` of every payload takes source
``upper_bound(base, j) - 1``, clamped into ``[0, n_src)``, so source ``i``
fills rows ``[base[i], base[i+1])`` and rows at or past the last live start
hold the last live source.  ``base`` is int32 and nondecreasing with
``base[0] == 0``; callers pad dead sources with the int32 maximum, so the
live source count can stay on the device.  The TPU kernel took up to 8
four-byte payloads; this one takes up to 32 payloads of 1, 2, 4 or 8 bytes,
all in one launch.  An int32 payload listed in ``add_row`` also gets its
output row's index added (wrapping like int32 addition): the join's build
position ``j + d`` comes out of the expansion itself.
"""
from __future__ import annotations

import torch

from .. import tracing
from . import (MAX_ARRAYS, check, check_cuda_inputs, int_array, launches,
               library, ptr_array, stream_of)

I32_MAX = 2 ** 31 - 1


def spread_ref(payloads, base: torch.Tensor, out_cap: int, add_row=()):
    """Plain PyTorch version of ``spread_kernel`` (zeros for no source)."""
    n = base.shape[0]
    if n == 0:
        return [torch.zeros(out_cap, dtype=p.dtype, device=p.device)
                for p in payloads]
    rows = torch.arange(out_cap, dtype=torch.int32, device=base.device)
    src = (torch.searchsorted(base, rows, right=True) - 1).clamp(0, n - 1)
    return [p.index_select(0, src) + rows if i in add_row
            else p.index_select(0, src) for i, p in enumerate(payloads)]


def spread_kernel(payloads, base: torch.Tensor, out_cap: int, add_row=()):
    """Expand each 1-D payload (one row per source, as long as ``base``) to
    ``out_cap`` rows, adding the row index to the int32 payloads at the
    positions in ``add_row``; see the module docstring.  CPU tensors take
    ``spread_ref``; CUDA tensors launch the kernel, without a host sync."""
    if base.dtype != torch.int32 or base.dim() != 1:
        raise ValueError("spread_kernel: base must be a 1-D int32 tensor")
    if not 0 <= out_cap <= I32_MAX:
        raise ValueError("spread_kernel: out_cap must be in [0, 2^31)")
    if not 1 <= len(payloads) <= MAX_ARRAYS:
        raise ValueError(f"spread_kernel: 1 to {MAX_ARRAYS} payloads")
    n = base.shape[0]
    for p in payloads:
        if p.dim() != 1 or p.shape[0] != n:
            raise ValueError("spread_kernel: payloads must be 1-D, as long "
                             "as base")
        if p.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"spread_kernel: unsupported dtype {p.dtype}")
    if any(payloads[i].dtype != torch.int32 for i in add_row):
        raise ValueError("spread_kernel: add_row payloads must be int32")
    if base.device.type == "cpu":
        return spread_ref(payloads, base, out_cap, add_row)
    if base.device.type != "cuda":
        raise ValueError(f"spread_kernel: unsupported device {base.device}")
    dev = base.device
    check_cuda_inputs("spread_kernel", dev, [base] + list(payloads))
    if n == 0 or out_cap == 0:
        return [torch.zeros(out_cap, dtype=p.dtype, device=dev)
                for p in payloads]
    with tracing.span("kernel.spread"):
        return _launch(payloads, base, n, out_cap, add_row)


def _launch(payloads, base: torch.Tensor, n: int, out_cap: int, add_row):
    """``spread_kernel``'s outputs, marshalling and launches on CUDA."""
    dev = base.device
    lib = library()
    outs = [torch.empty(out_cap, dtype=p.dtype, device=dev) for p in payloads]
    ntiles = -(-out_cap // lib.ss_spread_tile_rows())
    bounds = torch.empty(ntiles + 1, dtype=torch.int32, device=dev)
    # the C side launches on the current device
    with torch.cuda.device(dev):
        stream = stream_of(base)
        check(lib.ss_spread_bounds(base.data_ptr(), n, out_cap,
                                   bounds.data_ptr(), stream), "spread bounds")
        launches["spread"] += 1
        check(lib.ss_spread_expand(
            base.data_ptr(), out_cap, bounds.data_ptr(), len(payloads),
            sum(1 << i for i in set(add_row)), ptr_array(payloads),
            ptr_array(outs),
            int_array([p.element_size() for p in payloads]), stream),
            "spread expand")
        launches["spread"] += 1
    return outs
