"""Fused multi-request segmented reduction (kernel: ``csrc/segment_reduce.cu``).

Port of ``supersonic_tpu/kernels/segment_reduce.py::segment_reduce_multi``.
``requests`` is a list of ``(values, mode)``; every request reduces its
values over the same ``segment_ids`` into ``num_segments`` slots in one
pass over the rows (a partial launch, then a final fold), and ids outside [0, num_segments) are dropped.

Modes and results (one [K] tensor per request):
  * ``sum``      f32 values -> f32; i32 values -> i32, wrapping mod 2^32
  * ``count``    0/1 int32 indicators -> int64, exact at any row count
  * ``min``/``max``  f32 or i32 -> same dtype
  * ``firstpos`` i32 row positions -> their i32 minimum
A slot no row reached keeps the init value of ``segment_reduce.py:311-316``:
0 for sums and counts, +inf / INT32_MAX for min, -inf / INT32_MIN for max.
"""
from __future__ import annotations

import torch

from . import (check, check_cuda_inputs, int_array, launches, library,
               ptr_array, stream_of)

MAX_SEGMENTS = 2048
MAX_REQUESTS = 16

# mode codes of csrc/segment_reduce.cu, by (mode, is_float)
_CODES = {("sum", True): 0, ("sum", False): 1, ("count", False): 2,
          ("min", False): 3, ("max", False): 4, ("firstpos", False): 3,
          ("min", True): 5, ("max", True): 6}

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _check_request(values: torch.Tensor, mode: str, n: int) -> bool:
    if values.dim() != 1 or values.shape[0] != n:
        raise ValueError("segment_reduce_multi: values must be 1-D, as long "
                         "as the segment ids")
    if values.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"segment_reduce_multi: unsupported dtype "
                         f"{values.dtype}")
    is_float = values.dtype == torch.float32
    if (mode, is_float) not in _CODES:
        raise ValueError(f"segment_reduce_multi: mode {mode!r} does not take "
                         f"{values.dtype}")
    return is_float


def segment_reduce_multi_ref(requests, segment_ids: torch.Tensor,
                             num_segments: int):
    """Plain PyTorch version of ``segment_reduce_multi``."""
    K = num_segments
    keep = (segment_ids >= 0) & (segment_ids < K)
    ids = segment_ids[keep].long()
    res = []
    for values, mode in requests:
        v = values[keep]
        dev = values.device
        if mode == "count":
            res.append(torch.zeros(K, dtype=torch.int64, device=dev)
                       .index_add_(0, ids, v.long()))
        elif mode == "sum" and v.dtype == torch.float32:
            res.append(torch.zeros(K, dtype=torch.float32, device=dev)
                       .index_add_(0, ids, v))
        elif mode == "sum":
            s = torch.zeros(K, dtype=torch.int64, device=dev).index_add_(
                0, ids, v.long())
            res.append(((s - _I32_MIN) % (2 ** 32) + _I32_MIN).to(torch.int32))
        else:
            lo = mode in ("min", "firstpos")
            if v.dtype == torch.float32:
                init = float("inf") if lo else float("-inf")
            else:
                init = _I32_MAX if lo else _I32_MIN
            out = torch.full((K,), init, dtype=v.dtype, device=dev)
            res.append(out.scatter_reduce_(0, ids, v, "amin" if lo else "amax",
                                           include_self=True))
    return res


def segment_reduce_multi(requests, segment_ids: torch.Tensor,
                         num_segments: int):
    """Fused segmented reductions; see the module docstring.  CPU tensors
    take ``segment_reduce_multi_ref``; CUDA tensors launch the kernel."""
    if segment_ids.dtype != torch.int32 or segment_ids.dim() != 1:
        raise ValueError("segment_reduce_multi: segment ids must be a 1-D "
                         "int32 tensor")
    if not 1 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_reduce_multi: num_segments must be in "
                         f"[1, {MAX_SEGMENTS}]")
    if not 1 <= len(requests) <= MAX_REQUESTS:
        raise ValueError(f"segment_reduce_multi: 1 to {MAX_REQUESTS} "
                         "requests per call")
    n = segment_ids.shape[0]
    floats = [_check_request(v, m, n) for v, m in requests]
    if segment_ids.device.type == "cpu":
        return segment_reduce_multi_ref(requests, segment_ids, num_segments)
    if segment_ids.device.type != "cuda":
        raise ValueError(f"segment_reduce_multi: unsupported device "
                         f"{segment_ids.device}")
    vals = [v for v, _ in requests]
    dev = segment_ids.device
    check_cuda_inputs("segment_reduce_multi", dev, [segment_ids] + vals)
    lib = library()
    K, nreq = num_segments, len(requests)
    outs = []
    for v, mode in requests:
        dt = torch.int64 if mode == "count" else v.dtype
        outs.append(torch.empty(K, dtype=dt, device=dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_per_block = lib.ss_segment_reduce_threads() * 8
    nblocks = max(1, min(-(-n // rows_per_block), 4 * sms))
    partial = torch.empty(nblocks * nreq * K, dtype=torch.int32, device=dev)
    modes = [_CODES[(m, f)] for (_, m), f in zip(requests, floats)]
    # the C side launches on the current device
    with torch.cuda.device(dev):
        stream = stream_of(segment_ids)
        check(lib.ss_segment_reduce_partial(
            segment_ids.data_ptr(), n, K, nreq, int_array(modes),
            ptr_array(vals), partial.data_ptr(), nblocks, stream),
            "segment_reduce partial")
        launches["segment_reduce"] += 1
        check(lib.ss_segment_reduce_final(
            partial.data_ptr(), nblocks, K, nreq, int_array(modes),
            ptr_array(outs), stream), "segment_reduce final")
        launches["segment_reduce"] += 1
    return outs
