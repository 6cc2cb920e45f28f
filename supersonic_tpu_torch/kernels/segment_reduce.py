"""Fused multi-request segmented reduction (kernel: ``csrc/segment_reduce.cu``).

Port of ``supersonic_tpu/kernels/segment_reduce.py::segment_reduce_multi``
and of its ``segment_reduce_small`` (one sum, min or max), both as calls of
one kernel family, and of the slot arithmetic of the dense GroupAggregate
(``supersonic_tpu/ops/aggregate.py:504-519``), which the kernel does itself.
Every call is one kernel launch (after a 4-byte memset of its ticket), and
its results are the same bits on every run.

Two entry points:

  * ``segment_reduce_keyed(keys, requests, K, keep, num_rows)``: the keyed
    form.  ``keys`` is a list of up to 4 ``(lane, kmin, K_i)``, raw INT32 or
    INT64 group-key lanes with their planned domains, whose mixed-radix
    product is K <= 2048 slots.  A row is live where ``row < num_rows`` and
    ``keep[row]``; a live row whose key falls outside the domain is dropped
    and counted.  ``requests`` is a list of ``(values, valid, mode)``; a
    request counts a row where it is live and ``valid`` (when given).
    Returns (one [K] tensor per request, the 0-d int64 count of dropped
    live rows).
  * ``segment_reduce_multi(requests, segment_ids, K)`` and
    ``segment_reduce_small``: the ids form of the JAX package, the keyed
    form with one int32 key, kmin 0 and no keep mask; ids outside [0, K)
    drop.  ``requests`` is a list of ``(values, mode)``.

Modes and results:
  * ``count``    1 a counted row (keyed form without values), or the sum of
                 0/1 int32 indicators -> int64, exact at any row count
  * ``sum``      f32 values -> f32; i32 values -> i32, wrapping mod 2^32
  * ``min``/``max``  f32 or i32 -> same dtype; f32 counts -0.0 as +0.0, and a
                 slot that holds a NaN of either sign gives NaN
  * ``firstpos``/``lastpos``  the first / last counted row index (keyed form
                 without values), or the i32 min / max of the given positions
A slot no row reached keeps the init value of ``segment_reduce.py:311-316``:
0 for sums and counts, +inf / INT32_MAX for min and firstpos, -inf /
INT32_MIN for max and lastpos.

The kernel has two instances, picked by the accumulators' footprint
(``per_thread_accumulators``): when they fit in shared memory, an f32 sum
has one accumulator word per thread and slot and every other request one
per warp and slot (updated by shared-memory atomics, exact in any order);
else every request has one per warp and slot, with the requests taken in
groups.  It reads its inputs with 16-byte loads when
every one of them starts on a 16-byte boundary (``vector_loads``), else
with element loads.
"""
from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import (addr_array, check, check_cuda_inputs, int_array, launches,
               library, stream_of)

MAX_SEGMENTS = 2048
MAX_REQUESTS = 16
MAX_KEYS = 4
THREADS = 256  # threads a block (kThreads of the source)
SMEM_BYTES = 232448  # dynamic shared memory a block may hold (kSmemBytes)
MODES = ("count", "sum", "min", "max", "firstpos", "lastpos")

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def per_thread_accumulators(num_segments: int, requests) -> bool:
    """Whether a keyed call's ``requests`` take the per-thread instance: a
    4-byte word for each f32 sum, slot and thread of a block, and for each
    other request, slot and warp, fit in shared memory."""
    f32 = sum(_code(m, v) == 0 for v, _, m in requests)
    words = (f32 * THREADS + (len(requests) - f32) * (THREADS // 32))
    return words * num_segments * 4 <= SMEM_BYTES


def vector_loads(tensors) -> bool:
    """Whether the kernel reads these inputs with 16-byte loads: every one
    starts on a 16-byte boundary.  A view at another offset makes the whole
    call take the instance with element loads."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _code(mode: str, values) -> int:
    """Mode code of csrc/segment_reduce.cu."""
    is_float = values is not None and values.dtype == torch.float32
    if mode == "count":
        return 2
    if mode == "sum":
        return 0 if is_float else 1
    lo = mode in ("min", "firstpos")
    if is_float:
        return 5 if lo else 6
    return 3 if lo else 4


def _check(keys, requests, num_segments, keep, num_rows):
    """Validate a keyed call; returns the row count n."""
    if not 1 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_reduce: num_segments must be in "
                         f"[1, {MAX_SEGMENTS}]")
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"segment_reduce: 1 to {MAX_KEYS} key lanes")
    if not 1 <= len(requests) <= MAX_REQUESTS:
        raise ValueError(f"segment_reduce: 1 to {MAX_REQUESTS} requests per "
                         "call")
    n = keys[0][0].shape[0]
    domain = 1
    for lane, _kmin, k_i in keys:
        if lane.dim() != 1 or lane.shape[0] != n:
            raise ValueError("segment_reduce: key lanes must be 1-D and "
                             "equally long")
        if lane.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"segment_reduce: unsupported key dtype "
                             f"{lane.dtype}")
        if k_i < 1:
            raise ValueError("segment_reduce: empty key domain")
        domain *= k_i
    if domain != num_segments:
        raise ValueError(f"segment_reduce: key domains span {domain} slots, "
                         f"not {num_segments}")

    def row_lane(t, what, dtypes):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"segment_reduce: {what} must be 1-D, as long as "
                             "the keys")
        if t.dtype not in dtypes:
            raise ValueError(f"segment_reduce: unsupported {what} dtype "
                             f"{t.dtype}")

    if keep is not None:
        row_lane(keep, "keep", (torch.bool,))
    if isinstance(num_rows, torch.Tensor) and (
            num_rows.dim() != 0 or num_rows.dtype != torch.int64):
        raise ValueError("segment_reduce: num_rows must be a 0-d int64 "
                         "tensor or an int")
    for values, valid, mode in requests:
        if mode not in MODES:
            raise ValueError(f"segment_reduce: mode {mode!r}")
        if values is None:
            if mode in ("sum", "min", "max"):
                raise ValueError(f"segment_reduce: mode {mode!r} needs values")
        else:
            row_lane(values, "values", (torch.float32, torch.int32))
            if (mode in ("count", "firstpos", "lastpos")
                    and values.dtype != torch.int32):
                raise ValueError(f"segment_reduce: mode {mode!r} takes int32 "
                                 "values")
        if valid is not None:
            row_lane(valid, "valid", (torch.bool,))
        if (values is None and mode in ("firstpos", "lastpos")
                and n > _I32_MAX):
            raise ValueError("segment_reduce: row positions past int32")
    return n


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
                v = torch.where(v == 0, torch.zeros_like(v), v)  # -0.0 -> +0.0
            else:
                init = _I32_MAX if lo else _I32_MIN
            out = torch.full((K,), init, dtype=v.dtype, device=dev)
            res.append(out.scatter_reduce_(0, ids, v, "amin" if lo else "amax",
                                           include_self=True))
    return res


def segment_reduce_keyed_ref(keys, requests, num_segments: int, keep=None,
                             num_rows=None):
    """Plain PyTorch version of ``segment_reduce_keyed``: the dense
    GroupAggregate's int64 slot arithmetic, then
    ``segment_reduce_multi_ref``."""
    lane0 = keys[0][0]
    n, dev = lane0.shape[0], lane0.device
    live = (torch.ones(n, dtype=torch.bool, device=dev) if keep is None
            else keep.clone())
    if num_rows is not None:
        live &= torch.arange(n, device=dev) < num_rows
    gid, in_domain = None, None
    for lane, kmin, k_i in keys:
        v = lane.long() - kmin
        ok = (v >= 0) & (v < k_i)
        vc = v.clamp(0, k_i - 1)
        gid = vc if gid is None else gid * k_i + vc
        in_domain = ok if in_domain is None else (in_domain & ok)
    bad = (live & ~in_domain).sum()
    live &= in_domain
    ids = torch.where(live, gid, -1).to(torch.int32)
    reqs = []
    for values, valid, mode in requests:
        ok = live if valid is None else (live & valid)
        if mode == "count":
            x = (ok.to(torch.int32) if values is None
                 else torch.where(ok, values, 0))
        elif mode == "sum":
            x = torch.where(ok, values, torch.zeros_like(values))
        else:
            if values is None:
                values = torch.arange(n, dtype=torch.int32, device=dev)
            lo = mode in ("min", "firstpos")
            if values.dtype == torch.float32:
                init = float("inf") if lo else float("-inf")
            else:
                init = _I32_MAX if lo else _I32_MIN
            x = torch.where(ok, values, init)
            mode = "min" if lo else "max"
        reqs.append((x, mode))
    return segment_reduce_multi_ref(reqs, ids, num_segments), bad


def segment_reduce_keyed(keys, requests, num_segments: int, keep=None,
                         num_rows=None):
    """Keyed segmented reductions; see the module docstring.  Returns (one
    [K] tensor per request, 0-d int64 count of live rows dropped outside
    the key domain).  CPU tensors take ``segment_reduce_keyed_ref``; CUDA
    tensors launch the kernel, without a host sync."""
    _check(keys, requests, num_segments, keep, num_rows)
    dev = keys[0][0].device
    if dev.type == "cpu":
        return segment_reduce_keyed_ref(keys, requests, num_segments, keep,
                                        num_rows)
    return _launch(keys, requests, num_segments, keep, num_rows,
                   "segment_reduce")


def segment_reduce_multi(requests, segment_ids: torch.Tensor,
                         num_segments: int):
    """Fused segmented reductions over int32 ``segment_ids``; see the module
    docstring.  CPU tensors take ``segment_reduce_multi_ref``; CUDA tensors
    launch the kernel."""
    return _ids_form(requests, segment_ids, num_segments, "segment_reduce")


def segment_reduce_small_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                             num_segments: int, mode: str = "sum"):
    """Plain PyTorch version of ``segment_reduce_small``."""
    return segment_reduce_multi_ref([(values, mode)], segment_ids,
                                    num_segments)[0]


def segment_reduce_small(values: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int, mode: str = "sum"):
    """One segmented ``sum``, ``min`` or ``max`` of f32 or i32 values into
    ``num_segments`` slots; ids outside [0, num_segments) drop.  Its
    launches count under ``segment_reduce_small``."""
    if mode not in ("sum", "min", "max"):
        raise ValueError(f"segment_reduce_small: mode {mode!r}")
    return _ids_form([(values, mode)], segment_ids, num_segments,
                     "segment_reduce_small")[0]


def _ids_form(requests, segment_ids, num_segments, counter: str):
    if segment_ids.dtype != torch.int32 or segment_ids.dim() != 1:
        raise ValueError("segment_reduce_multi: segment ids must be a 1-D "
                         "int32 tensor")
    if any(m not in ("count", "sum", "min", "max", "firstpos")
           for _, m in requests):
        raise ValueError("segment_reduce_multi: modes are count, sum, min, "
                         "max and firstpos")
    if any(v is None for v, _ in requests):
        raise ValueError("segment_reduce_multi: every request has values")
    keys = [(segment_ids, 0, num_segments)]
    reqs = [(v, None, m) for v, m in requests]
    _check(keys, reqs, num_segments, None, None)
    if segment_ids.device.type == "cpu":
        return segment_reduce_multi_ref(requests, segment_ids, num_segments)
    return _launch(keys, reqs, num_segments, None, None, counter)[0]


def _launch(keys, requests, K, keep, num_rows, counter: str):
    """One kernel launch on CUDA tensors: (outputs, dropped-row count),
    its marshalling and launch the span ``kernel.<counter>``."""
    with tracing.span("kernel." + counter):
        return _marshal_and_launch(keys, requests, K, keep, num_rows, counter)


def _marshal_and_launch(keys, requests, K, keep, num_rows, counter: str):
    lane0 = keys[0][0]
    dev = lane0.device
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {dev}")
    n = lane0.shape[0]
    inputs = [lane for lane, _, _ in keys]
    if keep is not None:
        inputs.append(keep)
    for values, valid, _ in requests:
        inputs += [t for t in (values, valid) if t is not None]
    check_cuda_inputs("segment_reduce", dev, inputs)
    row_ptr, row_limit = 0, n
    if isinstance(num_rows, torch.Tensor):
        if num_rows.device != dev:
            raise ValueError(f"segment_reduce: num_rows on {num_rows.device}, "
                             f"expected {dev}")
        row_ptr = num_rows.data_ptr()
    elif num_rows is not None:
        row_limit = max(0, min(n, int(num_rows)))
    outs = []
    for values, _, mode in requests:
        dt = (torch.int64 if mode == "count" else
              torch.int32 if values is None else values.dtype)
        outs.append(torch.empty(K, dtype=dt, device=dev))
    bad = torch.empty((), dtype=torch.int64, device=dev)
    nreq = len(requests)
    per_thread = per_thread_accumulators(K, requests)
    modes = int_array([_code(m, v) for v, _, m in requests])
    lib = library()
    # the C side launches on the current device
    with torch.cuda.device(dev):
        nblocks, words = ctypes.c_int(), ctypes.c_longlong()
        check(lib.ss_segment_reduce_plan(n, K, nreq, modes, int(per_thread),
                                         ctypes.byref(nblocks),
                                         ctypes.byref(words)),
              "segment_reduce plan")
        scratch = torch.empty(words.value, dtype=torch.int32, device=dev)
        check(lib.ss_segment_reduce(
            len(keys), addr_array([t.data_ptr() for t, _, _ in keys]),
            int_array([int(t.dtype == torch.int64) for t, _, _ in keys]),
            (ctypes.c_longlong * len(keys))(*[int(k) for _, k, _ in keys]),
            int_array([int(k) for _, _, k in keys]),
            0 if keep is None else keep.data_ptr(), row_ptr, row_limit, n, K,
            nreq, modes,
            addr_array([0 if v is None else v.data_ptr()
                        for v, _, _ in requests]),
            addr_array([0 if d is None else d.data_ptr()
                        for _, d, _ in requests]),
            addr_array([o.data_ptr() for o in outs]), bad.data_ptr(),
            scratch.data_ptr(), int(per_thread), int(vector_loads(inputs)),
            nblocks.value, stream_of(lane0)), "segment_reduce")
        launches[counter] += 1
    return outs, bad
