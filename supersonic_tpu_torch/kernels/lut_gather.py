"""Multi-lane gather from a lookup table (kernel: ``csrc/lut_gather.cu``).

Port of ``supersonic_tpu/kernels/lut_gather.py::lut_gather``:
``[lut[clip(idx, 0, K - 1)] for lut in luts]``.  The TPU kernel took only
32-bit lanes of LUTs up to 65536 entries; this one takes lanes of 1, 2, 4
and 8 bytes and any K below 2^31, staging the LUT in shared memory when it
fits and reading it through L2 otherwise.  The lane sets the joins use (one
to three 4-byte lanes, with or without one 1-byte lane) take a kernel
specialised for them; any other set takes a generic one (``specialised``
says which).  The index may be a slice at any offset.
"""
from __future__ import annotations

import torch

from .. import tracing
from . import (MAX_ARRAYS, addr_array, check, check_cuda_inputs, int_array,
               launches, library, ptr_array, stream_of)


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
    with tracing.span("kernel.lut_gather"):
        return _launch(luts, idx, num_entries)


def _launch(luts, idx: torch.Tensor, num_entries: int):
    """``lut_gather``'s outputs, marshalling and launch on CUDA."""
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


def specialised(luts) -> bool:
    """Whether the kernel takes a specialised lane signature for these LUTs
    (the outputs the wrapper allocates are always aligned)."""
    widths = [t.element_size() for t in luts]
    return bool(library().ss_lut_gather_specialised(
        len(widths), int_array(widths), addr_array([0] * len(widths))))


def staged(luts, num_entries: int) -> bool:
    """Whether the kernel stages these LUTs in shared memory (the other
    route reads them through L2)."""
    widths = [t.element_size() for t in luts]
    return bool(library().ss_lut_gather_staged(num_entries, len(widths),
                                               int_array(widths)))


class BoundLut:
    """A LUT built on the host at bind: its tensor on each device is
    uploaded once, at its first use there, and reused by every later
    evaluation of the bound plan."""

    __slots__ = ("host", "_on")

    def __init__(self, host):
        host = torch.as_tensor(host)
        if host.dim() != 1 or host.shape[0] == 0:
            raise ValueError("BoundLut: a non-empty 1-D table")
        self.host = host
        self._on: dict = {}

    def __len__(self) -> int:
        return self.host.shape[0]

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            # a copy from pageable host memory waits for the stream
            with tracing.sync("lut.upload", self.host):
                t = self._on[device] = self.host.to(device)
        return t


def take_small(src, idx: torch.Tensor) -> torch.Tensor:
    """``src[clip(idx, 0, len(src) - 1)]`` for a 1-D ``src`` (a tensor or a
    ``BoundLut``) and 1-D integer ``idx``: one ``lut_gather`` lane, so a
    CUDA tensor always takes the kernel.  Port of
    ``supersonic_tpu/kernels/lut_gather.py::take_small``."""
    if isinstance(src, BoundLut):
        src = src.on(idx.device)
    k = src.shape[0]
    if idx.dtype != torch.int32:
        idx = idx.clamp(0, k - 1).to(torch.int32)
    return lut_gather([src], idx, k)[0]
