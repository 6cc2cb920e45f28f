"""Hand-written Hopper kernels of the port, and their build.

The CUDA sources live in ``supersonic_tpu_torch/csrc``.  At the first
launch on a CUDA tensor, ``library()`` compiles them with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface under
``supersonic_tpu_torch/_build/`` (named by a hash of the sources, so an
edited source rebuilds) and loads it with ``ctypes``.  Importing this
package builds nothing: the CPU tests import every module.

Each kernel module (``compaction``, ``lut_gather``, ``segment_reduce``)
holds its wrapper and the wrapper's plain PyTorch version.  A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches its
kernel or raises.  A wrapper adds one to ``launches[name]`` right after
each kernel launch it makes, and nowhere else: compaction launches a count
and a scatter kernel, segment_reduce a partial and a final pass, lut_gather
one kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Most arrays one launch moves (SS_MAX_ARRAYS of csrc/common.cuh)
MAX_ARRAYS = 32

# kernel name -> launches since the last reset_launches()
launches: dict[str, int] = {"compaction": 0, "lut_gather": 0,
                            "segment_reduce": 0}

_lock = threading.Lock()
_lib = None


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build() -> pathlib.Path:
    """Compile the CUDA sources into the shared library (if not built yet)
    and return its path."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libsupersonic_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp)] + [str(p) for p in sorted(CSRC.glob("*.cu"))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    (BUILD_DIR / "ptxas.log").write_text(res.stderr)
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    PP = ctypes.POINTER(ctypes.c_void_p)
    IP = ctypes.POINTER(ctypes.c_int)
    sigs = {
        "ss_compact_block_rows": [],
        "ss_compact_count": [P, L, P, P],
        "ss_compact_scatter": [P, L, P, L, I, PP, PP, IP, P],
        "ss_lut_gather_staged": [I, I, IP],
        "ss_lut_gather": [P, L, I, I, PP, PP, IP, P],
        "ss_segment_reduce_threads": [],
        "ss_segment_reduce_partial": [P, L, I, I, IP, PP, P, I, P],
        "ss_segment_reduce_final": [P, I, I, I, IP, PP, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I
    lib.ss_error_string.argtypes = [I]
    lib.ss_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise KernelError for a nonzero cudaError_t from a C entry point."""
    if code:
        msg = library().ss_error_string(code).decode()
        raise KernelError(f"{what}: CUDA error {code} ({msg})")


def ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_inputs(what: str, device: torch.device, tensors) -> None:
    """Every tensor must be contiguous and on ``device``."""
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor is not contiguous")
