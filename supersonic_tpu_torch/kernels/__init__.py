"""Hand-written Hopper kernels of the port, and their build.

The CUDA sources live in ``supersonic_tpu_torch/csrc``.  At the first
launch on a CUDA tensor, ``library()`` compiles them with ``nvcc`` for
``sm_90a`` (one process per source, all at once) into one shared library
with a plain C interface under ``supersonic_tpu_torch/_build/`` (named by a
hash of the sources, so an edited source rebuilds) and loads it with
``ctypes``.  Importing this
package builds nothing: the CPU tests import every module.

Each kernel module (``compaction``, ``lut_gather``, ``segment_reduce``,
``spread``, ``merge_sorted``) holds its wrappers and their plain PyTorch
versions.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises.  A wrapper adds one to
``launches[name]`` right after each kernel launch it makes, and nowhere
else: compaction launches one kernel (after zeroing its scratch with a
memset), segment_reduce (its keyed and ids forms, and segment_reduce_small,
one request of the same kernel) one kernel (after a memset of its ticket),
spread a bounds and an expand kernel, merge_sorted a splits and a merge
kernel, lut_gather one kernel.  ``launches`` and ``reset_launches`` live in
the port's counter registry, ``supersonic_tpu_torch/tracing.py``, and are
re-exported here; while spans are recorded, each wrapper's marshalling and
launch is the span ``kernel.<name>``.
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

from ..tracing import launches, reset_launches  # noqa: F401 (re-exported)

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Most arrays one launch moves (SS_MAX_ARRAYS of csrc/common.cuh)
MAX_ARRAYS = 32

_lock = threading.Lock()
_lib = None


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


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
    tmp = BUILD_DIR / f"tmp.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # one nvcc per source, all started at once, then one link
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / f"{src.stem}.o"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
               "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = []
    for src, _obj, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed on {src.name} "
                              f"({proc.returncode}):\n{err}")
        logs.append(err)
    lib = tmp / out.name
    res = subprocess.run([nvcc, "-shared", "-o", str(lib)]
                         + [str(obj) for _, obj, _ in jobs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelError(f"nvcc link failed ({res.returncode}):\n"
                          f"{res.stderr}")
    (BUILD_DIR / "ptxas.log").write_text("".join(logs))
    os.replace(lib, out)  # atomic: concurrent builds race harmlessly
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    PP = ctypes.POINTER(ctypes.c_void_p)
    IP = ctypes.POINTER(ctypes.c_int)
    LP = ctypes.POINTER(ctypes.c_longlong)
    sigs = {
        "ss_compact_tile_rows": [],
        "ss_compact": [P, L, L, I, I, PP, PP, IP, P, P, L, P],
        "ss_lut_gather_staged": [I, I, IP],
        "ss_lut_gather_specialised": [I, IP, PP],
        "ss_lut_gather": [P, L, I, I, PP, PP, IP, P],
        "ss_segment_reduce_threads": [],
        "ss_segment_reduce_smem_bytes": [],
        "ss_segment_reduce_plan": [L, I, I, IP, IP, I, IP, LP],
        "ss_segment_reduce": [I, PP, IP, LP, IP, P, P, L, L, I, I, IP, IP,
                              PP, PP, PP, P, P, I, I, I, P],
        "ss_spread_tile_rows": [],
        "ss_spread_bounds": [P, I, L, P, P],
        "ss_spread_expand": [P, L, P, I, ctypes.c_uint, PP, PP, IP, P],
        "ss_merge_tile_rows": [I, IP],
        "ss_merge_splits": [I, IP, IP, PP, PP, PP, PP, P, P, L, L, L, P, P],
        "ss_merge_sorted": [I, IP, IP, PP, PP, PP, PP, I, PP, PP, PP, IP, P,
                            P, L, P, P],
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


def addr_array(addresses) -> ctypes.Array:
    """A C array of device addresses (0 for a null pointer)."""
    return (ctypes.c_void_p * len(addresses))(*addresses)


def ptr_array(tensors) -> ctypes.Array:
    return addr_array([t.data_ptr() for t in tensors])


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
