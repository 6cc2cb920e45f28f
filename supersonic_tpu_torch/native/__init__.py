"""Host-side C++ helpers of the port, loaded with ctypes.

The port's own copy of the CONCAT assembly of
``supersonic_tpu/native/fastcol.cpp`` (``concat.cpp``).  It is built
with ``g++`` at its first use into ``supersonic_tpu_torch/_build/`` (named
by a hash of the source), never into the source tree; nothing is built on
import.  Without a host compiler ``concat_groups`` returns None and the
caller takes its Python loop.  This is host code, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "concat.cpp"
_BUILD = _SRC.parent.parent / "_build"
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = _BUILD / f"libconcat_{digest}.so"
        try:
            if not so.exists():
                _BUILD.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                                str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            return None
        I64P = ctypes.POINTER(ctypes.c_int64)
        lib.concat_groups.restype = ctypes.c_int64
        lib.concat_groups.argtypes = [
            ctypes.c_char_p, I64P, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, I64P, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_uint8, I64P, ctypes.c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ assembly is built (it is built by this call)."""
    return _load() is not None


def concat_groups(dict_blob: bytes, dict_offsets: np.ndarray,
                  codes: np.ndarray, valid, group_starts: np.ndarray,
                  separator: bytes, distinct: bool):
    """Each group's valid payloads joined by ``separator`` in row order:
    (bytes, int64 lengths a group, -1 for an all-NULL group), or None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    g = len(group_starts) - 1
    I64P = ctypes.POINTER(ctypes.c_int64)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    dict_offsets = np.ascontiguousarray(dict_offsets, dtype=np.int64)
    group_starts = np.ascontiguousarray(group_starts, dtype=np.int64)
    lens = np.empty(max(g, 1), dtype=np.int64)
    valid_ptr = None
    if valid is not None:
        valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
        valid_ptr = valid_u8.ctypes.data_as(ctypes.c_char_p)
    args = [dict_blob, dict_offsets.ctypes.data_as(I64P),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), valid_ptr,
            group_starts.ctypes.data_as(I64P), g, separator, len(separator),
            1 if distinct else 0]
    total = lib.concat_groups(*args, lens.ctypes.data_as(I64P), None)
    out = ctypes.create_string_buffer(max(int(total), 1))
    lib.concat_groups(*args, None, out)
    return out.raw[:total], lens[:g]
