"""Host-side C++ helpers of the port, loaded with ctypes.

The port's own copies of four functions of
``supersonic_tpu/native/fastcol.cpp``: the CONCAT assembly
(``concat.cpp``), and the dictionary encoder, the payload gather and the
k-way merge of the file format and the external sort (``fastcol.cpp``).
Both sources are built with ``g++`` at their first use into one library
in ``supersonic_tpu_torch/_build/`` (named by a hash of the sources),
never into the source tree; nothing is built on import.  Without a host
compiler every wrapper returns None and its caller takes its Python
route, as the JAX package's do.  This is host code, not a device kernel.
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

_HERE = pathlib.Path(__file__).resolve().parent
_SRCS = (_HERE / "concat.cpp", _HERE / "fastcol.cpp")
_BUILD = _HERE.parent / "_build"
_lock = threading.Lock()
_lib = None
_tried = False

I64P = ctypes.POINTER(ctypes.c_int64)
I32P = ctypes.POINTER(ctypes.c_int32)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        digest = hashlib.sha256(
            b"".join(s.read_bytes() for s in _SRCS)).hexdigest()[:16]
        so = _BUILD / f"libfastcol_{digest}.so"
        try:
            if not so.exists():
                _BUILD.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                                *map(str, _SRCS), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.concat_groups.restype = ctypes.c_int64
        lib.concat_groups.argtypes = [
            ctypes.c_char_p, I64P, I32P, ctypes.c_char_p, I64P,
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint8,
            I64P, ctypes.c_char_p]
        lib.dict_encode.restype = ctypes.c_int64
        lib.dict_encode.argtypes = [
            ctypes.c_char_p, I64P, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), I32P, I64P]
        lib.gather_blob.restype = None
        lib.gather_blob.argtypes = [
            ctypes.c_char_p, I64P, I32P, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p]
        lib.kway_merge_u64.restype = None
        lib.kway_merge_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, I64P,
            ctypes.c_int64, I64P]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the C++ library is built (it is built by this call)."""
    return _load() is not None


def _valid_ptr(valid):
    if valid is None:
        return None, None
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    return valid_u8, valid_u8.ctypes.data_as(ctypes.c_char_p)


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
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    dict_offsets = np.ascontiguousarray(dict_offsets, dtype=np.int64)
    group_starts = np.ascontiguousarray(group_starts, dtype=np.int64)
    lens = np.empty(max(g, 1), dtype=np.int64)
    _keep, valid_ptr = _valid_ptr(valid)
    args = [dict_blob, dict_offsets.ctypes.data_as(I64P),
            codes.ctypes.data_as(I32P), valid_ptr,
            group_starts.ctypes.data_as(I64P), g, separator, len(separator),
            1 if distinct else 0]
    total = lib.concat_groups(*args, lens.ctypes.data_as(I64P), None)
    out = ctypes.create_string_buffer(max(int(total), 1))
    lib.concat_groups(*args, None, out)
    return out.raw[:total], lens[:g]


def dict_encode_bytes(blob: bytes, offsets: np.ndarray, valid: np.ndarray):
    """n strings (``blob`` cut at int64 ``offsets[n + 1]``) as (int32
    codes[n] into the distinct values sorted bytewise, int64 rows[d] holding
    each value), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    n = len(offsets) - 1
    codes = np.zeros(n, dtype=np.int32)
    dict_rows = np.zeros(max(n, 1), dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n_distinct = lib.dict_encode(
        blob, offsets.ctypes.data_as(I64P), n,
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        codes.ctypes.data_as(I32P), dict_rows.ctypes.data_as(I64P))
    return codes, dict_rows[:n_distinct]


def gather_blob_bytes(dict_blob: bytes, dict_offsets: np.ndarray,
                      codes: np.ndarray, valid, total: int):
    """The dictionary payloads of each row's code, concatenated in row
    order (NULL rows add nothing; ``total`` bytes in all), or None without
    the library."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(max(total, 1))
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    dict_offsets = np.ascontiguousarray(dict_offsets, dtype=np.int64)
    _keep, valid_ptr = _valid_ptr(valid)
    lib.gather_blob(dict_blob, dict_offsets.ctypes.data_as(I64P),
                    codes.ctypes.data_as(I32P), valid_ptr, len(codes), out)
    return out.raw[:total]


def kway_merge(codes: np.ndarray, starts: np.ndarray):
    """The merged order of k sorted runs: ``codes`` is [n, m] uint64 lanes
    (ascending lexicographic order is the output order), ``starts`` the
    int64[k + 1] run offsets.  Returns int64[n] row ids, ties by run, or
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    if codes.ndim == 1:
        codes = codes[:, None]
    n, m = codes.shape
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    lib.kway_merge_u64(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), m,
        starts.ctypes.data_as(I64P), len(starts) - 1,
        out.ctypes.data_as(I64P))
    return out
