"""Type system of the PyTorch port.

The same 13 logical types as ``supersonic_tpu/types.py`` (reference:
supersonic/proto/supersonic.proto:5-22, base/infrastructure/types.h), with
a ``DataType -> torch.dtype`` map in place of the jnp one.  This is the
port's own copy: importing anything from ``supersonic_tpu`` runs that
package's ``__init__``, which imports JAX.

The port carries all 13: INT32, INT64, FLOAT, DOUBLE, BOOL, DATE (int32
days), DATETIME (int64 microseconds), ENUM (int32 index into the
attribute's ``EnumDefinition``), DATA_TYPE (int32 codes), STRING and BINARY
as int32 codes into a sorted host dictionary, and the unsigned types in
signed lanes, since torch's unsigned dtypes take too few operations:

  * UINT32 in int64 lanes holding 0 .. 2^32 - 1.  Every operation whose
    result type is UINT32 masks to the low 32 bits (``wrap_u32``), so
    arithmetic wraps modulo 2^32 as the JAX package's uint32 does, and
    compares, divisions and casts need nothing more.
  * UINT64 as int64 bit patterns.  Sums and products wrap alike; compares
    flip the sign bit, division, modulus and right shifts take the
    unsigned forms of this module, and a cast to a float splits the word
    (``convert``).

``Table.from_numpy`` takes np.uint32/np.uint64 arrays and ``to_numpy``
gives them back.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class DataType(enum.Enum):
    """The 13 logical column types (reference: proto/supersonic.proto:5-22)."""

    INT32 = "INT32"
    INT64 = "INT64"
    UINT32 = "UINT32"
    UINT64 = "UINT64"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BOOL = "BOOL"
    DATE = "DATE"
    DATETIME = "DATETIME"
    STRING = "STRING"
    BINARY = "BINARY"
    ENUM = "ENUM"
    DATA_TYPE = "DATA_TYPE"


INT32 = DataType.INT32
INT64 = DataType.INT64
UINT32 = DataType.UINT32
UINT64 = DataType.UINT64
FLOAT = DataType.FLOAT
DOUBLE = DataType.DOUBLE
BOOL = DataType.BOOL
DATE = DataType.DATE
DATETIME = DataType.DATETIME
STRING = DataType.STRING
BINARY = DataType.BINARY
ENUM = DataType.ENUM


@dataclass(frozen=True)
class TypeTraits:
    """Runtime traits for one DataType (reference: types.h:226 TypeInfo)."""

    dtype: np.dtype          # host dtype of the value array
    is_numeric: bool
    is_integer: bool
    is_floating: bool
    is_variable_length: bool  # dictionary-encoded
    is_signed: bool


_TRAITS: dict[DataType, TypeTraits] = {
    DataType.INT32: TypeTraits(np.dtype(np.int32), True, True, False, False, True),
    DataType.INT64: TypeTraits(np.dtype(np.int64), True, True, False, False, True),
    DataType.UINT32: TypeTraits(np.dtype(np.uint32), True, True, False, False, False),
    DataType.UINT64: TypeTraits(np.dtype(np.uint64), True, True, False, False, False),
    DataType.FLOAT: TypeTraits(np.dtype(np.float32), True, False, True, False, True),
    DataType.DOUBLE: TypeTraits(np.dtype(np.float64), True, False, True, False, True),
    DataType.BOOL: TypeTraits(np.dtype(np.bool_), False, False, False, False, False),
    DataType.DATE: TypeTraits(np.dtype(np.int32), False, False, False, False, True),
    DataType.DATETIME: TypeTraits(np.dtype(np.int64), False, False, False, False, True),
    DataType.STRING: TypeTraits(np.dtype(np.int32), False, False, False, True, True),
    DataType.BINARY: TypeTraits(np.dtype(np.int32), False, False, False, True, True),
    DataType.ENUM: TypeTraits(np.dtype(np.int32), False, False, False, False, True),
    DataType.DATA_TYPE: TypeTraits(np.dtype(np.int32), False, False, False, False, True),
}

_TORCH: dict[DataType, torch.dtype] = {
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.UINT32: torch.int64,  # 0 .. 2^32 - 1; see module docstring
    DataType.UINT64: torch.int64,  # bit patterns
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
    DataType.BOOL: torch.bool,
    DataType.DATE: torch.int32,      # days since the epoch
    DataType.DATETIME: torch.int64,  # microseconds since the epoch
    DataType.STRING: torch.int32,    # dictionary codes
    DataType.BINARY: torch.int32,
    DataType.ENUM: torch.int32,      # index into the EnumDefinition
    DataType.DATA_TYPE: torch.int32,  # index into DataType
}


def traits(t: DataType) -> TypeTraits:
    return _TRAITS[t]


def physical_dtype(t: DataType) -> np.dtype:
    """The host numpy dtype of a DataType's value array."""
    return _TRAITS[t].dtype


def check_column_type(t: DataType) -> None:
    """Raise for a value that is not a DataType."""
    if not isinstance(t, DataType):
        raise TypeError(f"{t!r} is not a DataType")


def torch_dtype(t: DataType) -> torch.dtype:
    """The torch dtype of the on-device value array for a DataType."""
    return _TORCH[t]


# -- the unsigned carriers ---------------------------------------------------

U32_MASK = 0xFFFFFFFF
I64_MIN = -(1 << 63)


def to_carrier(values: np.ndarray, t: DataType) -> np.ndarray:
    """A host value array (of ``physical_dtype(t)``) as the array the
    device lane holds: UINT32 widened to int64, UINT64 viewed as int64."""
    if t == DataType.UINT32:
        return values.astype(np.int64)
    if t == DataType.UINT64:
        return values.view(np.int64)
    return values


def from_carrier(values: np.ndarray, t: DataType) -> np.ndarray:
    """The inverse of ``to_carrier`` on host arrays."""
    if t == DataType.UINT32:
        return values.astype(np.uint32)
    if t == DataType.UINT64:
        return values.view(np.uint64)
    return values


def wrap_u32(x: torch.Tensor) -> torch.Tensor:
    """An int64 lane reduced modulo 2^32: a UINT32 result."""
    return x & U32_MASK


def u64_key(x: torch.Tensor) -> torch.Tensor:
    """UINT64 bits -> int64 whose signed order is the unsigned order
    (x + 2^63, wrapping: the JAX package's ``monotone_code``)."""
    return x ^ I64_MIN


def u64_shr(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of UINT64 bits; a shift past 63 (or a UINT64
    amount past 2^63, negative here) gives 0, as XLA's does."""
    s = torch.as_tensor(s, device=x.device).to(torch.int64)
    k = s.clamp(0, 63)
    keep = torch.where(k == 0, -1, (torch.ones_like(k) << (64 - k)) - 1)
    return torch.where((s < 0) | (s > 63), 0, (x >> k) & keep)


def u64_divmod(a: torch.Tensor, b: torch.Tensor):
    """Unsigned (a // b, a % b) of UINT64 bits, b != 0: a long division of
    a / 2 by b, then one correction step (Hacker's Delight 9-3)."""
    big = b < 0  # divisor >= 2^63: the quotient is 0 or 1
    bs = torch.where(big, 1, b)
    q = torch.div(u64_shr(a, 1), bs, rounding_mode="floor") << 1
    r = a - q * bs
    q = q + (u64_key(r) >= u64_key(bs)).to(torch.int64)
    q = torch.where(big, (u64_key(a) >= u64_key(b)).to(torch.int64), q)
    return q, a - q * b


def _u64_to_float(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """UINT64 bits -> float32/64, rounded once: a word past 2^63 halves
    with its low bit kept sticky (round to odd), converts and doubles."""
    neg = x < 0
    half = u64_shr(x, 1) | (x & 1)
    return torch.where(neg, half.to(dt) * 2, x.to(dt))


_INT_RANGE = {DataType.INT32: (-(1 << 31), (1 << 31) - 1),
              DataType.INT64: (-(1 << 63), (1 << 63) - 1),
              DataType.UINT32: (0, (1 << 32) - 1),
              DataType.UINT64: (0, (1 << 64) - 1)}


def _float_to_int(x: torch.Tensor, dst: DataType) -> torch.Tensor:
    """XLA's float -> integer convert on every device: truncate toward
    zero, saturate at the type's range, NaN -> 0 (torch's own ``.to`` of
    NaN or an out-of-range value differs between CPU and CUDA)."""
    lo, hi = _INT_RANGE.get(dst) or _INT_RANGE[
        DataType.INT32 if torch_dtype(dst) == torch.int32 else DataType.INT64]
    x = torch.nan_to_num(x.double(), nan=0.0).trunc()
    lo_f, hi_f = float(lo), float(hi)  # hi rounds up to 2^31/2^32/2^63/2^64
    if dst == DataType.UINT64:
        top = x >= 2.0 ** 63
        low = x.clamp(0.0, 2.0 ** 63 - 1024).to(torch.int64)
        high = ((x - 2.0 ** 63).clamp(0.0, 2.0 ** 63 - 2048)
                .to(torch.int64) ^ I64_MIN)
        out = torch.where(top, high, low)
        return torch.where(x >= 2.0 ** 64, -1, out)
    out = x.clamp(lo_f, hi_f if hi < 2**53 else 2.0 ** 63 - 1024)
    out = out.to(torch.int64)
    if hi >= 2**53:
        out = torch.where(x >= hi_f, hi, out)
    return out.to(torch_dtype(dst))


def convert(values: torch.Tensor, src: DataType, dst: DataType):
    """``values`` of type ``src`` as type ``dst``, with the JAX package's
    ``astype`` result: integers wrap, floats truncate and saturate, and the
    unsigned carriers convert by value."""
    dt = torch_dtype(dst)
    if src == dst:
        return values
    if dst in (DataType.FLOAT, DataType.DOUBLE):
        if src == DataType.UINT64:
            return _u64_to_float(values, dt)
        return values.to(dt)
    if dst == DataType.BOOL:
        return values != 0
    if values.is_floating_point():
        return _float_to_int(values, dst)
    if dst == DataType.UINT32:
        return wrap_u32(values.to(torch.int64))
    return values.to(dt)


def is_numeric(t: DataType) -> bool:
    return _TRAITS[t].is_numeric


def is_integer(t: DataType) -> bool:
    return _TRAITS[t].is_integer


def is_floating(t: DataType) -> bool:
    return _TRAITS[t].is_floating


def is_variable_length(t: DataType) -> bool:
    return _TRAITS[t].is_variable_length


# Numeric promotion (reference: bound_expression_factory.cc coercion rules),
# the same lattice as supersonic_tpu/types.py.
_PROMOTION_TABLE: dict[frozenset, DataType] = {}


def _fill_promotions() -> None:
    N = [DataType.INT32, DataType.UINT32, DataType.INT64, DataType.UINT64,
         DataType.FLOAT, DataType.DOUBLE]
    for a in N:
        _PROMOTION_TABLE[frozenset([a])] = a

    def put(a, b, r):
        _PROMOTION_TABLE[frozenset([a, b])] = r
    put(DataType.INT32, DataType.UINT32, DataType.INT64)
    put(DataType.INT32, DataType.INT64, DataType.INT64)
    put(DataType.INT32, DataType.UINT64, DataType.INT64)
    put(DataType.INT32, DataType.FLOAT, DataType.FLOAT)
    put(DataType.INT32, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.UINT32, DataType.INT64, DataType.INT64)
    put(DataType.UINT32, DataType.UINT64, DataType.UINT64)
    put(DataType.UINT32, DataType.FLOAT, DataType.FLOAT)
    put(DataType.UINT32, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.INT64, DataType.UINT64, DataType.INT64)
    put(DataType.INT64, DataType.FLOAT, DataType.FLOAT)
    put(DataType.INT64, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.UINT64, DataType.FLOAT, DataType.FLOAT)
    put(DataType.UINT64, DataType.DOUBLE, DataType.DOUBLE)
    put(DataType.FLOAT, DataType.DOUBLE, DataType.DOUBLE)


_fill_promotions()


class TypeError_(Exception):
    """Bind-time type error (reference: ERROR_ATTRIBUTE_TYPE_MISMATCH)."""


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    if not (is_numeric(a) and is_numeric(b)):
        raise TypeError_(f"no numeric promotion between {a} and {b}")
    return _PROMOTION_TABLE[frozenset([a, b])]
