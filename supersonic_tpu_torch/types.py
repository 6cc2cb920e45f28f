"""Type system of the PyTorch port.

The same 13 logical types as ``supersonic_tpu/types.py`` (reference:
supersonic/proto/supersonic.proto:5-22, base/infrastructure/types.h), with
a ``DataType -> torch.dtype`` map in place of the jnp one.  This is the
port's own copy: importing anything from ``supersonic_tpu`` runs that
package's ``__init__``, which imports JAX.

The port carries columns of INT32, INT64, FLOAT, DOUBLE, BOOL, DATE (int32
days), DATETIME (int64 microseconds), ENUM (int32 index into the
attribute's ``EnumDefinition``), and STRING and BINARY as int32 codes into
a sorted host dictionary.  UINT64 appears only as the default output type
of COUNT; it is stored as int64 (counts never reach 2^63) and read back as
uint64 by ``Table.to_numpy``.  UINT32 and UINT64 columns stay out: torch's
unsigned dtypes take too few operations (ROADMAP.md queue 1 item 1).
DATA_TYPE raises too, naming item 14.
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

# Column types the port carries.
COLUMN_TYPES = (DataType.INT32, DataType.INT64, DataType.FLOAT,
                DataType.DOUBLE, DataType.BOOL, DataType.DATE,
                DataType.DATETIME, DataType.STRING, DataType.BINARY,
                DataType.ENUM)

_TORCH: dict[DataType, torch.dtype] = {
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.UINT64: torch.int64,  # COUNT output only; see module docstring
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
    DataType.BOOL: torch.bool,
    DataType.DATE: torch.int32,      # days since the epoch
    DataType.DATETIME: torch.int64,  # microseconds since the epoch
    DataType.STRING: torch.int32,    # dictionary codes
    DataType.BINARY: torch.int32,
    DataType.ENUM: torch.int32,      # index into the EnumDefinition
}


def traits(t: DataType) -> TypeTraits:
    return _TRAITS[t]


def physical_dtype(t: DataType) -> np.dtype:
    """The host numpy dtype of a DataType's value array."""
    return _TRAITS[t].dtype


def check_column_type(t: DataType) -> None:
    """Raise for a column type the port does not carry yet."""
    if t in (DataType.UINT32, DataType.UINT64):
        raise NotImplementedError(
            f"{t.value} columns are not ported yet (ROADMAP.md queue 1 "
            "item 1: torch's unsigned dtypes take too few operations)")
    if t not in COLUMN_TYPES:
        raise NotImplementedError(
            f"{t.value} columns are not ported yet (ROADMAP.md queue 1 "
            "item 14: full expression engine and its types)")


def torch_dtype(t: DataType) -> torch.dtype:
    """The torch dtype of the on-device value array for a DataType."""
    if t not in _TORCH:
        check_column_type(t)
    return _TORCH[t]


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
