"""Sortable/groupable key encoding.

Port of ``monotone_code``, ``descending_code``, ``key_operands``,
``_f32_code`` (as ``f32_code``),
``group_code_columns`` and ``_check_keyable`` from
``supersonic_tpu/ops/keys.py``: every key column maps to a code whose
order equals the reference comparator's order on the values (sort.cc:
150-161), so a multi-key sort is a series of stable sorts over codes.
STRING/BINARY codes are already ordered: dictionaries are sorted.  The
merge's coding of keys into compare words lives beside its kernel
(``kernels/merge_sorted.py::key_words``).
"""
from __future__ import annotations

import torch

from ..dictionary import DeferredDictionary
from ..schema import SchemaError
from ..types import DataType, u64_key


def monotone_code(values: torch.Tensor, type_: DataType) -> torch.Tensor:
    """Integers stay as they are (UINT32 already lies in int64 lanes);
    UINT64 bits shift into the signed range (+2^63, wrapping); floats stay
    floats with -0.0 normalized to +0.0 (so the two compare equal, like C++
    ``<``); BOOL maps to int32."""
    if type_ in (DataType.FLOAT, DataType.DOUBLE):
        return torch.where(values == 0, torch.zeros_like(values), values)
    if type_ == DataType.UINT64:
        return u64_key(values)
    if type_ == DataType.BOOL:
        return values.to(torch.int32)
    return values


def f32_code(values: torch.Tensor) -> torch.Tensor:
    """FLOAT -> int32 in the signed IEEE total order of its bits (the JAX
    package's ``sort._f32_code``): the low 31 bits of a negative word flip,
    so -0.0 sorts before +0.0 and a NaN sorts by its sign bit and payload
    (a negative NaN first, a positive one last)."""
    i = values.view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def descending_code(code: torch.Tensor) -> torch.Tensor:
    """Order-reversing transform for DESC keys: bitwise-not for integers,
    negation for floats (NaNs keep sorting last either way)."""
    if code.is_floating_point():
        return -code
    return ~code


def key_lanes(table, names, ascendings, float_bits: bool = False) -> list:
    """Per key [null_rank?, code], most significant first: ascending order
    over the tuple is the reference's multi-column order, NULL first
    ascending and last descending (sort.cc:44-47).  The null rank is
    emitted only for nullable columns, and the code is zeroed under NULL.
    ``float_bits`` codes a FLOAT key by ``f32_code`` (``sort_table``'s
    order, as the JAX package's) instead of ``monotone_code``."""
    lanes = []
    for name, asc in zip(names, ascendings):
        _check_keyable(table, name)
        c = table.columns[name]
        type_ = table.schema.lookup(name).type
        code = (f32_code(c.values) if float_bits and type_ == DataType.FLOAT
                else monotone_code(c.values, type_))
        if not asc:
            code = descending_code(code)
        if c.valid is not None:
            lanes.append((c.valid if asc else ~c.valid).to(torch.int32))
            code = torch.where(c.valid, code, torch.zeros_like(code))
        lanes.append(code)
    return lanes


def key_operands(table, names, ascendings, pad_mask=None,
                 float_bits: bool = False) -> list:
    """[pad_rank] + ``key_lanes``, where rows of ``pad_mask`` (default: rows
    past num_rows) rank 1 and sort last."""
    if pad_mask is None:
        pad_mask = ~table.row_mask()
    return [pad_mask.to(torch.int32)] + key_lanes(table, names, ascendings,
                                                  float_bits)


def _check_keyable(table, name: str) -> None:
    """Sort/group/join keys need order-preserving (or at least value-unique)
    codes; a CONCAT result's deferred dictionary is neither (its codes are
    group ids assigned before the strings exist)."""
    if isinstance(table.dicts.get(name), DeferredDictionary):
        raise SchemaError(
            f"column {name!r} holds a runtime-resolved CONCAT result; it "
            "cannot be used as a sort/group/join key (codes are not "
            "order-preserving). Materialize the result first.")


def group_code_columns(table, names) -> list:
    """Per key ``(null_rank or None, code)`` for equality-based grouping:
    equal pairs are the reference's key equality (NULL == NULL, -0.0 ==
    +0.0).  The null rank (1 valid, 0 NULL) is None for a non-nullable
    column, and the code is zeroed under NULL."""
    pairs = []
    for name in names:
        _check_keyable(table, name)
        c = table.columns[name]
        code = monotone_code(c.values, table.schema.lookup(name).type)
        if c.valid is None:
            pairs.append((None, code))
        else:
            pairs.append((c.valid.to(torch.int32),
                          torch.where(c.valid, code, torch.zeros_like(code))))
    return pairs
