"""Sortable/groupable key encoding.

Port of ``monotone_code`` and ``descending_code`` from
``supersonic_tpu/ops/keys.py``: every key column maps to a code whose
order equals the reference comparator's order on the values (sort.cc:
150-161), so a multi-key sort is a series of stable sorts over codes.
"""
from __future__ import annotations

import torch

from ..types import DataType


def monotone_code(values: torch.Tensor, type_: DataType) -> torch.Tensor:
    """Integers stay as they are; floats stay floats with -0.0 normalized
    to +0.0 (so the two compare equal, like C++ ``<``); BOOL maps to
    int32."""
    if type_ in (DataType.FLOAT, DataType.DOUBLE):
        return torch.where(values == 0, torch.zeros_like(values), values)
    if type_ == DataType.BOOL:
        return values.to(torch.int32)
    return values


def descending_code(code: torch.Tensor) -> torch.Tensor:
    """Order-reversing transform for DESC keys: bitwise-not for integers,
    negation for floats (NaNs keep sorting last either way)."""
    if code.is_floating_point():
        return -code
    return ~code
