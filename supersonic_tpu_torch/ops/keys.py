"""Sortable/groupable key encoding.

Port of ``monotone_code``, ``descending_code`` and ``key_operands`` from
``supersonic_tpu/ops/keys.py``: every key column maps to a code whose
order equals the reference comparator's order on the values (sort.cc:
150-161), so a multi-key sort is a series of stable sorts over codes.
STRING/BINARY codes are already ordered: dictionaries are sorted.
``sortable_words`` is the counterpart of ``_sortable_i32`` of
``supersonic_tpu/ops/merge.py``: one signed integer lane per key operand,
for the merge kernel's integer compares.
"""
from __future__ import annotations

import torch

from ..types import DataType

# float dtype -> (same-width int dtype, bits of +qNaN, all bits but the sign)
_FLOAT_BITS = {
    torch.float32: (torch.int32, 0x7FC00000, 0x7FFFFFFF),
    torch.float64: (torch.int64, 0x7FF8000000000000, 0x7FFFFFFFFFFFFFFF),
}


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


def key_lanes(table, names, ascendings, words: bool = False) -> list:
    """Per key [null_rank?, code], most significant first: ascending order
    over the tuple is the reference's multi-column order, NULL first
    ascending and last descending (sort.cc:44-47).  The null rank is
    emitted only for nullable columns, and the code is zeroed under NULL.
    With ``words`` every code is its ``sortable_words`` lane, and a float
    code is taken from the raw values: ``sortable_words`` canonicalizes
    -0.0 once, after the DESC negation."""
    lanes = []
    for name, asc in zip(names, ascendings):
        c = table.columns[name]
        code = c.values
        if not (words and code.is_floating_point()):
            code = monotone_code(code, table.schema.lookup(name).type)
        if not asc:
            code = descending_code(code)
        if c.valid is not None:
            lanes.append((c.valid if asc else ~c.valid).to(torch.int32))
            code = torch.where(c.valid, code, torch.zeros_like(code))
        lanes.append(sortable_words(code) if words else code)
    return lanes


def key_operands(table, names, ascendings, pad_mask=None) -> list:
    """[pad_rank] + ``key_lanes``, where rows of ``pad_mask`` (default: rows
    past num_rows) rank 1 and sort last."""
    if pad_mask is None:
        pad_mask = ~table.row_mask()
    return [pad_mask.to(torch.int32)] + key_lanes(table, names, ascendings)


def sortable_words(op: torch.Tensor) -> torch.Tensor:
    """A key operand as one signed integer lane of the same order: int32
    and int64 stay, BOOL becomes int32, and f32/f64 become their signed
    total-order bits in int32/int64 after every NaN becomes +qNaN and -0.0
    becomes +0.0.  So NaNs sort last and equal each other and the zeros tie,
    as in ``lax.sort`` and ``torch.sort``, on either device; run it after
    ``descending_code``, whose negation flips the sign of NaNs and zeros."""
    if op.dtype == torch.bool:
        return op.to(torch.int32)
    if not op.is_floating_point():
        return op
    idt, qnan, magnitude = _FLOAT_BITS[op.dtype]
    bits = torch.where(op.isnan(), qnan,
                       torch.where(op == 0, 0, op.view(idt)))
    # negatives: flip all but the sign bit, so larger magnitudes rank lower
    return torch.where(bits >= 0, bits, bits ^ magnitude)
