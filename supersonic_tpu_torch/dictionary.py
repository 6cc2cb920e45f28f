"""Host-side dictionaries for variable-length columns.

The reference stores STRING/BINARY values inline in per-column Arenas with
StringPiece pointers (reference: base/infrastructure/block.h:196-284,
base/memory/arena.h).  The engine dictionary-encodes them: the device
column is int32 *codes*, and the dictionary (code -> bytes) lives on the
host.  This is the PyTorch port's copy of ``supersonic_tpu/dictionary.py``
(numpy only; the native bulk encoder is not carried over).

Dictionaries are built **order-preserving** (codes sorted lexicographically)
so that ORDER BY and comparisons on the codes match ORDER BY on the strings,
which is what makes sort/compare pure device ops (SURVEY.md §7.3 strings).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Dictionary:
    """Immutable code->value map. values[code] is the decoded Python value."""

    values: tuple  # tuple of str or bytes, sorted ascending => order-preserving
    # (weak ref to the last dictionary ``codes_in`` mapped into, its map)
    _codes_in: list = field(default_factory=list, init=False, repr=False,
                            compare=False)

    def __len__(self) -> int:
        return len(self.values)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """The value of each code, None where a code is out of range."""
        n = len(self.values)
        vals = np.empty(n + 1, dtype=object)
        vals[:n] = self.values
        c = np.asarray(codes).astype(np.int64)
        return vals[np.where((c >= 0) & (c < n), c, n)]

    def lookup(self, value) -> int:
        """Code for value, or -1 if absent."""
        import bisect

        i = bisect.bisect_left(self.values, value)
        if i < len(self.values) and self.values[i] == value:
            return i
        return -1

    def is_sorted(self) -> bool:
        return all(self.values[i] <= self.values[i + 1] for i in range(len(self.values) - 1))

    def codes_in(self, other: "Dictionary") -> np.ndarray:
        """int32 map of this dictionary's codes into ``other``'s, -1 where
        ``other`` lacks the value (at least one entry).  It takes a host
        pass over both, so the map into the last ``other`` is kept for the
        next call (a plan bound again over the same tables)."""
        last = self._codes_in
        if last and last[0]() is other:
            return last[1]
        index = {v: i for i, v in enumerate(other.values)}
        out = np.fromiter((index.get(v, -1) for v in self.values), np.int32,
                          len(self.values))
        if not out.size:
            out = np.zeros(1, dtype=np.int32)
        last[:] = [weakref.ref(other), out]
        return out


class DeferredDictionary(Dictionary):
    """Dictionary whose values are produced by the RUN, not the bind
    (reference analogue: CONCAT aggregation output strings, which the
    reference assembles per group at execution —
    aggregation_operators.h:235-283).

    Created empty at bind time so the column can flow through the plan as
    int32 codes; ``execute()`` resolves it from device aux outputs after
    the program runs.  NOT order-preserving: code order is group-key
    order, not lexicographic — sorting/grouping/joining on such a column
    is rejected at bind (see ops/keys.py).  Re-executing the same bound
    plan re-resolves the dictionary in place (cursor-like single-use
    results, matching the reference's consumed-cursor contract)."""

    def __init__(self):
        object.__setattr__(self, "values", ())
        object.__setattr__(self, "_codes_in", [])
        object.__setattr__(self, "resolved", False)

    def resolve(self, values) -> None:
        object.__setattr__(self, "values", tuple(values))
        object.__setattr__(self, "resolved", True)

    def _check(self):
        if not self.resolved:
            raise RuntimeError(
                "deferred dictionary not resolved — CONCAT results are "
                "only available after execute() has run the plan")

    def decode(self, codes: np.ndarray) -> np.ndarray:
        self._check()
        return super().decode(codes)

    def lookup(self, value) -> int:
        self._check()
        return super().lookup(value)

    def is_sorted(self) -> bool:
        # never order-preserving, even when the resolved values happen
        # to be sorted: consumers must not rely on code order
        return False


def encode(values) -> tuple[np.ndarray, np.ndarray, Dictionary]:
    """Encode a python/numpy sequence of strings into (codes, valid, dict).

    None entries become invalid rows (code 0).  The dictionary is sorted so
    code order == lexicographic order.
    """
    values = list(values)
    valid = np.array([v is not None for v in values], dtype=bool)
    present = sorted({v for v in values if v is not None})
    dict_ = Dictionary(tuple(present))
    index = {v: i for i, v in enumerate(present)}
    codes = np.array([index[v] if v is not None else 0 for v in values], dtype=np.int32)
    return codes, valid, dict_


def merge(a: Dictionary, b: Dictionary) -> tuple[Dictionary, np.ndarray, np.ndarray]:
    """Merge two dictionaries into one order-preserving dictionary.

    Returns (merged, remap_a, remap_b) where remap_x[old_code] = new_code.
    Used when unioning / coalescing tables with separately-encoded columns.
    """
    vals = sorted(set(a.values) | set(b.values))
    merged = Dictionary(tuple(vals))
    index = {v: i for i, v in enumerate(vals)}
    remap_a = np.array([index[v] for v in a.values], dtype=np.int32)
    remap_b = np.array([index[v] for v in b.values], dtype=np.int32)
    # Remaps must be non-empty for device gathers even when a dict is empty.
    if remap_a.size == 0:
        remap_a = np.zeros(1, dtype=np.int32)
    if remap_b.size == 0:
        remap_b = np.zeros(1, dtype=np.int32)
    return merged, remap_a, remap_b


def transform(d: Dictionary, fn) -> tuple[Dictionary, np.ndarray]:
    """Apply a per-value function (e.g. str.upper) to a dictionary.

    Returns (new_dict, remap) with remap[old_code] = new_code.  This is how
    unary string expressions run on the device: the O(|dict|) host transform happens
    at bind time, and evaluation is a single device gather through `remap`
    (reference string ops: expression/core/string_expressions.h, re-designed
    as code-indexed LUTs per SURVEY.md §2.5).
    """
    new_vals = [fn(v) for v in d.values]
    uniq = sorted(set(new_vals))
    nd = Dictionary(tuple(uniq))
    index = {v: i for i, v in enumerate(uniq)}
    remap = np.array([index[v] for v in new_vals], dtype=np.int32)
    if remap.size == 0:
        remap = np.zeros(1, dtype=np.int32)
    return nd, remap


class CrossSizeError(Exception):
    """Cross-product dictionary would exceed the configured size budget."""


def cross(a: Dictionary, b: Dictionary, fn=None,
          max_size: int = 1 << 20) -> tuple[Dictionary, np.ndarray]:
    """Combine two dictionaries value-by-value (default: concatenation).

    Returns (new_dict, lut) where lut[code_a * len(b) + code_b] is the new
    code of fn(a[code_a], b[code_b]).  This gives binary string expressions
    over two *non-constant* columns a dense device encoding: the O(|a|*|b|)
    combine runs on the host at bind time and evaluation is one device
    gather (reference: string_bound_expressions.cc Concat row loop,
    re-designed per SURVEY.md §2.5 strings-as-dictionary-codes).

    Raises CrossSizeError when |a|*|b| > max_size; callers fall back to the
    host materialization path (ops/host.py).
    """
    if fn is None:
        fn = lambda x, y: x + y
    la, lb = max(len(a), 1), max(len(b), 1)
    if la * lb > max_size:
        raise CrossSizeError(
            f"cross dictionary {len(a)}x{len(b)} exceeds budget {max_size}")
    if not a.values or not b.values:
        return Dictionary(()), np.zeros(la * lb, dtype=np.int32)
    combined = [fn(x, y) for x in a.values for y in b.values]
    uniq = sorted(set(combined))
    nd = Dictionary(tuple(uniq))
    index = {v: i for i, v in enumerate(uniq)}
    lut = np.fromiter((index[v] for v in combined), dtype=np.int32,
                      count=len(combined))
    return nd, lut


def property_lut(d: Dictionary, fn, dtype) -> np.ndarray:
    """Per-code scalar property LUT (e.g. len) for device-side gather."""
    if len(d.values) == 0:
        return np.zeros(1, dtype=dtype)
    return np.array([fn(v) for v in d.values], dtype=dtype)
