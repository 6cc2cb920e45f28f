"""Pure-python reference engine for differential testing.

Plays the role of the reference's std::map cross-checks (test/guide/
primer.cc:302-313) and the OperationTest expected-stream builder: simple,
obviously-correct row-at-a-time implementations of the operator semantics
(SQL NULL rules, NULL-first-ascending sort order, insertion-order
grouping, NULL join keys never matching).  Rows are python tuples; None
is NULL.

A copy of ``supersonic_tpu/reference/ref_engine.py``: that module is
numpy- and JAX-free, but importing it runs ``supersonic_tpu/__init__.py``,
which imports JAX, so the port keeps its own.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence


def filter_rows(rows, pred: Callable) -> list:
    """pred(row) -> True/False/None; None (NULL) counts as false."""
    return [r for r in rows if pred(r) is True]


class _Desc:
    """Reverse-ordering wrapper (descending keys)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def sort_rows(rows, keys: Sequence[tuple[int, bool]]) -> list:
    """keys: [(column_index, ascending)]; stable; NULL == NULL and
    NULL < non-NULL ascending (reference: sort.cc:44-47)."""

    def composite(r):
        out = []
        for idx, asc in keys:
            v = r[idx]
            if v is None:
                out.append((0 if asc else 1, _Desc(0) if not asc else 0))
            else:
                out.append((1 if asc else 0, v if asc else _Desc(v)))
        return tuple(out)

    return sorted(rows, key=composite)


_FIRST_UNSET = object()


def group_aggregate(rows, key_idx: Sequence[int],
                    aggs: Sequence[tuple[str, Optional[int]]]) -> list:
    """aggs: [(kind, column_index_or_None)], kind in sum/min/max/count/
    count_star/first/last.  Output: key values + agg values per group, in
    key insertion order; NULL == NULL groups together."""
    order: list = []
    state: dict = {}
    for r in rows:
        k = tuple(r[i] for i in key_idx)
        if k not in state:
            state[k] = [_FIRST_UNSET] * len(aggs)
            order.append(k)
        st = state[k]
        for j, (kind, ci) in enumerate(aggs):
            v = r[ci] if ci is not None else None
            cur = st[j]
            if kind == "count_star":
                st[j] = 1 if cur is _FIRST_UNSET else cur + 1
            elif kind == "count":
                base = 0 if cur is _FIRST_UNSET else cur
                st[j] = base + (1 if v is not None else 0)
            elif kind == "sum":
                if v is not None:
                    st[j] = v if cur in (_FIRST_UNSET, None) else cur + v
                elif cur is _FIRST_UNSET:
                    st[j] = None
            elif kind == "min":
                if v is not None:
                    st[j] = v if cur in (_FIRST_UNSET, None) else min(cur, v)
                elif cur is _FIRST_UNSET:
                    st[j] = None
            elif kind == "max":
                if v is not None:
                    st[j] = v if cur in (_FIRST_UNSET, None) else max(cur, v)
                elif cur is _FIRST_UNSET:
                    st[j] = None
            elif kind == "first":
                if cur is _FIRST_UNSET:
                    st[j] = v
            elif kind == "last":
                st[j] = v
            else:
                raise ValueError(kind)
    return [tuple(k) + tuple(state[k]) for k in order]


def hash_join(lhs, rhs, lkey: int, rkey: int, left_outer: bool,
              rhs_width: Optional[int] = None) -> list:
    """NULL keys never match; matches emitted in (lhs order, rhs order)."""
    width = rhs_width if rhs_width is not None else (
        len(rhs[0]) if rhs else 0)
    out = []
    for lr in lhs:
        lk = lr[lkey]
        matches = ([] if lk is None
                   else [rr for rr in rhs if rr[rkey] == lk])
        if matches:
            for rr in matches:
                out.append(tuple(lr) + tuple(rr))
        elif left_outer:
            out.append(tuple(lr) + (None,) * width)
    return out
