"""The comparison that decides ``correct``: each answer of the window against
the plain reference's answer to the same query and parameters.

An answer is a set of rows under an ORDER BY.  The rows are compared as a
set, matched by the reference's key columns (the GROUP BY keys, unique a
row), and the program's rows must come in the ORDER BY's order (rows that
tie on it may come in any order, as in SQL).  Exact columns must be equal;
the reference's ``approx`` columns (float sums and their quotients) are held
by their relative error, the largest of which is one number compared.
"""
from __future__ import annotations

import math

import numpy as np


def _cell(v):
    return v.item() if isinstance(v, np.generic) else v


def _rows(names, cols, n):
    return [tuple(_cell(cols[c][i]) for c in names) for i in range(n)]


def _ordered(rows, names, order) -> bool:
    idx = [(names.index(c), asc) for c, asc in order]
    for a, b in zip(rows, rows[1:]):
        for i, asc in idx:
            if a[i] == b[i]:
                continue
            if (a[i] < b[i]) != asc:
                return False
            break
    return True


def compare(names, cols, want) -> tuple:
    """(exact_ok, max_rel) of the program's answer ``cols`` (name -> host
    array, columns in ``names`` order) against the reference's ``want``
    (``reference.common.Answer``).  ``max_rel`` is the largest relative
    error of an approx column, 0.0 where there is none, inf where the rows
    cannot be matched."""
    if list(names) != list(want.columns):
        return False, math.inf
    n = len(next(iter(cols.values()))) if cols else 0
    if n != want.rows:
        return False, math.inf
    got = _rows(names, cols, n)
    ref = _rows(names, want.columns, n)
    if not _ordered(got, names, want.order):
        return False, math.inf
    kidx = [names.index(k) for k in want.keys]

    def by_key(r):
        return tuple(r[i] for i in kidx)

    got.sort(key=by_key)
    ref.sort(key=by_key)
    approx = {names.index(c) for c in want.approx}
    exact_ok, max_rel = True, 0.0
    for g, w in zip(got, ref):
        for i, (a, b) in enumerate(zip(g, w)):
            if i not in approx:
                exact_ok &= a == b
                continue
            a, b = float(a), float(b)
            if math.isnan(a) or math.isnan(b):
                rel = math.inf
            else:
                rel = abs(a - b) / abs(b) if b != 0 else abs(a - b)
            max_rel = max(max_rel, rel)
    return exact_ok, max_rel


def checks(results, limits: dict) -> dict:
    """The numbers compared over a run, each beside its limit.

    ``results``: one (raised, exact_ok, max_rel) a query of the window;
    ``limits``: the traffic file's ``limits``."""
    failed = sum(1 for raised, _, _ in results if raised)
    wrong = sum(1 for raised, ok, _ in results if not raised and not ok)
    out = {"failed_queries": {"value": failed, "limit": 0},
           "wrong_answers": {"value": wrong,
                             "limit": limits.get("wrong_answers", 0)}}
    if "max_rel_err" in limits:
        rel = max((r for raised, _, r in results if not raised),
                  default=0.0)
        out["max_rel_err"] = {"value": rel, "limit": limits["max_rel_err"]}
    return out


def passed(numbers: dict) -> bool:
    return all(x["value"] <= x["limit"] for x in numbers.values())
