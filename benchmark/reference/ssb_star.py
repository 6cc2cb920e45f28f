"""The Star Schema Benchmark's semantics in plain PyTorch: lineorder joined
with its dimensions by key, the rows that every predicate keeps, grouped and
summed in int64 (exact), or scalar-summed for flight 1."""
from __future__ import annotations

import torch

from reference.common import Answer, decode, group_sum, lookup, word_mask


def words_in(data, table, column, *words):
    """bool over ``table``'s rows: its STRING ``column`` is one of
    ``words``."""
    mask = word_mask(data, table, column, lambda w: w in words)
    return mask[data.tables[table][column].long()]


def words_between(data, table, column, lo, hi):
    mask = word_mask(data, table, column, lambda w: lo <= w <= hi)
    return mask[data.tables[table][column].long()]


def kept(data, fact_keep, joins):
    """(kept lineorder rows, the dimension row of each kept row per
    dimension): ``joins`` are (dim, fact_key, dim_key, bool over the dim's
    rows or None)."""
    lo = data.tables["lineorder"]
    keep = fact_keep
    rows = {}
    for dim, fact_key, dim_key, dim_ok in joins:
        r = lookup(data.tables[dim][dim_key], lo[fact_key])
        ok = r >= 0
        if dim_ok is not None:
            ok &= dim_ok[r.clamp(min=0)]
        keep = ok if keep is None else keep & ok
        rows[dim] = r
    idx = keep.nonzero().squeeze(1)
    return idx, {d: r[idx] for d, r in rows.items()}


def star(data, joins, group, measure, output, order, low):
    """GROUP BY ``group`` ((dim, column) pairs) SUM(``measure``) AS
    ``output`` over the rows that ``joins`` keep; ``measure`` maps
    (lineorder columns, kept rows) to int64 values."""
    idx, rows = kept(data, None, joins)
    keys = [data.tables[d][c][rows[d]] for d, c in group]
    uniq, sums = group_sum(keys, measure(data.tables["lineorder"], idx), low)
    cols = {c: decode(data, d, c, uniq[:, j])
            for j, (d, c) in enumerate(group)}
    cols[output] = sums
    return Answer(cols, keys=[c for _, c in group], order=order)


def revenue(lo, idx):
    return lo["lo_revenue"][idx].to(torch.int64)


def profit(lo, idx):
    return (lo["lo_revenue"][idx].to(torch.int64)
            - lo["lo_supplycost"][idx].to(torch.int64))


def flight1(data, fact_keep, date_ok, low):
    """SUM(lo_extendedprice * lo_discount) AS revenue over the lineorder
    rows that ``fact_keep`` keeps and whose date ``date_ok`` keeps."""
    idx, _ = kept(data, fact_keep,
                  [("date", "lo_orderdate", "d_datekey", date_ok)])
    lo = data.tables["lineorder"]
    total = (lo["lo_extendedprice"][idx].to(torch.int64)
             * lo["lo_discount"][idx].to(torch.int64)).sum()
    if low:
        total = ((total + 2 ** 31) % 2 ** 32) - 2 ** 31
    return Answer({"revenue": total.reshape(1).cpu().numpy()})


def between(x, lo, hi):
    return (x >= lo) & (x <= hi)
