"""Plans of the Star Schema Benchmark's queries in the port's operators.

A star plan filters lineorder by its own predicates (fused under the first
join), then joins one dimension after another, most selective filter first,
each an INNER join on a UNIQUE dimension key, carrying only the columns that
later joins, the aggregate or the output read.  Then a GroupAggregate into
INT64 sums and a Sort by the query's ORDER BY; or, for flight 1, a
ScalarAggregate.
"""
from __future__ import annotations


def s(T, value: str):
    return T.ConstString(value)


def i32(T, value: int):
    return T.Const(value, T.INT32)


def between(T, column: str, lo, hi, const):
    c = T.col(column)
    return (c >= const(T, lo)) & (c <= const(T, hi))


def joined(T, tables, fact_pred, joins, measures):
    """lineorder, filtered by ``fact_pred`` (or not), joined with each
    ``(dim, fact_key, dim_key, dim_pred, carry)`` of ``joins`` in order;
    the output holds ``measures`` (lineorder columns) and every ``carry``."""
    node = T.ScanTable(tables["lineorder"])
    if fact_pred is not None:
        node = T.Filter(fact_pred, node)
    keys = [j[1] for j in joins]
    carried = list(measures)
    for dim, fact_key, dim_key, dim_pred, carry in joins:
        rhs = T.ScanTable(tables[dim])
        if dim_pred is not None:
            rhs = T.Filter(dim_pred, rhs)
        keys.remove(fact_key)
        node = T.HashJoin(T.JoinType.INNER, [fact_key], [dim_key], node, rhs,
                          T.KeyUniqueness.UNIQUE,
                          lhs_projector=T.Projector.named(*keys, *carried),
                          rhs_projector=T.Projector.named(*carry))
        carried += carry
    return node


def grouped(T, node, group, measure, output, order, groups):
    """GROUP BY ``group`` with SUM(``measure``) as INT64 ``output``, at most
    ``groups`` groups, sorted by ``order`` ((column, ascending) pairs)."""
    agg = T.GroupAggregate(
        list(group),
        [T.AggSpec(T.Aggregation.SUM, measure, output, output_type=T.INT64)],
        node, T.GroupAggregateOptions(estimated_result_row_count=groups))
    return T.Sort([T.SortKey(c, ascending=a) for c, a in order], agg)


def profit(T, node, group):
    """Compute(group..., lo_revenue - lo_supplycost AS profit)."""
    return T.Compute([T.col(c) for c in group]
                     + [(T.col("lo_revenue") - T.col("lo_supplycost"))
                        .as_("profit")], node)


def flight1(T, tables, fact_pred, date_pred):
    """Q1.x: SUM(lo_extendedprice * lo_discount) AS revenue over lineorder
    filtered by ``fact_pred``, joined with the date filtered by
    ``date_pred``."""
    node = joined(T, tables, fact_pred,
                  [("date", "lo_orderdate", "d_datekey", date_pred, [])],
                  ["lo_extendedprice", "lo_discount"])
    rev = T.Compute([(T.col("lo_extendedprice") * T.col("lo_discount"))
                     .as_("rev")], node)
    return T.ScalarAggregate(
        [T.AggSpec(T.Aggregation.SUM, "rev", "revenue", output_type=T.INT64)],
        rev)
