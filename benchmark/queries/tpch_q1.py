"""TPC-H Q1 (§2.4.1), the pricing summary report: over lineitem where
l_shipdate <= DATE '1998-12-01' - :delta days, GROUP BY l_returnflag,
l_linestatus the sums of l_quantity, l_extendedprice, l_extendedprice * (1 -
l_discount), l_extendedprice * (1 - l_discount) * (1 + l_tax) and
l_discount, COUNT(*), and the averages of quantity, price and discount as
SUM / COUNT in a Compute above the group-by (Supersonic has no AVG); ORDER BY
l_returnflag, l_linestatus."""
import datetime as dt

EPOCH = dt.date(1970, 1, 1)


def cutoff(delta: int) -> int:
    """DATE '1998-12-01' - delta days, as days since 1970-01-01."""
    return (dt.date(1998, 12, 1) - dt.timedelta(days=delta) - EPOCH).days


def plan(T, tables, p):
    c, A = T.col, T.Aggregation
    one = T.Const(1.0, T.DOUBLE)
    keep = T.Filter(c("l_shipdate") <= T.Const(cutoff(p["delta"]), T.DATE),
                    T.ScanTable(tables["lineitem"]))
    disc_price = c("l_extendedprice") * (one - c("l_discount"))
    rows = T.Compute(
        [c("l_returnflag"), c("l_linestatus"), c("l_quantity"),
         c("l_extendedprice"), c("l_discount"), disc_price.as_("disc_price"),
         (disc_price * (one + c("l_tax"))).as_("charge")], keep)
    agg = T.GroupAggregate(
        ["l_returnflag", "l_linestatus"],
        [T.AggSpec(A.SUM, "l_quantity", "sum_qty"),
         T.AggSpec(A.SUM, "l_extendedprice", "sum_base_price"),
         T.AggSpec(A.SUM, "disc_price", "sum_disc_price"),
         T.AggSpec(A.SUM, "charge", "sum_charge"),
         T.AggSpec(A.SUM, "l_discount", "sum_disc"),
         T.AggSpec(A.COUNT, None, "count_order", output_type=T.INT64)],
        rows, T.GroupAggregateOptions(estimated_result_row_count=6))
    n = c("count_order")
    out = T.Compute(
        [c("l_returnflag"), c("l_linestatus"), c("sum_qty"),
         c("sum_base_price"), c("sum_disc_price"), c("sum_charge"),
         (c("sum_qty") / n).as_("avg_qty"),
         (c("sum_base_price") / n).as_("avg_price"),
         (c("sum_disc") / n).as_("avg_disc"), n], agg)
    return T.Sort([T.SortKey("l_returnflag"), T.SortKey("l_linestatus")], out)
