"""TPC-H Q6 (§2.4.6), the forecasting revenue change: SUM(l_extendedprice *
l_discount) AS revenue over lineitem where l_shipdate >= DATE ':year-01-01'
AND l_shipdate < that date + 1 year AND l_discount BETWEEN :discount - 0.01
AND :discount + 0.01 AND l_quantity < :quantity."""
import datetime as dt

EPOCH = dt.date(1970, 1, 1)


def bounds(p):
    """(first day, day past the year, discount low, discount high) as the
    constants of the query: DATE days and DOUBLEs to the cent."""
    lo = (dt.date(p["year"], 1, 1) - EPOCH).days
    hi = (dt.date(p["year"] + 1, 1, 1) - EPOCH).days
    d = round(p["discount"] * 100)
    return lo, hi, (d - 1) / 100, (d + 1) / 100


def plan(T, tables, p):
    c, C = T.col, T.Const
    lo, hi, dlo, dhi = bounds(p)
    pred = ((c("l_shipdate") >= C(lo, T.DATE))
            & (c("l_shipdate") < C(hi, T.DATE))
            & (c("l_discount") >= C(dlo, T.DOUBLE))
            & (c("l_discount") <= C(dhi, T.DOUBLE))
            & (c("l_quantity") < C(float(p["quantity"]), T.DOUBLE)))
    rev = T.Compute([(c("l_extendedprice") * c("l_discount")).as_("rev")],
                    T.Filter(pred, T.ScanTable(tables["lineitem"])))
    return T.ScalarAggregate([T.AggSpec(T.Aggregation.SUM, "rev", "revenue")],
                             rev)
