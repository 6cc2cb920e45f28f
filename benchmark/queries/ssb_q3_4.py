"""SSB Q3.4: SUM(lo_revenue) AS revenue GROUP BY c_city, s_city, d_year
ORDER BY d_year ASC, revenue DESC WHERE (c_city = :city1 OR c_city = :city2)
AND (s_city = :city1 OR s_city = :city2) AND d_yearmonth = :yearmonth (spec:
'UNITED KI1', 'UNITED KI5', 'Dec1997').  Joins customer (2/250), supplier
(2/250), date (1/84)."""
from queries.ssb_common import grouped, joined, s
from queries.ssb_q3_3 import city_pred


def plan(T, tables, p):
    node = joined(T, tables, None, [
        ("customer", "lo_custkey", "c_custkey", city_pred(T, "c_city", p),
         ["c_city"]),
        ("supplier", "lo_suppkey", "s_suppkey", city_pred(T, "s_city", p),
         ["s_city"]),
        ("date", "lo_orderdate", "d_datekey",
         T.col("d_yearmonth").eq(s(T, p["yearmonth"])), ["d_year"]),
    ], ["lo_revenue"])
    return grouped(T, node, ["c_city", "s_city", "d_year"], "lo_revenue",
                   "revenue", [("d_year", True), ("revenue", False)], 2 * 2)
