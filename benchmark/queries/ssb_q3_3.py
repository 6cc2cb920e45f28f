"""SSB Q3.3: SUM(lo_revenue) AS revenue GROUP BY c_city, s_city, d_year
ORDER BY d_year ASC, revenue DESC WHERE (c_city = :city1 OR c_city = :city2)
AND (s_city = :city1 OR s_city = :city2) AND d_year BETWEEN :year_lo AND
:year_hi (spec: 'UNITED KI1', 'UNITED KI5', 1992, 1997).  Joins customer
(2/250), supplier (2/250), date (6/7)."""
from queries.ssb_common import between, grouped, i32, joined, s


def city_pred(T, column, p):
    c = T.col(column)
    return c.eq(s(T, p["city1"])) | c.eq(s(T, p["city2"]))


def plan(T, tables, p):
    node = joined(T, tables, None, [
        ("customer", "lo_custkey", "c_custkey", city_pred(T, "c_city", p),
         ["c_city"]),
        ("supplier", "lo_suppkey", "s_suppkey", city_pred(T, "s_city", p),
         ["s_city"]),
        ("date", "lo_orderdate", "d_datekey",
         between(T, "d_year", p["year_lo"], p["year_hi"], i32), ["d_year"]),
    ], ["lo_revenue"])
    return grouped(T, node, ["c_city", "s_city", "d_year"], "lo_revenue",
                   "revenue", [("d_year", True), ("revenue", False)],
                   2 * 2 * 6)
