"""SSB Q3.2: SUM(lo_revenue) AS revenue GROUP BY c_city, s_city, d_year
ORDER BY d_year ASC, revenue DESC WHERE c_nation = :nation AND s_nation =
:nation AND d_year BETWEEN :year_lo AND :year_hi (spec: 'UNITED STATES',
1992, 1997).  Joins customer (1/25), supplier (1/25), date (6/7)."""
from queries.ssb_common import between, grouped, i32, joined, s


def plan(T, tables, p):
    node = joined(T, tables, None, [
        ("customer", "lo_custkey", "c_custkey",
         T.col("c_nation").eq(s(T, p["nation"])), ["c_city"]),
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_nation").eq(s(T, p["nation"])), ["s_city"]),
        ("date", "lo_orderdate", "d_datekey",
         between(T, "d_year", p["year_lo"], p["year_hi"], i32), ["d_year"]),
    ], ["lo_revenue"])
    return grouped(T, node, ["c_city", "s_city", "d_year"], "lo_revenue",
                   "revenue", [("d_year", True), ("revenue", False)],
                   10 * 10 * 6)
