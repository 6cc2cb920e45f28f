"""SSB Q3.1: SUM(lo_revenue) AS revenue GROUP BY c_nation, s_nation, d_year
ORDER BY d_year ASC, revenue DESC WHERE c_region = :region AND s_region =
:region AND d_year BETWEEN :year_lo AND :year_hi (spec: 'ASIA', 1992, 1997).
Joins customer (1/5), supplier (1/5), date (6/7)."""
from queries.ssb_common import between, grouped, i32, joined, s


def plan(T, tables, p):
    node = joined(T, tables, None, [
        ("customer", "lo_custkey", "c_custkey",
         T.col("c_region").eq(s(T, p["region"])), ["c_nation"]),
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_region").eq(s(T, p["region"])), ["s_nation"]),
        ("date", "lo_orderdate", "d_datekey",
         between(T, "d_year", p["year_lo"], p["year_hi"], i32), ["d_year"]),
    ], ["lo_revenue"])
    return grouped(T, node, ["c_nation", "s_nation", "d_year"], "lo_revenue",
                   "revenue", [("d_year", True), ("revenue", False)],
                   5 * 5 * 6)
