"""SSB Q2.1: SUM(lo_revenue) GROUP BY d_year, p_brand1 ORDER BY d_year,
p_brand1 WHERE p_category = :category AND s_region = :region (spec:
'MFGR#12', 'AMERICA').  Joins part (1/25), supplier (1/5), date."""
from queries.ssb_common import grouped, joined, s


def plan(T, tables, p):
    node = joined(T, tables, None, [
        ("part", "lo_partkey", "p_partkey",
         T.col("p_category").eq(s(T, p["category"])), ["p_brand1"]),
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_region").eq(s(T, p["region"])), []),
        ("date", "lo_orderdate", "d_datekey", None, ["d_year"]),
    ], ["lo_revenue"])
    return grouped(T, node, ["d_year", "p_brand1"], "lo_revenue", "revenue",
                   [("d_year", True), ("p_brand1", True)], 7 * 40)
