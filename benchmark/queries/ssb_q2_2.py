"""SSB Q2.2: SUM(lo_revenue) GROUP BY d_year, p_brand1 ORDER BY d_year,
p_brand1 WHERE p_brand1 BETWEEN :brand_lo AND :brand_hi AND s_region =
:region (spec: 'MFGR#2221', 'MFGR#2228', 'ASIA').  Joins part (8/1000),
supplier (1/5), date."""
from queries.ssb_common import between, grouped, joined, s


def plan(T, tables, p):
    node = joined(T, tables, None, [
        ("part", "lo_partkey", "p_partkey",
         between(T, "p_brand1", p["brand_lo"], p["brand_hi"], s),
         ["p_brand1"]),
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_region").eq(s(T, p["region"])), []),
        ("date", "lo_orderdate", "d_datekey", None, ["d_year"]),
    ], ["lo_revenue"])
    return grouped(T, node, ["d_year", "p_brand1"], "lo_revenue", "revenue",
                   [("d_year", True), ("p_brand1", True)], 7 * 8)
