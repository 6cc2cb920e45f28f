"""SSB Q4.3: SUM(lo_revenue - lo_supplycost) AS profit GROUP BY d_year,
s_city, p_brand1 ORDER BY d_year, s_city, p_brand1 WHERE c_region = :region
AND s_nation = :nation AND (d_year = :year1 OR d_year = :year2) AND
p_category = :category (spec: 'AMERICA', 'UNITED STATES', 1997, 1998,
'MFGR#14').  Joins supplier (1/25), part (1/25), customer (1/5), date
(2/7)."""
from queries.ssb_common import grouped, i32, joined, profit, s

GROUP = ["d_year", "s_city", "p_brand1"]


def plan(T, tables, p):
    year = T.col("d_year")
    node = joined(T, tables, None, [
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_nation").eq(s(T, p["nation"])), ["s_city"]),
        ("part", "lo_partkey", "p_partkey",
         T.col("p_category").eq(s(T, p["category"])), ["p_brand1"]),
        ("customer", "lo_custkey", "c_custkey",
         T.col("c_region").eq(s(T, p["region"])), []),
        ("date", "lo_orderdate", "d_datekey",
         year.eq(i32(T, p["year1"])) | year.eq(i32(T, p["year2"])),
         ["d_year"]),
    ], ["lo_revenue", "lo_supplycost"])
    return grouped(T, profit(T, node, GROUP), GROUP, "profit", "profit",
                   [(c, True) for c in GROUP], 2 * 10 * 40)
