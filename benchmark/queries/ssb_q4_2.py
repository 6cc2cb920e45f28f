"""SSB Q4.2: SUM(lo_revenue - lo_supplycost) AS profit GROUP BY d_year,
s_nation, p_category ORDER BY d_year, s_nation, p_category WHERE c_region =
:region AND s_region = :region AND (d_year = :year1 OR d_year = :year2) AND
(p_mfgr = :mfgr1 OR p_mfgr = :mfgr2) (spec: 'AMERICA', 1997, 1998,
'MFGR#1', 'MFGR#2').  Joins customer (1/5), supplier (1/5), date (2/7),
part (2/5)."""
from queries.ssb_common import grouped, i32, joined, profit, s
from queries.ssb_q4_1 import mfgr_pred

GROUP = ["d_year", "s_nation", "p_category"]


def plan(T, tables, p):
    year = T.col("d_year")
    node = joined(T, tables, None, [
        ("customer", "lo_custkey", "c_custkey",
         T.col("c_region").eq(s(T, p["region"])), []),
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_region").eq(s(T, p["region"])), ["s_nation"]),
        ("date", "lo_orderdate", "d_datekey",
         year.eq(i32(T, p["year1"])) | year.eq(i32(T, p["year2"])),
         ["d_year"]),
        ("part", "lo_partkey", "p_partkey", mfgr_pred(T, p), ["p_category"]),
    ], ["lo_revenue", "lo_supplycost"])
    return grouped(T, profit(T, node, GROUP), GROUP, "profit", "profit",
                   [(c, True) for c in GROUP], 2 * 5 * 10)
