"""SSB Q4.1: SUM(lo_revenue - lo_supplycost) AS profit GROUP BY d_year,
c_nation ORDER BY d_year, c_nation WHERE c_region = :region AND s_region =
:region AND (p_mfgr = :mfgr1 OR p_mfgr = :mfgr2) (spec: 'AMERICA',
'MFGR#1', 'MFGR#2').  Joins customer (1/5), supplier (1/5), part (2/5),
date."""
from queries.ssb_common import grouped, joined, profit, s

GROUP = ["d_year", "c_nation"]


def mfgr_pred(T, p):
    c = T.col("p_mfgr")
    return c.eq(s(T, p["mfgr1"])) | c.eq(s(T, p["mfgr2"]))


def plan(T, tables, p):
    node = joined(T, tables, None, [
        ("customer", "lo_custkey", "c_custkey",
         T.col("c_region").eq(s(T, p["region"])), ["c_nation"]),
        ("supplier", "lo_suppkey", "s_suppkey",
         T.col("s_region").eq(s(T, p["region"])), []),
        ("part", "lo_partkey", "p_partkey", mfgr_pred(T, p), []),
        ("date", "lo_orderdate", "d_datekey", None, ["d_year"]),
    ], ["lo_revenue", "lo_supplycost"])
    return grouped(T, profit(T, node, GROUP), GROUP, "profit", "profit",
                   [(c, True) for c in GROUP], 7 * 5)
