"""SSB Q4.1 (see queries/ssb_q4_1.py)."""
from reference.ssb_star import profit, star, words_in


def answer(data, p, low=False):
    return star(data, [
        ("customer", "lo_custkey", "c_custkey",
         words_in(data, "customer", "c_region", p["region"])),
        ("supplier", "lo_suppkey", "s_suppkey",
         words_in(data, "supplier", "s_region", p["region"])),
        ("part", "lo_partkey", "p_partkey",
         words_in(data, "part", "p_mfgr", p["mfgr1"], p["mfgr2"])),
        ("date", "lo_orderdate", "d_datekey", None),
    ], [("date", "d_year"), ("customer", "c_nation")], profit, "profit",
        [("d_year", True), ("c_nation", True)], low)
