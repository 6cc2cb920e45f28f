"""SSB Q4.2 (see queries/ssb_q4_2.py)."""
from reference.ssb_star import profit, star, words_in


def answer(data, p, low=False):
    year = data.tables["date"]["d_year"]
    return star(data, [
        ("customer", "lo_custkey", "c_custkey",
         words_in(data, "customer", "c_region", p["region"])),
        ("supplier", "lo_suppkey", "s_suppkey",
         words_in(data, "supplier", "s_region", p["region"])),
        ("date", "lo_orderdate", "d_datekey",
         (year == p["year1"]) | (year == p["year2"])),
        ("part", "lo_partkey", "p_partkey",
         words_in(data, "part", "p_mfgr", p["mfgr1"], p["mfgr2"])),
    ], [("date", "d_year"), ("supplier", "s_nation"),
        ("part", "p_category")], profit, "profit",
        [("d_year", True), ("s_nation", True), ("p_category", True)], low)
