"""SSB Q4.3 (see queries/ssb_q4_3.py)."""
from reference.ssb_star import profit, star, words_in


def answer(data, p, low=False):
    year = data.tables["date"]["d_year"]
    return star(data, [
        ("supplier", "lo_suppkey", "s_suppkey",
         words_in(data, "supplier", "s_nation", p["nation"])),
        ("part", "lo_partkey", "p_partkey",
         words_in(data, "part", "p_category", p["category"])),
        ("customer", "lo_custkey", "c_custkey",
         words_in(data, "customer", "c_region", p["region"])),
        ("date", "lo_orderdate", "d_datekey",
         (year == p["year1"]) | (year == p["year2"])),
    ], [("date", "d_year"), ("supplier", "s_city"), ("part", "p_brand1")],
        profit, "profit",
        [("d_year", True), ("s_city", True), ("p_brand1", True)], low)
