"""SSB Q2.2 (see queries/ssb_q2_2.py)."""
from reference.ssb_star import revenue, star, words_between, words_in


def answer(data, p, low=False):
    return star(data, [
        ("part", "lo_partkey", "p_partkey",
         words_between(data, "part", "p_brand1", p["brand_lo"],
                       p["brand_hi"])),
        ("supplier", "lo_suppkey", "s_suppkey",
         words_in(data, "supplier", "s_region", p["region"])),
        ("date", "lo_orderdate", "d_datekey", None),
    ], [("date", "d_year"), ("part", "p_brand1")], revenue, "revenue",
        [("d_year", True), ("p_brand1", True)], low)
