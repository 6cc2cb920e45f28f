"""SSB Q3.1 (see queries/ssb_q3_1.py)."""
from reference.ssb_star import between, revenue, star, words_in


def answer(data, p, low=False):
    d = data.tables["date"]
    return star(data, [
        ("customer", "lo_custkey", "c_custkey",
         words_in(data, "customer", "c_region", p["region"])),
        ("supplier", "lo_suppkey", "s_suppkey",
         words_in(data, "supplier", "s_region", p["region"])),
        ("date", "lo_orderdate", "d_datekey",
         between(d["d_year"], p["year_lo"], p["year_hi"])),
    ], [("customer", "c_nation"), ("supplier", "s_nation"),
        ("date", "d_year")], revenue, "revenue",
        [("d_year", True), ("revenue", False)], low)
