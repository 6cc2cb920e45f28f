"""SSB Q3.2 (see queries/ssb_q3_2.py)."""
from reference.ssb_star import between, revenue, star, words_in


def answer(data, p, low=False):
    d = data.tables["date"]
    return star(data, [
        ("customer", "lo_custkey", "c_custkey",
         words_in(data, "customer", "c_nation", p["nation"])),
        ("supplier", "lo_suppkey", "s_suppkey",
         words_in(data, "supplier", "s_nation", p["nation"])),
        ("date", "lo_orderdate", "d_datekey",
         between(d["d_year"], p["year_lo"], p["year_hi"])),
    ], [("customer", "c_city"), ("supplier", "s_city"), ("date", "d_year")],
        revenue, "revenue", [("d_year", True), ("revenue", False)], low)
