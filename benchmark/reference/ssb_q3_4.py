"""SSB Q3.4 (see queries/ssb_q3_4.py)."""
from reference.ssb_star import revenue, star, words_in


def answer(data, p, low=False):
    cities = (p["city1"], p["city2"])
    return star(data, [
        ("customer", "lo_custkey", "c_custkey",
         words_in(data, "customer", "c_city", *cities)),
        ("supplier", "lo_suppkey", "s_suppkey",
         words_in(data, "supplier", "s_city", *cities)),
        ("date", "lo_orderdate", "d_datekey",
         words_in(data, "date", "d_yearmonth", p["yearmonth"])),
    ], [("customer", "c_city"), ("supplier", "s_city"), ("date", "d_year")],
        revenue, "revenue", [("d_year", True), ("revenue", False)], low)
