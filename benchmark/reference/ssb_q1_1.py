"""SSB Q1.1 (see queries/ssb_q1_1.py)."""
from reference.ssb_star import between, flight1


def answer(data, p, low=False):
    lo, d = data.tables["lineorder"], data.tables["date"]
    fact = (between(lo["lo_discount"], p["discount_lo"], p["discount_hi"])
            & (lo["lo_quantity"] < p["quantity_lt"]))
    return flight1(data, fact, d["d_year"] == p["year"], low)
