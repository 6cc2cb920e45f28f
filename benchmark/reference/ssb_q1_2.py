"""SSB Q1.2 (see queries/ssb_q1_2.py)."""
from reference.ssb_star import between, flight1


def answer(data, p, low=False):
    lo, d = data.tables["lineorder"], data.tables["date"]
    fact = (between(lo["lo_discount"], p["discount_lo"], p["discount_hi"])
            & between(lo["lo_quantity"], p["quantity_lo"], p["quantity_hi"]))
    return flight1(data, fact, d["d_yearmonthnum"] == p["yearmonthnum"], low)
