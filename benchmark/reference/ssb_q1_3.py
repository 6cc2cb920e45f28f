"""SSB Q1.3 (see queries/ssb_q1_3.py)."""
from reference.ssb_star import between, flight1


def answer(data, p, low=False):
    lo, d = data.tables["lineorder"], data.tables["date"]
    fact = (between(lo["lo_discount"], p["discount_lo"], p["discount_hi"])
            & between(lo["lo_quantity"], p["quantity_lo"], p["quantity_hi"]))
    date = (d["d_weeknuminyear"] == p["week"]) & (d["d_year"] == p["year"])
    return flight1(data, fact, date, low)
