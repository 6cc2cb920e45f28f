"""TPC-H lineitem (TPC Benchmark H, §4.2.3) from a seed, on the device with
one ``torch.Generator`` in a few large calls; the configuration file gives
the row count and lists what is assumed.

Orders of 1-7 lines (uniform) up to the configured line count, each order's
date uniform over 1992-01-01 .. 1998-08-02 (ENDDATE - 151 days).  A line's
part is uniform over SF x 200,000 keys; L_QUANTITY is 1-50, L_EXTENDEDPRICE
= L_QUANTITY x P_RETAILPRICE (to the cent), L_DISCOUNT 0.00-0.10,
L_TAX 0.00-0.08, L_SHIPDATE = O_ORDERDATE + 1-121 days, L_RECEIPTDATE =
L_SHIPDATE + 1-30 days; L_RETURNFLAG is R or A at random where
L_RECEIPTDATE <= CURRENTDATE (1995-06-17), else N; L_LINESTATUS is O where
L_SHIPDATE > CURRENTDATE, else F.  Decimals are DOUBLE (k / 100, correctly
rounded); dates are DATE, days since 1970-01-01; the two flags are STRING
codes into ("A", "N", "R") and ("F", "O").
"""
from __future__ import annotations

import datetime as dt

import torch

from benchlib.datagen import order_lines, retail_cents

EPOCH = dt.date(1970, 1, 1)
START = (dt.date(1992, 1, 1) - EPOCH).days
LAST_ORDER = (dt.date(1998, 8, 2) - EPOCH).days
CURRENT = (dt.date(1995, 6, 17) - EPOCH).days
FLAGS = ("A", "N", "R")
STATUS = ("F", "O")


def generate(config: dict, seed: int, device) -> dict:
    """The data set, in the form of ``generators/ssb.py``'s."""
    n = config["rows"]["lineitem"]
    parts = config["rows"]["part"]
    seed = seed % 2 ** 63
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randint(lo, hi, size):  # lo..hi, both included
        return torch.randint(lo, hi + 1, (size,), generator=g, device=device)

    order = order_lines(n, g, device)
    n_orders = int(order[-1]) + 1
    odate = randint(START, LAST_ORDER, n_orders)[order]
    part = randint(1, parts, n)
    cents = retail_cents(part)
    qty = randint(1, 50, n)
    ship = odate + randint(1, 121, n)
    receipt = ship + randint(1, 30, n)
    ra = randint(0, 1, n) * 2          # A (0) or R (2)
    cols = {
        "l_quantity": qty.to(torch.float64),
        "l_extendedprice": (qty * cents).to(torch.float64) / 100,
        "l_discount": randint(0, 10, n).to(torch.float64) / 100,
        "l_tax": randint(0, 8, n).to(torch.float64) / 100,
        "l_returnflag": torch.where(receipt <= CURRENT, ra, 1).to(
            torch.int32),
        "l_linestatus": (ship > CURRENT).to(torch.int32),
        "l_shipdate": ship.to(torch.int32),
    }
    lineitem = {k: v.cpu().numpy() for k, v in cols.items()}
    types = {"lineitem": [("l_quantity", "DOUBLE"),
                          ("l_extendedprice", "DOUBLE"),
                          ("l_discount", "DOUBLE"), ("l_tax", "DOUBLE"),
                          ("l_returnflag", "STRING"),
                          ("l_linestatus", "STRING"),
                          ("l_shipdate", "DATE")]}
    return {"tables": {"lineitem": lineitem}, "types": types,
            "words": {"lineitem": {"l_returnflag": FLAGS,
                                   "l_linestatus": STATUS}},
            "fact": "lineitem"}
