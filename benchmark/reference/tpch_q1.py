"""TPC-H Q1 (see queries/tpch_q1.py) in plain PyTorch: float64 sums by
tree reduction (torch.sum), or float32 throughout under ``low``."""
import datetime as dt

import numpy as np
import torch

from reference.common import Answer

EPOCH = dt.date(1970, 1, 1)
EXACT = ["l_returnflag", "l_linestatus", "sum_qty", "avg_qty", "count_order"]
NAMES = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
         "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
         "count_order"]


def answer(data, p, low=False):
    li = data.tables["lineitem"]
    words = data.words["lineitem"]
    ft = torch.float32 if low else torch.float64
    last = (dt.date(1998, 12, 1) - dt.timedelta(days=p["delta"])
            - EPOCH).days
    keep = li["l_shipdate"] <= last
    rf, ls = li["l_returnflag"][keep], li["l_linestatus"][keep]
    qty = li["l_quantity"][keep].to(ft)
    price = li["l_extendedprice"][keep].to(ft)
    disc = li["l_discount"][keep].to(ft)
    tax = li["l_tax"][keep].to(ft)
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    rows = {k: [] for k in NAMES}
    for f in range(len(words["l_returnflag"])):
        for s in range(len(words["l_linestatus"])):
            m = (rf == f) & (ls == s)
            n = int(m.sum())
            if n == 0:
                continue
            sums = [float(x[m].sum()) for x in (qty, price, disc_price,
                                                charge, disc)]
            rows["l_returnflag"].append(words["l_returnflag"][f])
            rows["l_linestatus"].append(words["l_linestatus"][s])
            for k, v in zip(NAMES[2:6], sums[:4]):
                rows[k].append(v)
            rows["avg_qty"].append(sums[0] / n)
            rows["avg_price"].append(sums[1] / n)
            rows["avg_disc"].append(sums[4] / n)
            rows["count_order"].append(n)
    cols = {k: np.array(v, dtype=object if k in EXACT[:2] else None)
            for k, v in rows.items()}
    return Answer(cols, keys=EXACT[:2],
                  approx=[k for k in NAMES if k not in EXACT],
                  order=[("l_returnflag", True), ("l_linestatus", True)])
