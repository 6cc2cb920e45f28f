"""TPC-H Q6 (see queries/tpch_q6.py) in plain PyTorch: a float64 sum by
tree reduction (torch.sum), or float32 throughout under ``low``."""
import datetime as dt

import numpy as np
import torch

from reference.common import Answer

EPOCH = dt.date(1970, 1, 1)


def answer(data, p, low=False):
    li = data.tables["lineitem"]
    ft = torch.float32 if low else torch.float64
    lo = (dt.date(p["year"], 1, 1) - EPOCH).days
    hi = (dt.date(p["year"] + 1, 1, 1) - EPOCH).days
    d = round(p["discount"] * 100)
    disc = li["l_discount"].to(ft)
    keep = ((li["l_shipdate"] >= lo) & (li["l_shipdate"] < hi)
            & (disc >= torch.tensor((d - 1) / 100, dtype=ft))
            & (disc <= torch.tensor((d + 1) / 100, dtype=ft))
            & (li["l_quantity"].to(ft) < p["quantity"]))
    rev = (li["l_extendedprice"][keep].to(ft) * disc[keep]).sum()
    return Answer({"revenue": np.array([float(rev)])}, approx=["revenue"])
