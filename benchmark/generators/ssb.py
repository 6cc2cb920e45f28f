"""Star Schema Benchmark data (O'Neil, O'Neil, Chen, rev. 3, 2009) from a
seed, with dbgen's distributions; the configuration file gives the row
counts and lists what is assumed.

lineorder is made on the device with one ``torch.Generator`` in a few large
calls: orders of 1-7 lines (uniform) up to the configured line count, each
order's date uniform over 1992-01-01 .. 1998-08-02 and its customer uniform
over those whose key is not a multiple of 3 (TPC-H's rule, §4.2.3); a line's
part uniform, its supplier by TPC-H's PARTSUPP bridge over four suppliers a
part, quantity 1-50, discount 0-10 (percent), extendedprice = quantity x the
part's retail price in cents, revenue = extendedprice x (100 - discount) /
100, supplycost = 6 x retail price / 10 (integer division).  The dimensions
are made on the host with numpy from the same seed: their STRING columns are
codes into sorted word lists, with dbgen's cardinalities (p_mfgr 5,
p_category 25, p_brand1 1,000; 5 regions, 25 nations, 250 cities).
"""
from __future__ import annotations

import datetime as dt

import numpy as np
import torch

from benchlib.datagen import order_lines, retail_cents

NATIONS = [  # TPC-H's 25 nations (§4.2.3) and the index of their region
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1)]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec"]
FIRST_DAY = dt.date(1992, 1, 1)
LAST_DAY = dt.date(1998, 12, 31)
LAST_ORDER_DAY = dt.date(1998, 8, 2)   # ENDDATE - 151 days (TPC-H §4.2.3)


def _coded(values):
    """(codes int32, sorted words) of a list of strings."""
    words = tuple(sorted(set(values)))
    index = {w: i for i, w in enumerate(words)}
    return np.array([index[v] for v in values], dtype=np.int32), words


def _city(nation: int, digit: int) -> str:
    return f"{NATIONS[nation][0][:9]:<9}{digit}"


def _date_table():
    days = [FIRST_DAY + dt.timedelta(i)
            for i in range((LAST_DAY - FIRST_DAY).days + 1)]
    ym_codes, ym_words = _coded([f"{MONTHS[d.month - 1]}{d.year}"
                                 for d in days])
    cols = {
        "d_datekey": np.array([d.year * 10000 + d.month * 100 + d.day
                               for d in days], dtype=np.int32),
        "d_year": np.array([d.year for d in days], dtype=np.int32),
        "d_yearmonthnum": np.array([d.year * 100 + d.month for d in days],
                                   dtype=np.int32),
        "d_yearmonth": ym_codes,
        "d_weeknuminyear": np.array(
            [(d.timetuple().tm_yday - 1) // 7 + 1 for d in days],
            dtype=np.int32),
    }
    return cols, {"d_yearmonth": ym_words}


def _geo_table(prefix: str, n: int, rng):
    """customer or supplier: key 1..n and city, nation, region."""
    nation = rng.integers(0, 25, n)
    digit = rng.integers(0, 10, n)
    city_words = tuple(sorted({_city(i, j) for i in range(25)
                               for j in range(10)}))
    nation_words = tuple(sorted(name for name, _ in NATIONS))
    region_words = tuple(sorted(REGIONS))
    city_of = {w: i for i, w in enumerate(city_words)}
    city_lut = np.array([[city_of[_city(i, j)] for j in range(10)]
                         for i in range(25)], dtype=np.int32)
    nation_lut = np.array([nation_words.index(name) for name, _ in NATIONS],
                          dtype=np.int32)
    region_lut = np.array([region_words.index(REGIONS[r])
                           for _, r in NATIONS], dtype=np.int32)
    cols = {f"{prefix}_{'custkey' if prefix == 'c' else 'suppkey'}":
            np.arange(1, n + 1, dtype=np.int32),
            f"{prefix}_city": city_lut[nation, digit],
            f"{prefix}_nation": nation_lut[nation],
            f"{prefix}_region": region_lut[nation]}
    words = {f"{prefix}_city": city_words, f"{prefix}_nation": nation_words,
             f"{prefix}_region": region_words}
    return cols, words


def _part_table(n: int, rng):
    m = rng.integers(1, 6, n)
    c = rng.integers(1, 6, n)
    b = rng.integers(1, 41, n)
    mfgr = tuple(sorted(f"MFGR#{i}" for i in range(1, 6)))
    cat = tuple(sorted(f"MFGR#{i}{j}" for i in range(1, 6)
                       for j in range(1, 6)))
    brand = tuple(sorted(f"MFGR#{i}{j}{k}" for i in range(1, 6)
                         for j in range(1, 6) for k in range(1, 41)))
    mfgr_lut = np.array([mfgr.index(f"MFGR#{i}") for i in range(6)[1:]],
                        dtype=np.int32)
    cat_lut = np.array([[cat.index(f"MFGR#{i}{j}") for j in range(1, 6)]
                        for i in range(1, 6)], dtype=np.int32)
    brand_of = {w: k for k, w in enumerate(brand)}
    brand_lut = np.array([[[brand_of[f"MFGR#{i}{j}{k}"]
                            for k in range(1, 41)] for j in range(1, 6)]
                          for i in range(1, 6)], dtype=np.int32)
    cols = {"p_partkey": np.arange(1, n + 1, dtype=np.int32),
            "p_mfgr": mfgr_lut[m - 1],
            "p_category": cat_lut[m - 1, c - 1],
            "p_brand1": brand_lut[m - 1, c - 1, b - 1]}
    return cols, {"p_mfgr": mfgr, "p_category": cat, "p_brand1": brand}


def _lineorder(n: int, parts: int, customers: int, suppliers: int,
               datekeys: np.ndarray, g, device):
    order = order_lines(n, g, device)
    n_orders = int(order[-1]) + 1
    first = (LAST_ORDER_DAY - FIRST_DAY).days + 1
    day = torch.randint(0, first, (n_orders,), generator=g, device=device)
    cust = torch.randint(1, customers + 1, (n_orders,), generator=g,
                         device=device)
    # TPC-H's rule: a customer whose key is a multiple of 3 places no order
    cust = torch.where(cust % 3 == 0,
                       torch.where(cust + 1 <= customers, cust + 1, cust - 1),
                       cust)
    lut = torch.from_numpy(datekeys).to(device)
    part = torch.randint(1, parts + 1, (n,), generator=g, device=device)
    i = torch.randint(0, 4, (n,), generator=g, device=device)
    s = suppliers
    supp = (part + i * (s // 4 + (part - 1) // s)) % s + 1
    qty = torch.randint(1, 51, (n,), generator=g, device=device)
    disc = torch.randint(0, 11, (n,), generator=g, device=device)
    price = retail_cents(part)
    ext = qty * price
    cols = {
        "lo_orderdate": lut[day][order],
        "lo_custkey": cust[order],
        "lo_partkey": part,
        "lo_suppkey": supp,
        "lo_quantity": qty,
        "lo_extendedprice": ext,
        "lo_discount": disc,
        "lo_revenue": ext * (100 - disc) // 100,
        "lo_supplycost": 6 * price // 10,
    }
    return {k: v.to(torch.int32).cpu().numpy() for k, v in cols.items()}


def generate(config: dict, seed: int, device) -> dict:
    """The data set: ``tables[t][c]`` host arrays, ``types[t]`` the
    (column, DataType name) pairs, ``words[t][c]`` the sorted words of a
    STRING column's codes, ``fact`` the fact table's name."""
    rows = config["rows"]
    seed = seed % 2 ** 63
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    date, date_w = _date_table()
    part, part_w = _part_table(rows["part"], rng)
    cust, cust_w = _geo_table("c", rows["customer"], rng)
    supp, supp_w = _geo_table("s", rows["supplier"], rng)
    lo = _lineorder(rows["lineorder"], rows["part"], rows["customer"],
                    rows["supplier"], date["d_datekey"], g, device)
    tables = {"lineorder": lo, "part": part, "customer": cust,
              "supplier": supp, "date": date}
    words = {"part": part_w, "customer": cust_w, "supplier": supp_w,
             "date": date_w}
    types = {t: [(c, "STRING" if c in words.get(t, {}) else "INT32")
                 for c in cols] for t, cols in tables.items()}
    return {"tables": tables, "types": types, "words": words,
            "fact": "lineorder"}
