"""SSB Q1.2: SUM(lo_extendedprice * lo_discount) AS revenue WHERE
d_yearmonthnum = :yearmonthnum AND lo_discount BETWEEN :discount_lo AND
:discount_hi AND lo_quantity BETWEEN :quantity_lo AND :quantity_hi (spec:
199401, 4, 6, 26, 35)."""
from queries.ssb_common import between, flight1, i32


def plan(T, tables, p):
    fact = (between(T, "lo_discount", p["discount_lo"], p["discount_hi"], i32)
            & between(T, "lo_quantity", p["quantity_lo"], p["quantity_hi"],
                      i32))
    return flight1(T, tables, fact,
                   T.col("d_yearmonthnum").eq(i32(T, p["yearmonthnum"])))
