"""SSB Q1.1: SUM(lo_extendedprice * lo_discount) AS revenue WHERE d_year =
:year AND lo_discount BETWEEN :discount_lo AND :discount_hi AND lo_quantity <
:quantity_lt (spec: 1993, 1, 3, 25)."""
from queries.ssb_common import between, flight1, i32


def plan(T, tables, p):
    fact = (between(T, "lo_discount", p["discount_lo"], p["discount_hi"], i32)
            & (T.col("lo_quantity") < i32(T, p["quantity_lt"])))
    return flight1(T, tables, fact, T.col("d_year").eq(i32(T, p["year"])))
