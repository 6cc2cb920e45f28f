"""SSB Q1.3: SUM(lo_extendedprice * lo_discount) AS revenue WHERE
d_weeknuminyear = :week AND d_year = :year AND lo_discount BETWEEN
:discount_lo AND :discount_hi AND lo_quantity BETWEEN :quantity_lo AND
:quantity_hi (spec: 6, 1994, 5, 7, 26, 35)."""
from queries.ssb_common import between, flight1, i32


def plan(T, tables, p):
    fact = (between(T, "lo_discount", p["discount_lo"], p["discount_hi"], i32)
            & between(T, "lo_quantity", p["quantity_lo"], p["quantity_hi"],
                      i32))
    date = (T.col("d_weeknuminyear").eq(i32(T, p["week"]))
            & T.col("d_year").eq(i32(T, p["year"])))
    return flight1(T, tables, fact, date)
