"""TPC-H queries 2, 4, 5, 7-10, 12-14 and 17-20 over the port's DataFrame
API.

The port's own copy of the JAX package's `workloads/tpch_queries.py`,
with its signatures and defaults, holding the queries whose operators
the port carries (`PORTED`). Every function takes a dict of DataFrames
keyed by table name (`create_dataframe` over `tpch.gen_all`) and returns
a DataFrame. Shapes follow the official TPC-H v3 query set; correlated
subqueries are decomposed into aggregate and join form (EXISTS and IN
become left-semi joins, a correlated aggregate a grouped aggregate
joined back). Dates are int32 days since the epoch; date literals come
from `tpch.day`. Ratios cast to double first, as in the JAX package.
"""
from __future__ import annotations

import decimal

from .. import functions as F
from ..columnar import dtypes as dt
from ..expr.expressions import col, lit
from .tpch import day

__all__ = ["PORTED", "q2", "q4", "q5", "q7", "q8", "q9", "q10", "q12",
           "q13", "q14", "q17", "q18", "q19", "q20"]

D = decimal.Decimal

#: the queries of this module (the others of 2-22 wait on unported
#: operators: ROADMAP A.5)
PORTED = (2, 4, 5, 7, 8, 9, 10, 12, 13, 14, 17, 18, 19, 20)


def _sort(df, *orders):
    """Multi-key sort with per-key direction: orders are (expr, asc)."""
    from ..plan.logical import Sort, SortOrder
    from ..session import DataFrame
    sos = [SortOrder(e if not isinstance(e, str) else col(e), ascending=a)
           for e, a in orders]
    return DataFrame(df._session, Sort(df._plan, sos))


def _rename(df, **mapping):
    """Project all columns, renaming old -> new per mapping (new=old)."""
    names = list(df.columns)
    inv = {old: new for new, old in mapping.items()}
    return df.select(*[col(c).alias(inv.get(c, c)) for c in names])


def _rev():
    return col("l_extendedprice") * (lit(D("1")) - col("l_discount"))


def q2(t, size: int = 15, type_suffix: str = "BRASS",
       region: str = "EUROPE"):
    """Minimum cost supplier: the correlated min as a grouped min joined
    back on the part key."""
    eu_supp = (t["supplier"]
               .join(_rename(t["nation"], s_nationkey="n_nationkey"),
                     on=["s_nationkey"])
               .join(_rename(t["region"], n_regionkey="r_regionkey"),
                     on=["n_regionkey"])
               .filter(col("r_name") == lit(region)))
    ps_eu = (t["partsupp"]
             .join(_rename(eu_supp, ps_suppkey="s_suppkey"),
                   on=["ps_suppkey"]))
    min_cost = (ps_eu.group_by("ps_partkey")
                .agg(F.min(col("ps_supplycost")).alias("min_cost")))
    parts = t["part"].filter((col("p_size") == lit(size))
                             & F.endswith(col("p_type"), type_suffix))
    out = (parts
           .join(_rename(ps_eu, p_partkey="ps_partkey"), on=["p_partkey"])
           .join(min_cost.select(col("ps_partkey").alias("p_partkey"),
                                 col("min_cost")),
                 on=["p_partkey"])
           .filter(col("ps_supplycost") == col("min_cost"))
           .select("s_acctbal", "s_name", "n_name", "p_partkey",
                   "p_mfgr", "s_address", "s_phone", "s_comment"))
    return _sort(out, ("s_acctbal", False), ("n_name", True),
                 ("s_name", True), ("p_partkey", True)).limit(100)


def q4(t, d0: str = "1993-07-01", d1: str = "1993-10-01"):
    """Order priority checking: EXISTS as a left-semi join."""
    late = t["lineitem"].filter(col("l_commitdate") < col("l_receiptdate"))
    out = (t["orders"]
           .filter((col("o_orderdate") >= day(d0))
                   & (col("o_orderdate") < day(d1)))
           .with_column("l_orderkey", col("o_orderkey"))
           .join(late, on=["l_orderkey"], how="left_semi")
           .group_by("o_orderpriority")
           .agg(F.count("*").alias("order_count")))
    return _sort(out, ("o_orderpriority", True))


def q5(t, region: str = "ASIA", d0: str = "1994-01-01",
       d1: str = "1995-01-01"):
    """Local supplier volume: five joins, one on two keys."""
    out = (t["customer"]
           .join(_rename(t["orders"], c_custkey="o_custkey"),
                 on=["c_custkey"])
           .filter((col("o_orderdate") >= day(d0))
                   & (col("o_orderdate") < day(d1)))
           .with_column("l_orderkey", col("o_orderkey"))
           .join(t["lineitem"], on=["l_orderkey"])
           # the supplier is in the customer's nation
           .join(_rename(t["supplier"], l_suppkey="s_suppkey",
                         c_nationkey="s_nationkey"),
                 on=["l_suppkey", "c_nationkey"])
           .join(_rename(t["nation"], c_nationkey="n_nationkey"),
                 on=["c_nationkey"])
           .join(_rename(t["region"], n_regionkey="r_regionkey"),
                 on=["n_regionkey"])
           .filter(col("r_name") == lit(region))
           .group_by("n_name")
           .agg(F.sum(_rev()).alias("revenue")))
    return _sort(out, ("revenue", False))


def q7(t, n1: str = "FRANCE", n2: str = "GERMANY"):
    """Volume shipping between two nations."""
    y95, y96 = day("1995-01-01"), day("1996-12-31")
    supp_n = _rename(t["nation"], l_suppkey_nk="n_nationkey",
                     supp_nation="n_name").select(
        col("l_suppkey_nk"), col("supp_nation"))
    cust_n = _rename(t["nation"], c_nationkey="n_nationkey",
                     cust_nation="n_name").select(
        col("c_nationkey"), col("cust_nation"))
    df = (t["lineitem"]
          .filter((col("l_shipdate") >= y95) & (col("l_shipdate") <= y96))
          .join(_rename(t["supplier"], l_suppkey="s_suppkey",
                        l_suppkey_nk="s_nationkey")
                .select(col("l_suppkey"), col("l_suppkey_nk")),
                on=["l_suppkey"])
          .join(_rename(t["orders"], l_orderkey="o_orderkey")
                .select(col("l_orderkey"), col("o_custkey")),
                on=["l_orderkey"])
          .join(_rename(t["customer"], o_custkey="c_custkey")
                .select(col("o_custkey"), col("c_nationkey")),
                on=["o_custkey"])
          .join(supp_n, on=["l_suppkey_nk"])
          .join(cust_n, on=["c_nationkey"])
          .filter(((col("supp_nation") == lit(n1))
                   & (col("cust_nation") == lit(n2)))
                  | ((col("supp_nation") == lit(n2))
                     & (col("cust_nation") == lit(n1))))
          .with_column("l_year",
                       F.when(col("l_shipdate") <= day("1995-12-31"),
                              1995).otherwise(1996))
          .group_by("supp_nation", "cust_nation", "l_year")
          .agg(F.sum(_rev()).alias("revenue")))
    return _sort(df, ("supp_nation", True), ("cust_nation", True),
                 ("l_year", True))


def _order_year():
    """year(o_orderdate) over int32 days: a 7-branch CASE WHEN, exact
    over the TPC-H dates 1992..1998."""
    e = F.when(col("o_orderdate") <= day("1992-12-31"), 1992)
    for y in range(1993, 1998):
        e = e.when(col("o_orderdate") <= day(f"{y}-12-31"), y)
    return e.otherwise(1998)


def q8(t, nation: str = "BRAZIL", region: str = "AMERICA",
       ptype: str = "ECONOMY ANODIZED STEEL"):
    """National market share: a ratio of two double sums per year."""
    df = (t["part"].filter(col("p_type") == lit(ptype))
          .select(col("p_partkey").alias("l_partkey"))
          .join(t["lineitem"], on=["l_partkey"])
          .join(_rename(t["supplier"], l_suppkey="s_suppkey")
                .select(col("l_suppkey"), col("s_nationkey")),
                on=["l_suppkey"])
          .join(_rename(t["orders"], l_orderkey="o_orderkey")
                .select(col("l_orderkey"), col("o_custkey"),
                        col("o_orderdate")),
                on=["l_orderkey"])
          .filter((col("o_orderdate") >= day("1995-01-01"))
                  & (col("o_orderdate") <= day("1996-12-31")))
          .join(_rename(t["customer"], o_custkey="c_custkey")
                .select(col("o_custkey"), col("c_nationkey")),
                on=["o_custkey"])
          .join(_rename(t["nation"], c_nationkey="n_nationkey")
                .select(col("c_nationkey"), col("n_regionkey")),
                on=["c_nationkey"])
          .join(_rename(t["region"], n_regionkey="r_regionkey"),
                on=["n_regionkey"])
          .filter(col("r_name") == lit(region))
          .join(_rename(t["nation"], s_nationkey="n_nationkey",
                        supp_nation="n_name")
                .select(col("s_nationkey"), col("supp_nation")),
                on=["s_nationkey"])
          .with_column("o_year",
                       F.when(col("o_orderdate") <= day("1995-12-31"),
                              1995).otherwise(1996))
          .with_column("volume", _rev().cast(dt.FLOAT64))
          .with_column("nat_volume",
                       F.when(col("supp_nation") == lit(nation),
                              _rev().cast(dt.FLOAT64)).otherwise(0.0))
          .group_by("o_year")
          .agg(F.sum(col("nat_volume")).alias("nat"),
               F.sum(col("volume")).alias("total"))
          .select(col("o_year"),
                  (col("nat") / col("total")).alias("mkt_share")))
    return _sort(df, ("o_year", True))


def q9(t, word: str = "green"):
    """Product type profit measure: CONTAINS on p_name, a two-key join
    with partsupp, a decimal128 product cast to double."""
    amount = (_rev().cast(dt.FLOAT64)
              - (col("ps_supplycost") * col("l_quantity"))
              .cast(dt.FLOAT64))
    df = (t["part"].filter(F.contains(col("p_name"), word))
          .select(col("p_partkey").alias("l_partkey"))
          .join(t["lineitem"], on=["l_partkey"])
          .join(_rename(t["supplier"], l_suppkey="s_suppkey")
                .select(col("l_suppkey"), col("s_nationkey")),
                on=["l_suppkey"])
          .join(_rename(t["partsupp"], l_partkey="ps_partkey",
                        l_suppkey="ps_suppkey")
                .select(col("l_partkey"), col("l_suppkey"),
                        col("ps_supplycost")),
                on=["l_partkey", "l_suppkey"])
          .join(_rename(t["orders"], l_orderkey="o_orderkey")
                .select(col("l_orderkey"), col("o_orderdate")),
                on=["l_orderkey"])
          .join(_rename(t["nation"], s_nationkey="n_nationkey")
                .select(col("s_nationkey"), col("n_name")),
                on=["s_nationkey"])
          .with_column("o_year", _order_year())
          .with_column("amount", amount)
          .group_by("n_name", "o_year")
          .agg(F.sum(col("amount")).alias("sum_profit")))
    return _sort(df, ("n_name", True), ("o_year", False))


def q10(t, d0: str = "1993-10-01", d1: str = "1994-01-01"):
    """Returned item reporting: a six-key group-by, the top 20."""
    df = (t["customer"]
          .join(_rename(t["orders"], c_custkey="o_custkey"),
                on=["c_custkey"])
          .filter((col("o_orderdate") >= day(d0))
                  & (col("o_orderdate") < day(d1)))
          .with_column("l_orderkey", col("o_orderkey"))
          .join(t["lineitem"], on=["l_orderkey"])
          .filter(col("l_returnflag") == lit("R"))
          .join(_rename(t["nation"], c_nationkey="n_nationkey"),
                on=["c_nationkey"])
          .group_by("c_custkey", "c_name", "c_acctbal", "c_phone",
                    "n_name", "c_address")
          .agg(F.sum(_rev()).alias("revenue")))
    return _sort(df, ("revenue", False), ("c_custkey", True)).limit(20)


def q12(t, m1: str = "MAIL", m2: str = "SHIP", d0: str = "1994-01-01",
        d1: str = "1995-01-01"):
    """Shipping modes and order priority: IN and CASE WHEN."""
    high = F.when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                  1).otherwise(0)
    low = F.when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"),
                 0).otherwise(1)
    df = (t["orders"].with_column("l_orderkey", col("o_orderkey"))
          .join(t["lineitem"], on=["l_orderkey"])
          .filter(col("l_shipmode").isin(m1, m2)
                  & (col("l_commitdate") < col("l_receiptdate"))
                  & (col("l_shipdate") < col("l_commitdate"))
                  & (col("l_receiptdate") >= day(d0))
                  & (col("l_receiptdate") < day(d1)))
          .group_by("l_shipmode")
          .agg(F.sum(high).alias("high_line_count"),
               F.sum(low).alias("low_line_count")))
    return _sort(df, ("l_shipmode", True))


def q13(t, w1: str = "special", w2: str = "requests"):
    """Customer distribution: NOT LIKE, a left join and two aggregates."""
    kept = t["orders"].filter(
        ~F.like(col("o_comment"), f"%{w1}%{w2}%"))
    per_cust = (t["customer"].select(col("c_custkey"))
                .with_column("o_custkey", col("c_custkey"))
                .join(kept.select(col("o_custkey"), col("o_orderkey")),
                      on=["o_custkey"], how="left")
                .group_by("c_custkey")
                .agg(F.count(col("o_orderkey")).alias("c_count")))
    df = (per_cust.group_by("c_count")
          .agg(F.count("*").alias("custdist")))
    return _sort(df, ("custdist", False), ("c_count", False))


def q14(t, d0: str = "1995-09-01", d1: str = "1995-10-01"):
    """Promotion effect: STARTSWITH in a CASE WHEN, a ratio of sums."""
    promo = F.when(F.startswith(col("p_type"), "PROMO"),
                   _rev().cast(dt.FLOAT64)).otherwise(0.0)
    df = (t["lineitem"]
          .filter((col("l_shipdate") >= day(d0))
                  & (col("l_shipdate") < day(d1)))
          .join(_rename(t["part"], l_partkey="p_partkey")
                .select(col("l_partkey"), col("p_type")),
                on=["l_partkey"])
          .with_column("rev", _rev().cast(dt.FLOAT64))
          .with_column("promo_rev", promo)
          .agg(F.sum(col("promo_rev")).alias("p"),
               F.sum(col("rev")).alias("r"))
          .select((lit(100.0) * col("p") / col("r"))
                  .alias("promo_revenue")))
    return df


def q17(t, brand: str = "Brand#23", container: str = "MED BOX"):
    """Small-quantity-order revenue: the correlated avg as a grouped avg
    joined back on the part key."""
    avg_qty = (t["lineitem"]
               .group_by("l_partkey")
               .agg(F.avg(col("l_quantity").cast(dt.FLOAT64))
                    .alias("avg_qty"))
               .select(col("l_partkey"),
                       (col("avg_qty") * 0.2).alias("qty_threshold")))
    df = (t["part"]
          .filter((col("p_brand") == lit(brand))
                  & (col("p_container") == lit(container)))
          .select(col("p_partkey").alias("l_partkey"))
          .join(t["lineitem"], on=["l_partkey"])
          .join(avg_qty, on=["l_partkey"])
          .filter(col("l_quantity").cast(dt.FLOAT64)
                  < col("qty_threshold"))
          .agg(F.sum(col("l_extendedprice").cast(dt.FLOAT64))
               .alias("total"))
          .select((col("total") / lit(7.0)).alias("avg_yearly")))
    return df


def q18(t, qty: int = 300):
    """Large volume customers: IN as a left-semi join on a grouped sum
    compared in decimal128."""
    big = (t["lineitem"].group_by("l_orderkey")
           .agg(F.sum(col("l_quantity")).alias("sum_qty"))
           .filter(col("sum_qty") > lit(D(qty)))
           .select(col("l_orderkey").alias("o_orderkey")))
    df = (t["orders"]
          .join(big, on=["o_orderkey"], how="left_semi")
          .join(t["customer"].with_column("o_custkey", col("c_custkey")),
                on=["o_custkey"])
          .with_column("l_orderkey", col("o_orderkey"))
          .join(t["lineitem"].select(col("l_orderkey"),
                                     col("l_quantity")),
                on=["l_orderkey"])
          .group_by("c_name", "c_custkey", "o_orderkey", "o_orderdate",
                    "o_totalprice")
          .agg(F.sum(col("l_quantity")).alias("sum_qty")))
    return _sort(df, ("o_totalprice", False),
                 ("o_orderdate", True), ("o_orderkey", True)).limit(100)


def q19(t):
    """Discounted revenue: disjunctive filters over a join with part. The
    shipmode pair follows this generator's vocabulary ('REG AIR'; the
    spec's text says 'AIR REG')."""
    def branch(brand, containers, qlo, qhi, szhi):
        return ((col("p_brand") == lit(brand))
                & col("p_container").isin(*containers)
                & (col("l_quantity") >= lit(D(qlo)))
                & (col("l_quantity") <= lit(D(qhi)))
                & (col("p_size") >= 1) & (col("p_size") <= szhi))
    df = (t["lineitem"]
          .filter(col("l_shipmode").isin("AIR", "REG AIR")
                  & (col("l_shipinstruct") == lit("DELIVER IN PERSON")))
          .join(_rename(t["part"], l_partkey="p_partkey"),
                on=["l_partkey"])
          .filter(branch("Brand#12", ("SM CASE", "SM BOX", "SM PACK",
                                      "SM PKG"), 1, 11, 5)
                  | branch("Brand#23", ("MED BAG", "MED BOX", "MED PKG",
                                        "MED PACK"), 10, 20, 10)
                  | branch("Brand#34", ("LG CASE", "LG BOX", "LG PACK",
                                        "LG PKG"), 20, 30, 15))
          .agg(F.sum(_rev()).alias("revenue")))
    return df


def q20(t, word: str = "forest", nation: str = "CANADA",
        d0: str = "1994-01-01", d1: str = "1995-01-01"):
    """Potential part promotion: the nested INs as left-semi joins, a
    grouped sum joined back, and a DISTINCT."""
    forest_parts = (t["part"]
                    .filter(F.startswith(col("p_name"), word))
                    .select(col("p_partkey").alias("ps_partkey")))
    half_qty = (t["lineitem"]
                .filter((col("l_shipdate") >= day(d0))
                        & (col("l_shipdate") < day(d1)))
                .group_by("l_partkey", "l_suppkey")
                .agg(F.sum(col("l_quantity").cast(dt.FLOAT64))
                     .alias("sum_qty"))
                .select(col("l_partkey"), col("l_suppkey"),
                        (col("sum_qty") * 0.5).alias("half_qty")))
    qual_ps = (t["partsupp"]
               .join(forest_parts, on=["ps_partkey"], how="left_semi")
               .join(_rename(half_qty, ps_partkey="l_partkey",
                             ps_suppkey="l_suppkey"),
                     on=["ps_partkey", "ps_suppkey"])
               .filter(col("ps_availqty").cast(dt.FLOAT64)
                       > col("half_qty"))
               .select(col("ps_suppkey").alias("s_suppkey")).distinct())
    df = (t["supplier"]
          .join(qual_ps, on=["s_suppkey"], how="left_semi")
          .join(_rename(t["nation"], s_nationkey="n_nationkey"),
                on=["s_nationkey"])
          .filter(col("n_name") == lit(nation))
          .select(col("s_name"), col("s_address")))
    return _sort(df, ("s_name", True))
