"""TPC-H queries 4, 5, 7, 10, 12, 18 and 19 over the port's DataFrame API.

The port's own copy of the JAX package's `workloads/tpch_queries.py`,
with its signatures and defaults, holding the queries whose operators
the port carries (`PORTED`). Every function takes a dict of DataFrames
keyed by table name (`create_dataframe` over `tpch.gen_all`) and returns
a DataFrame. Shapes follow the official TPC-H v3 query set; correlated
subqueries are decomposed into aggregate and join form (EXISTS and IN
become left-semi joins). Dates are int32 days since the epoch; date
literals come from `tpch.day`.
"""
from __future__ import annotations

import decimal

from .. import functions as F
from ..expr.expressions import col, lit
from .tpch import day

__all__ = ["PORTED", "q4", "q5", "q7", "q10", "q12", "q18", "q19"]

D = decimal.Decimal

#: the queries of this module (the others of 2-22 wait on unported
#: operators: ROADMAP A.5)
PORTED = (4, 5, 7, 10, 12, 18, 19)


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
