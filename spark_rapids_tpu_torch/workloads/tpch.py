"""TPC-H generators for lineitem, orders and customer, Q6, Q1 and Q3, and
their numpy references.

The port's own copy of the JAX package's `workloads/tpch.py` pieces that
these queries need. Each generator draws the same numbers in the same
order as the JAX one: `gen_lineitem(sf, seed)` builds a table equal,
column for column, to the first eight columns of the JAX generator's;
`gen_orders` and `gen_customer` equal the JAX generators' base tables
(`full=False`; the extra columns of `full=True` wait for Q5, Q10 and
Q12).
"""
from __future__ import annotations

import decimal

import numpy as np
import pyarrow as pa

from .. import functions as F
from ..expr.expressions import col, lit

__all__ = ["LINEITEM_ROWS_PER_SF", "ORDERS_ROWS_PER_SF",
           "CUSTOMER_ROWS_PER_SF", "SEGMENTS", "dec_from_unscaled", "day",
           "gen_lineitem", "gen_orders", "gen_customer", "q6",
           "q6_numpy_baseline", "Q6_COLUMNS", "q1", "q1_numpy_baseline",
           "Q1_COLUMNS", "q3", "q3_numpy_baseline"]

LINEITEM_ROWS_PER_SF = 6_001_215
ORDERS_ROWS_PER_SF = 1_500_000
CUSTOMER_ROWS_PER_SF = 150_000
#: the market segments (TPC-H clause 4.2.2.13); BUILDING is code 1
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]

#: the lineitem columns Q6 reads
Q6_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")
#: the lineitem columns Q1 reads
Q1_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
              "l_returnflag", "l_linestatus", "l_shipdate")


def dec_from_unscaled(vals: np.ndarray, precision: int, scale: int):
    """A decimal128 array whose UNSCALED value is `vals` (a cast from
    int64 would rescale instead)."""
    n = len(vals)
    lo = vals.astype(np.int64)
    hi = np.where(lo < 0, np.int64(-1), np.int64(0))
    words = np.empty(2 * n, np.int64)
    words[0::2] = lo
    words[1::2] = hi
    return pa.Array.from_buffers(
        pa.decimal128(38, scale), n,
        [None, pa.py_buffer(words.tobytes())]).cast(
            pa.decimal128(precision, scale))


def day(s: str) -> int:
    """Date literal as int32 days since the epoch."""
    return int((np.datetime64(s) - np.datetime64("1970-01-01"))
               // np.timedelta64(1, "D"))


def gen_lineitem(sf: float = 0.1, seed: int = 0) -> pa.Table:
    n = int(LINEITEM_ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n).astype(np.int64) * 100          # dec(12,2)
    price = rng.integers(90_000, 10_500_000, n).astype(np.int64)  # dec(12,2)
    disc = rng.integers(0, 11, n).astype(np.int64)                # dec(4,2)
    tax = rng.integers(0, 9, n).astype(np.int64)
    shipdate = rng.integers(8036, 10591, n).astype(np.int32)      # days
    rf = rng.integers(0, 3, n)
    ls = rng.integers(0, 2, n)
    returnflag = pa.array(np.array(["A", "N", "R"])[rf])
    linestatus = pa.array(np.array(["F", "O"])[ls])
    okey = rng.integers(0, max(n // 4, 1), n).astype(np.int64)
    return pa.table({
        "l_orderkey": pa.array(okey, pa.int64()),
        "l_quantity": dec_from_unscaled(qty, 12, 2),
        "l_extendedprice": dec_from_unscaled(price, 12, 2),
        "l_discount": dec_from_unscaled(disc, 4, 2),
        "l_tax": dec_from_unscaled(tax, 4, 2),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": pa.array(shipdate, pa.int32()),
    })


def q6(df):
    """TPC-H Q6: forecasting revenue change (scan+filter+reduction)."""
    d = decimal.Decimal
    return (df.filter((col("l_shipdate") >= 8766) & (col("l_shipdate") < 9131)
                      & (col("l_discount") >= lit(d("0.05")))
                      & (col("l_discount") <= lit(d("0.07")))
                      & (col("l_quantity") < lit(d("24"))))
            .agg(F.sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue")))


def q6_numpy_baseline(ship, disc_unscaled, qty_unscaled, price_unscaled):
    """Vectorized single-core CPU reference over the raw unscaled arrays:
    the revenue's unscaled value at scale 4."""
    m = ((ship >= 8766) & (ship < 9131)
         & (disc_unscaled >= 5) & (disc_unscaled <= 7)
         & (qty_unscaled < 2400))
    return int(np.sum(price_unscaled[m] * disc_unscaled[m]))


def q1(df):
    """TPC-H Q1: pricing summary report (grouped agg, 8 aggregates)."""
    d = decimal.Decimal
    disc_price = col("l_extendedprice") * (lit(d("1")) - col("l_discount"))
    charge = disc_price * (lit(d("1")) + col("l_tax"))
    return (df.filter(col("l_shipdate") <= 10471)
            .group_by("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("count_order")))


def q1_numpy_baseline(ship, rf, ls, qty, price, disc, tax):
    """Vectorized single-core Q1 reference: grouped sums via bincount over
    the 6 (returnflag, linestatus) combinations. rf/ls are small int
    codes. (sum_charge sums in float64, which is not exact at scale.)"""
    m = ship <= 10471
    g = (rf * 2 + ls)[m]
    qty, price, disc, tax = qty[m], price[m], disc[m], tax[m]
    disc_price = price * (100 - disc)          # scale 4
    charge = disc_price * (100 + tax)          # scale 6
    out = {}
    out["sum_qty"] = np.bincount(g, qty, 6)
    out["sum_base_price"] = np.bincount(g, price, 6)
    out["sum_disc_price"] = np.bincount(g, disc_price, 6)
    out["sum_charge"] = np.bincount(g, charge.astype(np.float64), 6)
    out["count"] = np.bincount(g, minlength=6)
    return out


def gen_orders(sf: float = 0.1, seed: int = 1) -> pa.Table:
    n = int(ORDERS_ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    okey = np.arange(n, dtype=np.int64)
    ckey = rng.integers(0, max(n // 10, 1), n).astype(np.int64)
    odate = rng.integers(8036, 10591, n).astype(np.int32)
    rng.integers(0, 5, n)    # the JAX generator's unused draw, kept in step
    total = rng.integers(100_000, 50_000_000, n).astype(np.int64)
    return pa.table({
        "o_orderkey": pa.array(okey),
        "o_custkey": pa.array(ckey),
        "o_orderdate": pa.array(odate, pa.int32()),
        "o_totalprice": dec_from_unscaled(total, 15, 2),
        "o_shippriority": pa.array(rng.integers(0, 2, n).astype(np.int32),
                                   pa.int32()),
    })


def gen_customer(sf: float = 0.1, seed: int = 2) -> pa.Table:
    n = int(CUSTOMER_ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    return pa.table({
        "c_custkey": pa.array(np.arange(n, dtype=np.int64)),
        "c_mktsegment": pa.array(np.array(SEGMENTS)[rng.integers(0, 5, n)]),
    })


def q3(customer, orders, lineitem):
    """TPC-H Q3 shape: shipping priority (join, join, grouped sum, sort,
    top 10)."""
    from ..plan.logical import Sort, SortOrder
    from ..session import DataFrame
    d = decimal.Decimal
    rev = col("l_extendedprice") * (lit(d("1")) - col("l_discount"))
    df = (customer.filter(col("c_mktsegment") == lit("BUILDING"))
          .join(orders.with_column("c_custkey", col("o_custkey")),
                on=["c_custkey"], how="inner")
          .filter(col("o_orderdate") < 9204)
          .with_column("l_orderkey", col("o_orderkey"))
          .join(lineitem, on=["l_orderkey"], how="inner")
          .filter(col("l_shipdate") > 9204)
          .group_by("l_orderkey", "o_orderdate", "o_shippriority")
          .agg(F.sum(rev).alias("revenue")))
    sorted_df = DataFrame(df._session, Sort(df._plan, [
        SortOrder(col("revenue"), ascending=False),
        SortOrder(col("o_orderdate"), ascending=True)]))
    return sorted_df.limit(10)


def q3_numpy_baseline(c_key, c_seg, o_okey, o_ckey, o_date, o_prio,
                      l_okey, l_ship, l_price, l_disc):
    """Vectorized single-core Q3 reference: semi-joins by np.isin, a
    grouped sum over order keys; the top 10 by revenue, ties by order
    key. c_seg is the SEGMENTS code (BUILDING == 1)."""
    cust = c_key[c_seg == 1]
    om = (o_date < 9204) & np.isin(o_ckey, cust)
    okeys = o_okey[om]
    lm = (l_ship > 9204) & np.isin(l_okey, okeys)
    lk = l_okey[lm]
    rev = l_price[lm] * (100 - l_disc[lm])
    order = np.argsort(lk, kind="stable")
    lk_s, rev_s = lk[order], rev[order]
    starts = np.flatnonzero(np.r_[True, lk_s[1:] != lk_s[:-1]])
    sums = np.add.reduceat(rev_s, starts) if lk_s.size else np.array([])
    keys = lk_s[starts] if lk_s.size else np.array([], np.int64)
    top = np.argsort(-sums, kind="stable")[:10]
    return keys[top], sums[top]
