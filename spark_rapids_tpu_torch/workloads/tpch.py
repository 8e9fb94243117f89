"""TPC-H lineitem generator, Q6 and Q1, and their numpy references.

The port's own copy of the JAX package's `workloads/tpch.py` pieces that
Q6 and Q1 need. `gen_lineitem(sf, seed)` draws the same numbers in the same
order, so it builds a table equal, column for column, to the first eight
columns of the JAX generator's.
"""
from __future__ import annotations

import decimal

import numpy as np
import pyarrow as pa

from .. import functions as F
from ..expr.expressions import col, lit

__all__ = ["LINEITEM_ROWS_PER_SF", "dec_from_unscaled", "day",
           "gen_lineitem", "q6", "q6_numpy_baseline", "Q6_COLUMNS", "q1",
           "q1_numpy_baseline", "Q1_COLUMNS"]

LINEITEM_ROWS_PER_SF = 6_001_215

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
