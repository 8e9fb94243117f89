"""TPC-H generators for all eight tables, Q6, Q1 and Q3 with their numpy
references, and the registry of the ported queries.

The port's own copy of the JAX package's `workloads/tpch.py`. Each
generator draws the same numbers in the same order as the JAX one, so
`gen_all(sf, seed)` builds tables equal, column for column, to the JAX
package's. The `full=True` columns of lineitem, orders and customer come
from a second stream (`seed + 104729`) so that the base columns keep
their draws.
"""
from __future__ import annotations

import decimal

import numpy as np
import pyarrow as pa

from .. import functions as F
from ..expr.expressions import col, lit

__all__ = ["LINEITEM_ROWS_PER_SF", "ORDERS_ROWS_PER_SF",
           "CUSTOMER_ROWS_PER_SF", "PART_ROWS_PER_SF",
           "SUPPLIER_ROWS_PER_SF", "SEGMENTS", "SHIPMODES", "SHIPINSTRUCT",
           "ORDERPRIORITIES", "TYPE_S1", "TYPE_S2", "TYPE_S3",
           "CONTAINER_S1", "CONTAINER_S2", "COLORS", "NATIONS", "REGIONS",
           "dec_from_unscaled", "day", "gen_lineitem", "gen_orders",
           "gen_customer", "gen_part", "gen_supplier", "gen_partsupp",
           "gen_nation", "gen_region", "gen_all", "queries", "q6",
           "q6_numpy_baseline", "Q6_COLUMNS", "q1", "q1_numpy_baseline",
           "Q1_COLUMNS", "q3", "q3_numpy_baseline"]

LINEITEM_ROWS_PER_SF = 6_001_215
ORDERS_ROWS_PER_SF = 1_500_000
CUSTOMER_ROWS_PER_SF = 150_000
PART_ROWS_PER_SF = 200_000
SUPPLIER_ROWS_PER_SF = 10_000

# the spec's vocabularies (TPC-H v3 clauses 4.2.2.13 and 4.2.3)
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
ORDERPRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                   "5-LOW"]
#: the market segments; BUILDING is code 1
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "MED", "LG", "JUMBO"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "burnished", "chartreuse", "chiffon", "chocolate", "coral",
          "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
          "dim", "dodger", "drab", "firebrick", "floral", "forest",
          "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
          "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
          "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
          "magenta", "maroon", "medium", "metallic", "midnight", "mint",
          "misty", "moccasin", "navajo", "navy", "olive", "orange",
          "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
          "powder", "puff", "purple", "red", "rose", "rosy", "royal",
          "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
          "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
          "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
NATIONS = [  # (name, regionkey), the spec's nation table
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

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
        [None, pa.py_buffer(words)]).cast(
            pa.decimal128(precision, scale))


def day(s: str) -> int:
    """Date literal as int32 days since the epoch."""
    return int((np.datetime64(s) - np.datetime64("1970-01-01"))
               // np.timedelta64(1, "D"))


def _pick(rng, words, n):
    return np.array(words, dtype=object)[rng.integers(0, len(words), n)]


def _take(words, idx) -> pa.Array:
    """words[idx] as an Arrow string array, gathered by Arrow: building it
    from a numpy array of Python or unicode strings took most of a
    minute over SF10's lineitem."""
    return pa.array(list(words), pa.string()).take(pa.array(idx))


def gen_lineitem(sf: float = 0.1, seed: int = 0,
                 full: bool = False) -> pa.Table:
    n = int(LINEITEM_ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n).astype(np.int64) * 100          # dec(12,2)
    price = rng.integers(90_000, 10_500_000, n).astype(np.int64)  # dec(12,2)
    disc = rng.integers(0, 11, n).astype(np.int64)                # dec(4,2)
    tax = rng.integers(0, 9, n).astype(np.int64)
    shipdate = rng.integers(8036, 10591, n).astype(np.int32)      # days
    rf = rng.integers(0, 3, n)
    ls = rng.integers(0, 2, n)
    returnflag = _take(["A", "N", "R"], rf)
    linestatus = _take(["F", "O"], ls)
    okey = rng.integers(0, max(n // 4, 1), n).astype(np.int64)
    cols = {
        "l_orderkey": pa.array(okey, pa.int64()),
        "l_quantity": dec_from_unscaled(qty, 12, 2),
        "l_extendedprice": dec_from_unscaled(price, 12, 2),
        "l_discount": dec_from_unscaled(disc, 4, 2),
        "l_tax": dec_from_unscaled(tax, 4, 2),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": pa.array(shipdate, pa.int32()),
    }
    if full:
        r2 = np.random.default_rng(seed + 104729)
        npart = max(int(PART_ROWS_PER_SF * sf), 1)
        nsupp = max(int(SUPPLIER_ROWS_PER_SF * sf), 1)
        commit = shipdate + r2.integers(-30, 31, n).astype(np.int32)
        receipt = shipdate + r2.integers(1, 31, n).astype(np.int32)
        # (l_partkey, l_suppkey) is one of partsupp's pairs: each part
        # has 4 suppliers
        pk = r2.integers(0, npart, n)
        si = r2.integers(0, 4, n)
        sk = (pk * 4 + si * max(nsupp // 4, 1)) % nsupp
        cols.update({
            "l_partkey": pa.array(pk.astype(np.int64)),
            "l_suppkey": pa.array(sk.astype(np.int64)),
            "l_linenumber": pa.array(
                r2.integers(1, 8, n).astype(np.int32), pa.int32()),
            "l_commitdate": pa.array(commit, pa.int32()),
            "l_receiptdate": pa.array(receipt, pa.int32()),
            "l_shipinstruct": _take(SHIPINSTRUCT, r2.integers(
                0, len(SHIPINSTRUCT), n)),
            "l_shipmode": _take(SHIPMODES, r2.integers(
                0, len(SHIPMODES), n)),
        })
    return pa.table(cols)


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


def gen_orders(sf: float = 0.1, seed: int = 1,
               full: bool = False) -> pa.Table:
    n = int(ORDERS_ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    okey = np.arange(n, dtype=np.int64)
    ckey = rng.integers(0, max(n // 10, 1), n).astype(np.int64)
    odate = rng.integers(8036, 10591, n).astype(np.int32)
    rng.integers(0, 5, n)    # the JAX generator's unused draw, kept in step
    total = rng.integers(100_000, 50_000_000, n).astype(np.int64)
    cols = {
        "o_orderkey": pa.array(okey),
        "o_custkey": pa.array(ckey),
        "o_orderdate": pa.array(odate, pa.int32()),
        "o_totalprice": dec_from_unscaled(total, 15, 2),
        "o_shippriority": pa.array(rng.integers(0, 2, n).astype(np.int32),
                                   pa.int32()),
    }
    if full:
        r2 = np.random.default_rng(seed + 104729)
        # orders reference only custkeys not divisible by 3 (spec clause
        # 4.2.3): a third of the customers have no orders
        ncust = max(n // 10, 1)
        j = r2.integers(0, max(2 * ncust // 3, 1), n)
        cols["o_custkey"] = pa.array(
            (3 * (j // 2) + 1 + (j % 2)).astype(np.int64))
        status = _take(["F", "O", "P"], r2.integers(0, 3, n))
        color = r2.integers(0, len(COLORS), n)
        # about 2 % of the comments carry Q13's exclusion pattern
        special = r2.random(n) < 0.02
        comments = _take(
            list(COLORS) + [c + " special requests" for c in COLORS],
            color + special * len(COLORS))
        cols.update({
            "o_orderstatus": status,
            "o_orderpriority": _take(ORDERPRIORITIES, r2.integers(
                0, len(ORDERPRIORITIES), n)),
            "o_comment": comments,
        })
    return pa.table(cols)


def _phones(rng, nk):
    """`cc-ddd-ddd-dddd` with cc = 10 + nationkey; three draws a row, in
    row order."""
    return np.array([f"{10 + k}-{rng.integers(100,1000)}-"
                     f"{rng.integers(100,1000)}-{rng.integers(1000,10000)}"
                     for k in nk], dtype=object)


def gen_customer(sf: float = 0.1, seed: int = 2,
                 full: bool = False) -> pa.Table:
    n = int(CUSTOMER_ROWS_PER_SF * sf)
    rng = np.random.default_rng(seed)
    cols = {
        "c_custkey": pa.array(np.arange(n, dtype=np.int64)),
        "c_mktsegment": pa.array(np.array(SEGMENTS)[rng.integers(0, 5, n)]),
    }
    if full:
        r2 = np.random.default_rng(seed + 104729)
        nk = r2.integers(0, 25, n)
        phones = _phones(r2, nk)
        acct = r2.integers(-99_999, 1_000_000, n).astype(np.int64)
        cols.update({
            "c_name": pa.array(
                np.array([f"Customer#{i:09d}" for i in range(n)], object),
                pa.string()),
            "c_address": pa.array(_pick(r2, COLORS, n), pa.string()),
            "c_nationkey": pa.array(nk.astype(np.int64)),
            "c_phone": pa.array(phones, pa.string()),
            "c_acctbal": dec_from_unscaled(acct, 12, 2),
        })
    return pa.table(cols)


def gen_part(sf: float = 0.1, seed: int = 3) -> pa.Table:
    n = max(int(PART_ROWS_PER_SF * sf), 1)
    rng = np.random.default_rng(seed)
    c1 = _pick(rng, COLORS, n)
    c2 = _pick(rng, COLORS, n)
    name = c1 + np.array([" "], object) + c2
    ptype = (_pick(rng, TYPE_S1, n) + np.array([" "], object)
             + _pick(rng, TYPE_S2, n) + np.array([" "], object)
             + _pick(rng, TYPE_S3, n))
    container = (_pick(rng, CONTAINER_S1, n) + np.array([" "], object)
                 + _pick(rng, CONTAINER_S2, n))
    brand = np.array([f"Brand#{i}{j}" for i, j in zip(
        rng.integers(1, 6, n), rng.integers(1, 6, n))], dtype=object)
    price = (90_000 + (np.arange(n) % 200_001) * 100
             + rng.integers(0, 100, n)).astype(np.int64)
    return pa.table({
        "p_partkey": pa.array(np.arange(n, dtype=np.int64)),
        "p_name": pa.array(name, pa.string()),
        "p_mfgr": pa.array(np.array(
            [f"Manufacturer#{i}" for i in rng.integers(1, 6, n)], object),
            pa.string()),
        "p_brand": pa.array(brand, pa.string()),
        "p_type": pa.array(ptype, pa.string()),
        "p_size": pa.array(rng.integers(1, 51, n).astype(np.int32),
                           pa.int32()),
        "p_container": pa.array(container, pa.string()),
        "p_retailprice": dec_from_unscaled(price, 12, 2),
    })


def gen_supplier(sf: float = 0.1, seed: int = 4) -> pa.Table:
    n = max(int(SUPPLIER_ROWS_PER_SF * sf), 1)
    rng = np.random.default_rng(seed)
    nk = rng.integers(0, 25, n)
    phones = _phones(rng, nk)
    comments = _pick(rng, COLORS, n)
    # about 1 % of the suppliers get Q16's "Customer Complaints"
    bad = rng.random(n) < 0.01
    comments = np.where(
        bad, comments + np.array([" Customer Complaints"], object),
        comments)
    acct = rng.integers(-99_999, 1_000_000, n).astype(np.int64)
    return pa.table({
        "s_suppkey": pa.array(np.arange(n, dtype=np.int64)),
        "s_name": pa.array(np.array(
            [f"Supplier#{i:09d}" for i in range(n)], object), pa.string()),
        "s_address": pa.array(_pick(rng, COLORS, n), pa.string()),
        "s_nationkey": pa.array(nk.astype(np.int64)),
        "s_phone": pa.array(phones, pa.string()),
        "s_acctbal": dec_from_unscaled(acct, 12, 2),
        "s_comment": pa.array(comments.astype(object), pa.string()),
    })


def gen_partsupp(sf: float = 0.1, seed: int = 5) -> pa.Table:
    npart = max(int(PART_ROWS_PER_SF * sf), 1)
    nsupp = max(int(SUPPLIER_ROWS_PER_SF * sf), 1)
    rng = np.random.default_rng(seed)
    # 4 rows a part, the suppliers spread deterministically
    pk = np.repeat(np.arange(npart, dtype=np.int64), 4)
    n = len(pk)
    sk = ((pk * 4 + np.tile(np.arange(4), npart)
           * max(nsupp // 4, 1)) % nsupp).astype(np.int64)
    cost = rng.integers(100, 100_100, n).astype(np.int64)
    return pa.table({
        "ps_partkey": pa.array(pk),
        "ps_suppkey": pa.array(sk),
        "ps_availqty": pa.array(rng.integers(1, 10_000, n).astype(np.int32),
                                pa.int32()),
        "ps_supplycost": dec_from_unscaled(cost, 12, 2),
    })


def gen_nation() -> pa.Table:
    return pa.table({
        "n_nationkey": pa.array(np.arange(25, dtype=np.int64)),
        "n_name": pa.array([n for n, _ in NATIONS], pa.string()),
        "n_regionkey": pa.array(
            np.array([r for _, r in NATIONS], np.int64)),
    })


def gen_region() -> pa.Table:
    return pa.table({
        "r_regionkey": pa.array(np.arange(5, dtype=np.int64)),
        "r_name": pa.array(REGIONS, pa.string()),
    })


def gen_all(sf: float = 0.1, seed: int = 7) -> dict:
    """All eight tables as pyarrow Tables, foreign-key consistent at this
    sf."""
    return {
        "lineitem": gen_lineitem(sf, seed, full=True),
        "orders": gen_orders(sf, seed, full=True),
        "customer": gen_customer(sf, seed, full=True),
        "part": gen_part(sf),
        "supplier": gen_supplier(sf),
        "partsupp": gen_partsupp(sf),
        "nation": gen_nation(),
        "region": gen_region(),
    }


def queries() -> dict:
    """The ported TPC-H queries, each `fn(tables) -> DataFrame` over a
    dict of DataFrames keyed by table name (`gen_all`'s)."""
    from . import tpch_queries as Q
    reg = {
        1: lambda t: q1(t["lineitem"]),
        3: lambda t: q3(t["customer"], t["orders"], t["lineitem"]),
        6: lambda t: q6(t["lineitem"]),
    }
    for n in Q.PORTED:
        reg[n] = getattr(Q, f"q{n}")
    return dict(sorted(reg.items()))


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
