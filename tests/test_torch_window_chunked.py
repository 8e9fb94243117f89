"""The port's chunked (out-of-core) window path against its in-core path
and the JAX package, and the JAX package's window faults that the port
does not copy (ROADMAP C.23-C.26), each on its smallest input, held to a
Python reference (`math.fsum` per frame for doubles, Decimal for
decimals). Each fault test also asserts what the JAX package does there,
so the record stays checked.

The chunked path runs under forced small `sql.window.chunkRows` and
out-of-core sort thresholds, so the stream has many chunks, ties span
chunk edges (the peer-group holdback) and null partition keys stay
contiguous; its rows must equal the in-core rows bit for bit, doubles
included (their sums are exact, `exec/window.py` `xsum_frames`).
"""
import math
import random
import struct
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.exec.window import _xsum_range, xsum_frames

from test_torch_window import PORT, rows, run_both

CHUNKED = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
           "spark.rapids.tpu.sql.window.chunkRows": 1024,
           "spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes": 16 << 10}
IN_CORE = {"spark.rapids.tpu.sql.window.chunkRows": 0}


def _port(data, make, conf):
    s = pt.TpuSession(conf, device="cpu")
    df = make(s.create_dataframe(data), PORT)
    out = df.to_arrow()
    return out, df.last_metrics()


def _chunks(metrics) -> int:
    return int(sum(m.get("numChunks", 0) for m in metrics.values()))


@pytest.fixture(scope="module")
def mixed():
    """6,000 rows: a null every 13th partition key, heavy order ties,
    doubles of mixed magnitude (NaN and infinities in a few partitions),
    decimal(15,2) money whose sum widens to decimal(25,2)."""
    rng = np.random.default_rng(5)
    n = 6000
    k = [None if i % 13 == 0 else int(x)
         for i, x in enumerate(rng.integers(0, 7, n))]
    d = rng.normal(0, 1, n) * 10.0 ** rng.integers(-8, 12, n)
    d[rng.integers(0, n, 4)] = np.nan
    d[rng.integers(0, n, 3)] = np.inf
    d[rng.integers(0, n, 3)] = -np.inf
    cents = rng.integers(-10**14, 10**14, n)
    return {"k": pa.array(k, pa.int64()),
            "o": pa.array(rng.integers(0, 40, n).astype(np.int32)),
            "d": pa.array(d, mask=rng.random(n) < 0.05),
            "m": pa.array([Decimal(int(c)) / 100 for c in cents],
                          pa.decimal128(15, 2)),
            "i": pa.array(rng.integers(-1000, 1000, n), mask=rng.random(n)
                          < 0.05)}


def _running_query(df, p):
    W = p.W
    w = W.Window.partition_by("k").order_by("o")
    c = p.col
    return df.select(c("k"), c("o"), c("d"), c("m"), c("i"),
                     W.row_number().over(w).alias("rn"),
                     W.rank().over(w).alias("rk"),
                     W.dense_rank().over(w).alias("dr"),
                     W.win_sum(c("d")).over(w).alias("sd"),
                     W.win_avg(c("d")).over(w).alias("ad"),
                     W.win_min(c("d")).over(w).alias("nd"),
                     W.win_max(c("d")).over(w).alias("xd"),
                     W.win_sum(c("m")).over(w).alias("sm"),
                     W.win_avg(c("m")).over(w).alias("am"),
                     W.win_max(c("m")).over(w).alias("xm"),
                     W.win_sum(c("i")).over(w).alias("si"),
                     W.win_count(c("i")).over(w).alias("ci"))


def _canon(r):
    """A row with NaN as a string, so sorted rows compare equal."""
    return tuple("nan" if isinstance(v, float) and math.isnan(v) else v
                 for v in r)


def _bits(r):
    """A row with each double as its bytes: sorted rows then compare bit
    for bit (NaN, the sign of a zero)."""
    return tuple(struct.pack("<d", v) if isinstance(v, float) else v
                 for v in r)


def test_chunked_equals_incore_bit_for_bit(mixed):
    chunked, cm = _port(mixed, _running_query, CHUNKED)
    incore, im = _port(mixed, _running_query, IN_CORE)
    assert _chunks(cm) > 4 and _chunks(im) == 0, (cm, im)
    key = lambda r: tuple((v is None, v) for v in r)   # noqa: E731
    a = sorted((_bits(r) for r in zip(*[c.to_pylist()
                                        for c in chunked.columns])), key=key)
    b = sorted((_bits(r) for r in zip(*[c.to_pylist()
                                        for c in incore.columns])), key=key)
    assert a == b


def test_chunked_sums_equal_python(mixed):
    """The chunked running sums against Python: `math.fsum` of each
    frame's doubles (NaN, one infinity, both), Decimal of the money,
    the wrapping int64 sum."""
    out, _ = _port(mixed, _running_query, CHUNKED)
    src = list(zip(*[mixed[c].to_pylist() for c in ("k", "o", "d", "m",
                                                    "i")]))
    by = {}
    for r in src:
        by.setdefault(r[0], []).append(r)
    want = {}
    for k, rs in by.items():
        for o in {r[1] for r in rs}:
            fr = [r for r in rs if r[1] <= o]
            ds = [r[2] for r in fr if r[2] is not None]
            if any(math.isnan(v) for v in ds) or (
                    math.inf in ds and -math.inf in ds):
                sd = "nan"
            elif math.inf in ds:
                sd = math.inf
            elif -math.inf in ds:
                sd = -math.inf
            else:
                sd = math.fsum(ds) if ds else None
            ms = [r[3] for r in fr if r[3] is not None]
            want[(k, o)] = (sd, sum(ms, Decimal(0)) if ms else None)
    for r in out.select(["k", "o", "sd", "sm"]).to_pylist():
        sd = r["sd"]
        sd = "nan" if isinstance(sd, float) and math.isnan(sd) else sd
        assert (sd, r["sm"]) == want[(r["k"], r["o"])], r


def test_chunked_integer_columns_equal_jax(mixed):
    """The ranking, integer and decimal64-input columns of the port's
    chunked path against the JAX package's in-core result (its double
    sums cancel across partitions, C.24, and its decimal average is off
    by 10^scale, C.26: those columns are left out)."""
    def q(df, p):
        W = p.W
        w = W.Window.partition_by("k").order_by("o")
        c = p.col
        return df.select(c("k"), c("o"), c("i"),
                         W.row_number().over(w).alias("rn"),
                         W.rank().over(w).alias("rk"),
                         W.dense_rank().over(w).alias("dr"),
                         W.win_sum(c("i")).over(w).alias("si"),
                         W.win_min(c("i")).over(w).alias("ni"),
                         W.win_count(c("i")).over(w).alias("ci"))
    jt, _ = run_both(mixed, q)
    chunked, cm = _port(mixed, q, CHUNKED)
    assert _chunks(cm) > 4
    # row_number among tied (k, o) rows pairs with any i: compare it apart
    assert rows(jt.drop(["i", "rn"])) == rows(chunked.drop(["i", "rn"]))
    assert rows(jt.select(["k", "o", "rn"])) == \
        rows(chunked.select(["k", "o", "rn"]))


def test_c23_chunked_decimal_sum_widening_to_d128():
    """C.23: SUM over decimal(15,2) is decimal(25,2); the chunked JAX path
    adds int64 running sums and hands a one-word array to Arrow."""
    rng = np.random.default_rng(7)
    n = 6000
    k = rng.integers(0, 5, n)
    o = rng.integers(0, 1000, n)
    vals = [Decimal(int(c)) / 100 for c in rng.integers(-10**14, 10**14, n)]
    data = {"k": pa.array(k), "o": pa.array(o),
            "v": pa.array(vals, pa.decimal128(15, 2))}

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select(p.col("k"), p.col("o"),
                         p.W.win_sum(p.col("v")).over(w).alias("s"))
    got, m = _port(data, q, CHUNKED)
    assert _chunks(m) > 1
    assert got.schema.field("s").type == pa.decimal128(25, 2)
    want = {}
    for kk in set(k.tolist()):
        rs = [(oo, v) for kk2, oo, v in zip(k, o, vals) if kk2 == kk]
        for oo in {r[0] for r in rs}:
            want[(kk, oo)] = sum((v for o2, v in rs if o2 <= oo),
                                 Decimal(0))
    for r in got.to_pylist():
        assert r["s"] == want[(r["k"], r["o"])]
    incore, _ = _port(data, q, IN_CORE)
    assert rows(incore) == rows(got)
    with pytest.raises(Exception, match="too small"):
        run_both(data, q, CHUNKED)


C24 = {"k": pa.array([1, 1, 1, 2, 2]), "o": pa.array([1, 2, 3, 1, 2]),
       "f": pa.array([1.0, math.nan, 2.0, 3.0, 4.0]),
       "g": pa.array([1e17, 1.0, 1.0, 3.0, 4.0])}


def _fsum_frames(vals, keys, lo_off, hi_off):
    out = []
    for i, (v, kk) in enumerate(zip(vals, keys)):
        fr = [vals[j] for j in range(len(vals))
              if keys[j] == kk and i + lo_off <= j <= i + hi_off]
        out.append(math.nan if any(math.isnan(x) for x in fr)
                   else math.fsum(fr))
    return out


def test_c24_double_sums_are_segment_local():
    """C.24: the JAX running and bounded double sums difference one prefix
    over the whole batch, so a NaN or a large value of partition 1
    reaches partition 2."""
    def q(df, p):
        W = p.W
        w = W.Window.partition_by("k").order_by("o")
        return df.select(p.col("k"), p.col("o"),
                         W.win_sum(p.col("f")).over(w).alias("fs"),
                         W.win_sum(p.col("g")).over(w).alias("gs"),
                         W.win_sum(p.col("f")).over(
                             w.rows_between(-1, 0)).alias("fb"))
    jt, ptab = run_both(C24, q)
    keys = [1, 1, 1, 2, 2]
    f, g = C24["f"].to_pylist(), C24["g"].to_pylist()
    want = {"fs": _fsum_frames(f, keys, -9, 0),
            "gs": _fsum_frames(g, keys, -9, 0),
            "fb": _fsum_frames(f, keys, -1, 0)}
    for name, w in want.items():
        got = ptab.column(name).to_pylist()
        assert [_canon((x,)) for x in got] == [_canon((x,)) for x in w], \
            name
    assert ptab.column("gs").to_pylist() == [1e17, 1e17, 1e17, 3.0, 7.0]
    # the JAX package: [1, NaN, NaN, NaN, NaN] and [1e17, 1e17, 1e17, 0, 0]
    jf = jt.column("fs").to_pylist()
    assert jf[0] == 1.0 and all(math.isnan(x) for x in jf[1:])
    assert jt.column("gs").to_pylist() == [1e17, 1e17, 1e17, 0.0, 0.0]
    jb = jt.column("fb").to_pylist()
    assert jb[0] == 1.0 and all(math.isnan(x) for x in jb[1:])


def test_c25_lag_lead_defaults_of_any_type():
    """C.25: the JAX lag skips a string's default and cannot broadcast a
    decimal128 one."""
    data = {"k": pa.array([1, 1, 1, 2, 2]), "o": pa.array([1, 2, 3, 1, 2]),
            "s": pa.array(["a", None, "ccc", "d", "e"]),
            "d": pa.array([Decimal("1.00"), Decimal("2.50"), None,
                           Decimal("4.00"), Decimal("5.25")],
                          pa.decimal128(30, 2))}

    def qs(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select(p.col("k"), p.col("o"),
                         p.W.lag(p.col("s"), 1, "zz").over(w).alias("lg"),
                         p.W.lead(p.col("s"), 2, "").over(w).alias("ld"))

    def qd(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select(p.W.lag(p.col("d"), 1, Decimal("9.00")).over(w)
                         .alias("lg"))
    jt, ptab = run_both(data, qs)
    assert ptab.column("lg").to_pylist() == ["zz", "a", None, "zz", "d"]
    assert ptab.column("ld").to_pylist() == ["ccc", "", "", "", ""]
    assert jt.column("lg").to_pylist() == [None, "a", None, None, "d"]
    s = pt.TpuSession({}, device="cpu")
    got = qd(s.create_dataframe(data), PORT).to_arrow()
    assert got.column("lg").to_pylist() == [
        Decimal("9.00"), Decimal("1.00"), Decimal("2.50"), Decimal("9.00"),
        Decimal("4.00")]
    with pytest.raises(ValueError, match="broadcast"):
        run_both(data, qd)


def test_c26_decimal_average_is_scaled():
    """C.26: the JAX window average over a decimal(15,2) divides the
    unscaled sum by the count (150.0 for 1.50)."""
    data = {"k": pa.array([1, 1, 2]), "o": pa.array([1, 2, 1]),
            "v": pa.array([Decimal("1.50"), Decimal("2.25"),
                           Decimal("3.00")], pa.decimal128(15, 2))}

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select(p.W.win_avg(p.col("v")).over(w).alias("a"))
    jt, ptab = run_both(data, q)
    assert ptab.column("a").to_pylist() == [1.5, 1.875, 3.0]
    assert jt.column("a").to_pylist() == [150.0, 187.5, 300.0]


@pytest.mark.parametrize("seed", range(4))
def test_exact_double_frames_equal_fsum(seed):
    """`xsum_frames` over random frames of values from 1e-300 to 1e300,
    subnormals and cancelling pairs: equal to `math.fsum` of each frame
    (an overflowing frame: the infinity of its sign)."""
    rnd = random.Random(seed)
    n = 60
    xs = [rnd.choice([math.ldexp(rnd.uniform(-1, 1), rnd.randint(-1074, 1000)),
                      rnd.uniform(-1e6, 1e6), 1e17, -1e17, 5e-324, 3.0])
          for _ in range(n)]
    x = torch.tensor(xs, dtype=torch.float64)
    ok = torch.tensor([rnd.random() < 0.9 for _ in range(n)])
    lo = torch.tensor([rnd.randint(0, n - 1) for _ in range(n)])
    hi = torch.tensor([rnd.randint(0, n - 1) for _ in range(n)])
    elo, ehi = (int(v) for v in _xsum_range(x, ok))
    got = xsum_frames(x, ok, lo, hi, elo, ehi).tolist()
    for i in range(n):
        fr = [xs[j] for j in range(int(lo[i]), int(hi[i]) + 1) if ok[j]]
        try:
            want = math.fsum(fr)
        except OverflowError:
            want = math.copysign(math.inf, sum(fr))
        assert got[i] == want, (i, fr)
