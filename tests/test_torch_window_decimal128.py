"""Decimal128 window aggregates of the PyTorch port (on the CPU) against
the JAX package: a twin of every test of `tests/test_window_decimal128.py`
under the same name. Each runs its query through both packages and
requires the port's rows to equal the JAX package's (decimals exactly;
the one double, a decimal128 average, within one ulp: the JAX CPU compile
multiplies by the reciprocal of 10^scale, ROADMAP C.3) and the exact
Python Decimal reference.
"""
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

from test_torch_window import rows, run_both
from torch_parity import assert_same_column


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    n = 600
    k = rng.integers(0, 4, n)
    vals = [Decimal(int(rng.integers(-10**18, 10**18)) * 17) / 100
            for _ in range(n)]
    vals = [None if i % 11 == 0 else v for i, v in enumerate(vals)]
    o = rng.permutation(n)
    return k, o, vals


def _table(data, prec=23):
    k, o, vals = data
    return {"k": pa.array(k), "o": pa.array(o),
            "v": pa.array(vals, pa.decimal128(prec, 2))}


def _rows(k, o, vals):
    return sorted(((int(kk), int(oo), v) for kk, oo, v in zip(k, o, vals)),
                  key=lambda t: (t[0], t[1]))


def _by_key(at):
    return {(r["k"], r["o"]): r for r in at.to_pylist()}


def test_running_sum_min_max_exact(data):
    def q(df, p):
        W = p.W
        w = W.Window.partition_by("k").order_by("o")
        v = p.col("v")
        return df.select(p.col("k"), p.col("o"),
                         W.win_sum(v).over(w).alias("rs"),
                         W.win_min(v).over(w).alias("rm"),
                         W.win_max(v).over(w).alias("rx"),
                         W.win_count(v).over(w).alias("rc"))
    jt, ptab = run_both(_table(data), q, {})
    assert jt.schema == ptab.schema
    assert rows(jt) == rows(ptab)
    got = _by_key(ptab)
    run = {}
    for kk, oo, v in _rows(*data):
        ssum, smin, smax, cnt = run.get(kk, (Decimal(0), None, None, 0))
        if v is not None:
            ssum += v
            smin = v if smin is None else min(smin, v)
            smax = v if smax is None else max(smax, v)
            cnt += 1
        run[kk] = (ssum, smin, smax, cnt)
        g = got[(kk, oo)]
        assert g["rc"] == cnt
        if cnt:
            assert (g["rs"], g["rm"], g["rx"]) == (ssum, smin, smax)
        else:
            assert g["rs"] is None and g["rm"] is None


def test_whole_partition_and_avg(data):
    def q(df, p):
        w = p.W.Window.partition_by("k")
        return df.select(p.col("k"),
                         p.W.win_sum(p.col("v")).over(w).alias("ts"),
                         p.W.win_avg(p.col("v")).over(w).alias("ta"))
    jt, ptab = run_both(_table(data), q, {})
    assert rows(jt.select(["k", "ts"])) == rows(ptab.select(["k", "ts"]))
    order = [jt.column_names.index(c) for c in ("k", "ts")]
    js = sorted(zip(*[jt.column(i).to_pylist() for i in (*order, 2)]))
    ps = sorted(zip(*[ptab.column(i).to_pylist() for i in (*order, 2)]))
    assert_same_column(pa.array([r[2] for r in js]),
                       pa.array([r[2] for r in ps]), "ta", max_ulps=1)
    exp = {}
    for kk, _, v in _rows(*data):
        t, c = exp.get(kk, (Decimal(0), 0))
        exp[kk] = (t + v, c + 1) if v is not None else (t, c)
    for r in ptab.to_pylist():
        t, c = exp[r["k"]]
        assert r["ts"] == t
        assert r["ta"] == pytest.approx(float(t / c), rel=1e-12)


def test_bounded_frame_sum(data):
    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o").rows_between(-2, 0)
        return df.select(p.col("k"), p.col("o"),
                         p.W.win_sum(p.col("v")).over(w).alias("s3"))
    jt, ptab = run_both(_table(data), q, {})
    assert rows(jt) == rows(ptab)
    got = _by_key(ptab)
    per_key = {}
    for kk, oo, v in _rows(*data):
        per_key.setdefault(kk, []).append((oo, v))
    for kk, rs in per_key.items():
        for i, (oo, _) in enumerate(rs):
            vs = [v for _, v in rs[max(0, i - 2):i + 1] if v is not None]
            assert got[(kk, oo)]["s3"] == (sum(vs, Decimal(0)) if vs
                                           else None)


def test_d64_sum_widening_to_d128():
    vals = [Decimal("9999999999999.99"), Decimal("-0.01"),
            Decimal("8888888888888.88")]
    data = {"k": pa.array([1, 1, 1]), "o": pa.array([1, 2, 3]),
            "v": pa.array(vals, pa.decimal128(15, 2))}

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select(p.W.win_sum(p.col("v")).over(w).alias("rs"))
    jt, ptab = run_both(data, q, {})
    assert jt.column("rs").to_pylist() == ptab.column("rs").to_pylist() \
        == [vals[0], vals[0] + vals[1], sum(vals)]


@pytest.mark.parametrize("lo,hi", [(-2, 0), (-1, 1), (0, 3), (-4, -1)])
def test_bounded_rows_minmax_d128(data, lo, hi):
    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o").rows_between(lo, hi)
        return df.select(p.col("k"), p.col("o"),
                         p.W.win_min(p.col("v")).over(w).alias("mn"),
                         p.W.win_max(p.col("v")).over(w).alias("mx"))
    jt, ptab = run_both(_table(data), q, {})
    assert rows(jt) == rows(ptab)
    got = _by_key(ptab)
    by_part = {}
    for kk, oo, v in _rows(*data):
        by_part.setdefault(kk, []).append((oo, v))
    for kk, rs in by_part.items():
        for i, (oo, _) in enumerate(rs):
            a, b = max(0, i + lo), min(len(rs) - 1, i + hi)
            vs = [rs[j][1] for j in range(a, b + 1)
                  if rs[j][1] is not None]
            g = got[(kk, oo)]
            assert (g["mn"], g["mx"]) == ((min(vs), max(vs)) if vs
                                          else (None, None))


def test_bounded_range_minmax_d128(data):
    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o").range_between(-5, 5)
        return df.select(p.col("k"), p.col("o"),
                         p.W.win_min(p.col("v")).over(w).alias("mn"),
                         p.W.win_max(p.col("v")).over(w).alias("mx"))
    jt, ptab = run_both(_table(data), q, {})
    assert rows(jt) == rows(ptab)
    got = _by_key(ptab)
    by_part = {}
    for kk, oo, v in _rows(*data):
        by_part.setdefault(kk, []).append((oo, v))
    for kk, rs in by_part.items():
        for oo, _ in rs:
            vs = [v2 for o2, v2 in rs if oo - 5 <= o2 <= oo + 5
                  and v2 is not None]
            g = got[(kk, oo)]
            assert (g["mn"], g["mx"]) == ((min(vs), max(vs)) if vs
                                          else (None, None))
