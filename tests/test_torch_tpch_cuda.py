"""The ported TPC-H queries of `workloads/tpch_queries.py` on the card,
against the port on the CPU, and the expressions and aggregates of
slices 5 and 6 on the card.

Every test here needs a CUDA device and skips without one. The module
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -q tests/test_torch_tpch_cuda.py

The eight `gen_all` tables (sf 0.01, seed 11) go through a CUDA session
and a CPU session with the same conf, on the broadcast plan (the
defaults) and the shuffled one (threshold -1, small batches: partial ->
exchange -> final); the Arrow tables must be equal: exact, but for a
double column, which agrees within a relative 1e-9 (a sum on the card
adds in another order). Q18 runs at a quantity threshold and Q20 at a
nation that give rows at this scale. Also: IF / CASE WHEN / IN and the
decimal128 comparison; the string predicates, substring, `/`, `%` and
the decimal128 casts; min and max over NaN, -0.0, 0.0, nulls, dates and
decimal128, grouped and not, all on columns with nulls.
"""
import math
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expr.expressions import col, lit
from spark_rapids_tpu_torch.workloads import tpch, tpch_queries

PLANS = {"broadcast": {},
         "shuffled": {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
                      "spark.rapids.tpu.sql.batchSizeRows": 4096}}
#: parameters under which Q18 and Q20 have rows at sf 0.01
QUERY_KW = {18: {"qty": 150}, 20: {"nation": "GERMANY"}}
#: a double column's relative tolerance, card against CPU
FLOAT_RTOL = 1e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables():
    return tpch.gen_all(0.01, seed=11)


def _run(device, conf, make, tables):
    s = pt.TpuSession(dict(conf), device=device)
    return make({k: s.create_dataframe(v)
                 for k, v in tables.items()}).to_arrow()


def _same(a, b) -> bool:
    """Equal values, NaN equal to NaN and -0.0 apart from 0.0."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    return a == b


def _assert_equal(gpu, cpu, float_rtol=0.0):
    """Column by column: doubles within float_rtol (exact at 0, NaN and
    the sign of zero included), everything else exact."""
    assert gpu.schema == cpu.schema and gpu.num_rows == cpu.num_rows
    for name in gpu.column_names:
        # bytes: substring counts bytes, so a row may end mid character
        g, c = (t.column(name) for t in (gpu, cpu))
        if pa.types.is_string(g.type):
            g, c = g.cast(pa.binary()), c.cast(pa.binary())
        g, c = g.to_pylist(), c.to_pylist()
        if pa.types.is_floating(gpu.schema.field(name).type) and float_rtol:
            assert all((x is None) == (y is None) for x, y in zip(g, c))
            np.testing.assert_allclose(
                [x for x in g if x is not None],
                [y for y in c if y is not None], rtol=float_rtol)
        else:
            assert all(_same(x, y) for x, y in zip(g, c)), name


@pytest.mark.cuda
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("n", tpch_queries.PORTED)
def test_query_on_the_card_equals_the_cpu(cuda, tables, n, plan):
    def make(t):
        return getattr(tpch_queries, f"q{n}")(t, **QUERY_KW.get(n, {}))
    gpu = _run(cuda, PLANS[plan], make, tables)
    cpu = _run("cpu", PLANS[plan], make, tables)
    assert gpu.num_rows > 0
    _assert_equal(gpu, cpu, FLOAT_RTOL)


@pytest.mark.cuda
def test_case_in_and_decimal128_compare_on_the_card(cuda):
    rng = np.random.default_rng(3)
    n = 5000
    valid = rng.random(n) > 0.2
    at = pa.table({
        "i": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=~valid),
        "s": pa.array(np.array(["a", "bb", "ccc", ""])[
            rng.integers(0, 4, n)], mask=rng.random(n) < 0.1),
        "d": pa.array([decimal.Decimal(int(a) * 10**6 + int(b)).scaleb(-2)
                       for a, b in zip(rng.integers(-10**15, 10**15, n),
                                       rng.integers(0, 10**6, n))],
                      pa.decimal128(24, 2))})

    def make(s):
        df = s.create_dataframe(at)
        return df.select(
            F.when(col("i") > 0, col("i")).when(col("i") < -20, 7)
            .otherwise(lit(None)).alias("cw"),
            col("s").isin("a", "ccc").alias("in_s"),
            col("i").isin(1, 2, 3).alias("in_i"),
            (col("d") > lit(decimal.Decimal("12.345"))).alias("gt"),
            (col("d") <= col("i")).alias("le"))
    gpu = make(pt.TpuSession(device=cuda)).to_arrow()
    cpu = make(pt.TpuSession(device="cpu")).to_arrow()
    assert gpu.equals(cpu)


def _slice6_table(n=6000, seed=5):
    rng = np.random.default_rng(seed)
    words = np.array(["special requests", "requests special", "", "a_b",
                      "forest green", "é%x", "PROMO BRASS", "greenish"])
    f = rng.normal(size=n) * 100
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = 0.0
    unscaled = rng.integers(-10**18, 10**18, n)
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n).astype(np.int64)),
        "s": pa.array(words[rng.integers(0, len(words), n)],
                      mask=rng.random(n) < 0.1),
        "f": pa.array(f, mask=rng.random(n) < 0.1),
        "g": pa.array(rng.normal(size=n) * 3, mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-60, 60, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "dt": pa.array(rng.integers(8000, 10000, n).astype(np.int32),
                       pa.int32()).cast(pa.date32()),
        "d": pa.array([decimal.Decimal(int(v) * 1000 + 7).scaleb(-3)
                       for v in unscaled], pa.decimal128(24, 3),
                      mask=rng.random(n) < 0.1),
        "d2": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in
                        rng.integers(-10**9, 10**9, n)],
                       pa.decimal128(12, 2), mask=rng.random(n) < 0.1)})


@pytest.mark.cuda
@pytest.mark.parametrize("conf", [{}, {"spark.rapids.tpu.sql."
                                       "batchSizeRows": 1000}])
def test_min_max_over_nan_signed_zero_and_decimal128_on_the_card(cuda,
                                                                conf):
    """min maps NaN to +Infinity and max keeps NaN as the greatest; -0.0
    orders below 0.0; on the card as on the CPU, grouped (complete, and
    partial -> final over 1000-row batches) and not."""
    at = _slice6_table()

    def make(s, grouped):
        df = s.create_dataframe(at)
        aggs = [F.min("f").alias("fmin"), F.max("f").alias("fmax"),
                F.min("i").alias("imin"), F.max("dt").alias("dtmax"),
                F.min("d").alias("dmin"), F.max("d").alias("dmax"),
                F.max("d2").alias("d2max")]
        if grouped:
            return df.group_by("k").agg(*aggs).sort("k")
        return df.agg(*aggs)
    for grouped in (False, True):
        gpu = make(pt.TpuSession(dict(conf), device=cuda), grouped)
        cpu = make(pt.TpuSession(dict(conf), device="cpu"), grouped)
        _assert_equal(gpu.to_arrow(), cpu.to_arrow())


@pytest.mark.cuda
def test_string_predicates_division_and_casts_on_the_card(cuda):
    at = _slice6_table()

    def make(s):
        df = s.create_dataframe(at)
        return df.select(
            F.like(col("s"), "%special%requests%").alias("like"),
            F.like(col("s"), "a_b").alias("like_one"),
            F.contains(col("s"), "green").alias("contains"),
            F.startswith(col("s"), "PROMO").alias("starts"),
            F.endswith(col("s"), "BRASS").alias("ends"),
            F.substring(col("s"), -4, 3).alias("sub"),
            F.substring(col("s"), 2).alias("sub_rest"),
            (col("f") / col("g")).alias("fdiv"),
            (col("i") / lit(0)).alias("div0"),
            (col("i") % lit(7)).alias("rem"),
            (col("f") % col("g")).alias("frem"),
            (col("d2") / col("i")).alias("ddiv"),
            col("d").cast(dt.FLOAT64).alias("d_f"),
            col("d").cast(dt.DecimalType(18, 1)).alias("d_d64"),
            col("d").cast(dt.INT64).alias("d_i"),
            col("g").cast(dt.DecimalType(30, 5)).alias("g_d"),
            col("i").cast(dt.DecimalType(25, 2)).alias("i_d"),
            (col("s") == lit(None)).alias("null_eq"))
    gpu = make(pt.TpuSession(device=cuda)).to_arrow()
    cpu = make(pt.TpuSession(device="cpu")).to_arrow()
    _assert_equal(gpu, cpu)
