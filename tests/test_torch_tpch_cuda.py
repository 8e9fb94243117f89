"""TPC-H Q4, Q5, Q7, Q10, Q12, Q18 and Q19 of the port on the card,
against the port on the CPU, and the new expressions on the card.

Every test here needs a CUDA device and skips without one. The module
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -q tests/test_torch_tpch_cuda.py

The eight `gen_all` tables (sf 0.01, seed 11) go through a CUDA session
and a CPU session with the same conf, on the broadcast plan (the
defaults) and the shuffled one (threshold -1, small batches: partial ->
exchange -> final); the Arrow tables must be equal (exact). Q18 runs at
a quantity threshold that gives rows at this scale. Also: IF / CASE
WHEN / IN and the decimal128 comparison on columns with nulls.
"""
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.expr.expressions import col, lit
from spark_rapids_tpu_torch.workloads import tpch, tpch_queries

PLANS = {"broadcast": {},
         "shuffled": {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
                      "spark.rapids.tpu.sql.batchSizeRows": 4096}}
#: a quantity threshold under which Q18 has rows at sf 0.01
Q18_QTY = 150


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


@pytest.mark.cuda
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("n", tpch_queries.PORTED)
def test_query_on_the_card_equals_the_cpu(cuda, tables, n, plan):
    kw = {"qty": Q18_QTY} if n == 18 else {}

    def make(t):
        return getattr(tpch_queries, f"q{n}")(t, **kw)
    gpu = _run(cuda, PLANS[plan], make, tables)
    cpu = _run("cpu", PLANS[plan], make, tables)
    assert gpu.num_rows > 0
    assert gpu.equals(cpu)


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
