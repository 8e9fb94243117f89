"""TPC-H Q3 and the hash join of the port on the card, against the port
on the CPU.

Every test here needs a CUDA device and skips without one. The module
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -q tests/test_torch_q3_cuda.py

The same tables (from seeds) go through a CUDA session and a CPU session
with the same conf; the Arrow tables must be equal (exact). Covered: Q3
on the broadcast and the shuffled topology, its unlimited sorted result;
each ported `how` on the direct, sorted (promoted and not) and generic
count builds with null keys; the string-literal compares.
"""
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.expr.expressions import col, lit
from spark_rapids_tpu_torch.session import DataFrame
from spark_rapids_tpu_torch.workloads import tpch

HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables():
    return (tpch.gen_customer(0.01, seed=5), tpch.gen_orders(0.01, seed=6),
            tpch.gen_lineitem(0.01, seed=7))


def _both(cuda, make, conf):
    return (make(pt.TpuSession(dict(conf), device=cuda)).to_arrow(),
            make(pt.TpuSession(dict(conf), device="cpu")).to_arrow())


def _q3(tables, limit=True):
    def make(s):
        q = tpch.q3(*(s.create_dataframe(t) for t in tables))
        return q if limit else DataFrame(q._session, q._plan.child)
    return make


def _sorted(at):
    return at.sort_by([(c, "ascending") for c in at.column_names])


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [10 << 20, -1])
@pytest.mark.parametrize("limit", [True, False])
def test_q3_on_the_card_equals_the_cpu(cuda, tables, threshold, limit):
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 8192,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": threshold}
    gpu, cpu = _both(cuda, _q3(tables, limit), conf)
    assert gpu.num_rows == (10 if limit else cpu.num_rows) > 0
    if limit:
        assert gpu.equals(cpu)
    else:
        assert _sorted(gpu).equals(_sorted(cpu))


def _join_tables(seed, dup, nulls, key_type):
    rng = np.random.default_rng(seed)
    n_b, n_s = 3000, 5000
    bkey = (rng.integers(0, 1500, n_b) if dup
            else rng.permutation(4000)[:n_b]).astype(np.int64)
    skey = rng.integers(0, 4000, n_s).astype(np.int64)
    if key_type == "wide":     # a span past the direct build's limit
        bkey, skey = bkey * (1 << 40), skey * (1 << 40)
    bvalid = rng.random(n_b) > (0.1 if nulls else 0)
    svalid = rng.random(n_s) > (0.1 if nulls else 0)

    def keycol(k, v):
        if key_type == "string":
            return pa.array([f"k{x}" if ok else None for x, ok in zip(k, v)])
        return pa.array(k, mask=~v)
    build = pa.table({"k": keycol(bkey, bvalid),
                      "b": pa.array(rng.integers(0, 100, n_b)),
                      "s": pa.array([f"s{x}" for x in range(n_b)])})
    stream = pa.table({"k": keycol(skey, svalid),
                       "a": pa.array(rng.integers(0, 100, n_s))})
    return stream, build


@pytest.mark.cuda
@pytest.mark.parametrize("key_type", ["int", "wide", "string"])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_join_on_the_card_equals_the_cpu(cuda, how, dup, key_type):
    stream, build = _join_tables(3, dup, True, key_type)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 2048}

    def make(s):
        return s.create_dataframe(stream).join(s.create_dataframe(build),
                                               on=["k"], how=how)
    gpu, cpu = _both(cuda, make, conf)
    assert _sorted(gpu).equals(_sorted(cpu))


@pytest.mark.cuda
def test_string_literal_compares_on_the_card(cuda):
    words = ["BUILDING", "BUILDING\x00", "BUILDIN", "", None, "MACHINERY",
             "building", "BUILDINGS"] * 50
    t = pa.table({"w": pa.array(words)})

    def make(s):
        df = s.create_dataframe(t)
        return df.select((col("w") == lit("BUILDING")).alias("eq"),
                         (col("w") != lit("BUILDING")).alias("ne"),
                         (col("w") < lit("BUILDING")).alias("lt"),
                         (col("w") >= lit("BUILDING")).alias("ge"))
    gpu, cpu = _both(cuda, make, {})
    assert gpu.equals(cpu)
    assert gpu.column("eq").to_pylist()[:2] == [True, False]
    assert pc.sum(gpu.column("eq")).as_py() == 50
