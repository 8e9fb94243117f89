"""The out-of-core grouped aggregate of the PyTorch port (on the CPU):
the shapes of the JAX suite's `tests/test_aggregate.py:265-323` (every
key distinct, group state over `sql.agg.maxMergeRows` and a 256 KiB
device budget: the partials park as spill handles, spill, and the final
pass splits them into hash buckets of disjoint keys; the same with
string keys) and `tests/test_ooc_recursion.py:28` (10,000 groups over a
256-row merge bound: buckets split again, two levels). Each result must
equal Python's dict and the JAX package's Arrow table of the same query
(the JAX side at its default merge bound, which its own suite holds to
its out-of-core path), sorted by key; a `limit` over the bucket loop
and the partial / final aggregate of a shuffled plan must close every
handle. Tolerance: exact.
"""
import gc
import os

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F


def _metric(q, key):
    return sum(v.get(key, 0) for k, v in q.last_metrics().items()
               if k.startswith("HashAggregateExec"))


def _sorted(at):
    return at.sort_by([(at.column_names[0], "ascending")])


def _run(data, conf, aggs):
    s = pt.TpuSession(dict(conf), device="cpu")
    q = s.create_dataframe(data).group_by("k").agg(*aggs(F))
    out = _sorted(q.to_arrow())
    assert s.spill_store.open_handles == 0
    assert s.device_manager.reserved == 0
    return out, q, s


def _jax(data, aggs):
    s = st.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096})
    return _sorted(s.create_dataframe(data).group_by("k").agg(
        *aggs(JF)).to_arrow())


def test_groupby_out_of_core_bucket_fallback(tmp_path):
    n = 20000
    rng = np.random.default_rng(97)
    keys = rng.permutation(n).astype(np.int64)      # every key distinct
    vals = rng.integers(-100, 100, n).astype(np.int64)
    data = {"k": pa.array(keys), "v": pa.array(vals)}

    def aggs(f):
        return (f.sum("v").alias("sv"), f.count("v").alias("c"))

    out, q, s = _run(data, {
        "spark.rapids.tpu.sql.batchSizeRows": 1024,
        "spark.rapids.tpu.sql.agg.maxMergeRows": 2048,
        "spark.rapids.tpu.memory.tpu.poolBytes": 256 << 10,
        "spark.rapids.tpu.memory.host.spillStorageSize": 128 << 10,
        "spark.rapids.tpu.memory.spill.dir": str(tmp_path)}, aggs)
    got = {k: (sv, c) for k, sv, c in zip(*[out.column(i).to_pylist()
                                           for i in range(3)])}
    assert got == {int(k): (int(v), 1) for k, v in zip(keys, vals)}
    assert out.equals(_jax(data, aggs))
    m = s.spill_store.metrics
    assert m["spillToHost"] > 0 and m["spillToDisk"] > 0, m
    assert _metric(q, "numBucketSplits") >= 1
    assert os.listdir(tmp_path) == []


def test_groupby_out_of_core_string_keys():
    n = 6000
    rng = np.random.default_rng(99)
    keys = [f"user-{i:05d}" for i in rng.permutation(n)]
    vals = rng.integers(0, 50, n).astype(np.int64)
    data = {"k": pa.array(keys), "v": pa.array(vals)}

    def aggs(f):
        return (f.max("v").alias("mx"), f.sum("v").alias("sv"))

    out, q, _ = _run(data, {"spark.rapids.tpu.sql.batchSizeRows": 512,
                            "spark.rapids.tpu.sql.agg.maxMergeRows": 1024},
                     aggs)
    got = dict(zip(out.column(0).to_pylist(), out.column(1).to_pylist()))
    assert got == {k: int(v) for k, v in zip(keys, vals)}
    assert _metric(q, "numBucketSplits") >= 1
    assert out.equals(_jax(data, aggs))


def test_agg_bucket_recursion_two_levels():
    """maxMergeRows=256 with ~10k groups: 16 buckets at depth 0, and a
    second split inside the buckets still over the bound."""
    rng = np.random.default_rng(21)
    n = 40_000
    keys = rng.integers(0, 10_000, n).astype(np.int64)
    vals = rng.integers(-100, 100, n).astype(np.int64)
    data = {"k": pa.array(keys), "v": pa.array(vals)}

    def aggs(f):
        return (f.sum("v").alias("sv"), f.count("*").alias("c"))

    out, q, _ = _run(data, {"spark.rapids.tpu.sql.batchSizeRows": 4096,
                            "spark.rapids.tpu.sql.agg.maxMergeRows": 256},
                     aggs)
    want = {}
    for k, v in zip(keys, vals):
        sv, c = want.get(int(k), (0, 0))
        want[int(k)] = (sv + int(v), c + 1)
    got = {k: (sv, c) for k, sv, c in zip(*[out.column(i).to_pylist()
                                           for i in range(3)])}
    assert got == want
    assert _metric(q, "numBucketRecursions") >= 1, q.last_metrics()
    assert out.equals(_jax(data, aggs))


def test_limit_over_the_bucket_loop_closes_handles():
    n = 8000
    data = {"k": pa.array(np.arange(n)), "v": pa.array(np.arange(n) % 7)}
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024,
                       "spark.rapids.tpu.sql.agg.maxMergeRows": 512},
                      device="cpu")
    before = (s.spill_store.open_handles, s.device_manager.reserved)
    q = s.create_dataframe(data).group_by("k").agg(
        F.sum("v").alias("sv")).limit(3)
    assert q.to_arrow().num_rows == 3
    gc.collect()
    assert (s.spill_store.open_handles, s.device_manager.reserved) == before


@pytest.mark.parametrize("adaptive", [True, False])
def test_partial_final_aggregate_parks_and_closes(adaptive):
    """Many input partitions: partial aggregates per partition, the
    exchange, final aggregates per reduce partition, all parking their
    partials; equal to the single-partition result."""
    rng = np.random.default_rng(5)
    n = 12000
    data = {"k": pa.array(rng.integers(0, 3000, n)),
            "v": pa.array(rng.integers(0, 100, n))}

    def aggs(f):
        return (f.sum("v").alias("sv"), f.min("v").alias("mn"))

    out, q, _ = _run(data, {
        "spark.rapids.tpu.sql.batchSizeRows": 1024,
        "spark.rapids.tpu.sql.agg.maxMergeRows": 512,
        "spark.rapids.tpu.sql.adaptive.enabled": adaptive}, aggs)
    one, _, _ = _run(data, {}, aggs)
    assert out.equals(one)
    assert _metric(q, "numBucketSplits") >= 1
