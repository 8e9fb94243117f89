"""TPC-H Q9, Q18 and Q21 at SF 0.01 under a constrained memory conf, the
PyTorch port (on the CPU) against the JAX package on the same conf and
chip_smoke's exact references: a 512 KiB device budget, a 256 KiB join
build budget, a 4,096-row merge bound and a 128 KiB host spill tier
(the SF10 chip phase's 1 GiB / 64 MiB / 2^20 rows / 512 MiB scaled to
the data), so the joins sub-partition, the aggregates split into
buckets, and the parked batches spill to host memory and on to disk.
Then Q21 with a 64 KiB build budget, whose joins sub-partition too.
Each query must leave no spill handle open, no file behind and the
device reservation where it started.

The JAX package runs the same conf but its device budget (`jax_conf`).
Tolerance: keys, decimals and counts exact; Q9's double within a
relative 1e-12 of the JAX package's (the sub-partitioned joins feed the
grouped sum its rows in another order than the default plan does), and
within chip_smoke's 1e-9 of the exact reference.
"""
import os

import pytest

import chip_smoke
from test_torch_tpch_q2_8_9 import assert_tables_agree
from test_torch_tpch_q4_5_7 import (_few_threads,  # noqa: F401
                                    run_jax, run_port, tpch_tables)

QUERIES = (9, 18, 21)
COUNTERS = ("numSubPartitions", "numSubPartRecursions", "numBucketSplits",
            "numBucketRecursions")


def constrained(spill_dir, build_budget=256 << 10):
    return {"spark.rapids.tpu.sql.batchSizeRows": 4096,
            "spark.rapids.tpu.memory.tpu.poolBytes": 512 << 10,
            "spark.rapids.tpu.sql.join.buildSideBudgetBytes": build_budget,
            "spark.rapids.tpu.sql.agg.maxMergeRows": 4096,
            "spark.rapids.tpu.memory.host.spillStorageSize": 128 << 10,
            "spark.rapids.tpu.memory.spill.dir": str(spill_dir)}


def jax_conf(conf):
    """The same conf for the JAX package, but for its device budget: the
    JAX package sizes one process-wide manager from the first conf that
    reaches it, and under 512 KiB its store runs out (its reservation
    makes one pass of the spill hooks while its broadcast build parks
    batches on another thread). The budget decides what spills, never
    the rows."""
    return {k: v for k, v in conf.items()
            if k != "spark.rapids.tpu.memory.tpu.poolBytes"}


def counters(q):
    out = dict.fromkeys(COUNTERS, 0)
    for m in q.last_metrics().values():
        for k in COUNTERS:
            out[k] += m.get(k, 0)
    return out


def run_constrained(n, tables, conf):
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession(dict(conf), device="cpu")
    store, dm = s.spill_store, s.device_manager
    before = (dict(store.metrics), dm.reserved, store.open_handles)
    q, got = run_port(n, tables, conf, **chip_smoke.tpch_kw(n, tables))
    spills = {k: store.metrics[k] - before[0][k] for k in store.metrics}
    assert (dm.reserved, store.open_handles) == before[1:]
    assert os.listdir(conf["spark.rapids.tpu.memory.spill.dir"]) == []
    chip_smoke.check_tpch(n, got, chip_smoke.tpch_reference(n, tables),
                          "the constrained conf")
    return q, got, spills


@pytest.mark.parametrize("n", QUERIES)
def test_constrained_query_equals_jax(tpch_tables, tmp_path, n):
    conf = constrained(tmp_path)
    q, got, spills = run_constrained(n, tpch_tables, conf)
    c = counters(q)
    assert spills["spillToHost"] > 0 and spills["spillToDisk"] > 0, spills
    if n in (9, 18):
        assert c["numSubPartitions"] > 0, c
    if n in (18, 21):
        assert c["numBucketSplits"] > 0, c
    exp = run_jax(n, tpch_tables, jax_conf(conf),
                  **chip_smoke.tpch_kw(n, tpch_tables))
    assert_tables_agree(got, exp, rtol=1e-12)


def test_q21_subpartitions_under_a_smaller_build_budget(tpch_tables,
                                                        tmp_path):
    q, got, spills = run_constrained(21, tpch_tables, constrained(
        tmp_path, build_budget=64 << 10))
    assert counters(q)["numSubPartitions"] > 0
    assert spills["spillToDisk"] > 0
    _, default = run_port(21, tpch_tables, {},
                          **chip_smoke.tpch_kw(21, tpch_tables))
    assert got.equals(default)
