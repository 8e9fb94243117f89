"""The concurrent collect of the PyTorch port (on the CPU): a plan's
partitions run as tasks on a `tpu-collect` pool under the session's
TpuSemaphore, and the result must equal the same plan with
`sql.concurrentTpuTasks` 1 and the JAX package's, with the pieces in
partition order; `semaphoreWaitMs` and `semaphorePeakHeld` (at most the
permits) on the root. Then TPC-H at SF 0.01 under `concurrentTpuTasks`
2: four queries whole, equal to chip_smoke's exact references (Q12 also
to the JAX package), and a shuffled join and aggregate of their tables
whose root has many partitions, equal to the JAX package.
Tolerance: exact (the grouped sums are decimals and integers).
"""
import threading

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from test_torch_tpch_q4_5_7 import (SHUFFLED, _few_threads,  # noqa: F401
                                    run_jax, run_port, tpch_tables)

CONF = {"spark.rapids.tpu.sql.batchSizeRows": 512,
        "spark.rapids.tpu.sql.adaptive.enabled": False,
        "spark.rapids.tpu.sql.shuffle.partitions": 8}


def _data(n=6000, seed=1):
    rng = np.random.default_rng(seed)
    return {"k": pa.array(rng.integers(0, 400, n)),
            "v": pa.array(rng.integers(-9, 9, n)),
            "s": pa.array([f"s{x}" for x in rng.integers(0, 30, n)])}


def _root_metrics(q):
    return q.last_metrics()[q.last_plan()._op_id]


@pytest.mark.parametrize("tasks", [1, 2, 4])
def test_partitions_run_on_the_pool_in_partition_order(monkeypatch, tasks):
    threads = set()
    orig = HashAggregateExec.execute_partition

    def spy(self, ctx, pid):
        threads.add(threading.current_thread().name)
        yield from orig(self, ctx, pid)

    monkeypatch.setattr(HashAggregateExec, "execute_partition", spy)
    conf = dict(CONF, **{"spark.rapids.tpu.sql.concurrentTpuTasks": tasks})
    s = pt.TpuSession(conf, device="cpu")
    q = s.create_dataframe(_data()).group_by("k", "s").agg(
        F.sum("v").alias("sv"), F.count("*").alias("c"))
    got = q.to_arrow()
    assert q.last_plan().num_partitions(None) == 8
    assert any(t.startswith("tpu-collect") for t in threads), threads
    m = _root_metrics(q)
    assert "semaphoreWaitMs" in m
    assert 1 <= m["semaphorePeakHeld"] <= tasks
    # the same plan, one permit: the same rows in the same order
    s1 = pt.TpuSession(dict(CONF, **{
        "spark.rapids.tpu.sql.concurrentTpuTasks": 1}), device="cpu")
    one = s1.create_dataframe(_data()).group_by("k", "s").agg(
        F.sum("v").alias("sv"), F.count("*").alias("c")).to_arrow()
    assert got.equals(one)
    js = st.TpuSession(conf)
    exp = js.create_dataframe(_data()).group_by("k", "s").agg(
        JF.sum("v").alias("sv"), JF.count("*").alias("c")).to_arrow()
    key = [("k", "ascending"), ("s", "ascending")]
    assert got.sort_by(key).equals(exp.sort_by(key))


def test_one_partition_takes_the_direct_path():
    s = pt.TpuSession({}, device="cpu")
    q = s.create_dataframe(_data(100)).filter(F.col("v") > 0)
    q.to_arrow()
    assert "semaphoreWaitMs" not in _root_metrics(q)
    assert s.semaphore.metrics["acquires"] == 0


def test_a_failing_task_fails_the_query(monkeypatch):
    orig = HashAggregateExec.execute_partition

    def failing(self, ctx, pid):
        if pid == 3:
            raise KeyError("injected")
        yield from orig(self, ctx, pid)

    monkeypatch.setattr(HashAggregateExec, "execute_partition", failing)
    s = pt.TpuSession(CONF, device="cpu")
    with pytest.raises(KeyError):
        s.create_dataframe(_data()).group_by("k").agg(
            F.sum("v").alias("sv")).to_arrow()
    assert s.semaphore.debug_state()["available"] == 2


TASKS2 = dict(SHUFFLED, **{"spark.rapids.tpu.sql.concurrentTpuTasks": 2})


@pytest.mark.parametrize("n", [4, 10, 12, 18])
def test_tpch_queries_equal_the_reference(tpch_tables, n):
    """chip_smoke's exact reference, by its own check, with two permits
    and 4096-row batches (shuffled joins, several reduce partitions)."""
    import chip_smoke
    q, got = run_port(n, tpch_tables, TASKS2,
                      **chip_smoke.tpch_kw(n, tpch_tables))
    chip_smoke.check_tpch(n, got, chip_smoke.tpch_reference(n, tpch_tables),
                          "two permits")


def test_tpch_q12_equals_jax(tpch_tables):
    _, got = run_port(12, tpch_tables, TASKS2)
    assert got.num_rows > 0
    assert got.equals(run_jax(12, tpch_tables, SHUFFLED))


def test_tpch_multi_partition_root_equals_jax(tpch_tables):
    """lineitem joined with orders (shuffled), grouped by order priority
    and ship mode without a sort: the root has 8 partitions."""
    conf = dict(TASKS2, **{"spark.rapids.tpu.sql.adaptive.enabled":
                           False})

    def q(sess, f):
        li = sess.create_dataframe(tpch_tables["lineitem"])
        o = sess.create_dataframe(tpch_tables["orders"]).with_column(
            "l_orderkey", f.col("o_orderkey"))
        return li.join(o, on=["l_orderkey"]).group_by(
            "o_orderpriority", "l_shipmode").agg(
            f.sum("l_quantity").alias("q"), f.count("*").alias("c"))

    s = pt.TpuSession(conf, device="cpu")
    pq = q(s, F)
    got = pq.to_arrow()
    assert pq.last_plan().num_partitions(None) > 1
    assert _root_metrics(pq)["semaphorePeakHeld"] <= 2
    exp = q(st.TpuSession(conf), JF).to_arrow()
    key = [("o_orderpriority", "ascending"), ("l_shipmode", "ascending")]
    assert got.sort_by(key).equals(exp.sort_by(key))
