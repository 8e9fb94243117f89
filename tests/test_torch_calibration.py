"""The adaptive calibration loop in the port (`plan/stats.py`): the
shapes of the JAX suite's `tests/test_aqe_replan.py:210-309`.

`harvest_calibration` swallows its own errors after a run, as the JAX
package's does, so these tests show that it records: a run at the
default conf records entries; a scoped lookup hits and an unscoped one
misses; adaptive execution or calibration off records nothing; a query
with a limit records nothing; and on a Q5-shaped chain whose NDVs are
deliberately stale, the first plan keeps the written (blow-up) order,
its run records the join sets' true cardinalities, and the second plan
of the same query picks the selective order, as the JAX package's does.
Each test clears the process-wide table first.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.plan import stats as ps
from spark_rapids_tpu_torch.plan.optimizer import optimize

CONF = {"spark.rapids.tpu.sql.batchSizeRows": 512,
        "spark.rapids.tpu.sql.shuffle.partitions": 8,
        "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes": 4096}


@pytest.fixture(autouse=True)
def _clean_table():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    ps.clear_calibration()
    yield
    ps.clear_calibration()
    torch.set_num_threads(prev)


def _session(**extra):
    return pt.TpuSession(dict(CONF, **extra), device="cpu")


def _grouped(s):
    df = s.create_dataframe({"k": pa.array([i % 11 for i in range(4000)]),
                             "v": pa.array([float(i)
                                            for i in range(4000)])})
    return df.group_by("k").agg(F.sum("v").alias("sv"))


def test_harvest_records_and_a_scoped_lookup_hits():
    q = _grouped(_session())
    q.to_arrow()
    entries = ps.calibration_stats()["calibration_entries"]
    assert entries > 0
    # the scan's observed rows are its row count
    scan = q._plan
    while scan.children:
        scan = scan.children[0]
    key = ps.logical_fp(scan)
    with ps.calibration_scope(True):
        hits = ps.calibration_stats()["calibration_hits"]
        assert ps.calibration_lookup(key) == 4000.0
        assert ps.calibration_stats()["calibration_hits"] == hits + 1
        agg = q._plan
        while not hasattr(agg, "keys"):
            agg = agg.children[0]
        assert ps.compute_stats(agg).rows == 11.0
    assert ps.calibration_lookup(key) is None        # out of scope


def test_harvest_returns_what_it_recorded():
    q = _grouped(_session())
    q.to_arrow()
    ps.clear_calibration()
    from spark_rapids_tpu_torch.exec.base import ExecContext
    ctx = ExecContext(q._session.conf, torch.device("cpu"))
    ctx.metrics = q.last_metrics()
    n = ps.harvest_calibration(q.last_plan(), ctx)
    assert n > 0 and ps.calibration_stats()["calibration_entries"] > 0


@pytest.mark.parametrize("off", ["spark.rapids.tpu.sql.adaptive.enabled",
                                 "spark.rapids.tpu.sql.adaptive."
                                 "calibration.enabled"])
def test_gated_off_harvests_nothing(off):
    _grouped(_session(**{off: False})).to_arrow()
    assert ps.calibration_stats()["calibration_entries"] == 0


def test_limit_query_records_nothing():
    s = _session()
    df = s.create_dataframe({"k": pa.array(list(range(1000))),
                             "v": pa.array([float(i)
                                            for i in range(1000)])})
    df.sort("k").limit(5).to_arrow()
    assert ps.calibration_stats()["calibration_entries"] == 0


def _leaves(plan):
    out = []

    def walk(nd):
        if type(nd).__name__ == "Join":
            walk(nd.left)
            walk(nd.right)
        elif type(nd).__name__ in ("Project", "Filter"):
            walk(nd.children[0])
        else:
            out.append(tuple(sorted(nd.schema.names)))
    walk(plan)
    return out


def test_stale_estimate_corrected_on_the_second_run():
    s = _session(**{"spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                    -1})
    n = 3000
    rng = np.random.default_rng(7)
    a = s.create_dataframe({"j": pa.array(rng.integers(0, 30, n)),
                            "c_k": pa.array(np.arange(n))})
    b = s.create_dataframe({"j": pa.array(rng.integers(0, 30, n)),
                            "b_v": pa.array(rng.random(n))})
    c = s.create_dataframe({"c_k": pa.array(np.arange(10)),
                            "c_v": pa.array(rng.random(10))})
    # stale: j near-unique (A >< B looks selective), c_k in A 10 values
    a._plan._ndv_cache = {"j": float(n), "c_k": 10.0}
    b._plan._ndv_cache = {"j": float(n)}
    q = a.join(b, on=["j"]).join(c, on=["c_k"])
    with ps.calibration_scope(True):
        first = optimize(q._plan, s.conf)
    assert _leaves(first) == _leaves(q._plan)
    want = q.to_arrow()      # the blow-up order runs; the truth recorded
    assert ps.calibration_stats()["calibration_entries"] > 0
    q2 = a.join(b, on=["j"]).join(c, on=["c_k"])
    with ps.calibration_scope(True):
        second = optimize(q2._plan, s.conf)
    assert _leaves(second) != _leaves(q2._plan)
    inner = [None]

    def walk(nd):
        if type(nd).__name__ == "Join":
            inner[0] = nd
        for ch in nd.children:
            walk(ch)
    walk(second)
    sides = {_leaves(inner[0].left)[0], _leaves(inner[0].right)[0]}
    assert ("b_v", "j") not in sides
    assert ps.calibration_stats()["calibration_hits"] > 0
    # the corrected plan gives the same rows
    got = q2.to_arrow()
    cols = sorted(want.column_names)
    assert sorted(map(tuple, got.select(cols).to_pylist())) == \
        sorted(map(tuple, want.select(cols).to_pylist()))
