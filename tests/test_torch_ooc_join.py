"""The out-of-core sub-partitioned hash join of the PyTorch port (on the
CPU) against the JAX package and the port's own in-core join: the shapes
of the JAX suite's `tests/test_ooc_join.py` (a build of about 3,000 rows
over a 16 KiB `sql.join.buildSideBudgetBytes`, every `how`, held to
the JAX package's join of the same tables; a small device budget that
must spill the piles to host memory and disk) and
`tests/test_ooc_recursion.py:55-133` (a 2 KiB budget whose piles split
again; a `limit` that abandons the join and an error in mid-stream,
both of which must close every handle and give the device reservation
back). Also a join with a condition, a two-key join with a string key,
a broadcast (demoted) join and a shuffled one under the budget.

The row order of a join output is not defined: results compare sorted
by every column. Tolerance: exact.
"""
import gc
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.expr.expressions import col as jcol
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.expr.expressions import col

OOC = {"spark.rapids.tpu.sql.join.buildSideBudgetBytes": 16 << 10}
BASE = {"spark.rapids.tpu.sql.batchSizeRows": 512,
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 16}
HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mk(n_l, n_r, seed, with_nulls=True):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, n_r * 2, n_l).astype(np.int64).tolist()
    rk = rng.permutation(n_r * 2)[:n_r].astype(np.int64).tolist()
    if with_nulls:
        lk = [None if i % 97 == 0 else k for i, k in enumerate(lk)]
        rk = [None if i % 89 == 0 else k for i, k in enumerate(rk)]
    ldata = {"k": pa.array(lk, pa.int64()),
             "lv": pa.array(np.arange(n_l).astype(np.int64))}
    rdata = {"k": pa.array(rk, pa.int64()),
             "rv": pa.array((np.arange(n_r) * 7).astype(np.int64)),
             "tag": pa.array([f"r-{i}" for i in range(n_r)])}
    return ldata, rdata


def _rows(out):
    return sorted(zip(*[c.to_pylist() for c in out.columns]),
                  key=lambda t: tuple((x is None, x) for x in t))


def _metric(q, key):
    return sum(v.get(key, 0) for k, v in q.last_metrics().items()
               if k.startswith("HashJoinExec"))


def _port(ldata, rdata, how, conf, **kw):
    s = pt.TpuSession(dict(BASE, **conf), device="cpu")
    q = s.create_dataframe(ldata).join(s.create_dataframe(rdata),
                                       on=["k"], how=how, **kw)
    out = q.to_arrow()
    assert s.spill_store.open_handles == 0
    assert s.device_manager.reserved == 0
    return _rows(out), q, s


def _jax(ldata, rdata, how, conf, **kw):
    s = st.TpuSession(dict(BASE, **conf))
    return _rows(s.create_dataframe(ldata).join(
        s.create_dataframe(rdata), on=["k"], how=how, **kw).to_arrow())


@pytest.fixture(scope="module")
def data():
    return _mk(4000, 3000, seed=5)


@pytest.mark.parametrize("how", HOWS)
def test_subpartition_join_matches_jax(data, how):
    ldata, rdata = data
    got, q, _ = _port(ldata, rdata, how, OOC)
    assert _metric(q, "numSubPartitions") > 0
    want, _, _ = _port(ldata, rdata, how, {})
    assert got == want, f"{how}: {len(got)} vs {len(want)} rows"
    assert got == _jax(ldata, rdata, how, {})


def test_subpartition_join_uses_spill(tmp_path):
    """With a 64 KiB device budget the piles spill to host memory, and
    past a 16 KiB host tier to disk; the join completes, and no file
    stays behind."""
    ldata, rdata = _mk(6000, 5000, seed=9, with_nulls=False)
    want, _, _ = _port(ldata, rdata, "inner", {})
    conf = dict(OOC, **{
        "spark.rapids.tpu.memory.tpu.poolBytes": 64 << 10,
        "spark.rapids.tpu.memory.host.spillStorageSize": 16 << 10,
        "spark.rapids.tpu.memory.spill.dir": str(tmp_path)})
    got, q, s = _port(ldata, rdata, "inner", conf)
    assert got == want
    m = s.spill_store.metrics
    assert m["spillToHost"] > 0 and m["spillToDisk"] > 0, m
    assert os.listdir(tmp_path) == []


def test_join_subpartition_recursion():
    """A 2 KiB budget: S = 16 at the first level, whose piles are still
    over budget, so they split again."""
    rng = np.random.default_rng(22)
    n_l, n_r = 8000, 6000
    ldata = {"k": pa.array(rng.integers(0, n_r * 2, n_l)),
             "lv": pa.array(np.arange(n_l))}
    rdata = {"k": pa.array(rng.permutation(n_r * 2)[:n_r]),
             "rv": pa.array(np.arange(n_r) * 3)}
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1024}
    want, _, _ = _port(ldata, rdata, "inner", conf)
    got, q, _ = _port(ldata, rdata, "inner", dict(
        conf, **{"spark.rapids.tpu.sql.join.buildSideBudgetBytes": 2048}))
    assert got == want
    assert _metric(q, "numSubPartitions") == 16
    assert _metric(q, "numSubPartRecursions") >= 1, q.last_metrics()


def test_one_dominant_key_stops_the_recursion():
    """Every build row on one key: a split cannot shrink the pile, so the
    recursion stops at its first re-split and the join runs as is."""
    n = 3000
    ldata = {"k": pa.array(np.ones(50, np.int64)),
             "lv": pa.array(np.arange(50))}
    rdata = {"k": pa.array(np.ones(n, np.int64)),
             "rv": pa.array(np.arange(n))}
    got, q, _ = _port(ldata, rdata, "inner", {
        "spark.rapids.tpu.sql.join.buildSideBudgetBytes": 2048})
    assert len(got) == 50 * n
    assert _metric(q, "numSubPartRecursions") == 1


def test_abandoned_generator_closes_handles():
    """A limit over the out-of-core join abandons it mid-stream: every
    parked pile closes and the reservation returns to where it was."""
    rng = np.random.default_rng(24)
    n_l, n_r = 6000, 5000
    ldata = {"k": pa.array(rng.integers(0, n_r, n_l))}
    rdata = {"k": pa.array(np.arange(n_r)), "rv": pa.array(np.arange(n_r))}
    s = pt.TpuSession(dict(BASE, **OOC), device="cpu")
    store, dm = s.spill_store, s.device_manager
    before = (store.open_handles, dm.reserved)
    q = (s.create_dataframe(ldata).join(s.create_dataframe(rdata),
                                        on=["k"]).limit(5))
    assert q.to_arrow().num_rows == 5
    gc.collect()
    assert (store.open_handles, dm.reserved) == before


def test_error_mid_stream_closes_handles(monkeypatch):
    """A failure inside the bucket loop: the query raises, and the
    handles parked so far close."""
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    ldata, rdata = _mk(3000, 2000, seed=3)
    s = pt.TpuSession(dict(BASE, **OOC), device="cpu")
    orig = HashJoinExec._join_pass
    calls = {"n": 0}

    def failing(self, ctx, bb, stream):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyError("injected")
        yield from orig(self, ctx, bb, stream)

    monkeypatch.setattr(HashJoinExec, "_join_pass", failing)
    q = s.create_dataframe(ldata).join(s.create_dataframe(rdata), on=["k"])
    with pytest.raises(KeyError):
        q.to_arrow()
    assert s.spill_store.open_handles == 0
    assert s.device_manager.reserved == 0


@pytest.mark.parametrize("how", ["inner", "left", "full", "left_anti"])
def test_conditional_join_under_the_budget(data, how):
    ldata, rdata = data
    cond = col("lv") * 3 > col("rv")
    got, q, _ = _port(ldata, rdata, how, OOC, condition=cond)
    assert _metric(q, "numSubPartitions") > 0
    want, _, _ = _port(ldata, rdata, how, {}, condition=cond)
    assert got == want
    assert got == _jax(ldata, rdata, how, {},
                       condition=jcol("lv") * 3 > jcol("rv"))


def test_two_key_string_join_under_the_budget():
    """Keys (int64, string): the count build, both sides rehashed on
    both keys."""
    rng = np.random.default_rng(31)
    n_l, n_r = 1500, 1000
    ldata = {"k": pa.array(rng.integers(0, 300, n_l)),
             "s": pa.array([f"s{x}" for x in rng.integers(0, 7, n_l)]),
             "lv": pa.array(np.arange(n_l))}
    rdata = {"k": pa.array(rng.integers(0, 300, n_r)),
             "s": pa.array([f"s{x}" for x in rng.integers(0, 7, n_r)]),
             "rv": pa.array(np.arange(n_r))}

    def run(conf):
        s = pt.TpuSession(dict(BASE, **conf), device="cpu")
        q = s.create_dataframe(ldata).join(s.create_dataframe(rdata),
                                           on=["k", "s"], how="full")
        return _rows(q.to_arrow()), q

    got, q = run({"spark.rapids.tpu.sql.join.buildSideBudgetBytes":
                  8 << 10})
    assert _metric(q, "numSubPartitions") > 0
    want, _ = run({})
    assert got == want
    js = st.TpuSession(dict(BASE))
    assert got == _rows(js.create_dataframe(ldata).join(
        js.create_dataframe(rdata), on=["k", "s"], how="full").to_arrow())


def test_broadcast_join_over_the_budget(data):
    """A broadcast join (threshold high) whose build is over the budget
    also joins sub-partitioned."""
    ldata, rdata = data
    conf = dict(OOC, **{"spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                        1 << 30})
    got, q, _ = _port(ldata, rdata, "left", conf)
    assert _metric(q, "numSubPartitions") > 0
    assert "BroadcastExchangeExec" in repr(
        [type(c).__name__ for c in q.last_plan().children[0].children])
    want, _, _ = _port(ldata, rdata, "left", {})
    assert got == want
