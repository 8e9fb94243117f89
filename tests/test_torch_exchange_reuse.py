"""Exchange reuse in the port (`plan/reuse.py`) against the JAX package.

- Per TPC-H query at `gen_all(0.01, 11)`, the port's planner merges as
  many duplicate exchange subtrees (`exchange_reuse_hits` on the plan's
  root) as the JAX package's, at the default conf and on the shuffled
  plan (`autoBroadcastJoinThreshold` -1, 4096-row batches).
- The queries with a hit give the same rows with reuse on and off, and
  reuse runs fewer map partitions.
- A self-join's two exchanges become one: the `ReusedExchangeExec`
  serves the first occurrence's materialized stage, its map phase runs
  once (`mapPartitionsExecuted` summed over the plan), and the hit is
  counted once per action.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.plan.planner import Planner as JPlanner
from spark_rapids_tpu.workloads import tpch as jtpch
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.expr.expressions import col
from spark_rapids_tpu_torch.plan.planner import Planner as PPlanner
from spark_rapids_tpu_torch.workloads import tpch as ptpch

SHUFFLED = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.batchSizeRows": 4096}
REUSE_OFF = {"spark.rapids.tpu.sql.exec.exchange.reuse.enabled": False}
CONFS = {"defaults": {}, "shuffled": SHUFFLED}


def _map_partitions(q):
    """Map partitions the last action ran, over all its exchanges."""
    return sum(m.get("mapPartitionsExecuted", 0)
               for m in q.last_metrics().values())


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tpch_tables():
    return jtpch.gen_all(0.01, 11)


def _hits(n, tables, conf):
    js = st.TpuSession(dict(conf))
    ps = pt.TpuSession(dict(conf), device="cpu")
    jdf = jtpch.queries()[n]({k: js.create_dataframe(v)
                              for k, v in tables.items()})
    pdf = ptpch.queries()[n]({k: ps.create_dataframe(v)
                              for k, v in tables.items()})
    return (PPlanner(ps.conf).plan(pdf._plan).exchange_reuse_hits,
            JPlanner(js.conf).plan(jdf._plan).exchange_reuse_hits)


#: the queries with a hit on some plan: Q2 and Q11 reread partsupp's
#: joined chain, Q15 its revenue view
WITH_HITS = {2, 11, 15}


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("n", range(1, 23))
def test_reuse_hits_equal_jax(tpch_tables, n, conf):
    got, want = _hits(n, tpch_tables, CONFS[conf])
    assert got == want
    if n not in WITH_HITS:
        assert got == 0


@pytest.mark.parametrize("n", sorted(WITH_HITS))
def test_rows_equal_with_reuse_on_and_off(tpch_tables, n):
    outs, maps = [], []
    for extra in ({}, REUSE_OFF):
        s = pt.TpuSession(dict(SHUFFLED, **extra), device="cpu")
        q = ptpch.queries()[n]({k: s.create_dataframe(v)
                                for k, v in tpch_tables.items()})
        outs.append(q.to_arrow())
        maps.append(_map_partitions(q))
        hits = q.last_plan().exchange_reuse_hits
        assert (hits > 0) == (not extra)
    assert outs[0].equals(outs[1])
    assert maps[0] < maps[1]


def test_reused_exchange_serves_its_stage_once():
    rng = np.random.default_rng(5)
    at = pa.table({"k": pa.array(rng.integers(0, 300, 5000)),
                   "v": pa.array(np.arange(5000))})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.adaptive.enabled": False}
    outs, maps = [], []
    for extra in ({}, REUSE_OFF):
        s = pt.TpuSession(dict(conf, **extra), device="cpu")
        df = s.create_dataframe(at)
        q = df.join(df, on=["k"])
        outs.append(q.to_arrow())
        maps.append(_map_partitions(q))
        if not extra:
            root = q.last_plan()
            assert root.exchange_reuse_hits == 1
            stack, reused = [root], []
            while stack:
                node = stack.pop()
                if type(node).__name__ == "ReusedExchangeExec":
                    reused.append(node)
                stack.extend(node.children)
            (r,) = reused
            assert type(r.target).__name__ == "ShuffleExchangeExec"
            assert q.last_metrics()[r._op_id]["exchangeReuseHits"] == 1
    # one map phase (5 input batches) instead of two
    assert maps == [5, 10]
    # the self-join's columns share names: compare rows by position
    rows = [sorted(zip(*(c.to_pylist() for c in o.columns))) for o in outs]
    assert outs[0].num_rows == outs[1].num_rows > 0
    assert rows[0] == rows[1]


def test_reuse_under_adaptive_readers_swaps_the_plan_exchange():
    """With adaptive execution on, the reader's re-plan holds the reused
    node in place of the duplicate, so the stage's map phase still runs
    once."""
    rng = np.random.default_rng(6)
    at = pa.table({"k": pa.array(rng.integers(0, 300, 5000)),
                   "v": pa.array(np.arange(5000))})
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024,
                       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                       -1}, device="cpu")
    df = s.create_dataframe(at)
    q = df.join(df.select(col("k"), col("v").alias("w")), on=["k"])
    out = q.to_arrow()
    assert _map_partitions(q) == 5
    assert q.last_plan().exchange_reuse_hits == 1
    off = pt.TpuSession(dict(s.conf._settings, **REUSE_OFF), device="cpu")
    df2 = off.create_dataframe(at)
    want = df2.join(df2.select(col("k"), col("v").alias("w")),
                    on=["k"]).to_arrow()
    cols = sorted(out.column_names)
    assert out.num_rows == want.num_rows > 5000
    assert sorted(map(tuple, out.select(cols).to_pylist())) == \
        sorted(map(tuple, want.select(cols).to_pylist()))
