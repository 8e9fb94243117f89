"""TPC-H Q4, Q5 and Q7, end to end: the PyTorch port (on the CPU) against
the JAX package, its pandas oracle and chip_smoke's exact references.

Each query runs over `create_dataframe` of `gen_all(sf=0.01, seed=11)`
(the JAX suite's data) through both packages on three plans:
  - `defaults`: both packages at their default conf;
  - `no_reorder`: the port at its defaults, the JAX package with join
    reordering and AQE off (the plan the port makes);
  - `shuffled`: both with `autoBroadcastJoinThreshold` -1 and 4096-row
    batches, so every join is per partition and every grouped aggregate
    runs partial -> exchange -> final.
The Arrow results must be equal (exact: decimals and counts), in row
order; Q5, sorted by revenue alone, as a set with revenue not increasing
down the rows. The pandas oracle (decimals as float64) holds within its
own rtol for money, counts exact. This module also holds the helpers the
other `test_torch_tpch_q*.py` files import.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.workloads import tpch as jtpch
from spark_rapids_tpu.workloads import tpch_queries as jq
from spark_rapids_tpu.workloads.tpch_oracle import ORACLES, to_pandas
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.workloads import tpch_queries as pq

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SF, SEED = 0.01, 11
NO_REORDER = {"spark.rapids.tpu.sql.optimizer.joinReorder.enabled": False,
              "spark.rapids.tpu.sql.adaptive.enabled": False}
SHUFFLED = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.batchSizeRows": 4096}
#: plan -> (the port's conf, the JAX package's conf)
PLANS = {"defaults": ({}, {}),
         "no_reorder": ({}, NO_REORDER),
         "shuffled": (SHUFFLED, SHUFFLED)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tpch_tables():
    return jtpch.gen_all(SF, SEED)


@pytest.fixture(scope="module")
def pandas_tables(tpch_tables):
    return to_pandas(tpch_tables)


def run_port(n, tables, conf, **kw):
    s = pt.TpuSession(dict(conf), device="cpu")
    q = getattr(pq, f"q{n}")({k: s.create_dataframe(v)
                              for k, v in tables.items()}, **kw)
    return q, q.to_arrow()


def run_jax(n, tables, conf, **kw):
    s = st.TpuSession(dict(conf))
    return getattr(jq, f"q{n}")({k: s.create_dataframe(v)
                                 for k, v in tables.items()}, **kw).to_arrow()


def in_query_order(n, at):
    """Q5 sorts by revenue alone: its rows in one order for ties."""
    if n != 5:
        return at
    return at.sort_by([("revenue", "descending"), ("n_name", "ascending")])


def check_equal_jax(n, tables, plan, **kw):
    pconf, jconf = PLANS[plan]
    _, got = run_port(n, tables, pconf, **kw)
    exp = run_jax(n, tables, jconf, **kw)
    assert got.schema == exp.schema
    assert got.num_rows > 0
    if n == 5:
        revs = got.column("revenue").to_pylist()
        assert revs == sorted(revs, reverse=True)
    assert in_query_order(n, got).equals(in_query_order(n, exp))
    return got


def check_oracle(n, tables, pandas_tables, **kw):
    """The port's result against the JAX package's pandas oracle: money
    within rtol 1e-6 (the oracle sums float64), every other column exact,
    in the query's order (tied rows of Q5 by name)."""
    _, got = run_port(n, tables, {}, **kw)
    exp = ORACLES[n](pandas_tables, **kw).reset_index(drop=True)
    g = to_pandas({"r": in_query_order(n, got)})["r"]
    assert list(g.columns) == list(exp.columns)
    if n == 5:
        exp = exp.sort_values(["revenue", "n_name"],
                              ascending=[False, True]).reset_index(drop=True)
    assert len(g) == len(exp) > 0
    for c in exp.columns:
        if g[c].dtype.kind == "f" or exp[c].dtype.kind == "f":
            np.testing.assert_allclose(g[c].astype(float),
                                       exp[c].astype(float), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert g[c].tolist() == exp[c].tolist(), c


def check_reference(n, tables, **kw):
    """chip_smoke's exact numpy reference (the one the SF10 run checks
    against) equals the port's result, by chip_smoke's own check."""
    _, got = run_port(n, tables, SHUFFLED, **kw)
    qty = kw.get("qty", chip_smoke.TPCH_Q18_QTY)
    chip_smoke.check_tpch(n, got, chip_smoke.tpch_reference(n, tables, qty),
                          "the CPU")


QUERIES = (4, 5, 7)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("n", QUERIES)
def test_query_equals_jax(tpch_tables, n, plan):
    check_equal_jax(n, tpch_tables, plan)


@pytest.mark.parametrize("n", QUERIES)
def test_query_equals_the_pandas_oracle(tpch_tables, pandas_tables, n):
    check_oracle(n, tpch_tables, pandas_tables)


@pytest.mark.parametrize("n", QUERIES)
def test_query_equals_the_chip_smoke_reference(tpch_tables, n):
    check_reference(n, tpch_tables)


def _shape(plan, filter_refs):
    """A logical plan as nested (node, [children]), each Filter with the
    columns its condition reads."""
    name = type(plan).__name__
    if name == "Filter":
        name += str(sorted(filter_refs(plan.condition)))
    return (name, [_shape(c, filter_refs) for c in plan.children])


def check_optimized_shape(n, tables, **kw):
    """The port's optimizer, under its session's conf, leaves the plan
    the JAX optimizer does with join reordering off: the same nodes, each
    filter in the same place (a count(DISTINCT) rewritten on both)."""
    from spark_rapids_tpu.plan.optimizer import optimize as joptimize
    from spark_rapids_tpu.plan.optimizer import refs_of as jrefs
    from spark_rapids_tpu_torch.plan.optimizer import optimize as poptimize
    from spark_rapids_tpu_torch.plan.optimizer import refs_of as prefs
    ps, js = pt.TpuSession(device="cpu"), st.TpuSession(dict(NO_REORDER))
    pplan = getattr(pq, f"q{n}")({k: ps.create_dataframe(v)
                                  for k, v in tables.items()}, **kw)._plan
    jplan = getattr(jq, f"q{n}")({k: js.create_dataframe(v)
                                  for k, v in tables.items()}, **kw)._plan
    pshape = _shape(poptimize(pplan, ps.conf), prefs)
    assert pshape == _shape(joptimize(jplan, js.conf), jrefs)
    return pshape


def filters_below_joins(shape, out=None):
    """{filter: whether a Join lies under it} of a plan shape."""
    out = {} if out is None else out
    name, kids = shape

    def has_join(sh):
        return sh[0] == "Join" or any(has_join(k) for k in sh[1])
    if name.startswith("Filter"):
        out[name] = has_join(shape)
    for k in kids:
        filters_below_joins(k, out=out)
    return out


@pytest.mark.parametrize("n", QUERIES)
def test_optimized_plan_equals_jax(tpch_tables, n):
    shape = check_optimized_shape(n, tpch_tables)
    filters = filters_below_joins(shape)
    if n == 5:
        # r_name's and the order dates' filters sink to their scans
        assert filters["Filter['r_name']"] is False
        assert filters["Filter['o_orderdate']"] is False
    if n == 7:
        # the nation pair reads both sides: it stays above the joins
        assert filters["Filter['cust_nation', 'supp_nation']"] is True
        assert filters["Filter['l_shipdate']"] is False


def test_q5_joins_on_two_keys(tpch_tables):
    """Q5's supplier join takes the generic count build on (l_suppkey,
    c_nationkey)."""
    q, _ = run_port(5, tpch_tables, SHUFFLED)
    joins = [j for j in chip_smoke.plan_nodes(q.last_plan())
             if type(j).__name__ == "HashJoinExec"]
    two_key = [j for j in joins if len(j.rkeys) == 2]
    assert len(joins) == 5 and len(two_key) == 1
    mets = q.last_metrics()[two_key[0]._op_id]
    assert mets["countProbeBatches"] > 0 and \
        mets.get("directProbeBatches", 0) == 0


def test_q4_semi_join_keeps_each_order_once(tpch_tables):
    """Orders with several late lines count once (a semi join, not an
    inner one): the counts equal the number of distinct late orders."""
    _, got = run_port(4, tpch_tables, SHUFFLED)
    ref = chip_smoke.q4_reference(tpch_tables)
    assert [tuple(r.values()) for r in got.to_pylist()] == ref
    li = tpch_tables["lineitem"]
    late = li.filter(np.asarray(li.column("l_commitdate"))
                     < np.asarray(li.column("l_receiptdate")))
    keys = late.column("l_orderkey").to_numpy()
    assert len(np.unique(keys)) < len(keys)
