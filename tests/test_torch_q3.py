"""TPC-H Q3, end to end: the PyTorch port (on the CPU) against the JAX
package, `q3_numpy_baseline` and chip_smoke's exact reference.

`tpch.q3(customer, orders, lineitem)` runs at the sizes of
`tests/test_tpch.py::test_q3` on both join topologies: broadcast (the
default at this size) and per partition (`autoBroadcastJoinThreshold`
-1: both sides hash-exchanged). The JAX side runs twice, at its defaults
and with join reordering and AQE off (the plan the port makes): the two
must give the same rows. The result without the limit must equal the
JAX package's row for row once rows tied on (revenue, o_orderdate) are
put in one order; the top 10 must match the references' keys, with ties
allowed at the 10th row. Also: the generators equal the JAX package's,
the filters sink below the joins as in the JAX optimizer, the column
names of `with_column` and `join` (right and full outer too), `limit`
across batches, and the string-literal filter. Tolerance: exact.
"""
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.expr.expressions import col as jcol
from spark_rapids_tpu.plan.optimizer import optimize as joptimize
from spark_rapids_tpu.workloads import tpch as jtpch
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.expr.expressions import col as pcol
from spark_rapids_tpu_torch.plan.optimizer import optimize as poptimize
from spark_rapids_tpu_torch.session import DataFrame as PDataFrame
from spark_rapids_tpu_torch.workloads import tpch as ptpch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

NO_REORDER = {"spark.rapids.tpu.sql.optimizer.joinReorder.enabled": False,
              "spark.rapids.tpu.sql.adaptive.enabled": False}
TOPOLOGIES = {"broadcast": {},
              "per_partition": {
                  "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
                  "spark.rapids.tpu.sql.batchSizeRows": 4096}}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tables():
    return (jtpch.gen_customer(sf=0.01, seed=5),
            jtpch.gen_orders(sf=0.002, seed=6),
            jtpch.gen_lineitem(sf=0.002, seed=7))


def _q3(tpch, session, tables, limit=True):
    q = tpch.q3(*(session.create_dataframe(t) for t in tables))
    if limit:
        return q
    return type(q)(q._session, q._plan.child)


def _tie_order(at):
    """Rows by (revenue DESC, o_orderdate, l_orderkey): one order for rows
    the query's sort leaves tied."""
    return at.sort_by([("revenue", "descending"), ("o_orderdate", "ascending"),
                       ("l_orderkey", "ascending")])


def test_generators_equal_the_jax_package():
    for sf, seed in ((0.01, 5), (0.002, 6), (0.0137, 1)):
        assert ptpch.gen_customer(sf, seed).equals(
            jtpch.gen_customer(sf, seed))
        assert ptpch.gen_orders(sf, seed).equals(jtpch.gen_orders(sf, seed))
    assert ptpch.SEGMENTS == jtpch.SEGMENTS
    assert ptpch.gen_orders().equals(jtpch.gen_orders())
    assert ptpch.gen_customer().equals(jtpch.gen_customer())


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_q3_equals_jax_and_the_references(tables, topology):
    conf = TOPOLOGIES[topology]
    ps = pt.TpuSession(dict(conf), device="cpu")
    pdf = _q3(ptpch, ps, tables, limit=False)
    got_full = pdf.to_arrow()
    joins = [n for n in chip_smoke.plan_nodes(pdf.last_plan())
             if type(n).__name__ == "HashJoinExec"]
    assert [j.per_partition for j in joins] == \
        [topology == "per_partition"] * 2
    chip_smoke.check_q3_plan(pdf.last_plan(), topology == "per_partition")
    expect = chip_smoke.q3_reference(*tables)
    chip_smoke.check_q3_full(got_full, expect, "port")
    got = _q3(ptpch, ps, tables).to_arrow()
    chip_smoke.check_q3_top(got, expect, "port")
    for extra in ({}, NO_REORDER):
        js = st.TpuSession(dict(conf, **extra))
        exp_full = _q3(jtpch, js, tables, limit=False).to_arrow()
        assert _tie_order(got_full).equals(_tie_order(exp_full))
        exp = _q3(jtpch, js, tables).to_arrow()
        assert got.column_names == exp.column_names
        assert [(r["revenue"], r["o_orderdate"]) for r in got.to_pylist()] \
            == [(r["revenue"], r["o_orderdate"]) for r in exp.to_pylist()]
    # the numpy baseline breaks revenue ties by order key: compare its
    # revenues, and its keys where the revenue is not tied
    c, o, li = tables
    seg = np.array([ptpch.SEGMENTS.index(s)
                    for s in c.column("c_mktsegment").to_pylist()])
    keys, sums = ptpch.q3_numpy_baseline(
        c.column("c_custkey").to_numpy(), seg,
        o.column("o_orderkey").to_numpy(), o.column("o_custkey").to_numpy(),
        o.column("o_orderdate").to_numpy(),
        o.column("o_shippriority").to_numpy(),
        li.column("l_orderkey").to_numpy(), li.column("l_shipdate").to_numpy(),
        chip_smoke.unscaled(li, "l_extendedprice"),
        chip_smoke.unscaled(li, "l_discount"))
    rows = chip_smoke.q3_rows(got)
    assert [r[3] for r in rows] == [int(s) for s in sums]
    tied = {s for s in sums if list(sums).count(s) > 1}
    assert [r[0] for r in rows if r[3] not in tied] == \
        [int(k) for k, s in zip(keys, sums) if s not in tied]


def _shape(plan, filter_refs):
    """A logical plan as nested (node, [children]) with each Filter's
    referenced columns."""
    name = type(plan).__name__
    if name == "Filter":
        name += str(sorted(filter_refs(plan.condition)))
    return (name, [_shape(c, filter_refs) for c in plan.children])


def test_q3_filters_sink_below_the_joins_as_in_jax(tables):
    from spark_rapids_tpu.plan.optimizer import refs_of as jrefs
    from spark_rapids_tpu_torch.plan.optimizer import refs_of as prefs
    ps = pt.TpuSession(device="cpu")
    js = st.TpuSession(dict(NO_REORDER))
    pshape = _shape(poptimize(_q3(ptpch, ps, tables)._plan), prefs)
    jshape = _shape(joptimize(_q3(jtpch, js, tables)._plan, js.conf), jrefs)
    assert pshape == jshape

    def filters(shape, out):
        name, kids = shape
        if name.startswith("Filter"):
            out[name] = [k[0] for k in kids]
        for k in kids:
            filters(k, out)
        return out
    # each filter sits directly over its own scan, under the joins
    assert filters(pshape, {}) == {
        f"Filter[{c!r}]": ["InMemoryScan"]
        for c in ("c_mktsegment", "o_orderdate", "l_shipdate")}


def test_join_planner_decision_equals_jax(tables):
    """The broadcast-or-shuffle choice rests on the same byte estimate."""
    from spark_rapids_tpu.plan import planner as jplanner
    from spark_rapids_tpu_torch.plan import planner as pplanner
    ps, js = pt.TpuSession(device="cpu"), st.TpuSession(dict(NO_REORDER))
    pplan = poptimize(_q3(ptpch, ps, tables)._plan)
    jplan = joptimize(_q3(jtpch, js, tables)._plan, js.conf)

    def joins(plan, out):
        if type(plan).__name__ == "Join":
            out.append(plan)
        for c in plan.children:
            joins(c, out)
        return out
    pj, jj = joins(pplan, []), joins(jplan, [])
    assert len(pj) == len(jj) == 2
    for a, b in zip(pj, jj):
        assert pplanner._estimate_bytes(a.right) == \
            jplanner._estimate_bytes(b.right) > 0
    assert TpuConf().get(pplanner.BROADCAST_THRESHOLD) == 10 * 1024 * 1024


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_with_column_join_and_limit_naming(how):
    rng = np.random.default_rng(4)
    a = pa.table({"id": pa.array(rng.integers(0, 20, 60)),
                  "x": pa.array(rng.integers(0, 9, 60).astype(np.int32)),
                  "s": pa.array([f"v{i}" for i in range(60)])})
    b = pa.table({"id": pa.array(rng.integers(5, 30, 40)),
                  "x": pa.array(rng.integers(0, 9, 40).astype(np.int32)),
                  "y": pa.array(rng.integers(0, 99, 40))})
    outs = []
    for s, c in ((pt.TpuSession(device="cpu"), pcol),
                 (st.TpuSession(), jcol)):
        left = s.create_dataframe(a).with_column("z", c("x") + 1)
        right = s.create_dataframe(b).with_column("x", c("y") * 2)
        j = left.join(right, on=["id"], how=how)
        outs.append((j.columns, j.sort("id", "s", "y").limit(25).to_arrow()))
    assert outs[0][0] == outs[1][0] == ["id", "x", "s", "z", "y", "x"]
    assert outs[0][1].equals(outs[1][1])
    assert outs[0][1].num_rows == 25


@pytest.mark.parametrize("n", [0, 1, 7, 100, 10_000])
def test_limit_across_batches_and_partitions(n):
    t = pa.table({"k": pa.array(np.arange(1000) % 37),
                  "v": pa.array([f"r{i}" for i in range(1000)])})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 64}
    outs = []
    for s, c in ((pt.TpuSession(dict(conf), device="cpu"), pcol),
                 (st.TpuSession(dict(conf)), jcol)):
        df = s.create_dataframe(t).filter(c("k") > 3)
        outs.append((df.limit(n).to_arrow(),
                     df.sort("k", "v").limit(n).to_arrow()))
    live = sum(1 for i in range(1000) if i % 37 > 3)
    for got, exp in zip(outs[0], outs[1]):
        assert got.equals(exp)
        assert got.num_rows == min(n, live)


@pytest.mark.parametrize("n,cap", [(3, 3), (3000, 5000)])
def test_limit_compacts_a_batch_over_twice_the_limit(n, cap):
    from spark_rapids_tpu_torch.utils import transfer
    t = pa.table({"k": pa.array(np.arange(5000)[::-1].copy())})
    s = pt.TpuSession(device="cpu")
    q = s.create_dataframe(t).sort(pcol("k")).limit(n)
    root, ctx = q.physical_plan()
    assert type(root).__name__ == "LimitExec"
    transfer.syncs = 0
    (batch,) = list(root.execute_partition(ctx, 0))
    assert transfer.syncs >= 1          # the kept count is a counted read
    assert batch.capacity == cap
    assert int(batch.row_mask.sum()) == n
    assert q.to_arrow().column("k").to_pylist() == list(range(n))


def test_unlimited_dataframe_of_q3_is_the_sort(tables):
    ps = pt.TpuSession(device="cpu")
    q = _q3(ptpch, ps, tables, limit=False)
    assert isinstance(q, PDataFrame)
    assert type(q._plan).__name__ == "Sort"
