"""Cost-based join reordering (`plan/cbo.py` `reorder_joins` over
`plan/stats.py`) in the port against the JAX package.

The shapes of the JAX suite's `tests/test_join_reorder.py` go through
both packages' optimizers: a Q5-shaped chain whose written order joins
the blow-up pair first, the conf gate, the greedy order past the DP
bound, and left, semi and anti joins that bound a chain. The reordered
plans must be the JAX package's leaf for leaf, and the rows of the
reordered plan the written plan's (and, on one shape, the JAX
package's). Then the optimized plan of each of the 22 TPC-H queries at
`gen_all(0.01, 11)` with reordering on (the default) must have the JAX
optimizer's shape, and `compute_stats` must give the JAX package's row
and NDV estimates on the same Arrow input. Tolerance: plans and rows
exact; estimates equal as floats.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.plan.optimizer import optimize as joptimize
from spark_rapids_tpu.plan.optimizer import refs_of as jrefs
from spark_rapids_tpu.plan.stats import compute_stats as jstats
from spark_rapids_tpu.workloads import tpch as jtpch
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.plan.optimizer import optimize as poptimize
from spark_rapids_tpu_torch.plan.optimizer import refs_of as prefs
from spark_rapids_tpu_torch.plan.stats import compute_stats as pstats
from spark_rapids_tpu_torch.workloads import tpch as ptpch

REORDER_OFF = {"spark.rapids.tpu.sql.optimizer.joinReorder.enabled":
               "false"}
GREEDY = {"spark.rapids.tpu.sql.optimizer.joinReorder.maxDpRelations":
          "2"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves(plan):
    """Leaf relations (sorted column names) in left-deep order."""
    out = []

    def walk(n):
        if type(n).__name__ == "Join":
            walk(n.left)
            walk(n.right)
        elif type(n).__name__ in ("Project", "Filter"):
            walk(n.children[0])
        else:
            out.append(tuple(sorted(n.schema.names)))
    walk(plan)
    return out


def _innermost_join(plan):
    found = [None]

    def walk(n):
        if type(n).__name__ == "Join":
            found[0] = n
        for c in n.children:
            walk(c)
    walk(plan)
    return found[0]


def _rows_set(at):
    cols = sorted(at.schema.names)
    return sorted(map(tuple, at.select(cols).to_pylist()), key=str)


def _star(n=10_000):
    """Q5-shaped: fact A joins B on a low-NDV key (~100x blow-up) and C
    on a high-NDV key against a 10-row dimension."""
    rng = np.random.default_rng(0)
    return ({"j": pa.array(rng.integers(0, 100, n)),
             "c_k": pa.array(np.arange(n))},
            {"j": pa.array(rng.integers(0, 100, n)),
             "b_v": pa.array(rng.random(n))},
            {"c_k": pa.array(np.arange(10)),
             "c_v": pa.array(rng.random(10))})


def _typed_chain(how):
    rng = np.random.default_rng(1)
    return ({"j": pa.array(rng.integers(0, 50, 2000)),
             "c_k": pa.array(np.arange(2000))},
            {"j": pa.array(rng.integers(0, 50, 2000)),
             "b_v": pa.array(rng.random(2000))},
            {"c_k": pa.array(np.arange(10)),
             "c_v": pa.array(rng.random(10))}, how)


def _chain(session, tables, how="inner"):
    a, b, c = (session.create_dataframe(pa.table(t)) for t in tables)
    return a.join(b, on=["j"], how=how).join(c, on=["c_k"])


def _both(conf, tables, how="inner"):
    js = st.TpuSession(dict(conf))
    ps = pt.TpuSession(dict(conf), device="cpu")
    return (_chain(js, tables, how), js), (_chain(ps, tables, how), ps)


@pytest.mark.parametrize("conf", [{}, GREEDY], ids=["dp", "greedy"])
def test_q5_shaped_chain_reorders_as_in_jax(conf):
    (jq, js), (pq, ps) = _both(conf, _star())
    jopt = joptimize(jq._plan, js.conf)
    popt = poptimize(pq._plan, ps.conf)
    assert _leaves(popt) == _leaves(jopt) != _leaves(pq._plan)
    inner = _innermost_join(popt)
    assert ("b_v", "j") not in {_leaves(inner.left)[0],
                                _leaves(inner.right)[0]}
    off = pt.TpuSession(REORDER_OFF, device="cpu")
    want = _chain(off, _star()).to_arrow()
    got = pq.to_arrow()
    assert got.num_rows == want.num_rows
    assert _rows_set(got) == _rows_set(want)


def test_reorder_conf_gate_off_keeps_written_order():
    (jq, js), (pq, ps) = _both(REORDER_OFF, _star())
    assert _leaves(poptimize(pq._plan, ps.conf)) == _leaves(pq._plan) \
        == _leaves(joptimize(jq._plan, js.conf))
    # no conf: no reorder either (the parity tests' optimize(plan))
    assert _leaves(poptimize(pq._plan)) == _leaves(pq._plan)


@pytest.mark.parametrize("how", ["left", "left_semi", "left_anti"])
def test_non_inner_join_bounds_the_chain(how):
    *tables, how = _typed_chain(how)
    (jq, js), (pq, ps) = _both({}, tables, how)
    popt = poptimize(pq._plan, ps.conf)
    assert _leaves(popt) == _leaves(pq._plan) == \
        _leaves(joptimize(jq._plan, js.conf))
    off = pt.TpuSession(REORDER_OFF, device="cpu")
    assert _rows_set(pq.to_arrow()) == \
        _rows_set(_chain(off, tables, how).to_arrow())


def test_inner_chain_above_semi_reorders_as_in_jax():
    rng = np.random.default_rng(2)
    f = {"c_k": pa.array(rng.integers(0, 10_000, 500))}

    def query(s):
        a, b, c = (s.create_dataframe(pa.table(t)) for t in _star())
        return (a.join(s.create_dataframe(pa.table(f)), on=["c_k"],
                       how="left_semi")
                .join(b, on=["j"]).join(c, on=["c_k"]))
    js, ps = st.TpuSession({}), pt.TpuSession({}, device="cpu")
    pq = query(ps)
    popt = poptimize(pq._plan, ps.conf)
    assert _leaves(popt) == _leaves(joptimize(query(js)._plan, js.conf))
    semis = []

    def walk(x):
        if type(x).__name__ == "Join" and x.how == "left_semi":
            semis.append(x)
        for ch in x.children:
            walk(ch)
    walk(popt)
    assert len(semis) == 1 and _leaves(semis[0].left) == [("c_k", "j")]
    off = pt.TpuSession(REORDER_OFF, device="cpu")
    assert _rows_set(pq.to_arrow()) == _rows_set(query(off).to_arrow())


def test_four_relation_chain_equals_jax_and_the_written_order():
    rng = np.random.default_rng(3)
    n = 3000
    tabs = {
        "t1": {"k1": rng.integers(0, 30, n), "k2": rng.integers(0, 8, n),
               "v1": rng.random(n)},
        "t2": {"k1": np.arange(30), "v2": rng.random(30)},
        "t3": {"k2": np.arange(8), "k3": rng.integers(0, 4, 8)},
        "t4": {"k3": np.arange(4), "v4": rng.random(4)},
    }

    def query(s):
        d = {name: s.create_dataframe(
            {c: pa.array(v) for c, v in cols.items()})
            for name, cols in tabs.items()}
        return (d["t1"].join(d["t2"], on=["k1"])
                       .join(d["t3"], on=["k2"])
                       .join(d["t4"], on=["k3"]))
    js, ps = st.TpuSession({}), pt.TpuSession({}, device="cpu")
    pq, jq = query(ps), query(js)
    assert _leaves(poptimize(pq._plan, ps.conf)) == \
        _leaves(joptimize(jq._plan, js.conf))
    got = pq.to_arrow()
    want = query(pt.TpuSession(REORDER_OFF, device="cpu")).to_arrow()
    assert got.num_rows == want.num_rows
    assert _rows_set(got) == _rows_set(want) == _rows_set(jq.to_arrow())


# ----------------------------------------------------------------------
# the 22 TPC-H queries' optimized plans, reordering on
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tpch_tables():
    return jtpch.gen_all(0.01, 11)


def _shape(plan, filter_refs):
    name = type(plan).__name__
    if name == "Filter":
        name += str(sorted(filter_refs(plan.condition)))
    return (name, [_shape(c, filter_refs) for c in plan.children])


#: the queries whose written join order the JAX optimizer changes here
REORDERED = {2, 5, 11}


@pytest.mark.parametrize("n", range(1, 23))
def test_reordered_plan_equals_jax(tpch_tables, n):
    js, ps = st.TpuSession({}), pt.TpuSession({}, device="cpu")
    jdf = jtpch.queries()[n]({k: js.create_dataframe(v)
                              for k, v in tpch_tables.items()})
    pdf = ptpch.queries()[n]({k: ps.create_dataframe(v)
                              for k, v in tpch_tables.items()})
    pshape = _shape(poptimize(pdf._plan, ps.conf), prefs)
    assert pshape == _shape(joptimize(jdf._plan, js.conf), jrefs)
    written = pt.TpuSession(REORDER_OFF, device="cpu").conf
    assert (pshape != _shape(poptimize(pdf._plan, written), prefs)) == \
        (n in REORDERED)


# ----------------------------------------------------------------------
# compute_stats: rows and NDVs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("what", ["scan", "filter", "join", "agg", "semi",
                                  "left"])
def test_compute_stats_equals_jax(tpch_tables, what):
    from spark_rapids_tpu.expr.expressions import col as jcol
    from spark_rapids_tpu.expr.expressions import lit as jlit
    import spark_rapids_tpu.functions as JF
    from spark_rapids_tpu_torch.expr.expressions import col as pcol
    from spark_rapids_tpu_torch.expr.expressions import lit as plit
    import spark_rapids_tpu_torch.functions as PF

    def build(session, col, lit, F):
        d = {k: session.create_dataframe(v) for k, v in
             tpch_tables.items()}
        o, c, li = d["orders"], d["customer"], d["lineitem"]
        if what == "scan":
            return li
        if what == "filter":
            return li.filter((col("l_quantity") < lit(10))
                             & (col("l_shipmode") == lit("AIR")))
        if what == "join":
            return o.join(c.with_column("o_custkey", col("c_custkey")),
                          on=["o_custkey"])
        if what == "agg":
            return li.group_by("l_returnflag", "l_linestatus").agg(
                F.sum("l_quantity").alias("q"))
        if what == "semi":
            return c.join(o.with_column("c_custkey", col("o_custkey")),
                          on=["c_custkey"], how="left_semi")
        return c.join(o.with_column("c_custkey", col("o_custkey")),
                      on=["c_custkey"], how="left")
    jdf = build(st.TpuSession({}), jcol, jlit, JF)
    pdf = build(pt.TpuSession({}, device="cpu"), pcol, plit, PF)
    js_, ps_ = jstats(jdf._plan), pstats(pdf._plan)
    assert ps_.rows == js_.rows is not None
    names = list(pdf._plan.schema.names)
    assert names == list(jdf._plan.schema.names)
    assert [ps_.ndv_of(nm) for nm in names] == \
        [js_.ndv_of(nm) for nm in names]
