"""count(DISTINCT x) in the PyTorch port (on the CPU) against the JAX
package and a plain Python reference.

The port answers count(DISTINCT) only through the optimizer's two-level
rewrite (`plan/optimizer.py` `rewrite_distinct_aggs`): an inner DISTINCT
aggregate over the keys and x, an outer Count. Ported from the cases of
the JAX package's `tests/test_distinct_percentile.py`:
  - grouped and ungrouped, over int, string, decimal128 and double
    columns with nulls (the double with NaN, -0.0 and 0.0), on one input
    partition (a complete inner aggregate) and, for the keys the port's
    exchange hashes (int, string), over many (partial -> exchange ->
    final);
  - an empty input (ungrouped: 0; grouped: no rows);
  - two count(DISTINCT) of one child (one inner aggregate);
  - the optimized plan: two Aggregates where there was one, as the JAX
    optimizer makes them;
  - the shapes the rewrite leaves alone (a distinct beside another
    aggregate, two distinct children, the rewrite turned off) run on
    `CollectAggExec`, the sort path, as in the JAX package
    (`tests/test_torch_collect_agg.py` holds them at scale).
Each result must equal the JAX package's Arrow table (sorted by the
keys) and the Python reference, where -0.0 counts as 0.0 and every NaN
as one value. Tolerance: exact.
"""
import decimal
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.errors import NotPorted

N = 3000
REWRITE_OFF = {"spark.rapids.tpu.sql.optimizer.distinctAggRewrite.enabled":
               False}
MANY = {"spark.rapids.tpu.sql.batchSizeRows": 256}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _table(kind, seed=9):
    """k: an int group key with nulls; v: the counted column."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 7, N)
    kv = rng.random(N) > 0.05
    x = rng.integers(0, 40, N)
    valid = rng.random(N) > 0.1
    if kind == "int":
        v = pa.array(x.astype(np.int32), mask=~valid)
    elif kind == "string":
        v = pa.array([f"s{i}" * (i % 3 + 1) if ok else None
                      for i, ok in zip(x, valid)])
    elif kind == "decimal128":
        v = pa.array([decimal.Decimal(int(i) * 10**20 + 7).scaleb(-3)
                      if ok else None for i, ok in zip(x, valid)],
                     pa.decimal128(30, 3))
    else:
        f = (x - 20).astype(np.float64) / 4
        f[x == 3] = np.nan
        f[x == 20] = -0.0
        f[x == 21] = 0.0
        v = pa.array(f, mask=~valid)
    return pa.table({"k": pa.array(k.astype(np.int64), mask=~kv), "v": v})


def _norm(x):
    """Spark's distinct value: -0.0 is 0.0, every NaN one value."""
    if isinstance(x, float):
        if math.isnan(x):
            return "nan"
        return x + 0.0
    return x


def _reference(at, grouped):
    ks, vs = at.column("k").to_pylist(), at.column("v").to_pylist()
    seen = {}
    for k, v in zip(ks, vs):
        key = k if grouped else None
        s = seen.setdefault(key, set())
        if v is not None:
            s.add(_norm(v))
    if not grouped:
        return [(len(seen.get(None, ())),)]
    return sorted(((k, len(s)) for k, s in seen.items()),
                  key=lambda r: (r[0] is not None, r[0]))


def _run(session, F, at, grouped):
    df = session.create_dataframe(at)
    if grouped:
        return df.group_by("k").agg(
            F.countDistinct("v").alias("cd")).sort("k").to_arrow()
    return df.agg(F.count_distinct("v").alias("cd")).to_arrow()


def _rows(at):
    return list(zip(*[at.column(i).to_pylist()
                      for i in range(at.num_columns)]))


#: (counted column, partitions): the port's exchange does not hash a
#: double or a decimal128 key yet (ROADMAP A.5), so those run on one
CASES = [("int", "one"), ("int", "many"), ("string", "one"),
         ("string", "many"), ("decimal128", "one"), ("double", "one")]


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["grouped", "ungrouped"])
@pytest.mark.parametrize("kind,parts", CASES)
def test_count_distinct_equals_jax(kind, parts, grouped):
    conf = MANY if parts == "many" else {}
    at = _table(kind)
    got = _run(pt.TpuSession(dict(conf), device="cpu"), PF, at, grouped)
    exp = _run(st.TpuSession(dict(conf)), JF, at, grouped)
    assert got.schema.field("cd").type == pa.int64()
    assert got.equals(exp)
    assert _rows(got) == _reference(at, grouped)


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["grouped", "ungrouped"])
def test_empty_input(grouped):
    at = _table("int").slice(0, 0)
    got = _run(pt.TpuSession(device="cpu"), PF, at, grouped)
    exp = _run(st.TpuSession(), JF, at, grouped)
    assert got.equals(exp)
    assert _rows(got) == ([] if grouped else [(0,)])


def test_two_distinct_counts_of_one_child():
    at = _table("string")
    out = []
    for s, F in ((pt.TpuSession(MANY, device="cpu"), PF),
                 (st.TpuSession(MANY), JF)):
        out.append(s.create_dataframe(at).group_by("k").agg(
            F.countDistinct("v").alias("a"),
            F.countDistinct("v").alias("b")).sort("k").to_arrow())
    assert out[0].equals(out[1])
    assert out[0].column("a").equals(out[0].column("b"))


def test_the_rewrite_makes_two_aggregates_as_the_jax_optimizer_does():
    from spark_rapids_tpu.plan.optimizer import optimize as joptimize
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan.optimizer import optimize as poptimize
    at = _table("int")
    ps, js = pt.TpuSession(device="cpu"), st.TpuSession()
    pplan = ps.create_dataframe(at).group_by("k").agg(
        PF.countDistinct("v").alias("cd"))._plan
    jplan = js.create_dataframe(at).group_by("k").agg(
        JF.countDistinct("v").alias("cd"))._plan

    def shape(p):
        return [(type(n).__name__, [k.name for k in getattr(n, "keys", [])],
                 [(nm, repr(a)) for nm, a in getattr(n, "aggs", [])])
                for n in _chain(p)]
    popt = poptimize(pplan, ps.conf)
    assert shape(popt) == shape(joptimize(jplan, js.conf))
    outer, inner = popt, popt.children[0]
    assert isinstance(outer, L.Aggregate) and isinstance(inner, L.Aggregate)
    assert [k.name for k in inner.keys] == ["k", "__cd_val"]
    assert not inner.aggs
    # without the conf (or with the rewrite off) the plan keeps its one
    # aggregate
    assert shape(poptimize(pplan)) == shape(pplan)


def _chain(plan):
    out = [plan]
    while out[-1].children:
        out.append(out[-1].children[0])
    return out


@pytest.mark.parametrize("shape", ["beside_count", "two_children",
                                   "rewrite_off", "ungrouped_off"])
def test_shapes_the_rewrite_leaves_alone_raise_not_ported(shape):
    at = pa.table({"k": pa.array([1, 1, 2]), "v": pa.array([5, 6, 5]),
                   "w": pa.array([1, 1, 1])})
    conf = REWRITE_OFF if shape.endswith("off") else {}
    df = pt.TpuSession(dict(conf), device="cpu").create_dataframe(at)
    aggs = {"beside_count": [PF.countDistinct("v"), PF.count("*")],
            "two_children": [PF.countDistinct("v"), PF.countDistinct("w")],
            "rewrite_off": [PF.countDistinct("v")],
            "ungrouped_off": [PF.countDistinct("v")]}[shape]
    q = df.agg(*aggs) if shape == "ungrouped_off" else \
        df.group_by("k").agg(*aggs)
    # since the CollectAggExec slice the port answers each on its sort
    # path, as the JAX package does, with the JAX package's rows
    got = q.to_arrow()
    js = st.TpuSession(dict(conf))
    jdf = js.create_dataframe(at)
    jaggs = {"beside_count": [JF.countDistinct("v"), JF.count("*")],
             "two_children": [JF.countDistinct("v"),
                              JF.countDistinct("w")],
             "rewrite_off": [JF.countDistinct("v")],
             "ungrouped_off": [JF.countDistinct("v")]}[shape]
    jq = jdf.agg(*jaggs) if shape == "ungrouped_off" else \
        jdf.group_by("k").agg(*jaggs)
    want = jq.to_arrow()
    assert want.num_rows >= 1
    if shape != "ungrouped_off":
        got, want = got.sort_by("k"), want.sort_by("k")
    assert got.column_names == want.column_names
    assert got.to_pydict() == want.to_pydict()
