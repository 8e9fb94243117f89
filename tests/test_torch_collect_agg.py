"""`CollectAggExec`, the sort path of the grouped aggregate, in the PyTorch
port (on the CPU) against the JAX package and plain Python.

The planner sends an aggregate whose result cannot ride the partial
states to the sort path: a hash exchange of the raw rows on the keys
(when the input has several partitions), then one `CollectAggExec` per
partition; without keys one `CollectAggExec`. Cases:
  - count(DISTINCT) beside another aggregate, over two distinct
    children, and with `sql.optimizer.distinctAggRewrite.enabled` off,
    grouped on an int and on a string key, on one input partition and on
    many (the exchange on the keys), with nulls in keys and values;
  - percentile and median (rank selection, interpolated), with plain
    aggregates riding the same segmentation (sum, avg, count, min,
    stddev, approx_count_distinct, percentile_approx), and first / last
    of a string (a positional select in input order);
  - ungrouped, and over an empty input (one row: count 0, the rest
    null);
  - the plan: an exchange on the keys under a per-partition
    `CollectAggExec`;
  - the ArrayType results: collect_list, collect_set, percentile and
    percentile_approx over a list of percentages, equal to the JAX
    package (the test keeps the name it had when they raised NotPorted).
Tolerance: exact (percentile included: the port rounds its interpolation
once, as the JAX package's compile does), but percentile_approx and
stddev, within a relative 1e-9.
"""
import math

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.exec.aggregate import CollectAggExec
from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec

N = 3000
MANY = {"spark.rapids.tpu.sql.batchSizeRows": 256}
REWRITE_OFF = {"spark.rapids.tpu.sql.optimizer.distinctAggRewrite.enabled":
               False}
APPROX = ("sd", "pa")


def _table(seed=9, n=N):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 7, n)
    kv = rng.random(n) > 0.05
    v = rng.integers(0, 40, n)
    vv = rng.random(n) > 0.1
    x = rng.standard_normal(n) * 10
    return pa.table({
        "k": pa.array(k.astype(np.int64), mask=~kv),
        "ks": pa.array([None if not ok else f"key{j}" for j, ok in
                        zip(k, kv)]),
        "v": pa.array(v.astype(np.int32), mask=~vv),
        "w": pa.array((v % 5).astype(np.int64)),
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "t": pa.array([None if j % 11 == 0 else f"t{j}" for j in v])})


SHAPES = {
    "beside": lambda F: [F.countDistinct("v").alias("cd"),
                         F.count("*").alias("c"), F.sum("w").alias("s")],
    "two_children": lambda F: [F.countDistinct("v").alias("cd"),
                               F.countDistinct("t").alias("ct")],
    "rewrite_off": lambda F: [F.countDistinct("v").alias("cd")],
}


def _query(sess, F, at, key, aggs):
    df = sess.create_dataframe(at)
    return df.group_by(key).agg(*aggs(F)) if key else df.agg(*aggs(F))


def _both(conf, at, key, aggs):
    q = _query(pt.TpuSession(dict(conf), device="cpu"), PF, at, key, aggs)
    got = q.to_arrow()
    want = _query(st.TpuSession(dict(conf)), JF, at, key, aggs).to_arrow()
    if key:
        got, want = got.sort_by(key), want.sort_by(key)
    return got, want, q


def _assert_equal(got, want):
    assert got.column_names == want.column_names
    for c in got.column_names:
        a, b = got.column(c).to_pylist(), want.column(c).to_pylist()
        if c in APPROX:
            assert [x is None for x in a] == [x is None for x in b], c
            assert all(math.isclose(x, y, rel_tol=1e-9)
                       for x, y in zip(a, b) if x is not None), c
        else:
            assert a == b, c


@pytest.mark.parametrize("parts", ["one", "many"])
@pytest.mark.parametrize("key", ["k", "ks", None])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_count_distinct_shapes_equal_jax(shape, key, parts):
    conf = dict(MANY if parts == "many" else {})
    if shape == "rewrite_off":
        conf.update(REWRITE_OFF)
    at = _table()
    got, want, q = _both(conf, at, key, SHAPES[shape])
    _assert_equal(got, want)
    # against Python: distinct non-null values per key
    keys = at.column(key).to_pylist() if key else [None] * N
    vs = at.column("v").to_pylist()
    exp = {}
    for kk, v in zip(keys, vs):
        exp.setdefault(kk, set())
        if v is not None:
            exp[kk].add(v)
    rows = got.to_pylist()
    assert {r.get(key) if key else None: r["cd"] for r in rows} == \
        {kk: len(s) for kk, s in exp.items()}


def _plan_nodes(root):
    out, todo = [], [root]
    while todo:
        n = todo.pop()
        out.append(n)
        todo.extend(n.children)
    return out


def test_the_plan_exchanges_raw_rows_on_the_keys():
    at = _table()
    q = _query(pt.TpuSession(dict(MANY), device="cpu"), PF, at, "k",
               SHAPES["beside"])
    root, _ = q.physical_plan()
    nodes = _plan_nodes(root)
    collect = [n for n in nodes if isinstance(n, CollectAggExec)]
    assert len(collect) == 1 and collect[0].per_partition
    ex = [n for n in nodes if isinstance(n, ShuffleExchangeExec)]
    assert len(ex) == 1 and len(ex[0].keys) == 1
    # the raw rows, pruned to the columns the aggregates read
    assert sorted(ex[0].schema.names) == ["k", "v", "w"]
    # one partition: no exchange
    q1 = _query(pt.TpuSession(device="cpu"), PF, at, "k", SHAPES["beside"])
    nodes1 = _plan_nodes(q1.physical_plan()[0])
    assert not any(isinstance(n, ShuffleExchangeExec) for n in nodes1)
    assert any(isinstance(n, CollectAggExec) and not n.per_partition
               for n in nodes1)


def _percentile_aggs(F):
    return [F.median("x").alias("md"), F.percentile("x", 0.9).alias("p9"),
            F.percentile("v", 0.25).alias("p25"),
            F.count("x").alias("c"), F.sum("w").alias("s"),
            F.avg("v").alias("a"), F.min("x").alias("mn"),
            F.stddev("x").alias("sd"),
            F.approx_count_distinct("v", 0.1).alias("acd"),
            F.percentile_approx("x", 0.5, 1000).alias("pa"),
            F.first("t").alias("ft"), F.last("t").alias("lt"),
            F.first("t", True).alias("ftn")]


@pytest.mark.parametrize("parts", ["one", "many"])
@pytest.mark.parametrize("key", ["k", None])
def test_percentiles_and_riders_equal_jax(key, parts):
    at = _table(seed=3)
    got, want, _ = _both(MANY if parts == "many" else {}, at, key,
                         _percentile_aggs)
    _assert_equal(got, want)
    keys = at.column(key).to_pylist() if key else [None] * N
    xs, ts = at.column("x").to_pylist(), at.column("t").to_pylist()
    for r in got.to_pylist():
        kk = r.get(key) if key else None
        vals = np.sort([x for k2, x in zip(keys, xs)
                        if k2 == kk and x is not None])
        assert np.isclose(r["md"], np.percentile(vals, 50))
        assert np.isclose(r["p9"], np.percentile(vals, 90))
        tv = [t for k2, t in zip(keys, ts) if k2 == kk]
        assert (r["ft"], r["lt"]) == (tv[0], tv[-1])
        assert r["ftn"] == next(t for t in tv if t is not None)


def test_empty_input_ungrouped_and_grouped():
    at = _table().slice(0, 0)

    def aggs(F):
        return [F.countDistinct("v").alias("cd"), F.count("*").alias("c"),
                F.median("x").alias("md")]

    got, want, _ = _both({}, at, None, aggs)
    assert got.to_pylist() == [{"cd": 0, "c": 0, "md": None}]
    assert got.to_pylist() == want.to_pylist()
    got, want, _ = _both({}, at, "k", aggs)
    assert got.num_rows == want.num_rows == 0
    # a filter that keeps nothing (JAX test_distinct_percentile.py:65)
    df = pt.TpuSession(device="cpu").create_dataframe(_table())
    e = df.filter(PF.col("v") < -1).agg(
        PF.countDistinct(PF.col("v")).alias("cd"),
        PF.median(PF.col("v")).alias("md")).to_arrow().to_pylist()
    assert e == [{"cd": 0, "md": None}]


@pytest.mark.parametrize("make, what", [
    (lambda F: F.collect_list("v"), "collect_list"),
    (lambda F: F.collect_set("v"), "collect_set"),
    (lambda F: F.percentile("x", [0.1, 0.5]), "percentile"),
    (lambda F: F.percentile_approx("x", [0.1, 0.5]), "percentile_approx"),
])
def test_array_results_raise_not_ported(make, what):
    """Ported since ROADMAP A.5: each ArrayType result equals the JAX
    package's, element for element and in order (percentile_approx
    within a relative 1e-9, as above)."""
    at = _table(n=50)
    got = pt.TpuSession(device="cpu").create_dataframe(at).group_by(
        "k").agg(make(PF).alias("r")).to_arrow().sort_by("k")
    want = st.TpuSession().create_dataframe(at).group_by("k").agg(
        make(JF).alias("r")).to_arrow().sort_by("k")
    assert got.column("r").type == want.column("r").type, what
    assert got.column("k").to_pylist() == want.column("k").to_pylist()
    g, w = got.column("r").to_pylist(), want.column("r").to_pylist()
    if what != "percentile_approx":
        assert g == w, what
        return
    assert [r is None for r in g] == [r is None for r in w]
    for a, b in zip(g, w):
        if a is not None:
            assert len(a) == len(b)
            assert all(math.isclose(x, y, rel_tol=1e-9)
                       for x, y in zip(a, b)), (a, b)
