"""Join conditions, cross joins and the nested-loop join of the PyTorch
port (on the CPU) against the JAX package and a plain Python reference.

Ported from the JAX package's `tests/test_join_conditions.py`:
  - a conditional hash join (equal keys plus a non-equi condition) for
    every `how`, on the sorted build (an int64 key) and on the count
    build (a string key), broadcast and per partition, over several
    stream batches, with null keys and a condition that is null on some
    pairs (a null condition is no match);
  - an expression `on`, split into equi keys and a residual condition;
  - cross joins, with either side or both empty;
  - the nested-loop join (a condition with no equi keys) for every `how`,
    with `_CHUNK_TARGET` set small so a stream batch crosses the build
    in many chunks, the last one short;
  - the planner's choices: a cross join is broadcast even with the
    threshold at -1, a cross join with a condition runs the nested-loop
    join as `inner`, and equi keys of mismatched types beside a
    condition are refused.
Each result must equal the JAX package's Arrow table once both are
sorted by every column (a join's row order is not defined), and the
Python reference's rows. Tolerance: exact.
"""
from collections import Counter

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.expr import expressions as jx
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.exec.join import NestedLoopJoinExec
from spark_rapids_tpu_torch.expr import expressions as px

HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti")
SHUFFLED = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.batchSizeRows": 64}
BROADCAST = {"spark.rapids.tpu.sql.batchSizeRows": 64}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sides(seed, key="int", n_l=250, n_r=80):
    """(left, right) Arrow tables: a key with nulls (int64 or string), a
    value that is null on some rows (so the condition is null there) and
    a string payload."""
    rng = np.random.default_rng(seed)

    def side(n, kname, vname, sname):
        k = rng.integers(0, 15, n)
        kv = rng.random(n) > 0.15
        if key == "int":
            kcol = pa.array(k.astype(np.int64), mask=~kv)
        else:
            kcol = pa.array([f"k{x}" if ok else None
                             for x, ok in zip(k, kv)])
        v = rng.integers(0, 100, n).astype(np.int64)
        return pa.table({kname: kcol,
                         vname: pa.array(v, mask=rng.random(n) < 0.1),
                         sname: pa.array([f"{sname}{i % 11}" * (i % 3)
                                          for i in range(n)])})
    return side(n_l, "k", "lv", "ls"), side(n_r, "k2", "rv", "rs")


def _rows(at):
    return list(zip(*[at.column(i).to_pylist()
                      for i in range(at.num_columns)]))


def _ref_join(lrows, rrows, how, key_eq, cond):
    """The plain nested-loop semantics: a pair matches when key_eq and
    cond hold (None is no match)."""
    out = []
    rmatched = [False] * len(rrows)
    nr = len(rrows[0]) if rrows else 3
    nl = len(lrows[0]) if lrows else 3
    for lr in lrows:
        hits = [j for j, rr in enumerate(rrows)
                if key_eq(lr, rr) and cond(lr, rr)]
        for j in hits:
            rmatched[j] = True
            if how in ("inner", "left", "right", "full"):
                out.append(lr + rrows[j])
        if not hits and how in ("left", "full"):
            out.append(lr + (None,) * nr)
        if hits and how == "left_semi":
            out.append(lr)
        if not hits and how == "left_anti":
            out.append(lr)
    if how in ("right", "full"):
        out += [(None,) * nl + rr
                for j, rr in enumerate(rrows) if not rmatched[j]]
    return out


def _keys_equal(a, b):
    return a[0] is not None and b[0] is not None and a[0] == b[0]


def _less(a, b):
    return a[1] is not None and b[1] is not None and a[1] < b[1]


def _sorted(at):
    tmp = at.rename_columns([f"c{i}" for i in range(at.num_columns)])
    return tmp.sort_by([(c, "ascending") for c in tmp.column_names]) \
        .rename_columns(at.column_names)


def _both(left, right, build, conf):
    """`build(dl, dr, X)` over both packages: (the port's DataFrame, its
    Arrow result), after holding the result to the JAX package's."""
    ps = pt.TpuSession(dict(conf), device="cpu")
    pdf = build(ps.create_dataframe(left), ps.create_dataframe(right), px)
    got = pdf.to_arrow()
    js = st.TpuSession(dict(conf))
    exp = build(js.create_dataframe(left), js.create_dataframe(right),
                jx).to_arrow()
    assert got.column_names == exp.column_names
    assert _sorted(got).equals(_sorted(exp))
    return pdf, got


def _plan_nodes(pdf):
    stack, out = [pdf.last_plan()], []
    while stack:
        node = stack.pop()
        out.append(node)
        stack.extend(node.children)
    return out


@pytest.mark.parametrize("conf", [BROADCAST, SHUFFLED],
                         ids=["broadcast", "per_partition"])
@pytest.mark.parametrize("key", ["int", "string"])
@pytest.mark.parametrize("how", HOWS)
def test_conditional_hash_join_equals_jax(how, key, conf):
    left, right = _sides(95, key)

    def build(dl, dr, X):
        return dl.join(dr, on=(X.col("k") == X.col("k2"))
                       & (X.col("lv") < X.col("rv")), how=how)
    pdf, got = _both(left, right, build, conf)
    assert Counter(_rows(got)) == Counter(_ref_join(
        _rows(left), _rows(right), how, _keys_equal, _less))
    joins = [x for x in _plan_nodes(pdf)
             if type(x).__name__ == "HashJoinExec"]
    assert len(joins) == 1 and joins[0].condition is not None
    assert joins[0].per_partition == (conf is SHUFFLED)
    m = pdf.last_metrics()[joins[0]._op_id]
    # the direct build never runs under a condition
    assert m.get("directProbeBatches", 0) == 0
    path = "sortedProbeBatches" if key == "int" else "countProbeBatches"
    assert m[path] == m["streamBatches"] > 1


@pytest.mark.parametrize("how", HOWS)
def test_on_and_condition_together_equal_jax(how):
    """`on` names plus a `condition` over the combined schema."""
    left, right = _sides(96)
    right = right.rename_columns(["k", "rv", "rs"])

    def build(dl, dr, X):
        return dl.join(dr, on=["k"], how=how,
                       condition=X.col("lv") + X.col("rv") > 90)
    _, got = _both(left, right, build, BROADCAST)

    def cond(a, b):
        return a[1] is not None and b[1] is not None and a[1] + b[1] > 90
    exp = _ref_join(_rows(left), _rows(right), how, _keys_equal, cond)
    if how in ("inner", "left", "right", "full"):
        # the key once, then the left's other columns, then the right's
        # (a right join takes the key from the right, a full coalesces)
        pos = {"right": 3, "full": None}.get(how, 0)
        exp = [((r[0] if r[0] is not None else r[3]) if pos is None
                else r[pos],) + r[1:3] + r[4:] for r in exp]
    assert Counter(_rows(got)) == Counter(exp)


def test_on_expression_splits_into_keys_and_residual():
    """(k2 == k) AND a residual: the equality, either way round, becomes
    an equi key pair (so a hash join runs), the rest the condition."""
    left, right = _sides(99)

    def build(dl, dr, X):
        return dl.join(dr, on=(X.col("k2") == X.col("k"))
                       & (X.col("lv") + X.col("rv") > 90), how="inner")
    pdf, got = _both(left, right, build, BROADCAST)

    def cond(a, b):
        return a[1] is not None and b[1] is not None and a[1] + b[1] > 90
    assert Counter(_rows(got)) == Counter(_ref_join(
        _rows(left), _rows(right), "inner", _keys_equal, cond))
    (join,) = [x for x in _plan_nodes(pdf)
               if type(x).__name__ == "HashJoinExec"]
    assert [k.ordinal for k in join.lkeys] == [0]
    assert [k.ordinal for k in join.rkeys] == [0]


def test_null_keys_never_match_with_condition():
    lat = pa.table({"k": pa.array([1, None, 2], pa.int64()),
                    "lv": pa.array([1, 2, 3], pa.int64())})
    rat = pa.table({"k2": pa.array([1, None, 2], pa.int64()),
                    "rv": pa.array([10, 20, 30], pa.int64())})

    def build(dl, dr, X):
        return dl.join(dr, on=(X.col("k") == X.col("k2"))
                       & (X.col("rv") > X.col("lv")), how="left")
    _, got = _both(lat, rat, build, {})
    assert Counter(_rows(got)) == Counter(
        [(1, 1, 1, 10), (None, 2, None, None), (2, 3, 2, 30)])


@pytest.mark.parametrize("sizes", [(40, 3), (0, 3), (40, 0), (0, 0)],
                         ids=["both", "empty_left", "empty_right",
                              "both_empty"])
def test_cross_join_equals_jax(sizes):
    n_l, n_r = sizes
    left, right = _sides(7, n_l=n_l, n_r=n_r)

    def build(dl, dr, X):
        # a filter first leaves holes in the stream batch's mask
        return dl.filter(X.col("lv") > 20).join(dr, how="cross")
    pdf, got = _both(left, right, build, {})
    kept = [r for r in _rows(left) if r[1] is not None and r[1] > 20]
    assert Counter(_rows(got)) == Counter(
        lr + rr for lr in kept for rr in _rows(right))
    (join,) = [x for x in _plan_nodes(pdf)
               if type(x).__name__ == "HashJoinExec"]
    assert join.how == "cross" and not join.per_partition


def test_cross_join_is_broadcast_at_any_threshold():
    left, right = _sides(8, n_l=30, n_r=2)

    def build(dl, dr, X):
        return dl.join(dr, how="cross")
    pdf, got = _both(left, right, build, SHUFFLED)
    assert got.num_rows == 60
    kinds = [type(x).__name__ for x in _plan_nodes(pdf)]
    assert "BroadcastExchangeExec" in kinds
    assert "ShuffleExchangeExec" not in kinds


@pytest.mark.parametrize("how", HOWS)
def test_nested_loop_join_across_chunks_equals_jax(how, monkeypatch):
    """13 build rows and a 50-pair chunk target: 3 stream rows a chunk,
    the 250 stream rows (batches of 64, 64, 64 and 58) in 86 chunks,
    each batch's last one short."""
    monkeypatch.setattr(NestedLoopJoinExec, "_CHUNK_TARGET", 50)
    left, right = _sides(97, n_r=13)

    def build(dl, dr, X):
        return dl.join(dr, condition=X.col("lv") > X.col("rv") + 40,
                       how=how)
    pdf, got = _both(left, right, build, BROADCAST)

    def cond(a, b):
        return a[1] is not None and b[1] is not None and a[1] > b[1] + 40
    assert Counter(_rows(got)) == Counter(_ref_join(
        _rows(left), _rows(right), how, lambda a, b: True, cond))
    (nlj,) = [x for x in _plan_nodes(pdf)
              if type(x).__name__ == "NestedLoopJoinExec"]
    m = pdf.last_metrics()[nlj._op_id]
    assert m["streamBatches"] == 4
    assert m["nestedLoopChunks"] == 22 + 22 + 22 + 20


def test_cross_join_with_a_condition_runs_the_nested_loop_join():
    left, right = _sides(98, n_r=9)

    def build(dl, dr, X):
        return dl.join(dr, how="cross", condition=X.col("k") == X.col("k2"))
    pdf, got = _both(left, right, build, {})
    assert Counter(_rows(got)) == Counter(_ref_join(
        _rows(left), _rows(right), "inner", _keys_equal,
        lambda a, b: True))
    (nlj,) = [x for x in _plan_nodes(pdf)
              if type(x).__name__ == "NestedLoopJoinExec"]
    assert nlj.how == "inner"


def test_mismatched_key_types_beside_a_condition_are_refused():
    left, right = _sides(5)
    right = right.set_column(0, "k2", right.column(0).cast(pa.int32()))
    s = pt.TpuSession(device="cpu")
    q = s.create_dataframe(left).join(
        s.create_dataframe(right),
        on=(px.col("k") == px.col("k2")) & (px.col("lv") < px.col("rv")))
    with pytest.raises(px.UnsupportedExpr, match="mismatched types"):
        q.to_arrow()


def test_join_needs_keys_a_condition_or_cross():
    left, right = _sides(6)
    s = pt.TpuSession(device="cpu")
    dl, dr = s.create_dataframe(left), s.create_dataframe(right)
    with pytest.raises(ValueError):
        dl.join(dr)
    with pytest.raises(TypeError):
        dl.join(dr, on=[px.col("k")])
