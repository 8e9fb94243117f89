"""The hash join of the PyTorch port (on the CPU) against the JAX package.

Every ported `how` (inner, left, right, full, left_semi, left_anti) on
every build path of `exec/join.py`: the direct-address build (one int key
of a small span, unique build keys: the FK pass-through), the direct
build promoted to the sorted build (duplicate build keys: the expand
pass), the sorted build (a key span past the direct build's limit), and
the generic combined-sort count (two keys; a string key); each with no,
all and mixed null keys on both sides. The port's per-join metrics show
which path ran. Also: an empty build and an empty stream, the int64
maximum key next to null build keys, the broadcast and the per-partition
(shuffled) topologies, the joined column names, and the NotPorted
refusals (a count(DISTINCT) outside the optimizer's rewrite, a mesh
exchange, a build over `sql.join.buildSideBudgetBytes`). Each result must equal the JAX
package's Arrow table, row for row once both are sorted by every column
(the row order of a join output is not defined). Tolerance: exact.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.expr.expressions import col as jcol
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.errors import NotPorted
from spark_rapids_tpu_torch.expr.expressions import col

HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti")
PATHS = ("direct", "promoted", "sorted", "count_multi", "count_string")
NULLS = ("none", "all", "mixed")
I64_MAX = (1 << 63) - 1
WIDE = 1 << 40       # a key step that takes the span past the direct limit


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _valid(rng, n, nulls):
    if nulls == "none":
        return np.ones(n, bool)
    if nulls == "all":
        return np.zeros(n, bool)
    return rng.random(n) > 0.2


def _tables(path, nulls, seed=11, n_s=200, n_b=150):
    """(stream, build) Arrow tables whose keys take `path`."""
    rng = np.random.default_rng(seed)
    if path == "direct":
        bkey = rng.permutation(300)[:n_b]
    else:
        bkey = rng.integers(0, 60, n_b)
    skey = rng.integers(0, 300 if path == "direct" else 80, n_s)
    if path == "sorted":
        bkey, skey = bkey * WIDE - 7, skey * WIDE - 7
    bv, sv = _valid(rng, n_b, nulls), _valid(rng, n_s, nulls)

    def keys(k, v, side):
        if path == "count_string":
            return {"k": pa.array([f"key-{x}" if ok else None
                                   for x, ok in zip(k, v)])}
        out = {"k": pa.array(k.astype(np.int64), mask=~v)}
        if path == "count_multi":
            k2 = (k % 3).astype(np.int32)
            out["k2"] = pa.array(k2, mask=~v if side == "s" else None)
        return out
    stream = pa.table({**keys(skey, sv, "s"),
                       "a": pa.array(rng.integers(-50, 50, n_s)
                                     .astype(np.int32)),
                       "sa": pa.array([f"s{i % 17}" * (i % 4)
                                       for i in range(n_s)])})
    build = pa.table({**keys(bkey, bv, "b"),
                      "b": pa.array(rng.integers(0, 1000, n_b)),
                      "sb": pa.array([None if i % 9 == 0 else f"b{i}"
                                      for i in range(n_b)])})
    return stream, build


def _on(path):
    return ["k", "k2"] if path == "count_multi" else ["k"]


def _sorted(at):
    """The rows sorted by every column (renamed apart for the sort, so
    duplicate names sort too)."""
    tmp = at.rename_columns([f"c{i}" for i in range(at.num_columns)])
    return tmp.sort_by([(c, "ascending") for c in tmp.column_names]) \
        .rename_columns(at.column_names)


def _join(session, stream, build, on, how):
    return session.create_dataframe(stream).join(
        session.create_dataframe(build), on=on, how=how)


def _run_both(stream, build, on, how, conf):
    pdf = _join(pt.TpuSession(dict(conf), device="cpu"), stream, build, on,
                how)
    got = pdf.to_arrow()
    exp = _join(st.TpuSession(dict(conf)), stream, build, on,
                how).to_arrow()
    assert got.column_names == exp.column_names
    assert _sorted(got).equals(_sorted(exp))
    return pdf, got


def _join_metrics(pdf):
    root = pdf.last_plan()
    stack, joins = [root], []
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashJoinExec":
            joins.append(pdf.last_metrics().get(node._op_id, {}))
        stack.extend(node.children)
    assert len(joins) == 1
    return joins[0]


@pytest.mark.parametrize("nulls", NULLS)
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("path", PATHS)
def test_join_equals_jax(path, how, nulls):
    stream, build = _tables(path, nulls)
    pdf, got = _run_both(stream, build, _on(path), how, {})
    m = _join_metrics(pdf)
    assert m["streamBatches"] == 1
    if nulls == "all":
        return       # no valid build key: the direct build declines
    direct_ok = how in ("inner", "left", "left_semi", "left_anti")
    if path in ("direct", "promoted") and direct_ok:
        assert m.get("directProbeBatches") == 1
        promote = path == "promoted" and how in ("inner", "left")
        assert m.get("promotedToSorted", 0) == int(promote)
        if how in ("inner", "left"):
            assert m.get("fkOutputBatches", 0) == int(not promote)
            assert m.get("expandOutputBatches", 0) == int(promote)
    elif path in ("direct", "promoted", "sorted"):
        assert m.get("directProbeBatches", 0) == 0
        assert m.get("sortedProbeBatches") == 1
    else:
        assert m.get("countProbeBatches") == 1
    if how in ("left_semi", "left_anti"):
        assert got.column_names == list(stream.column_names)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("empty", ["build", "stream", "both"])
def test_empty_sides(how, empty):
    stream, build = _tables("promoted", "mixed")
    if empty in ("build", "both"):
        build = build.slice(0, 0)
    if empty in ("stream", "both"):
        stream = stream.slice(0, 0)
    _run_both(stream, build, ["k"], how, {})


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("path", ["direct", "sorted", "count_multi"])
def test_filtered_to_nothing(how, path):
    """Sides whose every row a filter removed (holey, all-dead batches)."""
    stream, build = _tables(path, "mixed")
    on = _on(path)
    outs = []
    for s, c in ((pt.TpuSession(device="cpu"), col),
                 (st.TpuSession(), jcol)):
        left = s.create_dataframe(stream).filter(c("a") > 1000)
        right = s.create_dataframe(build).filter(c("b") < 500)
        outs.append(left.join(right, on=on, how=how).to_arrow())
        left = s.create_dataframe(stream).filter(c("a") < 1000)
        right = s.create_dataframe(build).filter(c("b") > 5000)
        outs.append(left.join(right, on=on, how=how).to_arrow())
    assert _sorted(outs[0]).equals(_sorted(outs[2]))
    assert _sorted(outs[1]).equals(_sorted(outs[3]))


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("span", ["narrow", "wide"])
def test_int64_maximum_key_beside_null_build_keys(how, span):
    """A valid key equal to the int64 maximum must match although null
    build keys sort to the same place (narrow: the direct build at the
    top of the int64 range; wide: the sorted build)."""
    lo = I64_MAX - 5 if span == "narrow" else -(1 << 63)
    bk = [I64_MAX, None, lo, I64_MAX, None, I64_MAX - 1]
    sk = [I64_MAX, None, lo, 3, I64_MAX - 1, -(1 << 63), I64_MAX]
    build = pa.table({"k": pa.array(bk, pa.int64()),
                      "b": pa.array(range(len(bk)), pa.int64())})
    stream = pa.table({"k": pa.array(sk, pa.int64()),
                       "a": pa.array(range(len(sk)), pa.int32())})
    pdf, got = _run_both(stream, build, ["k"], how, {})
    if how == "inner":
        assert sorted(got.column("a").to_pylist()) == (
            [0, 0, 2, 4, 6, 6] if span == "narrow"
            else [0, 0, 2, 4, 5, 6, 6])


@pytest.mark.parametrize("path,how", [("promoted", h) for h in HOWS]
                         + [("sorted", "inner"), ("count_multi", "left")])
def test_per_partition_topology(path, how):
    """autoBroadcastJoinThreshold = -1: both sides hash-exchanged on the
    keys, joined per partition; many stream batches each."""
    stream, build = _tables(path, "mixed", n_s=700, n_b=300)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 128,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.shuffle.partitions": 4}
    pdf, _ = _run_both(stream, build, _on(path), how, conf)
    root = pdf.last_plan()
    stack = [root]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "HashJoinExec":
            assert node.per_partition
            assert [type(c).__name__ for c in node.children] == \
                ["ShuffleExchangeExec"] * 2
        stack.extend(node.children)
    assert _join_metrics(pdf)["streamBatches"] == 4


def test_broadcast_topology_collects_the_build_once():
    stream, build = _tables("promoted", "mixed", n_s=700)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 128}
    pdf, _ = _run_both(stream, build, ["k"], "inner", conf)
    join = pdf.last_plan().children[0]
    assert type(join).__name__ == "HashJoinExec" and not join.per_partition
    assert type(join.children[1]).__name__ == "BroadcastExchangeExec"
    m = _join_metrics(pdf)
    assert m["streamBatches"] == 6 and m["promotedToSorted"] == 1
    bc = pdf.last_metrics()[join.children[1]._op_id]
    assert bc["numOutputBatches"] == 2


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_joined_column_names_and_collisions(how):
    """pyspark's layout: the key once (right: from the right side; full:
    coalesced), then the left's columns, then the right's; a name on
    both sides keeps both columns under that name."""
    stream, build = _tables("promoted", "mixed")
    build = build.append_column("a", pa.array(np.arange(build.num_rows)))
    pdf, got = _run_both(stream, build, ["k"], how, {})
    assert got.column_names == ["k", "a", "sa", "b", "sb", "a"]
    if how in ("right", "full"):
        assert got.column("k").null_count == (
            build.column("k").null_count if how == "right" else
            build.column("k").null_count + stream.column("k").null_count)


def test_chained_joins_with_duplicate_names_go_positional():
    """A side that already holds two columns of one name joins by
    position: both survive."""
    stream, build = _tables("direct", "none")
    other = pa.table({"a": pa.array(np.arange(-50, 50, dtype=np.int32)),
                      "z": pa.array(np.arange(100))})
    outs = []
    for s in (pt.TpuSession(device="cpu"), st.TpuSession()):
        b2 = build.append_column("a", pa.array(np.arange(build.num_rows)
                                               .astype(np.int32)))
        j = s.create_dataframe(stream).join(s.create_dataframe(b2), on="k")
        outs.append(j.join(s.create_dataframe(other), on=["a"],
                           how="left").to_arrow())
    assert outs[0].column_names == outs[1].column_names
    assert _sorted(outs[0]).equals(_sorted(outs[1]))


def test_refusals_raise_not_ported():
    stream, build = _tables("direct", "none")
    s = pt.TpuSession(device="cpu")
    left, right = s.create_dataframe(stream), s.create_dataframe(build)
    import spark_rapids_tpu_torch.functions as F
    # a distinct beside another aggregate: the JAX package's sort path
    with pytest.raises(NotPorted, match="CollectAggExec"):
        left.group_by("a").agg(F.countDistinct("k"),
                               F.count("*")).to_arrow()
    mesh = pt.TpuSession({"spark.rapids.tpu.mesh.devices": 4}, device="cpu")
    with pytest.raises(NotPorted, match="mesh exchange"):
        mesh.create_dataframe(stream).join(
            mesh.create_dataframe(build), on=["k"]).to_arrow()
    tiny = pt.TpuSession({"spark.rapids.tpu.sql.join.buildSideBudgetBytes":
                          100}, device="cpu")
    with pytest.raises(NotPorted, match="buildSideBudgetBytes"):
        tiny.create_dataframe(stream).join(
            tiny.create_dataframe(build), on=["k"]).to_arrow()


@pytest.mark.parametrize("downstream", ["aggregate", "exchange", "join"])
def test_fk_output_mask_is_honoured_downstream(downstream):
    """The FK pass-through keeps the stream batch under a holey mask (an
    inner join that matches few rows): a grouped aggregate, a hash
    exchange and a second join (whose `maybe_compact` shrinks the batch)
    must all read only its live rows."""
    import spark_rapids_tpu.functions as JF
    import spark_rapids_tpu_torch.functions as PF
    rng = np.random.default_rng(5)
    n_s = 4000
    stream = pa.table({"k": pa.array(rng.integers(0, 20_000, n_s)),
                       "a": pa.array(rng.integers(0, 9, n_s)
                                     .astype(np.int32))})
    build = pa.table({"k": pa.array(rng.permutation(20_000)[:300]),
                      "b": pa.array(rng.integers(0, 5, 300))})
    third = pa.table({"b": pa.array(np.arange(5)),
                      "z": pa.array([f"z{i}" for i in range(5)])})
    outs = []
    for s, F in ((pt.TpuSession(device="cpu"), PF), (st.TpuSession(), JF)):
        j = s.create_dataframe(stream).join(s.create_dataframe(build),
                                            on=["k"])
        if downstream == "aggregate":
            q = j.group_by("b").agg(F.sum("a").alias("sa"),
                                    F.count("*").alias("n"))
        elif downstream == "exchange":
            q = j.repartition(4, "k")
        else:
            q = j.join(s.create_dataframe(third), on=["b"], how="left")
        outs.append(q)
    got, exp = outs[0].to_arrow(), outs[1].to_arrow()
    assert _sorted(got).equals(_sorted(exp))
    assert 0 < got.num_rows < n_s // 8
