"""Nested types in the PyTorch port (on the CPU) against the JAX package:
array, struct and map columns, the collection expressions, the
higher-order functions, explode and its family (GenerateExec), and the
nested gather and concatenation. One case for each case of the JAX
package's `tests/test_nested.py`, under the same name, each run through
both packages over the same Arrow input. The outputs must be equal,
exactly: the Arrow types, the values, and the order of rows and of
elements. A bare group_by's rows have no order: those compare sorted by
their key. The literal expectations of the JAX file are checked too.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.columnar.table import Table as JTable
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.columnar.table import Table as PTable
from spark_rapids_tpu_torch.exec.batch import DeviceBatch
from spark_rapids_tpu_torch.exec.nodes import _batch_to_arrow
from spark_rapids_tpu_torch.expr.expressions import \
    UnsupportedExpr as PUnsupported

from torch_parity import sessions


def _df_data():
    return {
        "id": pa.array([1, 2, 3, 4]),
        "arr": pa.array([[1, 2, 3], [], None, [4, 5]]),
        "tags": pa.array([["a", "b"], ["a"], None, []]),
        "m": pa.array([{"a": 1}, {"b": 2, "c": 3}, None, {}],
                      type=pa.map_(pa.string(), pa.int64())),
        "st": pa.array([{"x": 1, "y": "a"}, {"x": 2, "y": "b"},
                        {"x": 3, "y": "c"}, None]),
    }


def both(data, make, conf=None, sort_by=None):
    """`make(df, F)` through each package over `data`; asserts the two
    Arrow results are equal and returns the port's rows."""
    js, ps = sessions(conf)
    outs = []
    for s, F in ((js, JF), (ps, PF)):
        at = make(s.create_dataframe(data), F).to_arrow()
        if sort_by:
            at = at.sort_by(sort_by)
        outs.append(at)
    want, got = outs
    assert got.column_names == want.column_names
    for name in want.column_names:
        assert got.column(name).type == want.column(name).type, name
    assert got.to_pylist() == want.to_pylist()
    return got.to_pylist()


# ----------------------------------------------------------------------
# columnar round trips
# ----------------------------------------------------------------------
ROUNDTRIP = [
    pa.array([[1, 2], [3], None, [4, 5, 6], []]),
    pa.array([["a", "bb"], None, ["ccc"], [], ["d", None]]),
    pa.array([{"x": 1, "y": "a"}, {"x": 2, "y": None}, None]),
    pa.array([{"a": 1}, {"b": 2, "c": 3}, None, {}],
             type=pa.map_(pa.string(), pa.int64())),
    pa.array([[[1], [2, 3]], None, [[4]], [], [None, [5]]]),
]


def _port_roundtrip(arr):
    """Host decode, the copy to the device and back, Arrow out."""
    t = PTable.from_arrow(pa.table({"c": arr}), torch.device("cpu"))
    return _batch_to_arrow(DeviceBatch(t)).column("c").combine_chunks()


@pytest.mark.parametrize("data", ROUNDTRIP,
                         ids=["list_int", "list_str", "struct", "map",
                              "list_list"])
def test_nested_roundtrip(data):
    for d in (data, data.slice(1, 3)):
        want = JColumn.from_arrow(d).to_arrow()
        got = _port_roundtrip(d)
        assert got.type == want.type == d.type
        assert got.to_pylist() == want.to_pylist() == d.to_pylist()
        dtype, n, bufs = PColumn.host_from_arrow(d)
        assert PColumn.arrow_from_host(dtype, n, bufs).to_pylist() == \
            d.to_pylist()


def test_nested_table_roundtrip():
    t = pa.table({"a": pa.array([[1], [2, 3], None]),
                  "s": pa.array([{"k": "x"}, None, {"k": "z"}])})
    want = JTable.from_arrow(t).to_arrow()
    got = _batch_to_arrow(DeviceBatch(PTable.from_arrow(
        t, torch.device("cpu"))))
    assert got.to_pylist() == want.to_pylist() == t.to_pylist()
    assert got.schema.types == want.schema.types


# ----------------------------------------------------------------------
# collection expressions
# ----------------------------------------------------------------------
def test_size_getitem_element_at():
    out = both(_df_data(), lambda d, F: d.select(
        F.size(F.col("arr")).alias("sz"),
        F.col("arr").getItem(1).alias("it"),
        F.element_at(F.col("arr"), -1).alias("ea"),
        F.element_at(F.col("arr"), 2).alias("e2"),
        F.col("arr")[5].alias("oob")))
    assert [r["sz"] for r in out] == [3, 0, None, 2]
    assert [r["it"] for r in out] == [2, None, None, 5]
    assert [r["ea"] for r in out] == [3, None, None, 5]


def test_array_contains_min_max():
    out = both(_df_data(), lambda d, F: d.select(
        F.array_contains(F.col("arr"), 2).alias("ac"),
        F.array_min(F.col("arr")).alias("mn"),
        F.array_max(F.col("arr")).alias("mx"),
        F.array_contains(F.col("tags"), "b").alias("at")))
    assert [r["ac"] for r in out] == [True, False, None, False]
    assert [r["mn"] for r in out] == [1, None, None, 4]
    assert [r["mx"] for r in out] == [3, None, None, 5]


def test_sort_array():
    data = dict(_df_data())
    data["nul"] = pa.array([[3, None, 1], [None], [], [2, 2, None, 0]])
    out = both(data, lambda d, F: d.select(
        F.sort_array(F.col("arr"), asc=False).alias("s"),
        F.sort_array(F.col("arr")).alias("a"),
        F.sort_array(F.col("nul")).alias("na"),
        F.sort_array(F.col("nul"), asc=False).alias("nd")))
    assert [r["s"] for r in out] == [[3, 2, 1], [], None, [5, 4]]
    assert [r["na"] for r in out] == [[None, 1, 3], [None], [],
                                      [None, 0, 2, 2]]


def test_map_ops():
    out = both(_df_data(), lambda d, F: d.select(
        F.element_at(F.col("m"), "b").alias("mb"),
        F.map_keys(F.col("m")).alias("mk"),
        F.map_values(F.col("m")).alias("mv"),
        F.size(F.col("m")).alias("ms")))
    assert [r["mb"] for r in out] == [None, 2, None, None]
    assert [r["mk"] for r in out] == [["a"], ["b", "c"], None, []]
    assert [r["mv"] for r in out] == [[1], [2, 3], None, []]


def test_struct_create_and_getfield():
    out = both(_df_data(), lambda d, F: d.select(
        F.col("st").getField("y").alias("sy"),
        F.col("st")["x"].alias("sx"),
        F.struct(F.col("id").alias("a"), (F.col("id") * 2).alias("b"))
        .alias("mk"),
        F.named_struct("p", F.col("id"), "q", F.col("tags")).alias("ns"),
        F.get_field(F.col("st"), "x").alias("gf")))
    assert [r["sy"] for r in out] == ["a", "b", "c", None]
    assert [r["sx"] for r in out] == [1, 2, 3, None]
    assert out[1]["mk"] == {"a": 2, "b": 4}


def test_create_array():
    out = both(_df_data(), lambda d, F: d.select(
        F.array(F.col("id"), F.col("id") + 10).alias("a")))
    assert [r["a"] for r in out] == [[1, 11], [2, 12], [3, 13], [4, 14]]


def test_create_array_strings():
    out = both(_df_data(), lambda d, F: d.select(
        F.array(F.col("st").getField("y"), F.lit("z")).alias("a")))
    assert [r["a"] for r in out] == [["a", "z"], ["b", "z"], ["c", "z"],
                                     [None, "z"]]


# ----------------------------------------------------------------------
# higher-order functions
# ----------------------------------------------------------------------
def test_transform_filter():
    out = both(_df_data(), lambda d, F: d.select(
        F.transform(F.col("arr"), lambda x: x * 10).alias("t"),
        F.transform(F.col("arr"), lambda x, i: x + i).alias("ti"),
        F.filter(F.col("arr"), lambda x: x > 1).alias("f"),
        F.filter(F.col("tags"), lambda x: x == "a").alias("ft")))
    assert [r["t"] for r in out] == [[10, 20, 30], [], None, [40, 50]]
    assert [r["ti"] for r in out] == [[1, 3, 5], [], None, [4, 6]]
    assert [r["f"] for r in out] == [[2, 3], [], None, [4, 5]]


def test_exists_forall_aggregate():
    out = both(_df_data(), lambda d, F: d.select(
        F.exists(F.col("arr"), lambda x: x > 4).alias("e"),
        F.forall(F.col("arr"), lambda x: x > 0).alias("fa"),
        F.aggregate(F.col("arr"), F.lit(0), lambda a, x: a + x)
        .alias("ag")))
    assert [r["e"] for r in out] == [False, False, None, True]
    assert [r["fa"] for r in out] == [True, True, None, True]
    assert [r["ag"] for r in out] == [6, 0, None, 9]


def test_transform_captures_outer_column():
    out = both(_df_data(), lambda d, F: d.select(
        F.transform(F.col("arr"), lambda x: x + F.col("id")).alias("t")))
    assert [r["t"] for r in out] == [[2, 3, 4], [], None, [8, 9]]


# ----------------------------------------------------------------------
# the explode family (GenerateExec)
# ----------------------------------------------------------------------
def test_explode():
    out = both(_df_data(), lambda d, F: d.select(
        F.col("id"), F.explode(F.col("arr")).alias("n")))
    assert out == [{"id": 1, "n": 1}, {"id": 1, "n": 2}, {"id": 1, "n": 3},
                   {"id": 4, "n": 4}, {"id": 4, "n": 5}]


def test_explode_outer():
    out = both(_df_data(), lambda d, F: d.select(
        F.col("id"), F.explode_outer(F.col("tags")).alias("t")))
    assert out == [{"id": 1, "t": "a"}, {"id": 1, "t": "b"},
                   {"id": 2, "t": "a"}, {"id": 3, "t": None},
                   {"id": 4, "t": None}]
    both(_df_data(), lambda d, F: d.select(
        F.col("st"), F.posexplode_outer(F.col("arr"))))


def test_posexplode():
    out = both(_df_data(), lambda d, F: d.select(
        F.col("id"), F.posexplode(F.col("tags"))))
    assert out == [{"id": 1, "pos": 0, "col": "a"},
                   {"id": 1, "pos": 1, "col": "b"},
                   {"id": 2, "pos": 0, "col": "a"}]


def test_explode_map():
    out = both(_df_data(), lambda d, F: d.select(
        F.col("id"), F.explode(F.col("m"))))
    assert out == [{"id": 1, "key": "a", "value": 1},
                   {"id": 2, "key": "b", "value": 2},
                   {"id": 2, "key": "c", "value": 3}]


def test_explode_feeds_groupby():
    out = both(_df_data(), lambda d, F: (
        d.select(F.col("id"), F.explode(F.col("arr")).alias("n"))
        .group_by("n").agg(F.count("id").alias("c"),
                           F.sum("id").alias("s"))), sort_by="n")
    got = {r["n"]: (r["c"], r["s"]) for r in out}
    assert got == {1: (1, 1), 2: (1, 1), 3: (1, 1), 4: (1, 4), 5: (1, 4)}


def test_explode_after_filter():
    out = both(_df_data(), lambda d, F: (
        d.filter(F.col("id") >= 2)
        .select(F.col("id"), F.explode(F.col("arr")).alias("n"))))
    assert out == [{"id": 4, "n": 4}, {"id": 4, "n": 5}]


# ----------------------------------------------------------------------
# nested columns through the engine
# ----------------------------------------------------------------------
def test_nested_survives_coalesce_union():
    js, ps = sessions()
    t1 = pa.table({"a": pa.array([[1, 2], None])})
    t2 = pa.table({"a": pa.array([[3], []])})
    got = ps.create_dataframe(t1).union(ps.create_dataframe(t2)).to_arrow()
    want = js.create_dataframe(t1).union(js.create_dataframe(t2)).to_arrow()
    assert got.column("a").to_pylist() == want.column("a").to_pylist() \
        == [[1, 2], None, [3], []]


def test_nested_filter_compaction():
    out = both(_df_data(), lambda d, F: d.filter(
        F.col("id") % 2 == 1).select(F.col("arr"), F.col("st"),
                                     F.col("m")))
    assert [{"arr": r["arr"], "st": r["st"]} for r in out] == [
        {"arr": [1, 2, 3], "st": {"x": 1, "y": "a"}},
        {"arr": None, "st": {"x": 3, "y": "c"}}]


# ----------------------------------------------------------------------
# collect_list / collect_set
# ----------------------------------------------------------------------
def test_collect_list_set():
    data = {"k": pa.array([1, 2, 1, 2, 1, 3]),
            "v": pa.array([10, 20, 10, 40, 50, None]),
            "t": pa.array(["a", "b", "a", "c", "a", None])}
    out = both(data, lambda d, F: d.group_by("k").agg(
        F.collect_list(F.col("v")).alias("cl"),
        F.collect_set(F.col("v")).alias("cs"),
        F.collect_set(F.col("t")).alias("cts"),
        F.sum("v").alias("sv")), sort_by="k")
    got = {r["k"]: (sorted(r["cl"]), sorted(r["cs"]), sorted(r["cts"]),
                    r["sv"]) for r in out}
    assert got == {1: ([10, 10, 50], [10, 50], ["a"], 70),
                   2: ([20, 40], [20, 40], ["b", "c"], 60),
                   3: ([], [], [], None)}


def test_collect_multi_partition():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 7, 4000)
    v = rng.integers(0, 5, 4000)
    out = both({"k": pa.array(k), "v": pa.array(v)},
               lambda d, F: d.group_by("k").agg(
                   F.collect_set(F.col("v")).alias("cs"),
                   F.collect_list(F.col("v")).alias("cl")),
               conf={"spark.rapids.tpu.sql.batchSizeRows": 512},
               sort_by="k")
    exp = {}
    for kk, vv in zip(k, v):
        exp.setdefault(int(kk), set()).add(int(vv))
    assert {r["k"]: set(r["cs"]) for r in out} == exp


def test_nested_through_shuffle_join():
    rng = np.random.default_rng(3)
    n = 600
    ks = rng.integers(0, 20, n)
    arrs = [None if rng.random() < 0.1 else
            [int(x) for x in rng.integers(0, 9, rng.integers(0, 5))]
            for _ in range(n)]
    left = {"k": pa.array(ks), "p": pa.array(arrs, type=pa.list_(pa.int64()))}
    right = pa.table({"k": pa.array(list(range(20))),
                      "w": pa.array([k * 10 for k in range(20)])})
    js, ps = sessions({"spark.rapids.tpu.sql.batchSizeRows": 128})
    outs = []
    for s in (js, ps):
        d1 = s.create_dataframe(left)
        outs.append(d1.join(s.create_dataframe(right), on=["k"]).to_arrow())
    want, got = outs

    # rows of one key keep no defined order across the exchange: compare
    # each key's multiset of payloads
    def groups(at):
        out = {}
        for r in at.to_pylist():
            out.setdefault(r["k"], []).append((repr(r["p"]), r["w"]))
        return {k: sorted(v) for k, v in out.items()}
    assert got.schema.types == want.schema.types
    assert groups(got) == groups(want)
    exp = {}
    for k, p in zip(ks, arrs):
        exp.setdefault(int(k), []).append((repr(p), int(k) * 10))
    assert groups(got) == {k: sorted(v) for k, v in exp.items()}
    assert got.num_rows == n


def test_collect_list_strings_shuffled():
    rng = np.random.default_rng(5)
    n = 500
    ks = rng.integers(0, 9, n)
    ts = [f"s{x}" for x in rng.integers(0, 6, n)]
    out = both({"k": pa.array(ks), "t": pa.array(ts)},
               lambda d, F: d.group_by("k").agg(
                   F.collect_set(F.col("t")).alias("cs"),
                   F.collect_list(F.col("t")).alias("cl")),
               conf={"spark.rapids.tpu.sql.batchSizeRows": 128},
               sort_by="k")
    exp = {}
    for k, t in zip(ks, ts):
        exp.setdefault(int(k), set()).add(t)
    assert {r["k"]: set(r["cs"]) for r in out} == exp


# ----------------------------------------------------------------------
# the JAX file's review regressions
# ----------------------------------------------------------------------
def test_array_contains_long_string_values():
    long = ["x" * 40 + str(i) for i in range(4)]
    data = {"arr": pa.array([[long[0], long[2]]] * 2
                            + [[long[1]], [long[3], long[0]]]),
            "val": pa.array([long[0], long[1], long[1], long[2]])}
    out = both(data, lambda d, F: d.select(
        F.array_contains(F.col("arr"), F.col("val")).alias("c")))
    assert [r["c"] for r in out] == [True, False, True, False]


def test_element_at_map_long_string_keys():
    long = ["x" * 40 + str(i) for i in range(3)]
    data = {"m": pa.array([{long[0]: 1, long[1]: 2}, {long[2]: 3}],
                          type=pa.map_(pa.string(), pa.int64())),
            "k": pa.array([long[1], long[2]])}
    out = both(data, lambda d, F: d.select(
        F.element_at(F.col("m"), F.col("k")).alias("v")))
    assert [r["v"] for r in out] == [2, 3]


def test_explode_name_collision():
    data = {"col": pa.array([100, 200]), "arr": pa.array([[1, 2], [3]])}
    out = both(data, lambda d, F: d.select(F.explode(F.col("arr"))))
    assert [r["col"] for r in out] == [1, 2, 3]


def test_aggregate_per_row_zero():
    data = {"arr": pa.array([[1, 2], [10]]), "z": pa.array([100, 200])}
    out = both(data, lambda d, F: d.select(F.aggregate(
        F.col("arr"), F.col("z"), lambda a, x: a + x).alias("s")))
    assert [r["s"] for r in out] == [103, 210]


def test_lambda_string_capture_rejected():
    js, ps = sessions()
    data = {"arr": pa.array([[1], [2]]), "s": pa.array(["a", "b"])}
    for s, F, err in ((js, JF, JUnsupported), (ps, PF, PUnsupported)):
        d = s.create_dataframe(data)
        with pytest.raises(err):
            d.select(F.transform(F.col("arr"),
                                 lambda x: x + F.length(F.col("s")))
                     ).to_arrow()


# ----------------------------------------------------------------------
# beyond the JAX file: where the reference departs from Spark
# ----------------------------------------------------------------------
def test_array_min_max_nan_as_the_jax_package():
    """A NaN element makes array_min and array_max NaN, as XLA's minimum
    and maximum give them in the JAX package (Spark's array_min skips
    NaN: ROADMAP C.20)."""
    nan = float("nan")
    data = {"a": pa.array([[1.0, nan, 3.0], [nan], [2.0, -0.0, 0.0], None,
                           []])}
    js, ps = sessions()
    outs = [s.create_dataframe(data).select(
        F.array_min("a").alias("mn"), F.array_max("a").alias("mx"),
        F.sort_array("a").alias("s")).to_arrow()
        for s, F in ((js, JF), (ps, PF))]
    want, got = outs
    assert repr(got.to_pylist()) == repr(want.to_pylist())


def test_aggregate_merge_capture_refused():
    """The JAX package's fold reaches no outer column (its scan raises
    IndexError on one); the port refuses the capture at bind."""
    js, ps = sessions()
    data = {"a": pa.array([[1, 2], [3]]), "z": pa.array([10, 20])}
    make = lambda d, F: d.select(F.aggregate(
        F.col("a"), F.lit(0), lambda acc, x: acc + x + F.col("z")))
    with pytest.raises(IndexError):
        make(js.create_dataframe(data), JF).to_arrow()
    with pytest.raises(PUnsupported, match="captures"):
        make(ps.create_dataframe(data), PF).to_arrow()
