"""The port's Iceberg reads and writes against the JAX package's: the
cases of tests/test_iceberg_avro.py (tables built spec-shaped by that
file's IcebergBuilder: current snapshot, time travel by id and by
timestamp, v2 position deletes, a grouped query) and of
tests/test_iceberg_write.py (round trip, append and time travel,
overwrite, errorifexists, typed columns), each through both packages
with equal rows; and a table written by one package read by the other."""
import datetime
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.io.iceberg import IcebergTable as JTable
from spark_rapids_tpu_torch.io.iceberg import IcebergTable as PTable
from test_iceberg_avro import IcebergBuilder
from torch_parity import assert_same

CONF = {"spark.rapids.tpu.sql.batchSizeRows": 512}


def _sessions():
    return st.TpuSession(dict(CONF)), pt.TpuSession(dict(CONF),
                                                   device="cpu")


def _sorted(at):
    """The rows as tuples, sorted with nulls first."""
    return sorted((tuple(r.values()) for r in at.to_pylist()),
                  key=lambda t: [(v is not None, v) for v in t])


def _two_snapshots(root):
    b = IcebergBuilder(root)
    b.add_snapshot([pa.table({"k": pa.array([1, 2, 3]),
                              "v": pa.array([10, 20, 30])})], ts_ms=1000)
    b.add_snapshot([pa.table({"k": pa.array([4, 5]),
                              "v": pa.array([40, 50])})], ts_ms=2000)
    return b


@pytest.mark.parametrize("how,rows", [
    ({}, 5), ({"snapshot_id": 1}, 3), ({"as_of_timestamp": 1500}, 3),
    ({"as_of_timestamp": 2500}, 5)],
    ids=["current", "snapshot_1", "ts_1500", "ts_2500"])
def test_reads_and_time_travel_equal_jax(tmp_path, how, rows):
    _two_snapshots(tmp_path / "tbl")
    js, ps = _sessions()
    j = js.read.iceberg(str(tmp_path / "tbl"), **how).to_arrow()
    p = ps.read.iceberg(str(tmp_path / "tbl"), **how).to_arrow()
    assert_same(j, p, str(how))
    assert p.num_rows == rows


def test_unknown_snapshot_raises_alike(tmp_path):
    _two_snapshots(tmp_path / "tbl")
    js, ps = _sessions()
    errs = []
    for s in (js, ps):
        with pytest.raises(KeyError) as e:
            s.read.iceberg(str(tmp_path / "tbl"), snapshot_id=99)
        errs.append(str(e.value))
        with pytest.raises(KeyError) as e:
            s.read.iceberg(str(tmp_path / "tbl"), as_of_timestamp=5)
        errs.append(str(e.value))
    assert errs[2:] == errs[:2]


@pytest.mark.parametrize("positions", [[1, 3], [0], [0, 1, 2, 3], [9]])
def test_position_deletes_equal_jax(tmp_path, positions):
    b = IcebergBuilder(tmp_path / "tbl")
    b.add_snapshot([pa.table({"k": pa.array([1, 2, 3, 4]),
                              "v": pa.array([10, 20, 30, 40])}),
                    pa.table({"k": pa.array([5, 6]),
                              "v": pa.array([50, 60])})], ts_ms=1000)
    fp = b.snaps[-1]["_files"][0]
    b.add_snapshot([], delete_table=pa.table({
        "file_path": pa.array([fp] * len(positions)),
        "pos": pa.array(positions, type=pa.int64())}), ts_ms=2000)
    js, ps = _sessions()
    for how in ({"snapshot_id": 1}, {}):
        j = js.read.iceberg(str(tmp_path / "tbl"), **how).to_arrow()
        p = ps.read.iceberg(str(tmp_path / "tbl"), **how).to_arrow()
        assert_same(j, p, f"{positions} {how}")
    want = [k for i, k in enumerate([1, 2, 3, 4]) if i not in positions]
    assert sorted(p.column("k").to_pylist()) == want + [5, 6]


def test_grouped_query_over_iceberg(tmp_path):
    b = IcebergBuilder(tmp_path / "tbl")
    rng = np.random.default_rng(5)
    b.add_snapshot([pa.table({"k": pa.array(rng.integers(0, 8, 2000)),
                              "v": pa.array(rng.integers(0, 100, 2000))})],
                   ts_ms=1000)
    js, ps = _sessions()
    j = js.read.iceberg(str(tmp_path / "tbl")).group_by("k").agg(
        JF.sum("v").alias("s")).sort("k").to_arrow()
    p = ps.read.iceberg(str(tmp_path / "tbl")).group_by("k").agg(
        PF.sum("v").alias("s")).sort("k").to_arrow()
    assert_same(j, p, "grouped")


def _typed():
    return {"b": pa.array([True, None, False]),
            "i": pa.array([1, None, 3], pa.int32()),
            "l": pa.array([10 ** 12, None, -5]),
            "f": pa.array([1.5, None, -2.25]),
            "d": pa.array([Decimal("12.34"), None, Decimal("-0.01")],
                          pa.decimal128(9, 2)),
            "dt": pa.array([datetime.date(2020, 5, 17), None,
                            datetime.date(1970, 1, 1)]),
            "s": pa.array(["x", None, "z/w"])}


def _write_case(case, s, path):
    """One write scenario on one package; returns what the JAX test
    checks beside the rows."""
    rng = np.random.default_rng(4)
    if case == "roundtrip":
        n = 1500
        return s.create_dataframe({
            "k": pa.array(rng.integers(0, 9, n)),
            "v": pa.array(rng.normal(0, 1, n)),
            "s": pa.array([f"r{i % 13}" for i in range(n)])}) \
            .write.mode("overwrite").iceberg(path)
    if case == "append":
        s.create_dataframe({"x": pa.array([1, 2, 3])}) \
            .write.mode("overwrite").iceberg(path)
        return s.create_dataframe({"x": pa.array([4, 5])}) \
            .write.mode("append").iceberg(path)
    if case == "overwrite":
        s.create_dataframe({"x": pa.array([1, 2, 3])}) \
            .write.mode("overwrite").iceberg(path)
        return s.create_dataframe({"y": pa.array(["a"])}) \
            .write.mode("overwrite").iceberg(path)
    if case == "errorifexists":
        s.create_dataframe({"x": pa.array([1])}) \
            .write.mode("overwrite").iceberg(path)
        try:
            s.create_dataframe({"x": pa.array([2])}).write.iceberg(path)
        except FileExistsError:
            pass
        else:
            raise AssertionError("errorifexists wrote")
        return s.create_dataframe({"x": pa.array([3])}) \
            .write.mode("ignore").iceberg(path)
    if case == "typed":
        return s.create_dataframe(_typed()).write.mode("overwrite") \
            .iceberg(path)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["roundtrip", "append", "overwrite",
                                  "errorifexists", "typed"])
def test_writes_equal_jax_at_every_snapshot(tmp_path, case):
    got = {}
    for name, s, T in zip(("jax", "port"), _sessions(), (JTable, PTable)):
        path = str(tmp_path / name)
        rows = _write_case(case, s, path)
        snaps = [x["snapshot-id"] for x in T(path).snapshots()]
        per = [_sorted(s.read.iceberg(path, snapshot_id=sid).to_arrow())
               for sid in snaps]
        cur = s.read.iceberg(path).to_arrow()
        schema = [(f.name, f.dtype.simple_name(), f.nullable)
                  for f in T(path).schema().fields]
        got[name] = (rows, per, _sorted(cur), schema,
                     [x["summary"] for x in T(path).snapshots()])
    assert got["port"] == got["jax"]
    if case == "typed":
        back = got["port"][2]
        assert (True, 1, 10 ** 12, 1.5, Decimal("12.34"),
                datetime.date(2020, 5, 17), "x") in back


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_table_reads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "t")
    js, ps = _sessions()
    w, r = (js, ps) if writer == "jax" else (ps, js)
    W, R = (JTable, PTable) if writer == "jax" else (PTable, JTable)
    w.create_dataframe(_typed()).write.mode("overwrite").iceberg(path)
    w.create_dataframe(_typed()).write.mode("append").iceberg(path)
    sids = [x["snapshot-id"] for x in W(path).snapshots()]
    assert [x["snapshot-id"] for x in R(path).snapshots()] == sids
    for how in [{}] + [{"snapshot_id": sid} for sid in sids]:
        a = w.read.iceberg(path, **how).to_arrow()
        b = r.read.iceberg(path, **how).to_arrow()
        assert _sorted(a) == _sorted(b)
    # the reader's package appends to the writer's table
    r.create_dataframe(_typed()).write.mode("append").iceberg(path)
    assert w.read.iceberg(path).to_arrow().num_rows == 9
