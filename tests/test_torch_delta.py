"""The port's Delta tables against the JAX package's: the cases of
tests/test_delta.py and tests/test_delta_dv.py run through both
packages, each in its own directory, and every version of each table
must hold equal rows (time travel); the deletion-vector payloads are
byte-equal to the JAX `serialize_dv`; a table written by one package
reads in the other; and a `ParquetScanExec` given a DV directly drops
the same rows in both."""
import os
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.io import delta as jdelta
from spark_rapids_tpu.io import dv as jdv
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.session import DataFrame as JDataFrame
from spark_rapids_tpu_torch.io import delta as pdelta
from spark_rapids_tpu_torch.io import dv as pdv
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.session import DataFrame as PDataFrame

DV_ON = {"spark.rapids.tpu.delta.deletionVectors.enabled": "true",
         "spark.rapids.tpu.sql.batchSizeRows": 512}

JAX = types.SimpleNamespace(name="jax", delta=jdelta, F=JF,
                            session=lambda c=None: st.TpuSession(c or {}))
PORT = types.SimpleNamespace(name="port", delta=pdelta, F=PF,
                             session=lambda c=None: pt.TpuSession(
                                 c or {}, device="cpu"))


def _rows(at):
    return sorted(tuple(r.values()) for r in at.to_pylist())


def versions(M, s, path, ordered=False):
    """Every version of the table: its rows (sorted unless `ordered`),
    or the error a read raises."""
    out = []
    for v in range(M.delta.DeltaTable(path).latest_version() + 1):
        try:
            at = s.read.delta(path, version=v).to_arrow()
            out.append([tuple(r.values()) for r in at.to_pylist()]
                       if ordered else _rows(at))
        except ValueError as e:
            out.append(f"ValueError: {e}".replace(path, "<table>"))
    return out


def _kv(n, seed=2, k_hi=50):
    rng = np.random.default_rng(seed)
    return {"k": pa.array(rng.integers(0, k_hi, n)),
            "v": pa.array(np.arange(n, dtype=np.int64))}


# ---- the scenarios: each runs on one package (M) into `path` and
# returns whatever else the JAX test checks -----------------------------
def append_and_time_travel(M, path):
    s = M.session()
    rng = np.random.default_rng(110)
    a = s.create_dataframe({"a": pa.array(rng.integers(-99, 99, 100),
                                          pa.int32())})
    b = s.create_dataframe({"a": pa.array(rng.integers(-99, 99, 50),
                                          pa.int32())})
    return s, (a.write_delta(path), b.write_delta(path))


def overwrite(M, path):
    s = M.session()
    s.create_dataframe({"a": pa.array(np.arange(80))}).write_delta(path)
    s.create_dataframe({"a": pa.array(np.arange(30))}).write_delta(
        path, mode="overwrite")
    return s, [h["operation"] for h in M.delta.DeltaTable(path).history()]


def delete_copy_on_write(M, path):
    s = M.session()
    n = 200
    s.create_dataframe({
        "k": pa.array(list(range(n)), pa.int64()),
        "v": pa.array([i * 10 for i in range(n)], pa.int64())}) \
        .write_delta(path)
    s.create_dataframe({"k": pa.array([1000, 1001], pa.int64()),
                        "v": pa.array([0, 0], pa.int64())}).write_delta(path)
    v = M.delta.delete_delta(s, path, M.F.col("k") % 3 == 0)
    return s, (v, len(M.delta.DeltaTable(path).snapshot_adds()))


def update(M, path):
    s = M.session()
    s.create_dataframe({"k": pa.array([1, 2, 3, 4], pa.int64()),
                        "v": pa.array([10, 20, 30, 40], pa.int64())}) \
        .write_delta(path)
    return s, M.delta.update_delta(s, path, M.F.col("k") >= 3,
                                   {"v": M.F.col("v") + 1000})


def merge_upsert(M, path):
    s = M.session()
    s.create_dataframe({"k": pa.array([1, 2, 3], pa.int64()),
                        "v": pa.array([10, 20, 30], pa.int64())}) \
        .write_delta(path)
    src = s.create_dataframe({"k": pa.array([2, 3, 9], pa.int64()),
                              "v": pa.array([200, 300, 900], pa.int64())})
    return s, M.delta.merge_delta(s, path, src, on=["k"])


def merge_delete_matched(M, path):
    s = M.session()
    s.create_dataframe({"k": pa.array([1, 2, 3, 4], pa.int64()),
                        "v": pa.array([10, 20, 30, 40], pa.int64())}) \
        .write_delta(path)
    src = s.create_dataframe({"k": pa.array([2, 4], pa.int64()),
                              "v": pa.array([0, 0], pa.int64())})
    return s, M.delta.merge_delta(s, path, src, on=["k"],
                                  when_matched="delete",
                                  when_not_matched=None)


def merge_assignments_and_duplicates(M, path):
    s = M.session()
    s.create_dataframe({"k": pa.array([1, 2, 3], pa.int64()),
                        "v": pa.array([10, 20, 30], pa.int64())}) \
        .write_delta(path)
    src = s.create_dataframe({"k": pa.array([3, 4], pa.int64()),
                              "v": pa.array([0, 40], pa.int64())})
    v = M.delta.merge_delta(s, path, src, on=["k"],
                            matched_assignments={"v": M.F.col("v") * 2})
    dup = s.create_dataframe({"k": pa.array([1, 1], pa.int64()),
                              "v": pa.array([5, 6], pa.int64())})
    with pytest.raises(ValueError, match="multiple source rows") as e:
        M.delta.merge_delta(s, path, dup, on=["k"])
    return s, (v, str(e.value))


def checkpoint(M, path):
    s = M.session()
    for i in range(M.delta.CHECKPOINT_INTERVAL + 2):
        s.create_dataframe({"k": pa.array([i], pa.int64())}) \
            .write_delta(path)
    t = M.delta.DeltaTable(path)
    cp = t._last_checkpoint_version()
    return s, (cp, os.path.exists(t._checkpoint_file(cp)),
               pq.read_table(t._checkpoint_file(cp)).num_rows)


def optimize_with_dv_survivors(M, path):
    s = M.session()
    for i in range(4):
        s.create_dataframe({
            "k": pa.array(range(i * 10, i * 10 + 10), pa.int64()),
            "v": pa.array([i] * 10, pa.int64())}).write_delta(path)
    M.delta.delete_delta(M.session(DV_ON), path, M.F.col("k") % 4 == 0)
    stats = M.delta.optimize_delta(s, path, target_file_bytes=1 << 20)
    return s, (stats, len(M.delta.DeltaTable(path).snapshot_adds()))


def optimize_zorder(M, path):
    s = M.session()
    rng = np.random.default_rng(11)
    s.create_dataframe({"x": pa.array(rng.integers(0, 1000, 3000)),
                        "y": pa.array(rng.integers(0, 1000, 3000))}) \
        .write_delta(path)
    return s, M.delta.optimize_delta(s, path, zorder_by=["x", "y"])


def auto_compact(M, path):
    s = M.session({"spark.rapids.tpu.delta.autoCompact.minFiles": 3,
                   "spark.rapids.tpu.delta.autoCompact.targetBytes": 1 << 20})
    for i in range(4):
        s.create_dataframe({"k": pa.array([i] * 5, pa.int64())}) \
            .write_delta(path)
    t = M.delta.DeltaTable(path)
    return s, (len(t.snapshot_adds()),
               [h["operation"] for h in t.history()])


def dv_delete_keeps_data_file(M, path):
    s = M.session(DV_ON)
    s.create_dataframe(_kv(2000)).write.mode("overwrite").delta(path)
    before = set(M.delta.DeltaTable(path).snapshot_files())
    M.delta.delete_delta(s, path, M.F.col("v") % 7 == 0)
    adds = M.delta.DeltaTable(path).snapshot_adds()
    dvs = [a["deletionVector"] for a in adds if a.get("deletionVector")]
    return s, (set(os.path.join(path, a["path"]) for a in adds) == before,
               [(d["storageType"], os.path.isabs(d["pathOrInlineDv"]),
                 d["cardinality"], d["sizeInBytes"]) for d in dvs])


def second_delete_merges_dv(M, path):
    s = M.session(DV_ON)
    s.create_dataframe(_kv(2000)).write.mode("overwrite").delta(path)
    M.delta.delete_delta(s, path, M.F.col("v") < 100)
    M.delta.delete_delta(s, path, M.F.col("v") >= 1900)
    adds = M.delta.DeltaTable(path).snapshot_adds()
    return s, sum(a["deletionVector"]["cardinality"] for a in adds
                  if a.get("deletionVector"))


def delete_all_rows(M, path):
    s = M.session(DV_ON)
    s.create_dataframe(_kv(500)).write.mode("overwrite").delta(path)
    return s, M.delta.delete_delta(s, path, M.F.col("v") >= 0)


def update_after_dv(M, path):
    s = M.session(DV_ON)
    s.create_dataframe(_kv(800)).write.mode("overwrite").delta(path)
    M.delta.delete_delta(s, path, M.F.col("v") < 400)
    M.delta.update_delta(s, path, M.F.col("v") >= 700, {"k": 99})
    M.delta.update_delta(s, path, M.F.col("v") < 450, {"k": 7})
    types_ = {str(pq.read_schema(os.path.join(path, a["path"]))
                  .field("k").type)
              for a in M.delta.DeltaTable(path).snapshot_adds()}
    return s, types_


def dv_survives_checkpoint(M, path):
    s = M.session(DV_ON)
    s.create_dataframe(_kv(400)).write.mode("overwrite").delta(path)
    M.delta.delete_delta(s, path, M.F.col("v") < 50)
    for i in range(M.delta.CHECKPOINT_INTERVAL + 1):
        s.create_dataframe({"k": pa.array([0]),
                            "v": pa.array([10_000 + i])}) \
            .write.mode("append").delta(path)
    return s, M.delta.DeltaTable(path)._last_checkpoint_version()


def writer_modes(M, path):
    s = M.session()
    df = s.create_dataframe({"a": pa.array([1, 2])})
    df.write.delta(path)
    with pytest.raises(FileExistsError):
        df.write.delta(path)
    ignored = df.write.mode("ignore").delta(path)
    df.write.mode("append").delta(path)
    df.write.mode("overwrite").delta(path)
    return s, ignored


SCENARIOS = [append_and_time_travel, overwrite, delete_copy_on_write,
             update, merge_upsert, merge_delete_matched,
             merge_assignments_and_duplicates, checkpoint,
             optimize_with_dv_survivors, optimize_zorder, auto_compact,
             dv_delete_keeps_data_file, second_delete_merges_dv,
             delete_all_rows, update_after_dv, dv_survives_checkpoint,
             writer_modes]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__ for f in SCENARIOS])
def test_every_version_equals_jax(tmp_path, scenario):
    got = {}
    for M in (JAX, PORT):
        path = str(tmp_path / M.name)
        s, extra = scenario(M, path)
        got[M.name] = (versions(M, s, path,
                                ordered=scenario is optimize_zorder),
                       extra)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert len(got["port"][0]) >= 2


def test_zorder_clusters_rows(tmp_path):
    s = PORT.session()
    path = str(tmp_path / "t")
    optimize_zorder(PORT, path)
    at = s.read.delta(path).to_arrow()
    d = (np.abs(np.diff(np.asarray(at.column("x"))))
         + np.abs(np.diff(np.asarray(at.column("y")))))
    assert d.mean() < 300, d.mean()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dv_payloads_byte_equal_jax(seed):
    rng = np.random.default_rng(seed)
    parts = [rng.choice(70_000, 3000, replace=False),       # array boxes
             np.arange(5000, 12000),                         # a bitmap box
             (1 << 32) + rng.choice(10 ** 6, 500, replace=False),
             [(5 << 32) + 7, 0, 65535, 65536]]
    positions = [int(x) for p in parts for x in p]
    payload = pdv.serialize_dv(positions)
    assert payload == jdv.serialize_dv(positions)
    want = sorted(set(positions))
    assert pdv.deserialize_dv(payload) == want
    assert jdv.deserialize_dv(payload) == want


def test_dv_files_and_descriptors_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    dead = [int(x) for x in rng.choice(100_000, 9000, replace=False)]
    jd = jdv.write_dv_file(str(tmp_path / "j.bin"), dead)
    pd_ = pdv.write_dv_file(str(tmp_path / "p.bin"), dead)
    assert pd_ == jd
    assert open(tmp_path / "p.bin", "rb").read() == \
        open(tmp_path / "j.bin", "rb").read()
    assert pdv.read_dv_file(str(tmp_path / "j.bin")) == sorted(dead)
    desc = {"pathOrInlineDv": str(tmp_path / "p.bin"), "offset": 1,
            "sizeInBytes": pd_["sizeInBytes"]}
    assert pdv.load_dv_positions(str(tmp_path), desc) == sorted(dead)
    # the DV file a DELETE writes equals the JAX package's byte for byte
    outs = {}
    for M in (JAX, PORT):
        path = str(tmp_path / M.name)
        s = M.session(DV_ON)
        s.create_dataframe(_kv(3000, seed=4)).write.delta(path)
        M.delta.delete_delta(s, path, M.F.col("k") < 20)
        dv = [a["deletionVector"] for a in
              M.delta.DeltaTable(path).snapshot_adds()][0]
        outs[M.name] = open(dv["pathOrInlineDv"], "rb").read()
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_table_reads_in_the_other_package(tmp_path, writer):
    """One package writes (appends, a DV delete, an update, a merge, an
    OPTIMIZE, past a checkpoint), the other reads every version."""
    W, R = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    path = str(tmp_path / "t")
    s = W.session(DV_ON)
    s.create_dataframe(_kv(1000, seed=9)).write_delta(path)
    s.create_dataframe(_kv(300, seed=10)).write_delta(path)
    W.delta.delete_delta(s, path, W.F.col("k") < 10)
    W.delta.update_delta(s, path, W.F.col("k") == 30, {"v": -1})
    W.delta.merge_delta(s, path, s.create_dataframe(
        {"k": pa.array([30, 77], pa.int64()),
         "v": pa.array([5, 6], pa.int64())}).group_by("k").agg(
        W.F.max("v").alias("v")), on=["k"])
    for i in range(W.delta.CHECKPOINT_INTERVAL - 4):
        s.create_dataframe({"k": pa.array([i]),
                            "v": pa.array([i])}).write_delta(path)
    W.delta.optimize_delta(s, path, zorder_by=["k"])
    assert W.delta.DeltaTable(path)._last_checkpoint_version() == 10
    assert versions(R, R.session(), path) == versions(W, s, path)
    assert R.delta.DeltaTable(path).history() == \
        W.delta.DeltaTable(path).history()


def test_parquet_scan_given_a_dv_directly(tmp_path):
    """A ParquetScan carrying `dv` ({path: (root, descriptor)}): the
    dead rows drop in every reader, row-group pruning is skipped under
    the DV, and `prune` forwards the DV to the narrowed scan."""
    n = 5000
    data = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                     "v": pa.array(np.arange(n, dtype=np.int64) % 97)})
    f = str(tmp_path / "f.parquet")
    pq.write_table(data, f, row_group_size=700)
    dead = [int(x) for x in np.random.default_rng(3).choice(n, 900,
                                                            replace=False)]
    desc = pdv.write_dv_file(str(tmp_path / "dv.bin"), dead)
    desc = {"storageType": "p", "pathOrInlineDv": str(tmp_path / "dv.bin"),
            **desc}
    dv = {f: (str(tmp_path), desc)}
    live = [k for k in range(n) if k not in set(dead)]
    for reader in ("PERFILE", "MULTITHREADED", "COALESCING"):
        conf = {"spark.rapids.tpu.sql.batchSizeRows": 512,
                "spark.rapids.tpu.sql.format.parquet.reader.type": reader}
        js, ps = st.TpuSession(dict(conf)), pt.TpuSession(dict(conf),
                                                         device="cpu")
        jdf = JDataFrame(js, JL.ParquetScan([f], dv=dv))
        pdf = PDataFrame(ps, PL.ParquetScan([f], dv=dv))
        for q in (lambda d, F: d,
                  lambda d, F: d.filter(F.col("k") >= 4000).select("k"),
                  lambda d, F: d.select("v").group_by("v").agg(
                      F.count("v").alias("c")).sort("v")):
            j = q(jdf, JF).to_arrow()
            p = q(pdf, PF).to_arrow()
            assert p.equals(j), reader
        assert pdf.to_arrow().column("k").to_pylist() == live
        got = pdf.filter(PF.col("k") >= 4000).select("k").to_arrow()
        assert got.column("k").to_pylist() == [k for k in live
                                                if k >= 4000]
    from spark_rapids_tpu_torch.plan.optimizer import prune
    narrowed = prune(pdf.select("k")._plan, None).children[0]
    assert narrowed.columns == ["k"] and narrowed.dv == dv
