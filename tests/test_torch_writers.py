"""The port's file writers against the JAX package's: `DataFrame.write`
in every format and mode, `partitionBy`, the empty result, the async
write queue, and `write_parquet`. The same Arrow input, made from a seed,
goes through both packages, each writing into its own directory; the
outputs must be equal: text files byte for byte, Parquet and ORC files as
Arrow tables, file for file."""
import datetime
import os
import re
import threading
import time
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu.expr.expressions import col as jcol
from spark_rapids_tpu_torch.expr.expressions import col as pcol
from spark_rapids_tpu_torch.io.async_io import (AsyncWriteQueue,
                                                TrafficController,
                                                async_stats)
from spark_rapids_tpu_torch.io.writer import _split_by_keys

# the part files' names carry a per-job id (append-safe); it differs
# between the two packages' runs
_JOB = re.compile(r"-[0-9a-f]{8}\.")


def _data(n=600, seed=7):
    rng = np.random.default_rng(seed)
    i32 = rng.integers(0, 4, n).astype(np.int32)
    strs = np.array(["a/b", "x y", "k=v", "plain"])[rng.integers(0, 4, n)]
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "p_int": pa.array(i32, mask=rng.random(n) < 0.1),
        "p_str": pa.array(strs.tolist(), mask=rng.random(n) < 0.1),
        "v": pa.array(np.round(rng.normal(0, 100, n), 3)),
        "dec": pa.array([Decimal(int(x)).scaleb(-2) for x in
                         rng.integers(-10 ** 6, 10 ** 6, n)],
                        pa.decimal128(12, 2)),
        "d": pa.array([datetime.date(1995, 1, 1)
                       + datetime.timedelta(days=int(x))
                       for x in rng.integers(0, 2000, n)]),
        "s": pa.array([f"r{x}" if x % 9 else None
                       for x in rng.integers(0, 100, n)]),
    })


def _sessions(conf=None):
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 256, **(conf or {})}
    return st.TpuSession(dict(conf)), pt.TpuSession(dict(conf),
                                                   device="cpu")


def _files(root):
    """{relative path with the job id removed: absolute path} of the
    data files under `root`."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for nm in names:
            if nm == "_SUCCESS":
                continue
            rel = _JOB.sub(".", os.path.relpath(os.path.join(d, nm), root))
            assert rel not in out, rel
            out[rel] = os.path.join(d, nm)
    return out


def _read(path, ext):
    if ext == "parquet":
        return pq.read_table(path)
    if ext == "orc":
        return orc.read_table(path)
    with open(path, "rb") as f:
        return f.read()


def _assert_same_output(jroot, proot, ext):
    jf, pf = _files(jroot), _files(proot)
    assert sorted(jf) == sorted(pf)
    assert jf, "no files written"
    for rel in jf:
        a, b = _read(jf[rel], ext), _read(pf[rel], ext)
        if isinstance(a, bytes):
            assert a == b, rel
        else:
            assert a.equals(b), rel
    assert os.path.exists(os.path.join(proot, "_SUCCESS"))


def _write(df, fmt, path, mode="overwrite", partition_by=()):
    w = df.write.mode(mode)
    if partition_by:
        w = w.partitionBy(*partition_by)
    return getattr(w, fmt)(path)


_EXT = {"parquet": "parquet", "orc": "orc", "csv": "csv", "json": "json",
        "hive_text": "txt"}


@pytest.mark.parametrize("fmt", sorted(_EXT))
@pytest.mark.parametrize("keys", [(), ("p_int",), ("p_str", "p_int")],
                         ids=["flat", "int32", "string_int32"])
def test_every_format_equals_jax(tmp_path, fmt, keys):
    data = _data()
    js, ps = _sessions()
    jstats = _write(js.create_dataframe(data), fmt, str(tmp_path / "j"),
                    partition_by=keys)
    pstats = _write(ps.create_dataframe(data), fmt, str(tmp_path / "p"),
                    partition_by=keys)
    _assert_same_output(str(tmp_path / "j"), str(tmp_path / "p"),
                        _EXT[fmt])
    assert (pstats.num_files, pstats.num_rows, pstats.num_bytes,
            pstats.partitions) == (jstats.num_files, jstats.num_rows,
                                   jstats.num_bytes, jstats.partitions)
    if keys:
        # quoting: '/', ' ' and '=' escaped, a null the Hive default
        joined = "|".join(pstats.partitions)
        assert "__HIVE_DEFAULT_PARTITION__" in joined
        if "p_str" in keys:
            assert "p_str=a%2Fb" in joined and "p_str=x%20y" in joined \
                and "p_str=k%3Dv" in joined


def _column_a(path, fmt):
    """The values of column `a` in every part file under `path`."""
    import json as _json
    out = []
    for f in os.listdir(path):
        full = os.path.join(path, f)
        if f == "_SUCCESS":
            continue
        if fmt in ("parquet", "orc"):
            out += _read(full, fmt).column("a").to_pylist()
        else:
            lines = open(full).read().splitlines()
            if fmt == "csv":
                out += [int(x) for x in lines[1:]]
            elif fmt == "json":
                out += [_json.loads(x)["a"] for x in lines]
            else:
                out += [int(x) for x in lines]
    return sorted(out)


@pytest.mark.parametrize("fmt", sorted(_EXT))
@pytest.mark.parametrize("mode", ["overwrite", "append", "errorifexists",
                                  "ignore"])
def test_modes_equal_jax(tmp_path, mode, fmt):
    first = pa.table({"a": pa.array([1, 2, 3], pa.int64())})
    second = pa.table({"a": pa.array([7, 8], pa.int64())})
    outcome = {}
    for name, s in zip(("j", "p"), _sessions()):
        path = str(tmp_path / name)
        _write(s.create_dataframe(first), fmt, path)
        try:
            stats = _write(s.create_dataframe(second), fmt, path, mode)
            got = (stats.num_files, stats.num_rows)
        except FileExistsError:
            got = "FileExistsError"
        outcome[name] = (got, _column_a(path, fmt))
    assert outcome["p"] == outcome["j"]
    want_rows = {"overwrite": [7, 8], "append": [1, 2, 3, 7, 8],
                 "errorifexists": [1, 2, 3], "ignore": [1, 2, 3]}[mode]
    assert outcome["p"][1] == want_rows


@pytest.mark.parametrize("keys", [(), ("p_int",)], ids=["flat", "int32"])
@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_empty_result_writes_the_schema(tmp_path, keys, fmt):
    data = _data(100)
    js, ps = _sessions()
    _write(js.create_dataframe(data).filter(jcol("id") < 0), fmt,
           str(tmp_path / "j"), partition_by=keys)
    pstats = _write(ps.create_dataframe(data).filter(pcol("id") < 0), fmt,
                    str(tmp_path / "p"), partition_by=keys)
    assert (pstats.num_files, pstats.num_rows) == (1, 0)
    _assert_same_output(str(tmp_path / "j"), str(tmp_path / "p"),
                        _EXT[fmt])


@pytest.mark.parametrize("keys", [(), ("p_str",)], ids=["flat", "string"])
def test_async_on_and_off_write_equal_files(tmp_path, keys):
    data = _data(2000, seed=11)
    stats = {}
    for on in (True, False):
        s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 300,
                           "spark.rapids.tpu.sql.asyncWrite.enabled": on},
                          device="cpu")
        stats[on] = _write(s.create_dataframe(data), "parquet",
                           str(tmp_path / str(on)), partition_by=keys)
    on, off = _files(str(tmp_path / "True")), _files(str(tmp_path / "False"))
    assert sorted(on) == sorted(off) and len(on) >= 7
    for rel in on:
        assert open(on[rel], "rb").read() == open(off[rel], "rb").read()
    assert vars(stats[True]) == vars(stats[False])
    s = pt.TpuSession({}, device="cpu")
    assert async_stats(s.conf)["inFlightBytes"] == 0


@pytest.mark.parametrize("kw", [
    {}, {"compression": "zstd", "row_group_rows": 50},
    {"mode": "errorifexists"}, {"compression": "none",
                                "row_group_rows": 128}],
    ids=["defaults", "zstd_rg50", "errorifexists", "none_rg128"])
def test_write_parquet_equals_jax(tmp_path, kw):
    data = _data(900, seed=3)
    js, ps = _sessions()
    outs = {}
    for name, s in (("j", js), ("p", ps)):
        path = str(tmp_path / name)
        s.create_dataframe(data).write_parquet(path, **kw)
        files = sorted(f for f in os.listdir(path) if f != "_SUCCESS")
        metas = []
        for f in files:
            md = pq.ParquetFile(os.path.join(path, f)).metadata
            metas.append((f, md.num_rows, md.num_row_groups,
                          md.row_group(0).column(0).compression))
        outs[name] = (metas, [pq.read_table(os.path.join(path, f))
                              for f in files])
        assert os.path.exists(os.path.join(path, "_SUCCESS"))
    assert outs["p"][0] == outs["j"][0]
    assert len(outs["p"][0]) == 4          # 900 rows in 256-row partitions
    for a, b in zip(outs["j"][1], outs["p"][1]):
        assert a.equals(b)
    if kw.get("mode") == "errorifexists":
        with pytest.raises(FileExistsError):
            ps.create_dataframe(data).write_parquet(str(tmp_path / "p"),
                                                    **kw)


def test_write_parquet_of_an_empty_result(tmp_path):
    js, ps = _sessions()
    data = _data(50)
    for name, s, c in (("j", js, jcol), ("p", ps, pcol)):
        s.create_dataframe(data).filter(c("id") < 0).write_parquet(
            str(tmp_path / name))
    a = pq.read_table(str(tmp_path / "j" / "part-00000.parquet"))
    b = pq.read_table(str(tmp_path / "p" / "part-00000.parquet"))
    assert b.num_rows == 0 and a.equals(b)


def test_split_by_keys_matches_the_row_loop():
    """The column-wise split: groups in first-appearance order, each
    group's rows in table order, as the JAX writer's dict of rows."""
    rng = np.random.default_rng(5)
    n = 3000
    at = pa.table({
        "a": pa.array(rng.integers(0, 5, n).astype(np.int32),
                      mask=rng.random(n) < 0.2),
        "b": pa.array(np.array(["x", "y", "z/w"])[rng.integers(0, 3, n)]
                      .tolist(), mask=rng.random(n) < 0.2),
        "c": pa.array(rng.integers(0, 3, n))})
    for keys in (["a"], ["b"], ["a", "b"], ["b", "c", "a"]):
        want = {}
        for i, tup in enumerate(zip(*[at.column(k).to_pylist()
                                      for k in keys])):
            want.setdefault(tup, []).append(i)
        got = _split_by_keys(at, keys)
        assert [g[0] for g in got] == list(want)
        assert [list(g[1]) for g in got] == list(want.values())


# ---- the TrafficController and AsyncWriteQueue (tests/test_async_write.py)
def test_traffic_controller_bounds_in_flight_bytes():
    tc = TrafficController(100)
    q = AsyncWriteQueue(tc, num_threads=4)
    peak = [0]
    lock = threading.Lock()

    def slow_write():
        with lock:
            peak[0] = max(peak[0], tc.in_flight_bytes)
        time.sleep(0.05)

    for _ in range(12):
        q.submit(40, slow_write)
    q.close()
    # 3 * 40 > 100: at most two 40-byte tasks admitted together
    assert peak[0] <= 80, peak[0]
    assert tc.in_flight_bytes == 0
    assert tc.throttle_wait_seconds > 0


def test_oversized_task_always_admitted():
    tc = TrafficController(10)
    q = AsyncWriteQueue(tc, num_threads=2)
    done = []
    q.submit(1000, lambda: done.append(1))
    q.close()
    assert done == [1]


def test_error_propagates_on_drain():
    tc = TrafficController(1 << 20)
    q = AsyncWriteQueue(tc, num_threads=2)

    def boom():
        raise ValueError("disk on fire")

    q.submit(10, boom)
    with pytest.raises(RuntimeError, match="disk on fire"):
        q.drain()
    assert tc.in_flight_bytes == 0


def test_async_partitioned_write(tmp_path):
    s = pt.TpuSession(device="cpu")
    df = s.create_dataframe({"p": pa.array([1, 1, 2, 2, 3]),
                             "v": pa.array([10.0, 11.0, 20.0, 21.0, 30.0])})
    stats = df.write.mode("overwrite").partitionBy("p").parquet(
        str(tmp_path / "part"))
    assert sorted(stats.partitions) == ["p=1", "p=2", "p=3"]
    assert pq.read_table(str(tmp_path / "part")).num_rows == 5


@pytest.mark.parametrize("on", [True, False])
def test_a_failed_part_fails_the_job(tmp_path, monkeypatch, on):
    calls = [0]
    orig = pq.write_table

    def flaky(tbl, fname, **kw):
        calls[0] += 1
        if calls[0] >= 2:
            raise OSError("disk full")
        return orig(tbl, fname, **kw)

    monkeypatch.setattr(pq, "write_table", flaky)
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 2,
                       "spark.rapids.tpu.sql.asyncWrite.enabled": on},
                      device="cpu")
    df = s.create_dataframe({"v": pa.array(list(range(10)))})
    with pytest.raises(Exception, match="disk full"):
        df.write.mode("overwrite").parquet(str(tmp_path / "o"))


def test_an_unwinding_error_is_not_replaced(tmp_path, monkeypatch):
    """A plan that fails while a part's async write has failed too: the
    plan's own error reaches the caller, not the deferred write's."""
    s = pt.TpuSession(device="cpu")
    df = s.create_dataframe({"v": pa.array(list(range(10)))})

    def parts():
        yield pa.table({"v": pa.array([1, 2])})
        time.sleep(0.2)            # the failed write lands first
        raise ValueError("the plan failed")

    monkeypatch.setattr(type(df), "_iter_partition_tables",
                        lambda self: parts())

    def broken(tbl, fname, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(pq, "write_table", broken)
    with pytest.raises(ValueError, match="the plan failed"):
        df.write.mode("overwrite").parquet(str(tmp_path / "o"))
