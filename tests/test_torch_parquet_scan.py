"""`read.parquet` with device decode: a CPU port session with
`sql.format.parquet.deviceDecode.enabled` set explicitly against a JAX
package session with it set.

Every case requires equal Arrow output and equal `deviceDecodedChunks`
and `deviceDecodeFallback.*` counts: mixed eligible and fallback columns
(gzip, an FLBA decimal, a decimal128, a non-microsecond timestamp,
booleans), Spark's integer decimals, the MULTITHREADED, PERFILE and
COALESCING readers, row-group pruning, a limit that abandons the
prefetch thread, and the local file cache. An unset conf on a CPU
session keeps the host path.
"""
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.exec.nodes import ParquetScanExec

DECODE = "spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled"
READER = "spark.rapids.tpu.sql.format.parquet.reader.type"
BASE = {"spark.rapids.tpu.sql.batchSizeRows": 2048}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.15
    words = np.asarray(["", "MAIL", "SHIP", "TRUCK", "x" * 25], object)
    dec = [None if m else decimal.Decimal(int(v)).scaleb(-2)
           for v, m in zip(rng.integers(-10**9, 10**9, n), mask)]
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "i32": pa.array(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                        mask=mask),
        "i16": pa.array(rng.integers(-300, 300, n).astype(np.int16)),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32),
                        mask=mask),
        "f64": pa.array(rng.standard_normal(n)),
        "s": pa.array(words[rng.integers(0, len(words), n)],
                      type=pa.string(), mask=mask),
        "sp": pa.array([f"r{v}-" * int(v % 4)
                        for v in rng.integers(0, 10**6, n)]),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32))
        .cast(pa.date32()),
        "dec": pa.array(dec, type=pa.decimal128(12, 2)),
        "dec9": pa.array([None if v is None else v / 10 for v in dec],
                         type=pa.decimal128(9, 3)),
        "dec128": pa.array(dec, type=pa.decimal128(30, 2)),
        "ts": pa.array(rng.integers(0, 10**12, n), type=pa.timestamp("ms")),
        "tsu": pa.array(rng.integers(0, 10**15, n),
                        type=pa.timestamp("us")),
        "b": pa.array(rng.random(n) < 0.5, mask=mask),
    })


def _decode_metrics(df):
    out = {}
    for ms in df.last_metrics().values():
        for k, v in ms.items():
            if k.startswith("deviceDecode") and not k.endswith("Bytes"):
                out[k] = out.get(k, 0) + v
    return out


def _both(paths, conf, make=lambda df: df, columns=None):
    js = st.TpuSession(dict(conf))
    ps = pt.TpuSession(dict(conf), device="cpu")
    jdf = make(js.read.parquet(*paths, columns=columns))
    pdf = make(ps.read.parquet(*paths, columns=columns))
    ja, pa_ = jdf.to_arrow(), pdf.to_arrow()
    assert pa_.equals(ja), [c for c in ja.column_names
                            if not pa_.column(c).equals(ja.column(c))]
    return _decode_metrics(jdf), _decode_metrics(pdf), pdf


@pytest.mark.parametrize("layout", [
    dict(compression="NONE", use_dictionary=False),
    dict(compression="snappy"),
    dict(compression="snappy", store_decimal_as_integer=True),
    dict(compression="snappy", data_page_version="2.0",
         data_page_size=2048, row_group_size=1500),
    dict(compression={"k": "gzip", "i32": "gzip", "s": "zstd"},
         use_dictionary=["s", "i16", "d"]),
], ids=["plain", "snappy", "spark_ints", "v2_pages", "gzip_zstd"])
def test_mixed_and_fallback_columns(tmp_path, layout):
    t = _table(5000, seed=len(str(layout)))
    if isinstance(layout["compression"], dict):
        layout = dict(layout, compression={
            c: layout["compression"].get(c, "snappy")
            for c in t.column_names})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, **layout)
    jm, pm, _ = _both([p], dict(BASE, **{DECODE: True}))
    assert pm == jm
    assert pm["deviceDecodedChunks"] > 0
    assert pm["deviceDecodeFallback.type"] > 0     # FLBA, decimal128, ms


@pytest.mark.parametrize("reader", ["MULTITHREADED", "PERFILE",
                                    "COALESCING"])
def test_reader_types(tmp_path, reader):
    t = _table(6000, seed=4)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"part-{i}.parquet")
        pq.write_table(t.slice(i * 1500, 1500), p, row_group_size=700,
                       store_decimal_as_integer=True)
        paths.append(p)
    conf = dict(BASE, **{DECODE: True, READER: reader})
    jm, pm, pdf = _both(paths, conf, columns=["k", "s", "dec", "f64"])
    assert pm == jm
    if reader == "COALESCING":       # always the host path, as in JAX
        assert pm == {}
    else:
        assert pm == {"deviceDecodedChunks": 4 * 3 * 4}
    mets = pdf.last_metrics()
    waits = sum(m.get("prefetchWaitSecs", 0) > 0 for m in mets.values())
    assert waits == (reader != "COALESCING")


def test_row_group_pruning(tmp_path):
    from spark_rapids_tpu_torch.functions import col, lit
    import spark_rapids_tpu.functions as JF
    t = _table(8000, seed=8)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, row_group_size=1000, compression="snappy")
    conf = dict(BASE, **{DECODE: True})
    js = st.TpuSession(dict(conf))
    ps = pt.TpuSession(dict(conf), device="cpu")
    jdf = js.read.parquet(p).filter(JF.col("k") >= JF.lit(5500))
    pdf = ps.read.parquet(p).filter(col("k") >= lit(5500))
    assert pdf.to_arrow().equals(jdf.to_arrow())
    assert _decode_metrics(pdf) == _decode_metrics(jdf)
    skipped = sum(m.get("skippedRowGroups", 0)
                  for m in pdf.last_metrics().values())
    assert skipped == 5
    assert pdf.to_arrow().num_rows == 2500


def test_limit_abandons_the_prefetch(tmp_path):
    """A limit stops reading after its rows: the port's prefetch thread
    ends with the scan. (The JAX package's side reads the whole file:
    its own abandoned prefetch thread outlives the query.)"""
    import threading
    t = _table(8000, seed=2)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, row_group_size=500)
    conf = dict(BASE, **{DECODE: True})
    ps = pt.TpuSession(dict(conf), device="cpu")
    js = st.TpuSession(dict(conf))
    got = ps.read.parquet(p).limit(700).to_arrow()
    assert got.equals(js.read.parquet(p).to_arrow().slice(0, 700))
    assert not [th for th in threading.enumerate()
                if th.name == "srtpu-prefetch"]


def test_file_cache_serves_the_device_decode(tmp_path):
    """filecache.enabled: the scan reads a local copy (a miss, then a
    hit on the next action), with the same result and counts."""
    from spark_rapids_tpu_torch.io.file_cache import file_cache
    t = _table(3000, seed=9)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, row_group_size=1000)
    cache = tmp_path / "cache"
    conf = dict(BASE, **{DECODE: True,
                         "spark.rapids.tpu.filecache.enabled": True,
                         "spark.rapids.tpu.filecache.dir": str(cache)})
    ps = pt.TpuSession(dict(conf), device="cpu")
    want = st.TpuSession(dict(BASE, **{DECODE: True})).read.parquet(p)
    want_at = want.to_arrow()
    for _ in range(2):
        got = ps.read.parquet(p)
        assert got.to_arrow().equals(want_at)
        assert _decode_metrics(got) == _decode_metrics(want)
    m = file_cache(ps.conf).metrics
    assert m["misses"] >= 1 and m["hits"] >= 1
    assert [f.suffix for f in cache.iterdir()] == [".parquet"]


def test_unset_conf_on_the_cpu_keeps_the_host_path(tmp_path):
    t = _table(3000, seed=6)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p)
    jm, pm, pdf = _both([p], dict(BASE))
    assert pm == jm == {}
    root, ctx = pdf.physical_plan()
    while root.children:
        root = root.children[0]
    assert isinstance(root, ParquetScanExec)
    assert not root._device_decode_on(ctx)
    on = pt.TpuSession(dict(BASE, **{DECODE: True}), device="cpu")
    off = pt.TpuSession(dict(BASE, **{DECODE: False}), device="cpu")
    assert root._device_decode_on(
        type(ctx)(on.conf, torch.device("cpu")))
    assert not root._device_decode_on(
        type(ctx)(off.conf, torch.device("cpu")))
    # on a CUDA session the default conf decodes on the device
    assert root._device_decode_on(
        type(ctx)(pt.TpuSession(dict(BASE), device="cpu").conf,
                  torch.device("cuda")))
