"""The device Parquet decode on the card, against the port on the CPU.

Every test here needs a CUDA device and skips without one. The module
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -q tests/test_torch_parquet_cuda.py

Files written by pyarrow from a seed go through a CUDA session at the
default conf (device decode on) and a CPU session with the conf set;
the Arrow tables and the device-decode counts must be equal (exact:
integers, bytes, and floats carried bit for bit). Covered: plain,
snappy, dictionary and v2 pages with nulls, Spark's integer decimals,
a dictionary that overflows mid-chunk, device snappy, and the pinned
staging pool (its buffers page-locked, hit across files).
"""
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.memory.host import staging_pool
from spark_rapids_tpu_torch.workloads import tpch

DECODE = "spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled"
BASE = {"spark.rapids.tpu.sql.batchSizeRows": 8192}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode runs on the card)")
    return torch.device("cuda")


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
    })


def _counts(df):
    out = {}
    for ms in df.last_metrics().values():
        for k, v in ms.items():
            if k.startswith("deviceDecode") and not k.endswith("Bytes"):
                out[k] = out.get(k, 0) + v
    return out


def _card_equals_cpu(cuda, path, conf=None):
    conf = dict(BASE, **(conf or {}))
    gdf = pt.TpuSession(dict(conf), device=cuda).read.parquet(path)
    cdf = pt.TpuSession(dict(conf, **{DECODE: True}),
                        device="cpu").read.parquet(path)
    got, want = gdf.to_arrow(), cdf.to_arrow()
    assert got.equals(want), [c for c in want.column_names
                              if not got.column(c).equals(want.column(c))]
    assert _counts(gdf) == _counts(cdf)
    return _counts(gdf)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [
    dict(compression="NONE", use_dictionary=False),
    dict(compression="snappy"),
    dict(compression="snappy", store_decimal_as_integer=True),
    dict(compression="snappy", data_page_version="2.0",
         data_page_size=4096, row_group_size=6000),
    dict(compression="snappy", store_decimal_as_integer=True,
         dictionary_pagesize_limit=8192),
], ids=["plain", "snappy", "spark_ints", "v2_pages", "dict_overflow"])
def test_card_decode_equals_cpu(cuda, tmp_path, layout):
    p = str(tmp_path / "t.parquet")
    pq.write_table(_table(20000, seed=3), p, **layout)
    counts = _card_equals_cpu(cuda, p)
    assert counts["deviceDecodedChunks"] > 0


@pytest.mark.cuda
def test_card_device_snappy(cuda, tmp_path):
    rng = np.random.default_rng(5)
    n = 30000
    schema = pa.schema([pa.field("i64", pa.int64(), nullable=False),
                        pa.field("f64", pa.float64(), nullable=False)])
    t = pa.table({"i64": rng.integers(0, 50, n).astype(np.int64),
                  "f64": np.repeat(rng.standard_normal(300), 100)},
                 schema=schema)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, compression="snappy", use_dictionary=False)
    counts = _card_equals_cpu(cuda, p,
                              {"spark.rapids.tpu.sql.parquet.deviceSnappy":
                               True})
    assert counts == {"deviceDecodedChunks": 2}


@pytest.mark.cuda
def test_card_tpch_q6_q1_and_pinned_pool(cuda, tmp_path):
    li = tpch.gen_lineitem(0.02, seed=7, full=True)
    per = -(-li.num_rows // 4)
    for i in range(4):
        pq.write_table(li.slice(i * per, per),
                       str(tmp_path / f"part-{i}.parquet"),
                       row_group_size=10000, store_decimal_as_integer=True,
                       compression="snappy")
    conf = dict(BASE, **{"spark.rapids.tpu.sql.format.parquet.reader.type":
                         "MULTITHREADED"})
    gs = pt.TpuSession(dict(conf), device=cuda)
    cs = pt.TpuSession(dict(conf), device="cpu")
    q6 = tpch.q6(gs.read.parquet(str(tmp_path)))
    assert q6.to_arrow().equals(
        tpch.q6(cs.read.parquet(str(tmp_path))).to_arrow())
    q1 = tpch.q1(gs.read.parquet(str(tmp_path))).sort("l_returnflag",
                                                       "l_linestatus")
    assert q1.to_arrow().equals(tpch.q1(cs.read.parquet(
        str(tmp_path))).sort("l_returnflag", "l_linestatus").to_arrow())
    assert _counts(q1)["deviceDecodedChunks"] > 0
    pool = staging_pool(gs.conf, pinned=True)
    assert pool.pinned and pool.metrics["stagingPoolHits"] > 0
    lease = pool.acquire(1000)
    assert lease.tensor.is_pinned()
    lease.release()
