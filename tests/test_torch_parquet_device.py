"""The port's device Parquet decode (`io/parquet_device.py`,
`io/parquet_thrift.py`, `memory/host.py`, on the CPU) against the JAX
package's, chunk by chunk.

Files written by pyarrow from seeded numpy data go through both
packages' page-header parser, run parser, chunk plan and chunk decode.
Every comparison is exact: page metadata field by field, and for each
chunk the decision (decoded or None), the values (bit for bit), the
validity, the string offsets and bytes. The fuzz matrix is the JAX
package's (`tests/test_parquet_device2.py`): codec x page version x
dictionary x nulls over INT32 / INT64 / FLOAT / DOUBLE / BYTE_ARRAY,
with several pages and row groups; then the staging pool's cases.
"""
import dataclasses

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.column import bucket_capacity
from spark_rapids_tpu.io import parquet_device as jdev
from spark_rapids_tpu.io import parquet_thrift as jthrift
from spark_rapids_tpu_torch.io import parquet_device as pdev
from spark_rapids_tpu_torch.io import parquet_thrift as pthrift
from spark_rapids_tpu_torch.memory.host import (HostMemoryManager,
                                                PinnedStagingPool)

CPU = torch.device("cpu")


def _table(n, seed, with_nulls, dict_friendly):
    rng = np.random.default_rng(seed)
    mask = (rng.random(n) < 0.2) if with_nulls else None
    if dict_friendly:
        i32 = rng.integers(-5, 40, n).astype(np.int32)
        i64 = rng.integers(0, 12, n).astype(np.int64) * 31
        f32 = rng.choice(np.asarray([0.5, -1.0, 3.25], np.float32), n)
        f64 = rng.choice(np.asarray([0.0, -1.5, 2.25, 1e9]), n)
        words = np.asarray(["", "a", "bb", "ccc", "x" * 17, "snap", "py"],
                           dtype=object)
        s = words[rng.integers(0, len(words), n)]
    else:
        i32 = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
        i64 = rng.integers(-2**62, 2**62, n).astype(np.int64)
        f32 = rng.standard_normal(n).astype(np.float32)
        f64 = rng.standard_normal(n)
        lens = rng.integers(0, 23, n)       # includes empty strings
        alphabet = np.frombuffer(b"abcdefghijklmnop0123", np.uint8)
        s = np.asarray(["".join(chr(c) for c in rng.choice(alphabet, ln))
                        for ln in lens], dtype=object)
    return pa.table({
        "i32": pa.array(i32, type=pa.int32(), mask=mask),
        "i64": pa.array(i64, type=pa.int64(), mask=mask),
        "f32": pa.array(f32, type=pa.float32(), mask=mask),
        "f64": pa.array(f64, type=pa.float64(), mask=mask),
        "s": pa.array(s, type=pa.string(), mask=mask),
    })


def _chunk_bytes(pf, p, rg, ci):
    col = pf.metadata.row_group(rg).column(ci)
    start = col.data_page_offset
    if col.has_dictionary_page and col.dictionary_page_offset is not None:
        start = min(start, col.dictionary_page_offset)
    with open(p, "rb") as f:
        f.seek(start)
        return col, f.read(col.total_compressed_size)


def _same_decode(jgot, pgot, nrows):
    assert (jgot is None) == (pgot is None)
    if jgot is None:
        return
    assert len(jgot) == len(pgot)
    valid = np.asarray(jgot[1])
    np.testing.assert_array_equal(pgot[1].numpy(), valid)
    if len(jgot) == 3:                           # strings
        joff = np.asarray(jgot[2])
        np.testing.assert_array_equal(pgot[2].numpy(), joff)
        used = int(joff[-1])
        np.testing.assert_array_equal(pgot[0].numpy()[:used],
                                      np.asarray(jgot[0])[:used])
        assert not pgot[0].numpy()[used:].any()
    else:
        jv = np.asarray(jgot[0])
        pv = pgot[0].numpy()
        assert pv.dtype == jv.dtype
        np.testing.assert_array_equal(pv.view(np.uint8), jv.view(np.uint8))


def _decode_both(p, columns, pool=None, device_snappy=False):
    """Every chunk of the file through both packages; returns the count
    of chunks each decoded."""
    pf = pq.ParquetFile(p)
    decoded = 0
    for rg in range(pf.metadata.num_row_groups):
        elig = jdev.eligible_chunks(pf, rg, columns)
        assert pdev.eligible_chunks(pf, rg, columns) == elig
        assert pdev.fallback_reasons(pf, rg, columns) \
            == jdev.fallback_reasons(pf, rg, columns)
        nrows = pf.metadata.row_group(rg).num_rows
        cap = bucket_capacity(nrows)
        for name, ci in elig.items():
            nullable = pf.schema_arrow.field(name).nullable
            jc = jdev.chunk_device_plan(pf, p, rg, ci, name, nullable,
                                        device_snappy=device_snappy)
            pc = pdev.chunk_device_plan(pf, p, rg, ci, name, nullable,
                                        pool=pool,
                                        device_snappy=device_snappy)
            assert (jc is None) == (pc is None)
            if jc is None:
                continue
            assert bytes(pc.raw) == bytes(jc.raw)
            assert [dataclasses.asdict(x) for x in pc.pages] \
                == [dataclasses.asdict(x) for x in jc.pages]
            assert len(pc.dev_pages) == len(jc.dev_pages)
            jgot = jdev.decode_chunk_device(jc, cap)
            pgot = pdev.decode_chunk_device(pc, cap, CPU)
            _same_decode(jgot, pgot, nrows)
            decoded += pgot is not None
            jc.close()
            pc.close(sync=True)
    return decoded


# ----------------------------------------------------------------------
# the thrift reader
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pagever", ["1.0", "2.0"])
@pytest.mark.parametrize("use_dict", [False, True])
def test_page_headers_and_runs_equal_the_jax_parser(tmp_path, pagever,
                                                    use_dict):
    t = _table(6000, seed=5, with_nulls=True, dict_friendly=use_dict)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, compression="NONE", use_dictionary=use_dict,
                   data_page_version=pagever, data_page_size=2048)
    pf = pq.ParquetFile(p)
    n_runs = 0
    for ci in range(pf.metadata.num_columns):
        col, raw = _chunk_bytes(pf, p, 0, ci)
        jp = jthrift.parse_page_headers(raw, col.num_values)
        pp = pthrift.parse_page_headers(raw, col.num_values)
        assert [dataclasses.asdict(x) for x in pp] \
            == [dataclasses.asdict(x) for x in jp]
        assert len(pp) >= 2
        for page in pp:
            if page.page_type == pthrift.DICTIONARY_PAGE:
                continue
            end = page.data_offset + page.compressed_size
            for bw in (1, 3):
                jr = jthrift.parse_hybrid_runs(raw, page.data_offset, end,
                                               page.num_values, bw)
                pr = pthrift.parse_hybrid_runs(raw, page.data_offset, end,
                                               page.num_values, bw)
                assert [dataclasses.asdict(x) for x in pr] \
                    == [dataclasses.asdict(x) for x in jr]
                n_runs += len(pr)
    assert n_runs > 0


def test_malformed_header_raises_thrift_error():
    with pytest.raises(pthrift.ThriftError):
        pthrift.parse_page_headers(b"\x15", 10)
    with pytest.raises(pthrift.ThriftError):
        pdev._parse_snappy_elements(b"\x05\x00", 0, 2)


# ----------------------------------------------------------------------
# decode_chunk_device: the fuzz matrix
# ----------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["NONE", "snappy"])
@pytest.mark.parametrize("pagever", ["1.0", "2.0"])
@pytest.mark.parametrize("use_dict", [False, True])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_decode_chunk_fuzz(tmp_path, codec, pagever, use_dict, with_nulls):
    seed = (hash((codec, pagever)) + 2 * use_dict + with_nulls) % 977
    t = _table(4000, seed=seed, with_nulls=with_nulls,
               dict_friendly=use_dict)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, compression=codec, use_dictionary=use_dict,
                   data_page_version=pagever, data_page_size=4096,
                   row_group_size=1500)
    assert pq.ParquetFile(p).metadata.num_row_groups == 3
    assert _decode_both(p, t.column_names) == 3 * len(t.column_names)


@pytest.mark.parametrize("codec,pagever", [("snappy", "1.0"),
                                           ("NONE", "2.0")])
def test_decode_chunk_many_small_pages(tmp_path, codec, pagever):
    """Several pages per chunk: several def-level sections and
    packed-stream rebases, and PLAIN string pages in a jump table."""
    t = _table(8000, seed=3, with_nulls=True, dict_friendly=False)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, compression=codec, use_dictionary=False,
                   data_page_version=pagever, data_page_size=1024,
                   row_group_size=3500)
    assert _decode_both(p, t.column_names) == 3 * len(t.column_names)


def test_decode_chunk_dictionary_overflow_falls_back_alike(tmp_path):
    """A dictionary that overflows mid-chunk leaves PLAIN pages after
    dictionary pages: both packages refuse the chunk (None)."""
    rng = np.random.default_rng(9)
    t = pa.table({"i64": pa.array(rng.integers(0, 2**40, 20000)),
                  "s": pa.array([f"v{v}" for v in
                                 rng.integers(0, 10**6, 20000)])})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, compression="snappy", dictionary_pagesize_limit=4096)
    assert _decode_both(p, t.column_names) == 0


def test_decode_chunk_all_null_and_empty_strings(tmp_path):
    t = pa.table({
        "s_null": pa.array([None] * 300, type=pa.string()),
        "s_empty": pa.array([""] * 300, type=pa.string()),
        "i_null": pa.array([None] * 300, type=pa.int64()),
        "f_null": pa.array([None] * 300, type=pa.float32()),
    })
    for use_dict in (False, True):
        p = str(tmp_path / f"t{use_dict}.parquet")
        pq.write_table(t, p, compression="snappy", use_dictionary=use_dict)
        _decode_both(p, t.column_names)


def test_device_snappy_pages_equal(tmp_path):
    """sql.parquet.deviceSnappy: non-null PLAIN v1 pages decompress on
    the device from their element tables."""
    rng = np.random.default_rng(5)
    n = 6000
    schema = pa.schema([pa.field("i64", pa.int64(), nullable=False),
                        pa.field("f64", pa.float64(), nullable=False),
                        pa.field("s", pa.string(), nullable=False)])
    t = pa.table({"i64": rng.integers(0, 50, n).astype(np.int64),
                  "f64": np.repeat(rng.standard_normal(60), 100),
                  "s": [f"k{v % 9}" for v in range(n)]}, schema=schema)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, compression="snappy", use_dictionary=False)
    pf = pq.ParquetFile(p)
    for name, ci in pdev.eligible_chunks(pf, 0, t.column_names).items():
        c = pdev.chunk_device_plan(pf, p, 0, ci, name, False,
                                   device_snappy=True)
        assert c.dev_pages, f"device snappy did not engage for {name}"
    assert _decode_both(p, t.column_names, device_snappy=True) == 3


# ----------------------------------------------------------------------
# the staging pool
# ----------------------------------------------------------------------
def test_staging_pool_reuse_and_buckets():
    pool = PinnedStagingPool(1 << 20, HostMemoryManager(0))
    a = pool.acquire(100_000)           # -> 128 KiB bucket
    assert a.capacity == 128 * 1024
    assert a.view().nbytes == 100_000
    assert a.tensor.dtype == torch.uint8 and not a.tensor.is_pinned()
    a.array[:3] = (1, 2, 3)             # one buffer, two views
    assert a.tensor[:3].tolist() == [1, 2, 3]
    a.release()
    b = pool.acquire(90_000)            # same bucket: reuse
    assert b.capacity == 128 * 1024
    assert pool.metrics["stagingPoolHits"] == 1
    assert pool.metrics["stagingPoolMisses"] == 1
    b.release()
    c = pool.acquire(1000)              # another bucket: fresh
    assert c.capacity == 64 * 1024      # floor bucket
    assert pool.metrics["stagingPoolMisses"] == 2
    c.release()


def test_staging_pool_budget_accounting():
    mgr = HostMemoryManager(10 << 20)
    pool = PinnedStagingPool(8 << 20, mgr)
    a = pool.acquire(1 << 20)
    assert mgr.reserved == a.capacity
    a.release()
    assert pool.held_bytes == a.capacity     # cached, still reserved
    assert pool.clear() == a.capacity
    assert mgr.reserved == 0
    assert pool.held_bytes == 0


def test_staging_pool_budget_refusal_serves_transient():
    mgr = HostMemoryManager(100 * 1024)
    mgr.try_reserve(90 * 1024)               # another holder
    pool = PinnedStagingPool(8 << 20, mgr)
    a = pool.acquire(64 * 1024)
    assert not a._cached and pool.held_bytes == 0
    a.release()
    assert pool.metrics["stagingPoolHeldBytes"] == 0


def test_staging_pool_transient_over_cap():
    pool = PinnedStagingPool(128 * 1024)     # tiny pool
    a = pool.acquire(100 * 1024)             # fills the pool
    b = pool.acquire(100 * 1024)             # over cap: transient
    assert pool.metrics["stagingPoolTransient"] == 1
    b.release()
    assert pool.held_bytes == a.capacity     # transient not cached
    a.release()
    c = pool.acquire(100 * 1024)
    assert pool.metrics["stagingPoolHits"] == 1
    c.release()


def test_chunk_plan_uses_pool(tmp_path):
    t = _table(4000, seed=1, with_nulls=True, dict_friendly=False)
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, compression="snappy", use_dictionary=False)
    pool = PinnedStagingPool(64 << 20)
    assert _decode_both(p, t.column_names, pool=pool) == 5
    # chunks were read through the pool and the leases came back
    assert pool.metrics["stagingPoolMisses"] > 0
    assert pool.metrics["stagingPoolHits"] > 0   # reuse across chunks
    assert sum(len(v) for v in pool._free.values()) > 0


def test_staging_pool_threads_lose_no_count():
    """Leases from many threads: every acquire is a hit or a miss, and
    every cached buffer comes back."""
    import sys
    import threading
    pool = PinnedStagingPool(64 << 20)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for k in range(200):
                pool.acquire(1000 + 70_000 * (k % 3)).release()
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    m = pool.metrics
    assert m["stagingPoolHits"] + m["stagingPoolMisses"] == 16 * 200
    assert sum(len(v) for v in pool._free.values()) \
        == m["stagingPoolMisses"]
