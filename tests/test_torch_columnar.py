"""Arrow <-> device round trips of the PyTorch port against the JAX
package, and the numpy interop between the two packages' batches.

Every type the port moves (fixed-width numerics, dates, decimal64 and the
[n, 2] decimal128 layout, all-null columns) goes through the JAX
package's `Table.from_arrow` -> `_batch_to_arrow` and through the port's
counterparts; the two Arrow tables must be equal (schema, values, null
positions). Tolerance: exact.
"""
import datetime
import decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.table import Table as JTable
from spark_rapids_tpu.exec.batch import DeviceBatch as JBatch
from spark_rapids_tpu.exec.nodes import _batch_to_arrow as j_batch_to_arrow
from spark_rapids_tpu_torch import interop
from spark_rapids_tpu_torch.columnar.table import Schema, Table
from spark_rapids_tpu_torch.exec.batch import DeviceBatch
from spark_rapids_tpu_torch.exec.nodes import _batch_to_arrow

CPU = torch.device("cpu")
N = 300


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nulls(rng, n, frac=0.2):
    return rng.random(n) < frac


def _table(seed=0):
    rng = np.random.default_rng(seed)
    D = decimal.Decimal
    cols = {}
    m = _nulls(rng, N)
    cols["b"] = pa.array(rng.integers(0, 2, N).astype(bool), mask=m)
    for name, typ, lo, hi in [("i8", pa.int8(), -128, 127),
                              ("i16", pa.int16(), -2**15, 2**15 - 1),
                              ("i32", pa.int32(), -2**31, 2**31 - 1),
                              ("i64", pa.int64(), -2**63, 2**63 - 1)]:
        v = rng.integers(lo, hi, N, endpoint=True,
                         dtype=typ.to_pandas_dtype())
        v[:2] = [lo, hi]
        cols[name] = pa.array(v, type=typ, mask=_nulls(rng, N))
    cols["f32"] = pa.array(rng.standard_normal(N).astype(np.float32),
                           mask=_nulls(rng, N))
    f64 = rng.standard_normal(N) * 1e300
    f64[:3] = [np.nan, np.inf, -0.0]
    cols["f64"] = pa.array(f64, mask=_nulls(rng, N))
    cols["date"] = pa.array(
        [datetime.date(1992, 1, 1) + datetime.timedelta(days=int(d))
         for d in rng.integers(-30000, 30000, N)],
        type=pa.date32(), mask=_nulls(rng, N))
    for name, p, s in [("d4_2", 4, 2), ("d12_2", 12, 2), ("d18_0", 18, 0),
                       ("d27_4", 27, 4), ("d38_10", 38, 10)]:
        mags = rng.integers(0, 10**min(p, 18), N, dtype=np.int64)
        with decimal.localcontext() as c:
            c.prec = 60
            vals = [D(int(v) * (-1) ** i).scaleb(-s)
                    for i, v in enumerate(mags)]
            vals[0] = D(10**p - 1).scaleb(-s)
            vals[1] = -vals[0]
        m = _nulls(rng, N)
        cols[name] = pa.array([None if m[i] else v
                               for i, v in enumerate(vals)],
                              type=pa.decimal128(p, s))
    cols["nul"] = pa.nulls(N)
    return pa.table(cols)


def _jax_roundtrip(at, mask=None):
    jt = JTable.from_arrow(at)
    b = JBatch(jt, num_rows=at.num_rows)
    if mask is not None:
        full = np.zeros(b.capacity, bool)
        full[:len(mask)] = mask
        b = JBatch(jt, at.num_rows, jnp.asarray(full), b.capacity)
    return b, j_batch_to_arrow(b)


def _port_roundtrip(at, mask=None):
    b = DeviceBatch(Table.from_arrow(at, CPU), at.num_rows, device=CPU)
    if mask is not None:
        b = DeviceBatch(b.table, at.num_rows, torch.from_numpy(mask))
    return b, _batch_to_arrow(b)


COLUMNS = ["b", "i8", "i16", "i32", "i64", "f32", "f64", "date", "d4_2",
           "d12_2", "d18_0", "d27_4", "d38_10", "nul"]


def _assert_same(got, exp):
    """Equal Arrow tables, where a NaN equals a NaN (Arrow's `equals`
    says it does not) and -0.0 differs from 0.0."""
    assert got.schema == exp.schema
    assert got.num_rows == exp.num_rows
    for g, e in zip(got.columns, exp.columns):
        assert g.null_count == e.null_count
        gl, el = g.to_pylist(), e.to_pylist()
        if pa.types.is_floating(g.type):
            gl, el = [repr(v) for v in gl], [repr(v) for v in el]
        assert gl == el


@pytest.mark.parametrize("name", COLUMNS)
def test_column_roundtrip_matches_jax(name):
    at = _table().select([name])
    _, exp = _jax_roundtrip(at)
    _, got = _port_roundtrip(at)
    _assert_same(got, exp)
    _assert_same(got, at)


def test_masked_rows_match_jax():
    at = _table(1)
    mask = np.random.default_rng(1).random(at.num_rows) < 0.6
    _, exp = _jax_roundtrip(at, mask)
    _, got = _port_roundtrip(at, mask)
    assert got.num_rows == int(mask.sum())
    _assert_same(got, exp)


def test_chunked_and_sliced_input():
    at = _table(2)
    chunked = pa.concat_tables([at.slice(0, 100), at.slice(100)])
    sliced = at.slice(37, 150)
    for src in (chunked, sliced):
        _, exp = _jax_roundtrip(src)
        _, got = _port_roundtrip(src)
        _assert_same(got, exp)


def _jax_buffers(jb):
    return ([(np.asarray(c.data), np.asarray(c.validity))
             for c in jb.table.columns], np.asarray(jb.row_mask))


def test_interop_from_jax_batch_with_padding_and_mask():
    """JAX batches are padded to a power-of-two capacity; the padding
    rows, a filter mask and the decimal128 limb layout must survive."""
    at = _table(3).drop_columns(["nul"])
    mask = np.random.default_rng(3).random(at.num_rows) < 0.7
    jb, exp = _jax_roundtrip(at, mask)
    bufs, row_mask = _jax_buffers(jb)
    assert len(row_mask) > at.num_rows   # padded
    schema = Schema.from_arrow(at.schema)
    pb = interop.batch_from_numpy(schema, bufs, jb.num_rows, row_mask,
                                  device="cpu")
    assert pb.capacity == jb.capacity
    _assert_same(_batch_to_arrow(pb), exp)
    back, n, back_mask = interop.batch_to_numpy(pb)
    assert n == jb.num_rows
    np.testing.assert_array_equal(back_mask, row_mask)
    for (d0, v0), (d1, v1) in zip(bufs, back):
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(v1, v0)


def test_interop_rejects_mismatched_buffers():
    schema = Schema.from_arrow(pa.schema([("x", pa.decimal128(27, 4))]))
    flat = (np.zeros(8, np.int64), np.ones(8, bool))
    with pytest.raises(ValueError):
        interop.batch_from_numpy(schema, [flat], 8, np.ones(8, bool),
                                 device="cpu")


def test_interop_carries_string_columns():
    """String columns cross between the packages too: the JAX batch's
    padded byte buffer and its offsets become a port column whose rows
    read back equal, empty strings, nulls, multi-byte UTF-8 and a filter
    mask included; batch_to_numpy gives the same three buffers back."""
    rng = np.random.default_rng(8)
    n = 150
    words = ["", "a", "日本語", "naïve", "x" * 40, "tail  "]
    vals = [words[i] for i in rng.integers(0, len(words), n)]
    nul = _nulls(rng, n)
    at = pa.table({"s": pa.array([None if m else v
                                  for v, m in zip(vals, nul)]),
                   "k": pa.array(np.arange(n, dtype=np.int64)),
                   "b": pa.array([v.encode() for v in vals], pa.binary())})
    mask = rng.random(n) < 0.8
    jb, exp = _jax_roundtrip(at, mask)
    bufs = [(np.asarray(c.data), np.asarray(c.validity))
            + ((np.asarray(c.offsets),) if c.offsets is not None else ())
            for c in jb.table.columns]
    row_mask = np.asarray(jb.row_mask)
    schema = Schema.from_arrow(at.schema)
    pb = interop.batch_from_numpy(schema, bufs, jb.num_rows, row_mask,
                                  device="cpu")
    _assert_same(_batch_to_arrow(pb), exp)
    back, _, back_mask = interop.batch_to_numpy(pb)
    np.testing.assert_array_equal(back_mask, row_mask)
    for b0, b1 in zip(bufs, back):
        assert len(b0) == len(b1)
        for x, y in zip(b0, b1):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):     # a string column needs its offsets
        interop.batch_from_numpy(schema, [bufs[0][:2]] + bufs[1:],
                                 jb.num_rows, row_mask, device="cpu")
