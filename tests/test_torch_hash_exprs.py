"""hash (murmur3), xxhash64 and hive_hash in the port against the JAX
package on the CPU, over one column of every hashable type (boolean,
the integers, float, double with NaN, +-infinity and -0.0, decimal64,
decimal128, strings of 0 to 100 bytes with multi-byte UTF-8, date and
timestamp), each with nulls, one column at a time and folded across
columns. Exact. The long hashes also equal `chip_smoke.py`'s numpy
twins (Spark's hashLong of murmur3 and XXH64, Hive's long hash), and
xxhash64 of a short string a plain-Python XXH64 of its bytes.
"""
import decimal
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

from torch_parity import assert_same, project

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

N = 64


def _data(seed=31):
    rng = np.random.default_rng(seed)
    nul = rng.random(N) < 0.2
    nul[:8] = False
    ints = rng.integers(-2 ** 62, 2 ** 62, N)
    ints[:4] = [-2 ** 63, 2 ** 63 - 1, 0, -1]
    f = rng.normal(0, 1e3, N)
    f[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5]
    lens = rng.integers(0, 100, N)
    strs = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, k))
            for k in lens]
    strs[:6] = ["", "a", "abcd", "日本語テキスト", "x" * 64, "y" * 65]
    dec = [decimal.Decimal(int(v)).scaleb(-2) for v in
           rng.integers(-10 ** 15, 10 ** 15, N)]
    wide = [decimal.Decimal(f"{int(v)}{int(w):09d}E-3") for v, w in
            zip(rng.integers(-10 ** 15, 10 ** 15, N),
                rng.integers(0, 10 ** 9, N))]
    m = lambda a: pa.array(a, mask=nul)                    # noqa: E731
    return {
        "bo": m(rng.random(N) < 0.5),
        "by": m(rng.integers(-128, 128, N).astype(np.int8)),
        "sh": m(rng.integers(-2 ** 15, 2 ** 15, N).astype(np.int16)),
        "i": m(ints.astype(np.int32)), "l": m(ints),
        "fl": m(f.astype(np.float32)), "d": m(f),
        "m": pa.array([None if x else v for v, x in zip(dec, nul)],
                      pa.decimal128(17, 2)),
        "w": pa.array([None if x else v for v, x in zip(wide, nul)],
                      pa.decimal128(30, 3)),
        "s": pa.array([None if x else v for v, x in zip(strs, nul)]),
        "dt": pa.array(rng.integers(-40000, 40000, N).astype(np.int32),
                       pa.int32(), mask=nul).cast(pa.date32()),
        "ts": pa.array(ints // 1000, pa.timestamp("us", tz="UTC"),
                       mask=nul),
    }


COLS = ["bo", "by", "sh", "i", "l", "fl", "d", "m", "w", "s", "dt", "ts"]


@pytest.mark.parametrize("fn", ["hash", "xxhash64", "hive_hash"])
def test_hash_each_type_and_folded(fn):
    jt, ptab = project(_data(), lambda F: [getattr(F, fn)(c) for c in COLS]
                       + [getattr(F, fn)(*COLS),
                          getattr(F, fn)("s", "l", "d")])
    assert_same(jt, ptab, fn)


def test_long_hashes_equal_numpy():
    data = _data()
    longs = np.array(data["l"].fill_null(0).to_pylist(), np.int64)
    _, ptab = project({"l": pa.array(longs)}, lambda F: [
        F.hash("l"), F.xxhash64("l"), F.hive_hash("l")])
    assert ptab.column(0).to_pylist() == \
        chip_smoke.np_hash_long(longs).view(np.int32).tolist()
    assert ptab.column(1).to_pylist() == \
        chip_smoke.np_xxhash64_long(longs).tolist()
    assert ptab.column(2).to_pylist() == \
        chip_smoke.np_hive_hash_long(longs).tolist()


def test_xxhash64_of_short_strings_equals_python():
    """xxhash64 of strings under 32 bytes equals a plain-Python XXH64 of
    their bytes, seed 42 (Spark's hashUnsafeBytes small-input
    schedule)."""
    words = ["", "a", "Spark", "abcdefgh", "abcdefghijkl", "x" * 31]
    _, ptab = project({"s": pa.array(words)}, lambda F: [F.xxhash64("s")])
    assert ptab.column(0).to_pylist() == [
        chip_smoke.py_xxhash64_bytes(w.encode(), 42) for w in words]
