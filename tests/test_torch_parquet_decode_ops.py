"""The port's device Parquet decode ops (`ops/parquet_decode.py`, torch
on the CPU) against the JAX package's (`jit` on the CPU), op by op.

Every input is made from a seed with numpy and goes through both. Every
comparison is exact: the outputs are integers, bytes, and raw words
(the JAX package's uint64 words against the port's int64 words, bit for
bit). Covered: PLAIN assembly at widths 4 and 8 (empty pages and a
padded page table included), hybrid expansion at bit widths 1, 3, 8, 17
and 32, def levels (all-null and empty), string extents by pointer
doubling, the row maps, the string gather, the snappy expansion on the
JAX package's own payloads, and the word bitcasts.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.io import parquet_device as jdev
from spark_rapids_tpu.ops import parquet_decode as jpd
from spark_rapids_tpu_torch.io import parquet_device as pdev
from spark_rapids_tpu_torch.ops import parquet_decode as ppd


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _page_table(rng, n_values, n_pages, width, pad_to=None):
    """A chunk of random bytes holding `n_values` PLAIN values in
    `n_pages` pages (some possibly empty) behind random headers:
    (chunk, payload offsets, first values, n_pages)."""
    cuts = np.sort(rng.integers(0, n_values + 1, n_pages - 1))
    first = np.concatenate([[0], cuts]).astype(np.int32)
    counts = np.diff(np.concatenate([first, [n_values]]))
    offs, pos = [], int(rng.integers(0, 9))
    for c in counts:
        pos += int(rng.integers(1, 12))          # a page header's bytes
        offs.append(pos)
        pos += int(c) * width
    chunk = rng.integers(0, 256, pos + 5, dtype=np.uint8)
    offs = np.asarray(offs, np.int32)
    if pad_to is not None:
        offs = np.concatenate([offs, np.zeros(pad_to - n_pages, np.int32)])
        first = np.concatenate(
            [first, np.full(pad_to - n_pages, n_values, np.int32)])
    return chunk, offs, first


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n_values,n_pages,cap,pad", [
    (1000, 1, 1024, None), (1000, 5, 1024, 8), (3000, 7, 4096, None),
    (0, 1, 128, None), (200, 4, 256, 8)])
def test_decode_plain_fixed(width, n_values, n_pages, cap, pad):
    rng = np.random.default_rng(width * 1000 + n_values + n_pages)
    chunk, offs, first = _page_table(rng, n_values, n_pages, width, pad)
    want = jpd.decode_plain_fixed(jnp.asarray(chunk), jnp.asarray(offs),
                                  jnp.asarray(first), n_pages, n_values,
                                  width, cap)
    got = ppd.decode_plain_fixed(_t(chunk), _t(offs), _t(first), n_pages,
                                 n_values, width, cap)
    assert got.dtype == torch.int64 and got.shape == (cap,)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), _np(want))


def _hybrid_runs(rng, n_values, bit_width, pad):
    """Random run tables over a random byte chunk: RLE runs with values
    below 2^bw, bit-packed runs at byte offsets inside the chunk."""
    starts, counts, packed, values, offs = [], [], [], [], []
    pos, byte = 0, 0
    while pos < n_values:
        c = int(min(rng.integers(1, 300), n_values - pos))
        is_packed = bool(rng.random() < 0.5)
        starts.append(pos)
        counts.append(c)
        packed.append(int(is_packed))
        hi = min(1 << bit_width, 1 << 31) if bit_width else 1
        values.append(0 if is_packed else int(rng.integers(0, hi)))
        offs.append(byte if is_packed else 0)
        if is_packed:
            byte += -(-c * bit_width // 8) + int(rng.integers(0, 3))
        pos += c
    chunk = rng.integers(0, 256, byte + 8, dtype=np.uint8)
    tabs = [np.asarray(x, np.int32)
            for x in (starts, counts, packed, values, offs)]
    n_runs = len(starts)
    if pad:
        r = 1
        while r < n_runs + pad:
            r <<= 1
        fill = (n_values, 0, 0, 0, 0)
        tabs = [np.concatenate([t, np.full(r - n_runs, f, np.int32)])
                for t, f in zip(tabs, fill)]
    return chunk, tabs, n_runs


@pytest.mark.parametrize("bit_width", [1, 3, 8, 17, 32])
@pytest.mark.parametrize("n_values,cap,pad", [
    (5000, 8192, 0), (777, 1024, 3), (1, 128, 0)])
def test_expand_hybrid(bit_width, n_values, cap, pad):
    rng = np.random.default_rng(bit_width * 7 + n_values)
    chunk, tabs, n_runs = _hybrid_runs(rng, n_values, bit_width, pad)
    want = jpd.expand_hybrid(jnp.asarray(chunk),
                             *[jnp.asarray(t) for t in tabs], n_runs,
                             n_values, bit_width, cap)
    got = ppd.expand_hybrid(_t(chunk), *[_t(t) for t in tabs], n_runs,
                            n_values, bit_width, cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_expand_hybrid_refuses_a_width_over_32():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ppd.expand_hybrid(torch.zeros(8, dtype=torch.uint8), z, z, z, z, z,
                          1, 4, 33, 4)


@pytest.mark.parametrize("case", ["mixed", "all_null", "no_null",
                                  "empty"])
def test_apply_def_levels(case):
    rng = np.random.default_rng(len(case))
    cap = 1024
    total = 0 if case == "empty" else 1000
    levels = {"mixed": rng.integers(0, 2, cap),
              "all_null": np.zeros(cap), "no_null": np.ones(cap),
              "empty": rng.integers(0, 2, cap)}[case].astype(np.int32)
    words = rng.integers(-2**62, 2**62, cap)
    jw, jv = jpd.apply_def_levels(jnp.asarray(levels),
                                  jnp.asarray(words.view(np.uint64)), 1,
                                  total, cap)
    pw, pv = ppd.apply_def_levels(_t(levels), _t(words), 1, total, cap)
    np.testing.assert_array_equal(pv.numpy(), _np(jv))
    np.testing.assert_array_equal(pw.numpy().view(np.uint64), _np(jw))


def _string_pages(rng, n_values, n_pages, max_len):
    """A PLAIN BYTE_ARRAY section in `n_pages` pages: (chunk, payload
    offsets, first values, max values in a page)."""
    cuts = np.sort(rng.integers(0, n_values + 1, n_pages - 1))
    first = np.concatenate([[0], cuts]).astype(np.int32)
    counts = np.diff(np.concatenate([first, [n_values]]))
    out, offs = bytearray(rng.integers(0, 256, 5, dtype=np.uint8)), []
    for c in counts:
        out += bytes(rng.integers(0, 256, int(rng.integers(1, 9)),
                                  dtype=np.uint8))
        offs.append(len(out))
        for ln in rng.integers(0, max_len + 1, int(c)):
            out += int(ln).to_bytes(4, "little")
            out += bytes(rng.integers(0, 256, int(ln), dtype=np.uint8))
    return (np.frombuffer(bytes(out), np.uint8), np.asarray(offs, np.int32),
            first, int(max(counts.max(), 1)))


@pytest.mark.parametrize("n_values,n_pages,max_len,cap", [
    (1000, 1, 20, 1024), (3000, 6, 7, 4096), (300, 3, 0, 512),
    (1, 1, 40, 128)])
def test_byte_array_index(n_values, n_pages, max_len, cap):
    rng = np.random.default_rng(n_values + max_len)
    chunk, offs, first, maxv = _string_pages(rng, n_values, n_pages,
                                             max_len)
    kbits = max(1, max(maxv - 1, 1).bit_length())
    js, jl = jpd.byte_array_index(jnp.asarray(chunk), jnp.asarray(offs),
                                  jnp.asarray(first), n_pages, n_values,
                                  kbits, cap)
    ps, pl = ppd.byte_array_index(_t(chunk), _t(offs), _t(first), n_pages,
                                  n_values, kbits, cap)
    np.testing.assert_array_equal(ps.numpy(), _np(js))
    np.testing.assert_array_equal(pl.numpy(), _np(jl))


@pytest.mark.parametrize("null_share", [0.0, 0.3, 1.0])
def test_rows_from_packed_and_dict_rows(null_share):
    rng = np.random.default_rng(int(null_share * 10))
    cap, total = 1024, 1000
    valid = rng.random(cap) >= null_share
    starts = rng.integers(0, 10_000, cap).astype(np.int32)
    lens = rng.integers(0, 50, cap).astype(np.int32)
    js, jl = jpd.rows_from_packed(jnp.asarray(starts), jnp.asarray(lens),
                                  jnp.asarray(valid), total, cap)
    ps, pl = ppd.rows_from_packed(_t(starts), _t(lens), _t(valid), total,
                                  cap)
    np.testing.assert_array_equal(ps.numpy(), _np(js))
    np.testing.assert_array_equal(pl.numpy(), _np(jl))
    idx = rng.integers(0, 40, cap).astype(np.int32)
    dstart = rng.integers(0, 500, 40).astype(np.int32)
    dlen = rng.integers(0, 9, 40).astype(np.int32)
    js, jl = jpd.dict_rows(jnp.asarray(idx), jnp.asarray(dstart),
                           jnp.asarray(dlen), jnp.asarray(valid), total,
                           cap)
    ps, pl = ppd.dict_rows(_t(idx), _t(dstart), _t(dlen), _t(valid), total,
                           cap)
    np.testing.assert_array_equal(ps.numpy(), _np(js))
    np.testing.assert_array_equal(pl.numpy(), _np(jl))


@pytest.mark.parametrize("total,cap,dcap", [(1000, 1024, 32768),
                                            (0, 128, 128),
                                            (120, 128, 2048)])
def test_assemble_strings(total, cap, dcap):
    rng = np.random.default_rng(total)
    chunk = rng.integers(0, 256, 5000, dtype=np.uint8)
    lens = rng.integers(-2, 25, cap).astype(np.int32)
    starts = rng.integers(0, 5000 - 25, cap).astype(np.int32)
    jd, jo = jpd.assemble_strings(jnp.asarray(chunk), jnp.asarray(starts),
                                  jnp.asarray(lens), total, cap, dcap)
    pdata, po = ppd.assemble_strings(_t(chunk), _t(starts), _t(lens), total,
                                     cap, dcap)
    np.testing.assert_array_equal(po.numpy(), _np(jo))
    np.testing.assert_array_equal(pdata.numpy(), _np(jd))


def _snappy_payloads():
    rng = np.random.default_rng(17)
    fuzz = []
    for _ in range(6):
        parts = []
        for _ in range(rng.integers(1, 9)):
            if rng.random() < 0.5:
                parts.append(bytes(rng.integers(0, 256, 200,
                                                dtype=np.uint8)))
            else:
                parts.append(bytes(rng.integers(0, 4, 1, dtype=np.uint8))
                             * int(rng.integers(1, 800)))
        fuzz.append(b"".join(parts))
    return [b"", b"abc", b"hello hello hello hello hello hello",
            bytes(range(256)) * 40, b"\x00" * 5000, b"ab" * 4000] + fuzz


@pytest.mark.parametrize("k", range(len(_snappy_payloads())))
def test_snappy_expand(k):
    payload = _snappy_payloads()[k]
    comp = pa.Codec("snappy").compress(payload).to_pybytes()
    tab = pdev._parse_snappy_elements(comp, 0, len(comp))
    assert tab == jdev._parse_snappy_elements(comp, 0, len(comp))
    out_len, dl, ll, sl = tab
    assert out_len == len(payload)
    e = jpd.bucket_len(max(len(dl), 1))
    dst = np.full(e, out_len, np.int32)
    lit = np.zeros(e, np.int32)
    src = np.zeros(e, np.int32)
    dst[:len(dl)], lit[:len(dl)], src[:len(dl)] = dl, ll, sl
    cap = jpd.bucket_len(max(out_len, 1), floor=128)
    kbits = max(1, (cap - 1).bit_length())
    c = np.frombuffer(comp, np.uint8)
    want = jpd.snappy_expand(jnp.asarray(c), jnp.asarray(dst),
                             jnp.asarray(lit), jnp.asarray(src), len(dl),
                             out_len, kbits, cap)
    got = ppd.snappy_expand(_t(c), _t(dst), _t(lit), _t(src), len(dl),
                            out_len, kbits, cap)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert bytes(got.numpy()[:out_len]) == payload


@pytest.mark.parametrize("physical,np_name", [
    ("INT32", "int32"), ("INT64", "int64"), ("FLOAT", "float32"),
    ("DOUBLE", "float64")])
def test_word_bitcasts(physical, np_name):
    rng = np.random.default_rng(3)
    words = rng.integers(-2**63, 2**63 - 1, 500, dtype=np.int64)
    if physical in ("INT32", "FLOAT"):
        words = words & 0xFFFFFFFF                 # zero-extended lanes
    uw = words.view(np.uint64)
    want = jpd.words_to_device(jnp.asarray(uw), np_name)
    got = ppd.words_to_device(_t(words), np_name)
    assert str(got.numpy().dtype) == np_name
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  _np(want).view(np.uint8))
    np.testing.assert_array_equal(
        ppd.words_to_np_values(words, physical).view(np.uint8),
        jpd.words_to_np_values(uw, physical).view(np.uint8))
    assert ppd.bucket_len(1000, 128) == jpd.bucket_len(1000, 128) == 1024
