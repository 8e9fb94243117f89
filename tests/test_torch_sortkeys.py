"""Order keys and the multi-key stable sort of the PyTorch port against
the JAX package's `ops/sortkeys.py`.

`order_keys` (every ported type, ascending and descending, nulls and
NaN/-0.0 included), `string_chunk_keys`, `lexsort` (many ties: the
stable order must be the JAX variadic sort's exactly), `group_boundaries`
and the chunk counts run in both packages on the same seeded numpy
inputs. The port keeps a uint32 key as its unsigned value in int64, so
keys compare as integers. Tolerance: exact.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.ops import sortkeys as jsk
from spark_rapids_tpu.ops.kernel_utils import CV as JCV
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.ops import sortkeys as psk
from spark_rapids_tpu_torch.ops.kernel_utils import CV as PCV

N = 3000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fixed(name, seed):
    rng = np.random.default_rng(seed)
    if name == "int32":
        v = rng.integers(-5, 5, N).astype(np.int32)
        v[:2] = [-2**31, 2**31 - 1]
        return v, jdt.INT32, pdt.INT32
    if name == "int64":
        v = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64)
        v[::3] = 7
        return v, jdt.INT64, pdt.INT64
    if name == "bool":
        return rng.integers(0, 2, N).astype(bool), jdt.BOOL, pdt.BOOL
    if name == "float32":
        v = rng.standard_normal(N).astype(np.float32)
        v[:5] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
        v[5::7] = 1.5
        return v, jdt.FLOAT32, pdt.FLOAT32
    if name == "float64":
        v = rng.standard_normal(N) * 1e300
        v[:5] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
        v[5::7] = -2.5
        return v, jdt.FLOAT64, pdt.FLOAT64
    if name == "decimal128":
        v = rng.integers(-2**62, 2**62, (N, 2), dtype=np.int64)
        v[::4, 1] = rng.integers(-3, 3, (N + 3) // 4)
        v[::5] = v[1]
        return v, jdt.DecimalType(30, 2), pdt.DecimalType(30, 2)
    raise KeyError(name)


def _keys_equal(pk, jk):
    assert len(pk) == len(jk)
    for p, j in zip(pk, jk):
        j = np.asarray(j)
        p = p.numpy()
        if j.dtype.kind == "f":
            np.testing.assert_array_equal(p, j)
        else:
            np.testing.assert_array_equal(p.astype(np.int64),
                                          j.astype(np.int64))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("name", ["int32", "int64", "bool", "float32",
                                  "float64", "decimal128"])
def test_order_keys_match_jax(name, descending):
    v, jt, pt_ = _fixed(name, seed=len(name))
    valid = np.random.default_rng(1).random(N) > 0.1
    jk = jsk.order_keys(JCV(jnp.asarray(v), jnp.asarray(valid)), jt,
                        descending=descending)
    pk = psk.order_keys(PCV(torch.from_numpy(v), torch.from_numpy(valid)),
                        pt_, descending=descending)
    _keys_equal(pk, jk)
    # and the sort over (null flag, keys) is the JAX sort, ties included
    jperm = jsk.lexsort([jnp.asarray(~valid).astype(jnp.uint8)] + jk)
    pperm = psk.lexsort([torch.from_numpy(~valid).to(torch.uint8)] + pk,
                        [None] + psk.key_widths(pt_))
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(jperm))


def _string_cvs(seed, n=N):
    rng = np.random.default_rng(seed)
    words = ["", "a", "ab", "abc", "abcd", "abcde", "b", "é", "日本",
             "zzzzzzzzz", "zzzzzzzza", "\x00", "\x00\x01", "ÿ", None]
    arr = pa.array([words[i] for i in rng.integers(0, len(words), n)],
                   pa.string())
    _, _, b = PColumn.host_from_arrow(arr)
    pcv = PCV(torch.from_numpy(b["data"].copy()),
              torch.from_numpy(b["validity"]),
              torch.from_numpy(b["offsets"].copy()))
    jcv = JCV(jnp.asarray(b["data"]), jnp.asarray(b["validity"]),
              jnp.asarray(b["offsets"]))
    return arr, pcv, jcv


@pytest.mark.parametrize("nchunks", [1, 2, 4])
@pytest.mark.parametrize("descending", [False, True])
def test_string_chunk_keys_and_sort_match_jax(nchunks, descending):
    arr, pcv, jcv = _string_cvs(nchunks)
    jk = jsk.order_keys(jcv, jdt.STRING, nchunks, descending)
    pk = psk.order_keys(pcv, pdt.STRING, nchunks, descending)
    _keys_equal(pk, jk)
    nulls = ~np.asarray(arr.is_valid())
    jperm = jsk.lexsort([jnp.asarray(nulls).astype(jnp.uint8)] + jk)
    pperm = psk.lexsort([torch.from_numpy(nulls).to(torch.uint8)] + pk,
                        [None] + psk.key_widths(pdt.STRING, nchunks))
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(jperm))


def test_string_chunk_keys_order_bytes_lexicographically():
    """Byte order, with the reference's padding rule: a trailing 0x00
    byte pads like a missing one, so "" and "\x00" tie (and keep their
    input order)."""
    arr, pcv, _ = _string_cvs(9)
    pk = psk.order_keys(pcv, pdt.STRING, 4)
    perm = psk.lexsort(pk, psk.key_widths(pdt.STRING, 4)).numpy()
    vals = [(v or "").encode() for v in arr.to_pylist()]
    padded = [v.ljust(16, b"\x00") for v in vals]
    assert [padded[i] for i in perm] == sorted(padded)
    ties = [i for i in perm if vals[i] in (b"", b"\x00")]
    assert ties == sorted(ties)


@pytest.mark.parametrize("seed", range(4))
def test_lexsort_ties_and_packing(seed):
    """Many keys of mixed widths with heavy ties: the packed, chained
    stable sort equals the JAX variadic stable sort and np.lexsort."""
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 2, N).astype(np.uint8),
            rng.integers(0, 3, N).astype(np.int32) - 1,
            rng.integers(0, 4, N).astype(np.uint32),
            rng.integers(-2, 2, N).astype(np.int64),
            rng.integers(0, 2, N).astype(np.uint8),
            rng.integers(0, 5, N).astype(np.uint32)]
    jperm = np.asarray(jsk.lexsort([jnp.asarray(k) for k in keys]))
    pk = [torch.from_numpy(k.astype(np.int64) if k.dtype == np.uint32
                           else k) for k in keys]
    widths = [None, None, 32, None, None, 32]
    pperm = psk.lexsort(pk, widths).numpy()
    np.testing.assert_array_equal(pperm, jperm)
    np.testing.assert_array_equal(pperm, np.lexsort(keys[::-1]))
    words = psk.pack_keys(pk, widths)
    assert len(words) < len(pk)
    jb = np.asarray(jsk.group_boundaries([jnp.asarray(k)[jperm]
                                          for k in keys]))
    pb = psk.group_boundaries([w[torch.from_numpy(pperm)]
                               for w in words]).numpy()
    np.testing.assert_array_equal(pb, jb)


def test_nchunks_match_jax():
    for maxlen in range(0, 300):
        assert psk.nchunks_for_len(maxlen) == jsk.nchunks_for_len(maxlen)
    arr, pcv, jcv = _string_cvs(3)
    mask = np.random.default_rng(2).random(N) > 0.5
    assert psk.string_nchunks(pcv, torch.from_numpy(mask)) == \
        jsk.string_nchunks(jcv, jnp.asarray(mask))


def test_group_boundaries_first_row_and_empty():
    empty = torch.zeros(0, dtype=torch.int64)
    assert psk.group_boundaries([empty]).shape == (0,)
    k = torch.tensor([3, 3, 3, 4, 4, 3])
    assert psk.group_boundaries([k]).tolist() == [True, False, False, True,
                                                  False, True]
