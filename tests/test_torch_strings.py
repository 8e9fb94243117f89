"""String columns in the PyTorch port against the JAX package.

String (and binary) columns go through Arrow decode and upload, back to
Arrow, the row gather, the compaction, the concatenation, murmur3, the
literal equality (`ops/strings.py` `equals_literal`), the general compare
(`compare`) and the string comparisons of the expression layer (`==`,
`!=`, `<`, `<=`, `>`, `>=` and `<=>`, against a literal and between
columns) in both packages on the same seeded inputs: empty strings, nulls, multi-byte
UTF-8, and strings past 64 bytes (where the JAX package's hash folds the
last word instead of the tail, docs/compatibility.md:59). Every output
must equal the JAX package's (Arrow tables equal; hashes bit for bit).
Tolerance: exact.
"""
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.ops import concat as jconcat
from spark_rapids_tpu.ops import gather as jgather
from spark_rapids_tpu.ops import hash as jhash
from spark_rapids_tpu.ops.kernel_utils import CV as JCV
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.column import Column as PColumn
from spark_rapids_tpu_torch.columnar.table import Table as PTable
from spark_rapids_tpu_torch.exec.batch import DeviceBatch
from spark_rapids_tpu_torch.exec.nodes import _batch_to_arrow
from spark_rapids_tpu_torch.ops import concat as pconcat
from spark_rapids_tpu_torch.ops import gather as pgather
from spark_rapids_tpu_torch.ops import hash as phash
from spark_rapids_tpu_torch.ops.kernel_utils import CV as PCV

CPU = torch.device("cpu")
WORDS = ["", "a", "ab", "abc", "abcd", "abcde", "é", "日本語", "zzÿ",
         "ÿþýü", "x" * 63, "x" * 64, "x" * 65,
         "y" * 70, "y" * 69 + "z", "q" * 200, None]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _strings(n, seed, null_frac=None, binary=False):
    rng = np.random.default_rng(seed)
    vals = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    if null_frac is not None:
        vals = [None if rng.random() < null_frac else v for v in vals]
    if binary:
        return pa.array([None if v is None else v.encode() for v in vals],
                        pa.binary())
    return pa.array(vals, pa.string())


def _jcv(arr):
    _, _, b = JColumn.host_from_arrow(arr)
    return JCV(jnp.asarray(b["data"]), jnp.asarray(b["validity"]),
               jnp.asarray(b["offsets"]))


def _pcv(arr):
    _, _, b = PColumn.host_from_arrow(arr)
    return PCV(torch.from_numpy(b["data"].copy()),
               torch.from_numpy(b["validity"]),
               torch.from_numpy(b["offsets"].copy()))


def _j_arrow(cv, n, dtype=jdt.STRING):
    return JColumn.arrow_from_host(dtype, n, {
        "data": np.asarray(cv.data), "validity": np.asarray(cv.validity),
        "offsets": np.asarray(cv.offsets)})


def _p_arrow(cv, n, dtype=pdt.STRING):
    return PColumn.arrow_from_host(dtype, n, {
        "data": cv.data.numpy(), "validity": cv.validity.numpy(),
        "offsets": cv.offsets.numpy()})


CASES = {
    "mixed": lambda: _strings(3000, 1),
    "with_nulls": lambda: _strings(3000, 2, null_frac=0.3),
    "all_null": lambda: pa.array([None] * 50, pa.string()),
    "all_empty": lambda: pa.array([""] * 50, pa.string()),
    "no_rows": lambda: pa.array([], pa.string()),
    "sliced": lambda: _strings(500, 3, null_frac=0.2).slice(37, 300),
    "large_string": lambda: _strings(400, 4).cast(pa.large_string()),
    "binary": lambda: _strings(400, 5, null_frac=0.1, binary=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_arrow_upload_round_trip(case):
    arr = CASES[case]()
    at = pa.table({"s": arr, "i": pa.array(np.arange(len(arr)),
                                           pa.int32())})
    tbl = PTable.from_arrow(at, CPU)
    got = _batch_to_arrow(DeviceBatch(tbl, at.num_rows, device=CPU))
    want = (st.TpuSession().create_dataframe(at).to_arrow())
    assert got.equals(want)
    typ = pa.binary() if pa.types.is_binary(arr.type) else pa.string()
    assert got.column("s").to_pylist() == arr.cast(typ).to_pylist()
    # every buffer of the upload is 16 B aligned in one packed copy
    c = tbl.columns[0]
    assert c.offsets.dtype == torch.int32 and c.data.dtype == torch.uint8
    assert c.offsets.shape[0] == len(arr) + 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_bounds", [False, True])
def test_take_strings_matches_jax(seed, with_bounds):
    arr = _strings(2000, seed, null_frac=0.2)
    rng = np.random.default_rng(seed + 10)
    idx = rng.integers(0, len(arr), 1500)          # repeats rows
    inb = rng.random(1500) > 0.25 if with_bounds else None
    jcv, pcv = _jcv(arr), _pcv(arr)
    nbytes = int(sum(len(arr[int(i)].as_py().encode())
                     for k, i in enumerate(idx)
                     if arr[int(i)].is_valid
                     and (inb is None or inb[k])))
    jout = jgather.take_strings(
        jcv, jnp.asarray(idx, jnp.int32),
        None if inb is None else jnp.asarray(inb),
        out_data_capacity=max(nbytes, 1) + 64)
    pout = pgather.take(pcv, torch.from_numpy(idx),
                        None if inb is None else torch.from_numpy(inb),
                        out_data_capacity=nbytes)
    assert _p_arrow(pout, 1500).equals(_j_arrow(jout, 1500))
    # gather_cols sizes the bytes exactly
    gc = pgather.gather_cols([pcv], torch.from_numpy(idx),
                             None if inb is None
                             else torch.from_numpy(inb))[0]
    assert gc.data.shape[0] == nbytes
    assert _p_arrow(gc, 1500).equals(_j_arrow(jout, 1500))


def test_compact_matches_jax():
    arr = _strings(1000, 7, null_frac=0.2)
    rng = np.random.default_rng(8)
    mask = rng.random(1000) > 0.6
    jcv, pcv = _jcv(arr), _pcv(arr)
    cap = jcv.validity.shape[0]
    jmask = jnp.asarray(np.concatenate([mask, np.zeros(cap - 1000, bool)]))
    (jout,), jn = jgather.compact([jcv], jmask)
    (pout,), pn = pgather.compact([pcv], torch.from_numpy(mask))
    assert pn == int(jn) == int(mask.sum())
    assert _p_arrow(pout, pn).equals(_j_arrow(jout, pn))
    perm, count = pgather.compaction_perm(torch.from_numpy(mask))
    jperm, jcount = jgather.compaction_perm(jnp.asarray(mask))
    assert int(count) == int(jcount)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("nparts", [2, 3, 5])
def test_concat_rebases_offsets_like_jax(nparts):
    arrs = [_strings(200 + 37 * i, 20 + i, null_frac=0.1)
            for i in range(nparts)]
    # parts gathered first, so their byte buffers carry zero padding
    pparts = [pgather.take(_pcv(a), torch.arange(len(a) - 1, -1, -1))
              for a in arrs]
    jparts = [jgather.take_strings(_jcv(a), jnp.arange(len(a) - 1, -1, -1))
              for a in arrs]
    n = sum(len(a) for a in arrs)
    pout = pconcat.concat_cvs(pparts, pdt.STRING)
    want = pa.concat_arrays([a.take(pa.array(np.arange(len(a) - 1, -1, -1)))
                             for a in arrs])
    assert _p_arrow(pout, n).to_pylist() == want.to_pylist()
    # the JAX parts keep their padded capacities: its concatenation holds
    # each part's live rows followed by its padding rows
    jout = jconcat.concat_cvs(jparts, jdt.STRING)
    jrows = _j_arrow(jout, int(jout.validity.shape[0])).to_pylist()
    live, start = [], 0
    for p, a in zip(jparts, arrs):
        live += jrows[start:start + len(a)]
        start += int(p.validity.shape[0])
    assert _p_arrow(pout, n).to_pylist() == live


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("binary", [False, True])
def test_murmur3_of_strings_matches_jax(seed, binary):
    arr = _strings(3000, seed, null_frac=0.2, binary=binary)
    ints = np.random.default_rng(seed).integers(-2**31, 2**31, 3000,
                                                dtype=np.int64)
    ints = ints.astype(np.int32)
    jd, pd = (jdt.BINARY, pdt.BINARY) if binary else (jdt.STRING,
                                                      pdt.STRING)
    jcv, pcv = _jcv(arr), _pcv(arr)
    cap = jcv.validity.shape[0]
    jint = JCV(jnp.asarray(np.resize(ints, cap)), jnp.ones(cap, bool))
    pint = PCV(torch.from_numpy(ints), torch.ones(3000, dtype=torch.bool))
    for jcols, pcols, jts, pts in (([jcv], [pcv], [jd], [pd]),
                                   ([jint, jcv], [pint, pcv],
                                    [jdt.INT32, jd], [pdt.INT32, pd])):
        jh = np.asarray(jhash.murmur3_row_hash(jcols, jts))[:3000]
        ph = phash.murmur3_row_hash(pcols, pts).numpy()
        np.testing.assert_array_equal(ph, jh.astype(np.int64) & 0xFFFFFFFF)
        for n in (1, 7, 200):
            np.testing.assert_array_equal(
                phash.partition_ids(pcols, pts, n).numpy(),
                np.asarray(jhash.partition_ids(jcols, jts, n))[:3000])


def test_string_repartition_matches_jax():
    rng = np.random.default_rng(4)
    at = pa.table({"s": _strings(6000, 9, null_frac=0.15),
                   "k": pa.array(rng.integers(0, 50, 6000), pa.int64())})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1024}
    want = st.TpuSession(conf).create_dataframe(at).repartition(
        7, "s").to_arrow()
    got = pt.TpuSession(conf, device="cpu").create_dataframe(
        at).repartition(7, "s").to_arrow()
    assert got.equals(want)
    want = st.TpuSession(conf).create_dataframe(at).repartition(
        5, "k", "s").to_arrow()
    got = pt.TpuSession(conf, device="cpu").create_dataframe(
        at).repartition(5, "k", "s").to_arrow()
    assert got.equals(want)


# ----------------------------------------------------------------------
# compares: ops/strings.py and the expression layer
# ----------------------------------------------------------------------
LITERALS = ["BUILDING", "BUILDING\x00", "", "a", "abcd", "abcde", "日本語",
            "x" * 64, "ÿþýü"]
CMP_WORDS = WORDS + ["BUILDING", "BUILDING\x00", "BUILDIN", "BUILDINGS",
                     "building", "a\x00", "abcd\x00"]


def _cmp_strings(n, seed):
    rng = np.random.default_rng(seed)
    return pa.array([CMP_WORDS[i]
                     for i in rng.integers(0, len(CMP_WORDS), n)],
                    pa.string())


@pytest.mark.parametrize("literal", LITERALS)
def test_equals_literal_matches_jax(literal):
    from spark_rapids_tpu.ops import strings as jstr
    from spark_rapids_tpu_torch.ops import strings as pstr
    arr = _cmp_strings(300, 5)
    raw = literal.encode()
    got = pstr.equals_literal(_pcv(arr), raw).numpy()
    exp = np.asarray(jstr.equals_literal(_jcv(arr), raw))[:len(arr)]
    np.testing.assert_array_equal(got, exp)
    # the kernel reads bytes only: a null row is its empty bytes
    want = np.array([(v or "") == literal for v in arr.to_pylist()])
    np.testing.assert_array_equal(got, want)


def test_trailing_zero_byte_is_not_equal():
    """Unlike the chunk keys of a sort, the equality checks the length:
    "BUILDING\\x00" is not "BUILDING"."""
    from spark_rapids_tpu_torch.ops import strings as pstr
    arr = pa.array(["BUILDING", "BUILDING\x00", "BUILDING\x00\x00",
                    "BUILDIN"])
    assert pstr.equals_literal(_pcv(arr), b"BUILDING").tolist() == \
        [True, False, False, False]
    assert pstr.equals_literal(_pcv(arr), b"BUILDING\x00").tolist() == \
        [False, True, False, False]
    assert pstr.compare(_pcv(arr), _pcv(pa.array(["BUILDING"] * 4))) \
        .tolist() == [0, 1, 1, -1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_matches_jax(seed):
    from spark_rapids_tpu.ops import strings as jstr
    from spark_rapids_tpu_torch.ops import strings as pstr
    a, b = _cmp_strings(257, seed), _cmp_strings(257, seed + 10)
    got = pstr.compare(_pcv(a), _pcv(b)).numpy()
    exp = np.asarray(jstr.compare(_jcv(a), _jcv(b)))[:len(a)]
    np.testing.assert_array_equal(got, exp)
    want = [(x.encode() > y.encode()) - (x.encode() < y.encode())
            if x is not None and y is not None else None
            for x, y in zip(a.to_pylist(), b.to_pylist())]
    assert [w for w, v in zip(got.tolist(), want) if v is not None] == \
        [v for v in want if v is not None]


def test_compare_of_empty_columns():
    from spark_rapids_tpu_torch.ops import strings as pstr
    e = pa.array([""] * 3)
    assert pstr.compare(_pcv(e), _pcv(pa.array(["", "a", ""]))).tolist() \
        == [0, -1, 0]
    assert pstr.compare(_pcv(pa.array(["b", "", "a"])), _pcv(e)).tolist() \
        == [1, 0, 1]


def _compare_exprs(E, c, lit):
    """Every string comparison against three literals and between two
    columns, in the expression module E of one package."""
    out = []
    for v in ("BUILDING", "abcd", ""):
        out += [(c("w") == lit(v)).alias(f"eq_{v}"),
                (lit(v) == c("w")).alias(f"req_{v}"),
                (c("w") != lit(v)).alias(f"ne_{v}"),
                (c("w") < lit(v)).alias(f"lt_{v}"),
                (c("w") <= lit(v)).alias(f"le_{v}"),
                (c("w") > lit(v)).alias(f"gt_{v}"),
                (c("w") >= lit(v)).alias(f"ge_{v}"),
                E.EqNullSafe(c("w"), lit(v)).alias(f"ns_{v}")]
    out += [(c("w") == c("u")).alias("eq_cols"),
            (c("w") < c("u")).alias("lt_cols"),
            E.EqNullSafe(c("w"), c("u")).alias("ns_cols")]
    return out


@pytest.mark.parametrize("null_frac", [None, 0.3])
def test_string_comparisons_match_jax(null_frac):
    from spark_rapids_tpu.expr.expressions import col as jcol, lit as jlit
    from spark_rapids_tpu_torch.expr.expressions import col as pcol
    from spark_rapids_tpu_torch.expr.expressions import lit as plit
    rng = np.random.default_rng(8)
    w = _cmp_strings(400, 8).to_pylist()
    u = _cmp_strings(400, 9).to_pylist()
    if null_frac:
        w = [None if rng.random() < null_frac else x for x in w]
        u = [None if rng.random() < null_frac else x for x in u]
    t = pa.table({"w": pa.array(w, pa.string()),
                  "u": pa.array(u, pa.string())})
    from spark_rapids_tpu.expr import expressions as jexpr
    from spark_rapids_tpu_torch.expr import expressions as pexpr
    got = pt.TpuSession(device="cpu").create_dataframe(t).select(
        *_compare_exprs(pexpr, pcol, plit)).to_arrow()
    exp = st.TpuSession().create_dataframe(t).select(
        *_compare_exprs(jexpr, jcol, jlit)).to_arrow()
    assert got.equals(exp)
    assert got.column("eq_BUILDING").to_pylist() == [
        None if x is None else x == "BUILDING" for x in w]
    assert got.column("ns_cols").to_pylist() == [
        x == y for x, y in zip(w, u)]
