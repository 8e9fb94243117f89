"""The exact decimal SUM of the PyTorch port against the JAX package.

Sum's update / merge / finalize run over the same numpy batches in both
packages: decimal(17,4) (Q6's product) summing into decimal(27,4) on the
32-bit limb path, at the extremes of its range, with negative totals,
with a total past precision 27 (null), and over empty input (null).
Count and count(*) ride along. Tolerance: exact.
"""
import types

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.columnar.table import Schema as JSchema
from spark_rapids_tpu.expr import aggregates as jagg
from spark_rapids_tpu.expr import expressions as jx
from spark_rapids_tpu.ops import decimal128 as jd128
from spark_rapids_tpu.ops.kernel_utils import CV as JCV
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.columnar.table import Schema as PSchema
from spark_rapids_tpu_torch.expr import aggregates as pagg
from spark_rapids_tpu_torch.expr import expressions as px
from spark_rapids_tpu_torch.ops import decimal128 as pd128
from spark_rapids_tpu_torch.ops.kernel_utils import CV as PCV

MAX17 = 10**17 - 1


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _schema(p, s):
    return pa.schema([("v", pa.decimal128(p, s))])


def _run(pkg, agg_cls, batches, p=17, s=4):
    """update per batch, merge, finalize; -> (value array, ok)."""
    if pkg == "jax":
        a = agg_cls(jx.col("v")).bind(JSchema.from_arrow(_schema(p, s)))
        mk = lambda d, v: JCV(jnp.asarray(d), jnp.asarray(v))  # noqa: E731
        arr = jnp.asarray
    else:
        a = agg_cls(px.col("v")).bind(PSchema.from_arrow(_schema(p, s)))
        mk = lambda d, v: PCV(torch.from_numpy(d),  # noqa: E731
                              torch.from_numpy(v))
        arr = torch.from_numpy
    acc = None
    for data, valid, mask in batches:
        st_ = a.update(mk(data, valid), arr(mask))
        acc = st_ if acc is None else a.merge(acc, st_)
    val, ok = a.finalize(acc)
    return repr(a.dtype), np.asarray(val), bool(np.asarray(ok))


def _batches(vals, valid=None, mask=None, size=1000):
    vals = np.asarray(vals, np.int64)
    n = len(vals)
    valid = np.ones(n, bool) if valid is None else valid
    mask = np.ones(n, bool) if mask is None else mask
    return [(vals[i:i + size], valid[i:i + size], mask[i:i + size])
            for i in range(0, max(n, 1), size)]


def _value(words):
    lo, hi = (int(x) for x in words)
    u = (lo & (2**64 - 1)) | ((hi & (2**64 - 1)) << 64)
    return u - 2**128 if u >= 2**127 else u


def _check(agg_cls, batches, expect=None, p=17, s=4):
    jt, jv, jok = _run("jax", agg_cls, batches, p, s)
    ptype, pv, pok = _run("port", agg_cls, batches, p, s)
    assert ptype == jt
    assert pok == jok
    np.testing.assert_array_equal(pv, jv)
    if expect is not None:
        assert pok
        got = _value(pv) if pv.shape == (2,) else int(pv)
        assert got == expect
    return pv, pok


def _pick(port_cls, jax_cls):
    """An aggregate constructor for either package, picked by the
    package of the child expression it is given."""
    return lambda child: (port_cls(child)
                          if isinstance(child, px.Expression)
                          else jax_cls(child))


_Sum = _pick(pagg.Sum, jagg.Sum)


def _check_sum(vals, expect=None, **kw):
    return _check(_Sum, _batches(vals, **kw), expect)


def test_many_rows_of_max_decimal17():
    n = 20_000
    _check_sum(np.full(n, MAX17), expect=n * MAX17)


def test_negative_total_and_mixed_signs():
    rng = np.random.default_rng(0)
    vals = -rng.integers(0, MAX17, 5000, dtype=np.int64)
    vals[:3] = [-MAX17, MAX17, -MAX17]
    _check_sum(vals, expect=int(vals.astype(object).sum()))


def test_nulls_and_masked_rows_are_skipped():
    rng = np.random.default_rng(1)
    vals = rng.integers(-MAX17, MAX17, 4000, dtype=np.int64)
    valid = rng.random(4000) > 0.3
    mask = rng.random(4000) > 0.3
    keep = valid & mask
    _check_sum(vals, valid=valid, mask=mask,
               expect=int(vals[keep].astype(object).sum()))


def test_empty_and_all_null_input_is_null():
    for batches in (_batches(np.zeros(0, np.int64)),
                    _batches(np.arange(10), valid=np.zeros(10, bool)),
                    _batches(np.arange(10), mask=np.zeros(10, bool))):
        _, ok = _check(_Sum, batches)
        assert not ok


@pytest.mark.parametrize("hi_sum", [2**62 - 1, -(2**62 - 1), 2**29, -2**29])
def test_total_past_precision_27_is_null(hi_sum):
    """A total of 27 digits or more is null. Rows cannot reach it while
    the limb sums stay exact (< 2^62), so the state is built directly:
    the signed high-limb sum `hi_sum` weighs 2^32."""
    for lo_sum in (0, 2**62 - 1):
        sums = [lo_sum, hi_sum]
        jv, jovf = jd128.combine_limb_sums(
            [jnp.asarray(x, jnp.int64) for x in sums], 27)
        pv, povf = pd128.combine_limb_sums(
            [torch.tensor(x, dtype=torch.int64) for x in sums], 27)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        assert bool(povf) == bool(jovf)
        total = lo_sum + hi_sum * 2**32
        assert bool(povf) == (abs(total) > 10**27 - 1)
        if not bool(povf):
            assert _value(pv.numpy()) == total


def test_sum_below_precision_18_stays_int64():
    # decimal(4,2) sums into decimal(14,2): the plain int64 path
    rng = np.random.default_rng(2)
    vals = rng.integers(-9999, 9999, 3000, dtype=np.int64)
    _check(_Sum, _batches(vals), expect=int(vals.sum()), p=4, s=2)


@pytest.mark.parametrize("cls", ["count", "count_star"])
def test_count_matches_jax(cls):
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 100, 3000, dtype=np.int64)
    valid = rng.random(3000) > 0.2
    mask = rng.random(3000) > 0.4
    pick = (_pick(pagg.Count, jagg.Count) if cls == "count" else
            _pick(lambda c: pagg.CountStar(), lambda c: jagg.CountStar()))
    exp = int((valid & mask).sum()) if cls == "count" else int(mask.sum())
    _check(pick, _batches(vals, valid=valid, mask=mask), expect=exp)


def test_dataframe_aggregates_over_empty_input():
    """One null sum row and zero counts, end to end in both packages."""
    at = pa.table({"v": pa.array([], pa.decimal128(17, 4)),
                   "w": pa.array([], pa.int32())})
    js = st.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096})
    ps = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                       device="cpu")
    exp = js.create_dataframe(at).agg(JF.sum("v").alias("s"),
                                      JF.count("w"),
                                      JF.count("*")).to_arrow()
    got = ps.create_dataframe(at).agg(PF.sum("v").alias("s"),
                                      PF.count("w"),
                                      PF.count("*")).to_arrow()
    assert got.equals(exp)
    assert got.to_pylist() == [{"s": None, "count(w)": 0, "count(*)": 0}]


# ----------------------------------------------------------------------
# decimal128 arithmetic (the Q1 slice): add, subtract, multiply, rescale
# ----------------------------------------------------------------------
def _words(rng, n, bits=126):
    """n random int128s of up to `bits` magnitude bits, as [n, 2] words,
    with the extremes and zero up front."""
    vals = [int(x) for x in rng.integers(-2**62, 2**62, n)]
    vals = [v << int(rng.integers(0, bits - 62)) for v in vals]
    vals[:6] = [0, 1, -1, 2**127 - 1, -2**127, 10**38 - 1]
    u = [v & (2**128 - 1) for v in vals]
    lo = [(x & (2**64 - 1)) - (2**64 if x & (1 << 63) else 0) for x in u]
    hi = [(x >> 64) - (2**64 if x >> 127 else 0) for x in u]
    return np.stack([np.array(lo, np.int64), np.array(hi, np.int64)], 1)


def _same(port_out, jax_out):
    for p, j in zip(port_out, jax_out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", ["dec_add", "dec_sub"])
def test_dec_add_sub_match_jax(seed, op):
    rng = np.random.default_rng(seed)
    a, b = _words(rng, 2000), _words(rng, 2000)
    b[6:20] = a[6:20]            # a - a, and doubling near the bounds
    _same(getattr(pd128, op)(torch.from_numpy(a), torch.from_numpy(b)),
          getattr(jd128, op)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("down_shift,precision,bits",
                         [(0, 38, 63), (0, 38, 80), (3, 38, 100),
                          (7, 30, 90), (12, 20, 64)])
def test_dec_mul_scaled_matches_jax(down_shift, precision, bits):
    """Exact products, HALF_UP down-shifts of the 256-bit product, and
    overflow past the precision (or 127 bits) to null."""
    rng = np.random.default_rng(down_shift + bits)
    a, b = _words(rng, 600, bits), _words(rng, 600, bits)
    _same(pd128.dec_mul_scaled(torch.from_numpy(a), torch.from_numpy(b),
                               down_shift, precision),
          jd128.dec_mul_scaled(jnp.asarray(a), jnp.asarray(b), down_shift,
                               precision))


@pytest.mark.parametrize("from_s,to_s,half_up", [(2, 6, True), (6, 2, True),
                                                 (6, 2, False), (4, 4, True),
                                                 (0, 30, True)])
def test_dec_rescale_matches_jax(from_s, to_s, half_up):
    rng = np.random.default_rng(from_s * 7 + to_s)
    a = _words(rng, 800, 110)
    _same(pd128.dec_rescale(torch.from_numpy(a), from_s, to_s, 38, half_up),
          jd128.dec_rescale(jnp.asarray(a), from_s, to_s, 38, half_up))


def test_limb_splits_match_jax():
    a = _words(np.random.default_rng(5), 1000)
    for p, j in zip(pd128.split_d128_limbs(torch.from_numpy(a)),
                    jd128.split_d128_limbs(jnp.asarray(a))):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


EXPR_SCHEMA = pa.schema([("price", pa.decimal128(12, 2)),
                         ("disc", pa.decimal128(4, 2)),
                         ("tax", pa.decimal128(4, 2)),
                         ("big", pa.decimal128(38, 10)),
                         ("mid", pa.decimal128(20, 10)),
                         ("k", pa.int64())])


def _expr_inputs(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    D = __import__("decimal").Decimal
    cols = {
        "price": [D(int(x)).scaleb(-2) for x in
                  rng.integers(-10**12 + 1, 10**12, n)],
        "disc": [D(int(x)).scaleb(-2) for x in rng.integers(0, 11, n)],
        "tax": [D(int(x)).scaleb(-2) for x in rng.integers(0, 9, n)],
        "big": [D(int(x) * 10**int(e)).scaleb(-10) for x, e in zip(
            rng.integers(-10**18, 10**18, n), rng.integers(0, 20, n))],
        "mid": [D(int(x)).scaleb(-10) for x in
                rng.integers(-10**18, 10**18, n)],
        "k": [int(x) for x in rng.integers(-10**15, 10**15, n)],
    }
    valid = rng.random(n) > 0.1
    at = pa.table({c: pa.array([v if ok else None
                                for v, ok in zip(vals, valid)],
                               EXPR_SCHEMA.field(c).type)
                   for c, vals in cols.items()})
    return at


def _eval_both(build, at):
    js = st.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096})
    ps = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                       device="cpu")
    exp = js.create_dataframe(at).select(build(jx).alias("r")).to_arrow()
    got = ps.create_dataframe(at).select(build(px).alias("r")).to_arrow()
    return got, exp


D_ = __import__("decimal").Decimal
EXPRS = {
    # Q1's products: decimal(18,4) * decimal(5,2) -> decimal(24,6)
    "q1_charge": lambda E: E.col("price") * (E.lit(D_("1")) - E.col("disc"))
    * (E.lit(D_("1")) + E.col("tax")),
    # `1 - disc` with an int literal: decimal(26,4) on the limb path
    "int_literal_disc_price": lambda E: E.col("price")
    * (E.lit(1) - E.col("disc")) * E.col("price"),
    # clamped product: precision 59 -> 38, scale 20 -> 6 (a down-shift)
    "clamped_product": lambda E: E.col("big") * E.col("mid"),
    "d128_add_rescale": lambda E: E.col("big") + E.col("price"),
    "d128_sub": lambda E: E.col("mid") - E.col("price") * E.col("disc"),
    "d128_overflow_to_null": lambda E: E.col("big") * E.col("big")
    * E.col("big"),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_decimal128_expressions_match_jax(name):
    got, exp = _eval_both(EXPRS[name], _expr_inputs())
    assert got.schema == exp.schema
    assert got.equals(exp)
    if name == "clamped_product":
        assert got.schema.field("r").type == pa.decimal128(38, 6)
    if name == "d128_overflow_to_null":
        assert got.column("r").null_count > got.num_rows // 2


def test_sum_and_avg_over_q1_types_match_jax():
    """Sum over a decimal128 input (Q1's sum_charge: four limbs) and the
    HALF_UP decimal averages, ungrouped, negatives included."""
    at = _expr_inputs(3000, seed=4)
    js = st.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 512})
    ps = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 512},
                       device="cpu")

    def q(s, F, E):
        charge = E.col("price") * (E.lit(D_("1")) - E.col("disc")) \
            * (E.lit(D_("1")) + E.col("tax"))
        return s.create_dataframe(at).agg(
            F.sum(charge).alias("sum_charge"), F.sum("mid").alias("sm"),
            F.avg("price").alias("ap"), F.avg("disc").alias("ad"),
            F.avg("k").alias("ak"))
    exp = q(js, JF, jx).to_arrow()
    got = q(ps, PF, px).to_arrow()
    assert got.equals(exp)
    assert got.schema.field("sum_charge").type == pa.decimal128(34, 6)
    assert got.schema.field("ap").type == pa.decimal128(18, 6)


# ----------------------------------------------------------------------
# decimal128 comparison (the Q18 slice): dec_cmp, dec_cmp_scaled and the
# six comparison operators at mixed scales
# ----------------------------------------------------------------------
def _as_words(vals):
    u = [v & (2**128 - 1) for v in vals]
    lo = [(x & (2**64 - 1)) - (2**64 if x & (1 << 63) else 0) for x in u]
    hi = [(x >> 64) - (2**64 if x >> 127 else 0) for x in u]
    return np.stack([np.array(lo, np.int64), np.array(hi, np.int64)], 1)


P38 = 10**38 - 1
#: (a, b) pairs of unscaled values on the boundaries
CMP_EDGES = [(P38, P38), (P38, -P38), (-P38, P38), (-P38, -P38),
             (P38, P38 - 1), (-P38, -P38 + 1), (0, 0), (0, -0), (1, -1),
             (-1, 1), (0, P38), (-P38, 0), (100, 1), (1, 100), (-100, -1),
             (2**127 - 1, 2**127 - 1), (-2**127, 2**127 - 1),
             (10**37, 10**36), (5, 50), (-5, -50), (12345, 1234500)]


def _cmp_cases(rng, n=1500):
    a = _words(rng, n, 126)
    b = _words(rng, n, 126)
    b[::3] = a[::3]                  # equal raw words
    b[1::7] = -a[1::7]               # opposite signs (as raw words)
    ea, eb = zip(*CMP_EDGES)
    return (np.concatenate([_as_words(ea), a]),
            np.concatenate([_as_words(eb), b]))


@pytest.mark.parametrize("seed", [0, 1])
def test_dec_cmp_matches_jax(seed):
    a, b = _cmp_cases(np.random.default_rng(seed))
    got = pd128.dec_cmp(torch.from_numpy(a), torch.from_numpy(b))
    exp = jd128.dec_cmp(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("sa,sb", [(0, 0), (2, 0), (0, 2), (2, 2), (4, 2),
                                   (6, 10), (0, 38), (38, 0), (37, 1),
                                   (10, 38), (19, 19)])
def test_dec_cmp_scaled_matches_jax_at_the_boundaries(sa, sb):
    """±(10^38 - 1) and the int128 extremes, values equal after
    rescaling (1.00 against 1), zero against zero, opposite signs, and a
    scale difference of 38 (the 256-bit product's largest)."""
    rng = np.random.default_rng(sa * 41 + sb)
    a, b = _cmp_cases(rng)
    # values equal after rescaling: b = a * 10^(sb - sa) where it fits
    d = abs(sa - sb)
    m = min(10**15, 10**(38 - d) - 1)       # x * 10^d stays in range
    xs = [int(x) for x in rng.integers(-m, m + 1, 200)] + [m, -m, 0]
    scaled = [(x, x * 10**d) if sb >= sa else (x * 10**d, x) for x in xs]
    ea, eb = zip(*scaled)
    a = np.concatenate([a, _as_words(ea)])
    b = np.concatenate([b, _as_words(eb)])
    got = pd128.dec_cmp_scaled(torch.from_numpy(a), sa,
                               torch.from_numpy(b), sb)
    exp = jd128.dec_cmp_scaled(jnp.asarray(a), sa, jnp.asarray(b), sb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # and against exact rationals, wherever both sides are in range
    for i, (x, y) in enumerate(zip(_ints(a), _ints(b))):
        lhs, rhs = x * 10**max(sb - sa, 0), y * 10**max(sa - sb, 0)
        assert int(got[i]) == (lhs > rhs) - (lhs < rhs), (x, y)
    n_eq = len(scaled)
    assert (got[-n_eq:] == 0).all()


def _ints(words):
    out = []
    for lo, hi in words.tolist():
        v = (hi << 64) | (lo & (2**64 - 1))
        out.append(v)
    return out


CMP_SCHEMA = pa.schema([("big", pa.decimal128(38, 10)),
                        ("sum", pa.decimal128(22, 2)),
                        ("qty", pa.decimal128(12, 2)),
                        ("k", pa.int32())])


def _cmp_table(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    big = [D_(int(x) * 10**int(e)).scaleb(-10) for x, e in zip(
        rng.integers(-10**18, 10**18, n), rng.integers(0, 20, n))]
    big[:4] = [D_(f"{v}e-10") for v in (P38, -P38, 0, 300 * 10**10)]
    s = [D_(int(x)).scaleb(-2) for x in rng.integers(25_000, 35_000, n)]
    s[:4] = [D_(v).scaleb(-2) for v in (30000, 30001, 29999, -30000)]
    qty = [D_(int(x)).scaleb(-2) for x in rng.integers(-10**6, 10**6, n)]
    valid = rng.random(n) > 0.1
    cols = {"big": big, "sum": s, "qty": qty,
            "k": [int(x) for x in rng.integers(-400, 400, n)]}
    return pa.table({c: pa.array([v if ok or i < 4 else None
                                  for i, (v, ok) in enumerate(zip(vals,
                                                                  valid))],
                                 CMP_SCHEMA.field(c).type)
                     for c, vals in cols.items()})


CMP_EXPRS = {
    "q18_sum_gt_300": lambda E: E.col("sum") > E.lit(D_(300)),
    "d128_vs_d64_col": lambda E: E.col("big") <= E.col("qty"),
    "d128_vs_d128": lambda E: E.col("big") >= E.col("sum"),
    "d128_vs_int": lambda E: E.col("sum") < E.col("k"),
    "d128_eq_literal": lambda E: E.col("sum") == E.lit(D_("300.00")),
    "d128_ne_literal": lambda E: E.col("big") != E.lit(D_("300")),
    "product_vs_literal": lambda E: E.col("qty") * E.col("qty")
    > E.lit(D_("25000000")),
    "literal_on_the_left": lambda E: E.lit(D_("299.995")) < E.col("sum"),
}


@pytest.mark.parametrize("name", sorted(CMP_EXPRS))
def test_decimal128_comparisons_match_jax(name):
    got, exp = _eval_both(CMP_EXPRS[name], _cmp_table())
    assert got.schema == exp.schema
    assert got.equals(exp)
    vals = got.column("r").to_pylist()
    assert True in vals and False in vals and None in vals


def test_q18_threshold_rows():
    """sum_qty > 300 at scale 2 against scale 0: 300.00 is not over."""
    got, _ = _eval_both(CMP_EXPRS["q18_sum_gt_300"], _cmp_table())
    assert got.column("r").to_pylist()[:4] == [False, True, False, False]


@pytest.mark.parametrize("build", [
    lambda E: E.Cast(E.col("big"), "decimal(30,2)"),
    lambda E: E.Cast(E.col("qty") * E.col("qty"), E.BOOL),
    lambda E: E.EqNullSafe(E.col("sum"), E.col("big")),
])
def test_decimal128_casts_and_null_safe_equality_still_raise(build):
    """Above precision 18, + - * /, the six comparisons and every cast
    the JAX package binds are ported (`test_torch_divide_cast.py`; a
    cast named by a type string and a cast to boolean bind to the JAX
    package's type). The name is older than the port of <=>, which now
    binds to the JAX package's boolean too
    (`test_torch_eq_null_safe.py` holds its values)."""
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu_torch.columnar import dtypes as pdt
    ns = types.SimpleNamespace(col=px.col, Cast=px.Cast,
                               Dec=pdt.DecimalType, INT64=pdt.INT64,
                               BOOL=pdt.BOOL, EqNullSafe=px.EqNullSafe)
    jns = types.SimpleNamespace(col=jx.col, Cast=jx.Cast,
                                Dec=jdt.DecimalType, INT64=jdt.INT64,
                                BOOL=jdt.BOOL, EqNullSafe=jx.EqNullSafe)
    port = build(ns)
    want = build(jns).bind(JSchema.from_arrow(CMP_SCHEMA)).dtype
    assert repr(port.bind(PSchema.from_arrow(CMP_SCHEMA)).dtype) == \
        repr(want)
