"""`/`, `%` and the numeric casts (decimal128 on either side) of the
PyTorch port (on the CPU) against the JAX package.

Each expression is built in both packages over one Arrow table with
about 10 % nulls (int32, int64, doubles holding NaN, -0.0, 0.0 and
values past the integer ranges, decimal(5,2), decimal(12,2),
decimal(24,3) and decimal(38,0) near its limit, and divisors that are
0) and selected through a DataFrame; the Arrow results must be equal,
exact, the doubles bit for bit, with two exceptions that XLA's compiler
makes in the JAX package's programs: it turns a division by the constant
10^scale (a decimal's cast to double) into a product with the
reciprocal, so those doubles agree within one unit in the last place (two
after a further division; and bit for bit with the JAX package's eager emission, the quotient
its source writes); and it fuses `a - trunc(a / b) * b` (a float `%`)
into a multiply-add that rounds once, so a float `%` agrees within one
unit in the last place of the dividend. A cast
whose overflow leaves a value the JAX package cannot hand to Arrow is
held to the JAX package through a further cast to double, and to an
exact Python reference.
Covered: Spark's `/` result types
(doubles for non-decimals, `p1 - s1 + s2 + max(6, s1 + p2 + 1)` adjusted
for decimals, a decimal64 and a decimal128 result), a divisor of 0 or
-0.0 giving null, decimal overflow giving null, `%` with the dividend's
sign, `x % -1` on the minimum integer, decimal `%` across scales (above
precision 18 refused in both packages), and every cast between
integral, double, decimal64 and decimal128.
"""
import decimal
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr import expressions as jx
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.expr import expressions as px

D = decimal.Decimal
N = 1500

JAX = types.SimpleNamespace(col=jx.col, lit=jx.lit, T=jdt)
PORT = types.SimpleNamespace(col=px.col, lit=px.lit, T=pdt)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(7)

    def nulls():
        return rng.random(N) < 0.1

    def dec(vals, p, s):
        return pa.array([D(int(v)).scaleb(-s) for v in vals],
                        pa.decimal128(p, s), mask=nulls())
    f = rng.normal(size=N) * 1e3
    special = [np.nan, -0.0, 0.0, 1e30, -1e30, 2.5, -2.5, 0.5, -0.5,
               9.2e18, -9.3e18, 3e9, np.inf, -np.inf]
    f[:len(special)] = special
    g = rng.normal(size=N) * 10
    g[rng.random(N) < 0.05] = 0.0
    g[rng.random(N) < 0.05] = -0.0
    i = rng.integers(-100, 100, N).astype(np.int32)
    i[:3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0]
    j = rng.integers(-9, 9, N)
    j[:3] = [-1, -1, 0]
    big = rng.integers(-10**18, 10**18, N).astype(object) * 10**20 \
        + rng.integers(0, 10**18, N).astype(object)
    big[:2] = [10**38 - 1, -(10**38 - 1)]
    return pa.table({
        "i": pa.array(i, mask=nulls()),
        "j": pa.array(j, pa.int64(), mask=nulls()),
        "f": pa.array(f, mask=nulls()),
        "g": pa.array(g, mask=nulls()),
        "a": dec(rng.integers(-99999, 99999, N), 5, 2),
        "b": dec(np.where(rng.random(N) < 0.1, 0,
                          rng.integers(-999, 999, N)), 3, 1),
        "c": dec(rng.integers(-10**11, 10**11, N), 12, 2),
        "d": dec(rng.integers(-10**18, 10**18, N) * 1000
                 + rng.integers(0, 1000, N), 24, 3),
        "e": pa.array([D(int(v)) for v in big], pa.decimal128(38, 0),
                      mask=nulls())})


def _dec(E, p, s):
    return E.T.DecimalType(p, s)


EXPRS = {
    "float_div": lambda E: E.col("f") / E.col("g"),
    "float_div_literal_zero": lambda E: E.col("f") / E.lit(0.0),
    "float_div_negative_zero": lambda E: E.col("f") / E.lit(-0.0),
    "int_div_is_double": lambda E: E.col("i") / E.col("j"),
    "int_div_zero": lambda E: E.col("i") / E.lit(0),
    "literal_over_column": lambda E: E.lit(100.0) / E.col("g"),
    "dec64_result": lambda E: E.col("a") / E.col("b"),
    "dec128_result": lambda E: E.col("c") / E.col("c"),
    "dec128_over_dec": lambda E: E.col("d") / E.col("c"),
    "dec128_over_small": lambda E: E.col("d") / E.col("b"),
    "dec_overflow": lambda E: E.col("e") / E.col("b"),
    "dec_over_int": lambda E: E.col("a") / E.col("i"),
    "dec_over_long": lambda E: E.col("c") / E.col("j"),
    "dec_over_double": lambda E: E.col("c") / E.col("g"),
    "int_rem": lambda E: E.col("i") % E.col("j"),
    "int_rem_literal": lambda E: E.col("i") % E.lit(7),
    "min_int_rem_minus_one": lambda E: E.col("i") % E.lit(-1),
    "long_rem": lambda E: E.col("j") % E.col("i"),
    "dec_rem": lambda E: E.col("a") % E.col("b"),
    "dec_rem_int": lambda E: E.col("c") % E.col("i"),
    "long_plus_dec_widens_to_dec128": lambda E: E.col("j") + E.col("c"),
    "d128_to_double": lambda E: E.col("d").cast(E.T.FLOAT64),
    "d128_38_to_double": lambda E: E.col("e").cast(E.T.FLOAT64),
    "d128_to_float": lambda E: E.col("d").cast(E.T.FLOAT32),
    "d128_to_long": lambda E: E.col("d").cast(E.T.INT64),
    "d128_to_int": lambda E: E.col("d").cast(E.T.INT32),
    "d128_to_byte": lambda E: E.col("e").cast(E.T.INT8),
    "d128_to_dec64_down": lambda E: E.col("d").cast(_dec(E, 18, 1)),
    "d128_to_dec128_up": lambda E: E.col("d").cast(_dec(E, 30, 6)),
    "d128_38_rescale_overflow": lambda E: E.col("e").cast(_dec(E, 38, 2)),
    "dec64_to_dec128": lambda E: E.col("c").cast(_dec(E, 20, 4)),
    "int_to_dec128": lambda E: E.col("i").cast(_dec(E, 25, 5)),
    "long_to_dec128_overflow": lambda E: E.col("j").cast(_dec(E, 20, 19)),
    "double_to_dec128": lambda E: E.col("f").cast(_dec(E, 30, 4)),
    "double_to_dec128_overflow": lambda E: E.col("f").cast(_dec(E, 19, 0)),
    "double_to_dec64_half_up": lambda E: E.col("g").cast(_dec(E, 6, 0)),
    "double_to_int": lambda E: E.col("f").cast(E.T.INT32),
    "double_to_short": lambda E: E.col("f").cast(E.T.INT16),
    "product_to_double": lambda E: (E.col("c") * E.col("c"))
    .cast(E.T.FLOAT64),
}


def _both(table, build):
    got = pt.TpuSession(device="cpu").create_dataframe(table).select(
        build(PORT).alias("r")).to_arrow()
    exp = st.TpuSession().create_dataframe(table).select(
        build(JAX).alias("r")).to_arrow()
    return got, exp


def _bits(column):
    """A double column as int64 bits (NaN and -0.0 compared exactly);
    any other column as is."""
    if pa.types.is_floating(column.type):
        arr = column.combine_chunks()
        width = {32: np.int32, 64: np.int64}[arr.type.bit_width]
        vals = arr.fill_null(0).to_numpy().view(width)
        return [None if not v else int(x)
                for x, v in zip(vals, arr.is_valid().to_numpy(
                    zero_copy_only=False))]
    return column.to_pylist()


#: the results that pass through a decimal's cast to double, and the
#: units in the last place they may differ by (a division after the
#: cast adds one)
VIA_DECIMAL_TO_DOUBLE = {"dec_over_double": 2, "d128_to_double": 1,
                         "product_to_double": 1}


def _within_an_ulp(got, exp, ulps=1):
    g, e = (c.column("r").combine_chunks() for c in (got, exp))
    assert g.is_valid().equals(e.is_valid())
    ok = g.is_valid().to_numpy(zero_copy_only=False)
    gv, ev = (c.fill_null(0).to_numpy()[ok] for c in (g, e))
    assert np.array_equal(np.isnan(gv), np.isnan(ev))
    fin = ~np.isnan(gv)
    np.testing.assert_array_max_ulp(gv[fin], ev[fin], maxulp=ulps)


@pytest.mark.parametrize("name", list(EXPRS))
def test_equals_jax(table, name):
    got, exp = _both(table, EXPRS[name])
    assert got.schema == exp.schema
    if name in VIA_DECIMAL_TO_DOUBLE:
        _within_an_ulp(got, exp, VIA_DECIMAL_TO_DOUBLE[name])
    else:
        assert _bits(got.column("r")) == _bits(exp.column("r"))


@pytest.mark.parametrize("p,s", [(24, 3), (38, 0), (38, 10), (12, 2)])
def test_decimal_to_double_is_the_eager_quotient(p, s):
    """Bit for bit the JAX package's cast evaluated op by op:
    (hi 2^64 + unsigned lo) / 10^s for a decimal128, x / 10^s for a
    decimal64."""
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar.table import Schema as JSchema
    from spark_rapids_tpu.ops.kernel_utils import CV as JCV
    from spark_rapids_tpu_torch.columnar.table import Schema as PSchema
    from spark_rapids_tpu_torch.ops.kernel_utils import CV as PCV
    rng = np.random.default_rng(p + s)
    n = 4000
    lim = 10 ** p - 1
    vals = [int(a) * int(b) % lim * (1 if c else -1) for a, b, c in zip(
        rng.integers(1, 2**62, n), rng.integers(1, 2**62, n),
        rng.integers(0, 2, n))]
    vals[:2] = [lim, -lim]
    if p > 18:
        data = np.array([[v & (2**64 - 1), v >> 64] for v in vals],
                        dtype=object)
        data[:, 0] = [x - 2**64 if x >= 2**63 else x for x in data[:, 0]]
        data = data.astype(np.int64)
    else:
        data = np.array(vals, np.int64)
    valid = rng.random(n) > 0.1
    schema = pa.schema([("x", pa.decimal128(p, s))])
    je = jx.Cast(jx.col("x"), jdt.FLOAT64).bind(JSchema.from_arrow(schema))
    jout = je.emit(jx.EmitCtx([JCV(jnp.asarray(data), jnp.asarray(valid))],
                              n))
    pe = px.Cast(px.col("x"), pdt.FLOAT64).bind(PSchema.from_arrow(schema))
    pout = pe.emit(px.EmitCtx([PCV(torch.from_numpy(data),
                                   torch.from_numpy(valid))], n,
                              torch.device("cpu")))
    assert np.array_equal(np.asarray(jout.data).view(np.int64),
                          pout.data.numpy().view(np.int64))


def test_float_remainder_within_an_ulp_of_the_dividend(table):
    got, exp = _both(table, lambda E: E.col("f") % E.col("g"))
    g, e = (c.column("r").to_numpy(zero_copy_only=False)
            for c in (got, exp))
    assert np.array_equal(np.isnan(g), np.isnan(e))
    f = table.column("f").to_numpy(zero_copy_only=False)
    ok = ~np.isnan(g)
    assert np.all(np.abs(g[ok] - e[ok]) <= np.spacing(np.abs(f[ok])))


def _rescaled(values, s, p):
    """An exact decimal cast to decimal(p, s): HALF_UP to scale s, None
    past precision p (the unscaled ints)."""
    out = []
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        for v in values:
            u = None if v is None else int(v.quantize(
                decimal.Decimal(1).scaleb(-s),
                rounding=decimal.ROUND_HALF_UP).scaleb(s))
            out.append(None if u is None or abs(u) >= 10 ** p else u)
    return out


def _to_dec_reference(x, p, s):
    """A double's cast to decimal(p, s) as the JAX package computes it:
    x * 10^s rounded half away from zero, None past the precision."""
    xf = x * (10.0 ** s)
    scaled = np.where(xf >= 0, np.floor(xf + 0.5), np.ceil(xf - 0.5))
    ok = (np.abs(scaled) < 10 ** p) & ~np.isnan(x)
    return [int(v) if k else None for v, k in zip(scaled, ok)]


OVERFLOWS = {
    "d128_to_dec64_overflow": (
        lambda E: E.col("d").cast(_dec(E, 18, 1)),
        lambda t: _rescaled(t.column("d").to_pylist(), 1, 18), 1),
    "d128_to_dec128_overflow": (
        lambda E: E.col("e").cast(_dec(E, 36, 0)),
        lambda t: _rescaled(t.column("e").to_pylist(), 0, 36), 0),
    "double_to_dec64_overflow": (
        lambda E: E.col("f").cast(_dec(E, 12, 2)),
        lambda t: [None if v is None else r for v, r in zip(
            t.column("f").to_pylist(), _to_dec_reference(
                t.column("f").to_numpy(zero_copy_only=False), 12, 2))],
        2),
}


@pytest.mark.parametrize("name", list(OVERFLOWS))
def test_overflowing_cast(table, name):
    build, reference, scale = OVERFLOWS[name]
    # through a double, which the JAX package can hand back
    got, exp = _both(table, lambda E: build(E).cast(E.T.FLOAT64))
    _within_an_ulp(got, exp)
    out = pt.TpuSession(device="cpu").create_dataframe(table).select(
        build(PORT).alias("r")).to_arrow().column("r").to_pylist()
    want = reference(table)
    assert any(w is None for w in want) and any(w is not None
                                                for w in want)
    wide = decimal.Context(prec=80)
    assert [None if v is None else int(v.scaleb(scale, wide))
            for v in out] == want


def test_division_result_types_follow_spark(table):
    """decimal(5,2) / decimal(3,1) is decimal(10,6); decimal(12,2) /
    decimal(12,2) decimal(27,15); decimal(24,3) / decimal(12,2) clamps
    to decimal(38,15)."""
    got = pt.TpuSession(device="cpu").create_dataframe(table).select(
        (px.col("a") / px.col("b")).alias("x"),
        (px.col("c") / px.col("c")).alias("y"),
        (px.col("d") / px.col("c")).alias("z")).to_arrow()
    assert [got.schema.field(n).type for n in "xyz"] == [
        pa.decimal128(10, 6), pa.decimal128(27, 15),
        pa.decimal128(38, 15)]


def test_divisor_zero_and_negative_zero_give_null(table):
    got, _ = _both(table, EXPRS["float_div"])
    g = table.column("g").to_numpy(zero_copy_only=False)
    zero = np.nan_to_num(g, nan=1.0) == 0
    out = got.column("r").is_null().to_numpy(zero_copy_only=False)
    assert zero.any() and out[zero].all()


def test_decimal128_remainder_is_refused_in_both(table):
    with pytest.raises(jx.UnsupportedExpr):
        (jx.col("d") % jx.col("c")).bind(
            st.TpuSession().create_dataframe(table)._plan.schema)
    with pytest.raises(px.UnsupportedExpr):
        pt.TpuSession(device="cpu").create_dataframe(table).select(
            (px.col("d") % px.col("c")).alias("r")).to_arrow()


def test_reflected_division():
    at = pa.table({"g": [2.0, 0.0, -4.0, None]})
    out = pt.TpuSession(device="cpu").create_dataframe(at).select(
        (100.0 / px.col("g")).alias("r")).to_arrow()
    assert out.column("r").to_pylist() == [50.0, None, -25.0, None]


def test_type_string_casts_stay_unported():
    """A cast named by a type string, unported until the scalar slice,
    now resolves the name as the JAX package does (`from_name`), and an
    unknown name raises ValueError in both."""
    from spark_rapids_tpu.expr import expressions as jx
    assert repr(px.col("a").cast("double").to) == \
        repr(jx.col("a").cast("double").to)
    assert repr(px.col("a").cast("decimal(20, 3)").to) == \
        repr(jx.col("a").cast("decimal(20, 3)").to)
    for E in (px, jx):
        with pytest.raises(ValueError):
            E.col("a").cast("varchar")
