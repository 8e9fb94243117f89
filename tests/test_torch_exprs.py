"""Expression evaluation of the PyTorch port against the JAX package.

Q6's predicate and `l_extendedprice * l_discount`, the comparisons,
decimal arithmetic, Kleene logic and casts (with decimal overflow to
null) bind against one schema in both packages and evaluate on the same
numpy inputs, nulls included. The port's data and validity must equal
the JAX package's element for element. Tolerance: exact.
"""
import datetime
import decimal
import types

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.columnar.table import Schema as JSchema
from spark_rapids_tpu.expr import expressions as jx
from spark_rapids_tpu.ops.kernel_utils import CV as JCV
from spark_rapids_tpu_torch import NotPorted
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.columnar.table import Schema as PSchema
from spark_rapids_tpu_torch.expr import expressions as px
from spark_rapids_tpu_torch.ops.kernel_utils import CV as PCV

D = decimal.Decimal
N = 2048

SCHEMA = pa.schema([("l_quantity", pa.decimal128(12, 2)),
                    ("l_extendedprice", pa.decimal128(12, 2)),
                    ("l_discount", pa.decimal128(4, 2)),
                    ("l_shipdate", pa.int32()),
                    ("l_orderkey", pa.int64()),
                    ("flag", pa.bool_()),
                    ("other", pa.bool_())])

JAX = types.SimpleNamespace(col=jx.col, lit=jx.lit, Cast=jx.Cast,
                            Dec=jdt.DecimalType, INT32=jdt.INT32,
                            INT64=jdt.INT64, FLOAT64=jdt.FLOAT64,
                            BOOL=jdt.BOOL)
PORT = types.SimpleNamespace(col=px.col, lit=px.lit, Cast=px.Cast,
                             Dec=pdt.DecimalType, INT32=pdt.INT32,
                             INT64=pdt.INT64, FLOAT64=pdt.FLOAT64,
                             BOOL=pdt.BOOL)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0):
    """Unscaled lineitem-like buffers with ~15% nulls and extremes."""
    rng = np.random.default_rng(seed)
    data = [rng.integers(1, 51, N).astype(np.int64) * 100,
            rng.integers(90_000, 10_500_000, N).astype(np.int64),
            rng.integers(0, 11, N).astype(np.int64),
            rng.integers(8036, 10591, N).astype(np.int32),
            rng.integers(-2**63, 2**63 - 1, N, endpoint=True,
                         dtype=np.int64),
            rng.integers(0, 2, N).astype(bool),
            rng.integers(0, 2, N).astype(bool)]
    data[0][:2] = [10**12 - 1, -(10**12 - 1)]     # decimal(12,2) extremes
    data[1][:2] = [10**12 - 1, -(10**12 - 1)]
    data[2][:2] = [9999, -9999]                   # decimal(4,2) extremes
    data[4][:3] = [2**63 - 1, -2**63, 9999]
    valid = [rng.random(N) > 0.15 for _ in data]
    return data, valid


def _eval(build, ns, schema, mk_cv, ctx_of):
    data, valid = _inputs()
    e = build(ns).bind(schema)
    cvs = [mk_cv(d, v) for d, v in zip(data, valid)]
    cv = e.emit(ctx_of(cvs))
    return e.dtype, np.asarray(cv.data), np.asarray(cv.validity)


def _both(build):
    jd, jdat, jval = _eval(
        build, JAX, JSchema.from_arrow(SCHEMA),
        lambda d, v: JCV(jnp.asarray(d), jnp.asarray(v)),
        lambda cvs: jx.EmitCtx(cvs, N))
    pd_, pdat, pval = _eval(
        build, PORT, PSchema.from_arrow(SCHEMA),
        lambda d, v: PCV(torch.from_numpy(d), torch.from_numpy(v)),
        lambda cvs: px.EmitCtx(cvs, N, torch.device("cpu")))
    assert repr(pd_) == repr(jd)
    np.testing.assert_array_equal(pval, jval)
    np.testing.assert_array_equal(pdat, jdat)
    return pdat, pval


def q6_predicate(E):
    col, lit = E.col, E.lit
    return ((col("l_shipdate") >= 8766) & (col("l_shipdate") < 9131)
            & (col("l_discount") >= lit(D("0.05")))
            & (col("l_discount") <= lit(D("0.07")))
            & (col("l_quantity") < lit(D("24"))))


CASES = {
    "q6_predicate": q6_predicate,
    "q6_revenue_product": lambda E: E.col("l_extendedprice")
    * E.col("l_discount"),
    "lt_dec_scale_up": lambda E: E.col("l_quantity") < E.lit(D("24")),
    "le_dec": lambda E: E.col("l_discount") <= E.lit(D("0.07")),
    "gt_dec_finer_literal": lambda E: E.col("l_discount")
    > E.lit(D("0.055")),
    "ge_int": lambda E: E.col("l_shipdate") >= 8766,
    "eq_int_vs_long_literal": lambda E: E.col("l_shipdate") == 2**40,
    "ne_long": lambda E: E.col("l_orderkey") != 9999,
    "int_vs_decimal": lambda E: E.col("l_shipdate") < E.lit(D("9000.5")),
    "null_literal_compare": lambda E: E.col("l_shipdate") < E.lit(None),
    "add_dec_scales": lambda E: E.col("l_extendedprice")
    + E.col("l_discount"),
    "sub_dec_int": lambda E: E.col("l_quantity") - E.col("l_shipdate"),
    "mul_dec_literal": lambda E: E.col("l_extendedprice") * E.lit(D("1.5")),
    "long_wraps": lambda E: E.col("l_orderkey") * 3 + 1,
    "kleene_and": lambda E: E.col("flag") & E.col("other"),
    "kleene_or": lambda E: E.col("flag") | E.col("other"),
    "kleene_not": lambda E: ~(E.col("flag") | (E.col("l_shipdate") > 9000)),
    "between": lambda E: E.col("l_discount").between(E.lit(D("0.05")),
                                                     E.lit(D("0.07"))),
    "cast_dec_narrow_overflow": lambda E: E.Cast(E.col("l_extendedprice"),
                                                 E.Dec(5, 2)),
    "cast_dec_round_half_up": lambda E: E.Cast(E.col("l_quantity"),
                                               E.Dec(10, 0)),
    "cast_dec_scale_down_overflow": lambda E: E.Cast(
        E.col("l_extendedprice"), E.Dec(6, 1)),
    "cast_long_to_dec_overflow": lambda E: E.Cast(E.col("l_orderkey"),
                                                  E.Dec(4, 0)),
    "cast_int_to_dec": lambda E: E.Cast(E.col("l_shipdate"), E.Dec(10, 0)),
    "cast_dec_to_int": lambda E: E.Cast(E.col("l_extendedprice"), E.INT32),
    "cast_dec_to_double": lambda E: E.Cast(E.col("l_discount"), E.FLOAT64),
    "cast_int_to_long": lambda E: E.Cast(E.col("l_shipdate"), E.INT64),
    "cast_bool_to_dec": lambda E: E.Cast(E.col("flag"), E.Dec(3, 1)),
    "cast_bool_to_int": lambda E: E.Cast(E.col("flag"), E.INT32),
    "cast_int_to_double": lambda E: E.Cast(E.col("l_shipdate"), E.FLOAT64),
    "cast_long_to_int_wraps": lambda E: E.Cast(E.col("l_orderkey"),
                                               E.INT32),
    "cast_dec_to_long": lambda E: E.Cast(E.col("l_quantity"), E.INT64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emit_matches_jax(case):
    _both(CASES[case])


def test_decimal_overflow_gives_null():
    """The narrowing casts above do null some rows (not a vacuous pass)."""
    _, valid = _both(CASES["cast_dec_narrow_overflow"])
    data, in_valid = _inputs()
    fits = np.abs(data[1]) < 10**5
    np.testing.assert_array_equal(valid, in_valid[1] & fits)
    assert (in_valid[1] & ~fits).any()


@pytest.mark.parametrize("build", [
    # a cast named by a type string
    lambda E: E.Cast(E.col("l_extendedprice") * E.col("l_quantity"),
                     "decimal(30,4)"),
    lambda E: E.Cast(E.col("l_quantity"), E.BOOL),            # to boolean
    # a timestamp literal against a date
    lambda E: E.lit(datetime.datetime(1998, 1, 1)) == E.col("l_shipdate"),
    lambda E: E.Cast(E.col("l_orderkey"), "int"),
    lambda E: E.Cast(E.col("l_shipdate"), E.BOOL),
])
def test_unported_expressions_raise(build):
    """Five expressions the port once refused with NotPorted, ported
    since (type-string casts, casts to boolean, timestamp literals):
    each binds in the port to the JAX package's type, or raises where
    the JAX package raises, an exception of the same name (a timestamp
    against a date cannot be promoted; a date does not cast to
    boolean)."""
    try:
        want = build(JAX).bind(JSchema.from_arrow(SCHEMA)).dtype
    except Exception as e:      # noqa: BLE001 - the JAX package's refusal
        with pytest.raises(Exception) as got:
            build(PORT).bind(PSchema.from_arrow(SCHEMA))
        assert type(got.value).__name__ == type(e).__name__
        return
    assert repr(build(PORT).bind(PSchema.from_arrow(SCHEMA)).dtype) == \
        repr(want)


def test_string_against_non_string_compare_is_refused_like_jax():
    with pytest.raises(jx.UnsupportedExpr):
        (jx.lit("a") == jx.col("l_shipdate")).bind(JSchema.from_arrow(SCHEMA))
    with pytest.raises(px.UnsupportedExpr, match="string/non-string"):
        (px.lit("a") == px.col("l_shipdate")).bind(PSchema.from_arrow(SCHEMA))
