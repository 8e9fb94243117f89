"""Null-safe equality (<=>) over decimal128 operands in the PyTorch port
(on the CPU) against the JAX package.

Two nulls are equal, a null and a value are not, and two values are
equal when both of their (lo, hi) words are, at one scale. The rows:
pairs that differ only in the high word, a negative value against its
two's-complement neighbour, null against null and against a value, and
decimal(38,0) at its extremes. The JAX package's device path refuses
this comparison, so its side runs at its default conf, where its host
interpreter answers; the port runs it on the device path. Exact.
"""
import decimal

import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF

D = decimal.Decimal
HI = D(2 ** 64)             # one unit of the high word, unscaled
MAX38 = D("9" * 38)
MIN38 = D("-" + "9" * 38)   # unary minus would round at 28 digits
MAX38_LESS1 = D("9" * 37 + "8")


def _case(name):
    if name == "high_word":
        a = [D("1.00"), HI / 100, HI / 100 + D("0.01"), D(-(2 ** 64)) / 100]
        b = [HI / 100 + D("1.00"), D("0.00"), D("0.01"), D("0.00")]
        return a, b, pa.decimal128(30, 2)
    if name == "negative_neighbour":
        # -1 is all ones in both words; its neighbours differ in one
        a = [D(-1), D(-1), D(-(2 ** 64)), D(-(2 ** 64) - 1), D(-(2 ** 63))]
        b = [D(-1), D(-2), D(-(2 ** 64) + 1), D(-(2 ** 64)),
             D(-(2 ** 63) - 1)]
        return a, b, pa.decimal128(25, 0)
    if name == "nulls":
        a = [None, None, D("3.5"), D("3.5")]
        b = [None, D("3.5"), None, D("3.5")]
        return a, b, pa.decimal128(20, 1)
    if name == "extremes":
        a = [MAX38, MIN38, MAX38, MIN38, D(0)]
        b = [MAX38, MIN38, MAX38_LESS1, MAX38, D(0)]
        return a, b, pa.decimal128(38, 0)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["high_word", "negative_neighbour",
                                  "nulls", "extremes"])
def test_decimal128_eq_null_safe_equals_jax(name):
    a, b, ty = _case(name)
    at = pa.table({"a": pa.array(a, ty), "b": pa.array(b, ty)})
    got = pt.TpuSession(device="cpu").create_dataframe(at).select(
        PF.EqNullSafe(PF.col("a"), PF.col("b")).alias("r"),
        PF.EqNullSafe(PF.col("b"), PF.col("a")).alias("s")).to_arrow()
    want = st.TpuSession().create_dataframe(at).select(
        JF.EqNullSafe(JF.col("a"), JF.col("b")).alias("r"),
        JF.EqNullSafe(JF.col("b"), JF.col("a")).alias("s")).to_arrow()
    assert got.column("r").to_pylist() == want.column("r").to_pylist()
    assert got.column("s").to_pylist() == want.column("s").to_pylist()
    # and the values themselves: never null
    expect = [(x is None and y is None) or
              (x is not None and y is not None and x == y)
              for x, y in zip(a, b)]
    assert got.column("r").to_pylist() == expect


def test_decimal128_eq_null_safe_across_scales():
    """decimal(30,2) <=> decimal(25,0): compared at one scale."""
    at = pa.table({"a": pa.array([D("5.00"), D("5.01"), None],
                                 pa.decimal128(30, 2)),
                   "b": pa.array([D(5), D(5), None], pa.decimal128(25, 0))})
    got = pt.TpuSession(device="cpu").create_dataframe(at).select(
        PF.EqNullSafe(PF.col("a"), PF.col("b")).alias("r")).to_arrow()
    want = st.TpuSession().create_dataframe(at).select(
        JF.EqNullSafe(JF.col("a"), JF.col("b")).alias("r")).to_arrow()
    assert got.column("r").to_pylist() == want.column("r").to_pylist() \
        == [True, False, True]
