"""The port's arithmetic, null, math, round, greatest / least, bitwise
and shift expressions against the JAX package on the CPU, over seeded
columns holding nulls, NaN, +-0.0, +-infinity and the minimum and
maximum integers (`torch_parity.project`).

Tolerance: exact for every integer, decimal and boolean result, and for
floor, ceil, rint, signum, sqrt, abs and negate of doubles (a zero's
sign included). At most 2 units in the last place for the rest: the
transcendental functions, pow and atan2 (XLA's CPU compile and torch
use different approximations), a double round (XLA multiplies by the
reciprocal of 10^d where the port divides, ROADMAP C.3) and math over a
decimal (the same division). Subnormal inputs are held apart: the JAX
package's CPU compile flushes them to zero, the port does not (ROADMAP
C.17).
"""
import importlib
import math

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu_torch.expr.expressions import UnsupportedExpr
from torch_parity import (I32_MAX, I32_MIN, I64_MAX, I64_MIN, JAX_CONF,
                          assert_same, project, ulps)

N = 96
SEED = 12


def _E(F):
    """The expressions module beside a functions module."""
    return importlib.import_module(
        F.__name__.rsplit(".", 1)[0] + ".expr.expressions")


def _data(seed=SEED, n=N):
    rng = np.random.default_rng(seed)
    a = rng.integers(-10 ** 12, 10 ** 12, n)
    b = rng.integers(-50, 50, n)
    a[:8] = [I64_MIN, I64_MAX, I64_MIN, 7, -7, 0, I64_MIN, I64_MAX]
    b[:8] = [-1, -1, 1, -3, -3, 0, 2, 0]
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    j = rng.integers(-40, 40, n).astype(np.int32)
    i[:6] = [I32_MIN, I32_MAX, I32_MIN, 5, -5, 0]
    j[:6] = [-1, -1, 31, 33, -1, 0]
    f = rng.normal(0, 50, n)
    f[:10] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 0.5, -0.5, 2.5, -1.0,
              1e300]
    g = rng.normal(0, 3, n)
    g[:10] = [1.0, 3.0, -3.0, 2.0, np.nan, 0.0, -0.0, -2.0, np.inf, 7.0]
    # decimal(12, 2) and (9, 3) unscaled values
    m = rng.integers(-10 ** 11, 10 ** 11, n)
    m[:4] = [10 ** 12 - 1, -(10 ** 12 - 1), 5, -5]
    k = rng.integers(-10 ** 6, 10 ** 6, n)
    k[:4] = [0, 7, -7, 1]
    nul = rng.random(n) < 0.15
    nul[:10] = False
    md = pa.array([None if x else int(v) for v, x in zip(m, nul)],
                  pa.int64())
    return {
        "a": pa.array(a, mask=nul), "b": pa.array(b),
        "i": pa.array(i, mask=nul), "j": pa.array(j),
        "t": pa.array((i % 100).astype(np.int8)),
        "f": pa.array(f, mask=nul), "g": pa.array(g),
        "m": _scaled(md, 12, 2), "k": _scaled(pa.array(k), 9, 3),
    }


def _scaled(unscaled, p, s):
    """A decimal(p, s) array of the given unscaled int64 values."""
    import decimal
    return pa.array([None if v is None else
                     decimal.Decimal(v).scaleb(-s)
                     for v in unscaled.to_pylist()], pa.decimal128(p, s))


EXACT = {
    "arith": lambda F: [
        _E(F).IntDivide(F.col("a"), F.col("b")),
        _E(F).IntDivide(F.col("i"), F.col("j")),
        _E(F).IntDivide(F.col("m"), F.col("k")),
        F.pmod("a", "b"), F.pmod("i", "j"), F.pmod("f", "g"),
        F.pmod("m", "k"), F.col("a") % F.col("b"),
        F.negate("a"), F.negate("f"), -F.col("i"), F.negate("m"),
        F.abs("a"), F.abs("i"), F.abs("f"), F.abs("m")],
    "nulls": lambda F: [
        F.isnull("a"), F.col("f").isNull(), F.col("m").isNotNull(),
        F.isnan("f"), F.isnan("g"),
        F.coalesce("a", "b"), F.coalesce(F.col("f"), F.lit(-1.5)),
        F.coalesce(F.lit(None), F.col("i"), F.lit(3))],
    "exact_math": lambda F: [
        F.floor("f"), F.ceil("f"), F.floor("a"), F.ceil("i"),
        F.signum("f"), F.signum("a"), F.sqrt("f"), F.sqrt("g"),
        _E(F).MathUnary("rint", F.col("f"))],
    "round": lambda F: [
        F.round("m", 1), F.round("m", 0), F.round("m", -2),
        F.round("k", 5), F.round("a", -3), F.round("i", 1),
        F.round("i", -1), F.round("t", -1)],
    "minmax": lambda F: [
        F.greatest("a", "b"), F.least("a", "b", F.lit(3)),
        F.greatest("f", "g"), F.least("f", "g"), F.greatest("i", "j"),
        F.least("m", F.negate("m")), F.greatest("k", "k")],
    "bitwise": lambda F: [
        F.bitwise_and("a", "b"), F.bitwise_or("i", "j"),
        F.bitwise_xor("a", "i"), F.bitwise_not("a"), F.bitwise_not("t"),
        F.shiftleft("i", "j"), F.shiftright("i", "j"),
        F.shiftleft("a", "b"), F.shiftright("a", F.lit(65)),
        F.shiftleft("t", F.lit(30)), F.shiftright("t", "j")],
}


@pytest.mark.parametrize("group", sorted(EXACT))
def test_exact(group):
    jt, ptab = project(_data(), EXACT[group])
    assert_same(jt, ptab, group)


TRANSCENDENTAL = ("exp", "log", "log10", "log2", "log1p", "sin", "cos",
                  "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
                  "cbrt", "expm1", "degrees", "radians")


def _ulp_exprs(F):
    E = _E(F)
    # sinh and cosh over "g" alone: see test_sinh_cosh_of_large_values
    out = [E.MathUnary(fn, F.col(c)) for fn in TRANSCENDENTAL
           for c in ("f", "g") if fn not in ("sinh", "cosh") or c == "g"]
    out += [F.pow("f", "g"), F.pow("g", F.lit(3)), F.pow("i", F.lit(0.5)),
            F.atan2("f", "g"), F.atan2("i", "a"),
            F.round("f", 2), F.round("f", -1), F.round("g", 0),
            F.sqrt("m"), F.log("k"), F.floor("m"), F.ceil("k")]
    return out


def test_within_two_ulps():
    data = _data()
    # the doubles over ranges where the functions stay finite
    rng = np.random.default_rng(SEED + 1)
    data["g"] = pa.array(np.concatenate([
        [0.0, -0.0, 1.0, -1.0, 0.5, np.nan, np.inf, 1e-8],
        rng.uniform(-2, 2, N - 8)]))
    jt, ptab = project(data, _ulp_exprs)
    assert_same(jt, ptab, "2 ulps", {c: 2 for c in jt.column_names})


def test_sinh_cosh_of_large_values():
    """The JAX package's CPU compile of sinh and cosh drifts to hundreds
    of ulps past |x| of about 20 (sinh(53.72) is 2^10 ulps off); the
    port's are within 2 ulps of the C library's, Python's `math`, over
    the whole finite range (ROADMAP C.17)."""
    x = np.concatenate([np.linspace(-700, 700, 57), [20.5, -33.3, 53.7]])
    _, ptab = project({"x": pa.array(x)}, lambda F: [
        _E(F).MathUnary("sinh", F.col("x")),
        _E(F).MathUnary("cosh", F.col("x"))])
    for i, fn in enumerate((math.sinh, math.cosh)):
        want = np.array([fn(v) for v in x])
        got = np.array(ptab.column(f"c{i}").to_pylist())
        assert (ulps(got, want) <= 2).all(), fn


def test_subnormal_inputs_are_not_flushed():
    """The JAX package's CPU compile flushes subnormal doubles to zero
    before sqrt, log and signum; the port computes with them, as numpy
    and Spark do (ROADMAP C.17)."""
    tiny = [1e-310, -4e-320, 2.2e-308]
    jt, ptab = project({"f": pa.array(tiny)}, lambda F: [
        F.sqrt("f"), F.log("f"), F.signum("f")])
    assert jt.column("c0").to_pylist()[0] == 0.0
    assert jt.column("c1").to_pylist()[0] is None
    x = np.array(tiny)
    assert ptab.column("c0").to_pylist()[:1] == [math.sqrt(1e-310)]
    got = ptab.column("c1").to_pylist()
    assert got[0] == pytest.approx(math.log(1e-310), rel=1e-15)
    assert got[1] is None
    assert ptab.column("c2").to_pylist() == list(np.sign(x))


@pytest.mark.parametrize("make", [
    lambda F: F.sqrt("w"), lambda F: F.round("w", 1),
    lambda F: F.negate("w"), lambda F: F.abs("w"),
    lambda F: F.greatest("w", "w"), lambda F: F.pmod("w", "w"),
    lambda F: _E(F).IntDivide(F.col("w"), F.col("w")),
    lambda F: F.col("w").cast("string"), lambda F: F.isnan("a"),
    lambda F: F.pow("s", "a"), lambda F: F.bitwise_and("f", "a")],
    ids=["sqrt", "round", "negate", "abs", "greatest", "pmod", "div",
         "to_string", "isnan_long", "pow_string", "bitwise_double"])
def test_refused_alike(make):
    """Where the JAX classes take no decimal128 (`_reject_d128`), the
    port refuses it at bind with the same UnsupportedExpr; sqrt and the
    cast to a string, which the JAX device path takes and then breaks
    on, are refused too (ROADMAP C.17). isnan of a long and pow of a
    string, which the JAX planner's type signatures refuse, and a
    bitwise op on a double, which its binder refuses, likewise."""
    import decimal
    data = {"w": pa.array([decimal.Decimal("1.5")] * 4,
                          pa.decimal128(30, 1)),
            "a": pa.array([1, 2, 3, 4]), "f": pa.array([1.5] * 4),
            "s": pa.array(["2"] * 4)}
    with pytest.raises(Exception):
        project(data, lambda F: [make(F)])
    import spark_rapids_tpu_torch as pt
    import spark_rapids_tpu_torch.functions as PF
    # the device path (the host fallback off, as on the JAX side)
    s = pt.TpuSession(JAX_CONF, device="cpu")
    with pytest.raises(UnsupportedExpr):
        s.create_dataframe(data).select(make(PF).alias("x")).to_arrow()
