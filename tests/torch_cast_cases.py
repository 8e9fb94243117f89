"""The cases of the CAST parity tests (`test_torch_casts.py`,
`test_torch_cast_strings.py`): the types by their Spark names, a seeded
column of each with its edge values, which pairs the JAX `Cast` binds,
and the pairs whose JAX result cannot be returned or compared bit for
bit (see `test_torch_casts.py`)."""
import decimal

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.expr.expressions import UnsupportedExpr
from torch_parity import JAX_CONF, assert_same_column, project

TYPES = {"boolean": pa.bool_(), "tinyint": pa.int8(),
         "smallint": pa.int16(), "int": pa.int32(), "bigint": pa.int64(),
         "float": pa.float32(), "double": pa.float64(),
         "decimal(10,2)": pa.decimal128(10, 2),
         "decimal(30,4)": pa.decimal128(30, 4), "string": pa.string(),
         "date": pa.date32(), "timestamp": pa.timestamp("us", tz="UTC")}
N = 48


def _ints(rng, lo, hi, edge):
    v = rng.integers(max(lo, -5000), min(hi, 5000), N)
    v[:len(edge)] = edge
    return v


def column(name, seed=21):
    rng = np.random.default_rng(seed)
    nul = rng.random(N) < 0.15
    nul[:8] = False
    if name == "boolean":
        return pa.array(rng.random(N) < 0.5, mask=nul)
    if name in ("tinyint", "smallint", "int", "bigint"):
        ty = TYPES[name]
        info = np.iinfo(ty.to_pandas_dtype())
        v = _ints(rng, int(info.min), int(info.max),
                  [info.min, info.max, 0, -1, 1, 100, -128, 127])
        if name == "bigint":
            v[8:16] = rng.integers(-10 ** 15, 10 ** 15, 8)
        return pa.array(v.astype(info.dtype), mask=nul)
    if name in ("float", "double"):
        v = rng.normal(0, 1e4, N)
        v[:10] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, -2.5, 1e30,
                  -3e9, 123.456]
        return pa.array(v.astype(np.float32 if name == "float"
                                 else np.float64), mask=nul)
    if name.startswith("decimal"):
        p, s = (10, 2) if name == "decimal(10,2)" else (30, 4)
        top = 10 ** min(p, 17)
        v = [int(x) for x in rng.integers(-top, top, N)]
        v[:6] = [10 ** p - 1, -(10 ** p - 1), 0, 1, -1, 5 * 10 ** (s - 1)]
        return pa.array([None if m else decimal.Decimal(f"{x}E-{s}")
                         for x, m in zip(v, nul)], TYPES[name])
    if name == "string":
        vals = ["12", " -7 ", "+3", "1.5", "-0.25", "1e3", "2.5E-2", "abc",
                "", "  ", "9223372036854775807", "-9223372036854775808",
                "9223372036854775808", "99999999999999999999.5", "true",
                " FALSE", "y", "no", "1", "0", "NaN", "-Infinity", "inf",
                "1969-07-20", "2038-01-19", "1900-02-29", "2000-02-29",
                "2020-13-01", "0001-01-01", "9999-12-31",
                "2038-01-19 03:14:08", "1969-12-31T23:59:59",
                "2020-01-01 24:00:00", "1234.5678", "-0", ".5", "5.",
                "12345678901234567890123.456", "0.000001", "1e-7",
                "127", "128", "-129", "32768", "3e38", "1e309", "x1",
                "2020-1-1"]
        return pa.array(vals[:N], mask=nul[:len(vals[:N])])
    if name == "date":
        v = _ints(rng, -200000, 200000, [-719162, 2932896, -1, 0, 24855,
                                        -25567, 11016, 19000])
        return pa.array(v.astype(np.int32), pa.int32(), mask=nul).cast(
            pa.date32())
    v = rng.integers(-4 * 10 ** 15, 4 * 10 ** 15, N)
    v[:8] = [-62135596800000000, 253402300799999999, -1, 1, 0, 999999,
             -86400000001, 2147483648000001]
    return pa.array(v, pa.timestamp("us", tz="UTC"), mask=nul)


def _accepted(fr, to) -> bool:
    """Whether the JAX `Cast` binds this pair."""
    from spark_rapids_tpu.columnar.table import Schema
    from spark_rapids_tpu.expr.expressions import (Cast, UnsupportedExpr
                                                   as JUnsupported, col)
    try:
        Cast(col("x"), to).bind(Schema.from_arrow(pa.schema(
            [("x", TYPES[fr])])))
        return True
    except JUnsupported:
        return False


#: pairs the JAX package cannot return: its device path reads a
#: decimal128's [n, 2] words as one array, or emits one int64 where
#: [n, 2] words are due (C.17)
REFERENCE_BREAKS = {
    ("boolean", "decimal(30,4)"): lambda col: [
        None if b is None else decimal.Decimal(int(b)).quantize(
            decimal.Decimal("0.0001")) for b in col.to_pylist()],
    ("decimal(30,4)", "boolean"): lambda col: [
        None if v is None else v != 0 for v in col.to_pylist()],
}
#: decimal128 -> string: the JAX device path fails (only its host
#: fallback answers); the port refuses it at bind (C.17) and, with the
#: fallback on, answers on the host as the JAX package does (C.29)
PORT_REFUSES = {("decimal(30,4)", "string")}

#: double results of a division by a power of ten (C.3)
ONE_ULP = {(f, t) for f in ("decimal(10,2)", "decimal(30,4)", "timestamp")
           for t in ("float", "double")}


def _returnable(F, to):
    """cast(x AS to) in a form the JAX package can return (ROADMAP C.2);
    both packages run the same expression. A decimal64 goes through
    IF(cast IS NOT NULL, cast, NULL), which writes 0 into the null slots
    where the bare cast leaves the overflowed unscaled value that the
    JAX Arrow conversion refuses. A timestamp goes on to decimal(38, 6),
    its exact microseconds: the JAX conversion of a timestamp column
    with nulls goes through Python datetimes, which end at year 9999."""
    c = F.col("x").cast(to)
    if to == "decimal(10,2)":
        return F.when(c.isNotNull(), c)
    return c.cast("decimal(38,6)") if to == "timestamp" else c




def check_matrix(fr):
    """Every pair from `fr` that the JAX `Cast` binds: through both
    packages, or against `REFERENCE_BREAKS` / `PORT_REFUSES`."""
    col = column(fr)
    pairs = [to for to in TYPES if _accepted(fr, to)]
    direct = [to for to in pairs if (fr, to) not in REFERENCE_BREAKS
              and (fr, to) not in PORT_REFUSES]
    jt, ptab = project({"x": col},
                       lambda F: [_returnable(F, to) for to in direct])
    for i, to in enumerate(direct):
        assert_same_column(jt.column(i), ptab.column(i), f"{fr} -> {to}",
                           1 if (fr, to) in ONE_ULP else 0)
    # the device path: the host fallback off, as on the JAX side
    s = pt.TpuSession(JAX_CONF, device="cpu")
    for to in pairs:
        def run(session=s):
            return session.create_dataframe({"x": col}).select(
                PF.col("x").cast(to).alias("y")).to_arrow()
        if (fr, to) in PORT_REFUSES:
            with pytest.raises(UnsupportedExpr):
                run()
            # with the fallback on (both packages' default) each answers
            # on its host interpreter, alike
            want = st.TpuSession().create_dataframe({"x": col}).select(
                JF.col("x").cast(to).alias("y")).to_arrow()
            assert run(pt.TpuSession(device="cpu")).equals(want), (fr, to)
        elif (fr, to) in REFERENCE_BREAKS:
            assert run().column(0).to_pylist() == \
                REFERENCE_BREAKS[(fr, to)](col), (fr, to)


def check_refused(fr):
    """Every pair from `fr` that the JAX `Cast` refuses, the port refuses
    with UnsupportedExpr on its device path (the host fallback off)."""
    s = pt.TpuSession(JAX_CONF, device="cpu")
    for to in TYPES:
        if _accepted(fr, to):
            continue
        with pytest.raises(UnsupportedExpr):
            s.create_dataframe({"x": column(fr)}).select(
                PF.col("x").cast(to).alias("y")).to_arrow()
