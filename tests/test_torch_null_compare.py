"""Comparisons with a NULL literal in the PyTorch port (on the CPU)
against the JAX package.

A comparison that has a NULL side is all null, whatever the other
side's type, and `<=>` with NULL is true exactly where the other side
is null; IN over a list holding NULL then follows Kleene OR. The JAX
package answers the string cases on its host path and the integer ones
on the device; both answers are Spark's. Each case runs through
`select` and `filter` on a string and an int column, with the NULL on
either side; the Arrow results must be equal.
"""
import types

import pyarrow as pa
import pytest

import spark_rapids_tpu as st
from spark_rapids_tpu.expr import expressions as jx
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.expr import expressions as px

JAX = types.SimpleNamespace(col=jx.col, lit=jx.lit, X=jx)
PORT = types.SimpleNamespace(col=px.col, lit=px.lit, X=px)

TABLES = {"string": pa.table({"s": ["b", "a", None, "", "a"]}),
          "int": pa.table({"s": pa.array([2, 1, None, 0, 1], pa.int64())})}

def _one(kind):
    return "a" if kind == "string" else 1


CASES = {
    "eq": lambda E, k: E.col("s") == E.lit(None),
    "ne": lambda E, k: E.col("s") != E.lit(None),
    "lt": lambda E, k: E.col("s") < E.lit(None),
    "null_on_the_left": lambda E, k: E.X.Ge(E.lit(None), E.col("s")),
    "eq_null_safe": lambda E, k: E.X.EqNullSafe(E.col("s"), E.lit(None)),
    "eq_null_safe_left": lambda E, k: E.X.EqNullSafe(E.lit(None),
                                                     E.col("s")),
    "null_eq_null": lambda E, k: E.lit(None) == E.lit(None),
    "null_eq_null_safe": lambda E, k: E.X.EqNullSafe(E.lit(None),
                                                     E.lit(None)),
    "not_of_null_compare": lambda E, k: ~(E.col("s") == E.lit(None)),
    "or_with_a_value": lambda E, k: (E.col("s") == E.lit(None))
    | (E.col("s") == E.lit(_one(k))),
    "and_with_a_value": lambda E, k: (E.col("s") == E.lit(None))
    & (E.col("s") == E.lit(_one(k))),
    "isin_with_null": lambda E, k: E.col("s").isin(_one(k), None),
    "isin_only_null": lambda E, k: E.col("s").isin(None),
}


def _run(E, session, kind, name, how):
    df = session.create_dataframe(TABLES[kind])
    e = CASES[name](E, kind)
    if how == "select":
        return df.select(e.alias("r")).to_arrow()
    return df.filter(e).to_arrow()


@pytest.mark.parametrize("how", ["select", "filter"])
@pytest.mark.parametrize("kind", list(TABLES))
@pytest.mark.parametrize("name", list(CASES))
def test_null_literal_compare_equals_jax(name, kind, how):
    got = _run(PORT, pt.TpuSession(device="cpu"), kind, name, how)
    exp = _run(JAX, st.TpuSession(), kind, name, how)
    assert got.equals(exp)


def test_the_inputs_once_refused():
    """The two inputs that were refused: IN with a NULL and = NULL on a
    string column."""
    df = pt.TpuSession(device="cpu").create_dataframe(
        pa.table({"s": ["b", "a", None]}))
    assert df.select(px.col("s").isin("a", None).alias("r")).to_arrow() \
        .column("r").to_pylist() == [None, True, None]
    assert df.select((px.col("s") == px.lit(None)).alias("r")).to_arrow() \
        .column("r").to_pylist() == [None, None, None]


OFF = {"spark.rapids.tpu.sql.allowCpuFallback": False,
       "spark.rapids.tpu.sql.exec.degradeToHost.enabled": False}


@pytest.mark.parametrize("fallback", ["off", "on"])
def test_int_column_against_a_string_literal_stays_refused(fallback):
    """`col(int).isin("1")`: both device paths refuse it (ROADMAP C.1).
    With the host fallback off the port refuses it as the JAX package
    does; with it on (the default) both answer on the host, alike (and
    depart from Spark there: an int never equals a string)."""
    conf = OFF if fallback == "off" else {}
    q = {}
    for name, s, E in (("jax", st.TpuSession(dict(conf)), JAX),
                       ("port", pt.TpuSession(dict(conf), device="cpu"),
                        PORT)):
        q[name] = s.create_dataframe(TABLES["int"]).select(
            E.col("s").isin("1").alias("r"))
    if fallback == "off":
        with pytest.raises(jx.UnsupportedExpr) as je:
            q["jax"].to_arrow()
        with pytest.raises(px.UnsupportedExpr) as pe:
            q["port"].to_arrow()
        assert str(pe.value) == str(je.value)
    else:
        got = q["port"].to_arrow()
        assert got.equals(q["jax"].to_arrow())
        assert got.column("r").to_pylist() == [False, False, None, False,
                                               False]
