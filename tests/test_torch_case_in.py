"""IF, CASE WHEN, IN and `functions.when` of the PyTorch port (on the
CPU) against the JAX package.

The same expression is built in both packages over one Arrow table of
random columns with about 15 % nulls (int32, int64, string, two decimal
scales, bool, a date-like int32) and selected through a DataFrame; the
Arrow results must be equal (exact). Covered: a null predicate takes the
ELSE branch; CASE WHEN without ELSE (and a `when` chain used directly as an
expression) gives null; branch types cast to the output type (the
non-null branch's); string, decimal and integer branches; nested CASE;
IN over int and string lists, an empty list and a list holding NULL;
CASE WHEN inside a grouped sum (int32 into int64, as Q12).
"""
import decimal
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.expr import expressions as jx
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.expr import expressions as px

D = decimal.Decimal
N = 3000

JAX = types.SimpleNamespace(col=jx.col, lit=jx.lit, F=JF, If=jx.If,
                            CaseWhen=jx.CaseWhen, In=jx.In)
PORT = types.SimpleNamespace(col=px.col, lit=px.lit, F=PF, If=px.If,
                             CaseWhen=px.CaseWhen, In=px.In)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _table(seed=0):
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(N) < 0.15
    words = np.array(["a", "bb", "ccc", "", "MAIL", "SHIP", "1-URGENT"])
    return pa.table({
        "i": pa.array(rng.integers(-30, 30, N).astype(np.int32),
                      mask=nulls()),
        "j": pa.array(rng.integers(-5, 5, N), mask=nulls()),
        "s": pa.array(words[rng.integers(0, len(words), N)], mask=nulls()),
        "d": pa.array([D(int(v)).scaleb(-2)
                       for v in rng.integers(-10**6, 10**6, N)],
                      pa.decimal128(12, 2), mask=nulls()),
        "e": pa.array([D(int(v)).scaleb(-2) for v in rng.integers(0, 11, N)],
                      pa.decimal128(4, 2), mask=nulls()),
        "b": pa.array(rng.integers(0, 2, N).astype(bool), mask=nulls()),
        "day": pa.array(rng.integers(9131, 9862, N).astype(np.int32)),
        "g": pa.array(rng.integers(0, 5, N).astype(np.int32))})


CASES = {
    "if_int": lambda E: E.F.when(E.col("i") > 0, E.col("i"))
    .otherwise(E.col("i") * 2),
    "null_predicate_takes_else": lambda E: E.F.when(E.col("b"), 1)
    .otherwise(0),
    "if_node": lambda E: E.If(E.col("i") < E.col("j"), E.col("j"),
                              E.lit(-1)),
    "no_else_is_null": lambda E: E.CaseWhen(
        [(E.col("i") > 10, E.lit(1)), (E.col("i") < -10, E.lit(2))]),
    "when_chain_without_else": lambda E: E.F.when(E.col("i") > 10, 1)
    .when(E.col("i") < -10, 2),
    "null_then_branch_takes_else_type": lambda E: E.F.when(
        E.col("b"), E.lit(None)).otherwise(E.col("j")),
    "narrowing_else": lambda E: E.F.when(E.col("b"), 7)
    .otherwise(E.col("j")),
    "widening_else": lambda E: E.F.when(E.col("b"), E.col("j"))
    .otherwise(7),
    "string_branches": lambda E: E.F.when(E.col("s") == E.lit("a"),
                                          E.col("s"))
    .otherwise(E.lit("zz")),
    "string_no_else": lambda E: E.F.when(E.col("i") > 0, E.col("s")),
    "decimal_branches": lambda E: E.F.when(E.col("b"), E.col("d"))
    .otherwise(E.col("e")),
    "decimal_arith_branch": lambda E: E.F.when(
        E.col("e") > E.lit(D("0.05")),
        E.col("d") * (E.lit(D("1")) - E.col("e"))).otherwise(E.col("d")),
    "year_of_day": lambda E: E.F.when(E.col("day") <= 9495, 1995)
    .otherwise(1996),
    "nested_case": lambda E: E.F.when(E.col("i").isin(1, 2, 3),
                                      E.lit("x"))
    .when(E.col("s").isin("bb", "MAIL"), E.lit("y")).otherwise(E.lit("z")),
    "three_branches": lambda E: E.F.when(E.col("i") < -10, E.col("j"))
    .when(E.col("i") < 0, E.col("j") * 10).when(E.col("i") < 10, 0)
    .otherwise(E.lit(None)),
    "in_int": lambda E: E.col("i").isin(1, 2, 3, -7),
    "in_int64": lambda E: E.col("j").isin(0, 4),
    "in_one": lambda E: E.col("i").isin(5),
    "in_string": lambda E: E.col("s").isin("MAIL", "SHIP"),
    "in_string_empty_word": lambda E: E.col("s").isin("", "ccc"),
    "in_with_null": lambda E: E.col("i").isin(1, None),
    "in_empty": lambda E: E.In(E.col("i"), []),
    "in_decimal": lambda E: E.col("e").isin(E.lit(D("0.05")),
                                            E.lit(D("0.10"))),
    "not_in": lambda E: ~E.col("s").isin("a", "bb"),
    "q12_flag": lambda E: E.F.when(
        E.col("s").isin("1-URGENT", "2-HIGH"), 1).otherwise(0),
}


def _select(E, session, expr):
    df = session.create_dataframe(_table())
    return df.select(E.col("i"), expr.alias("out")).to_arrow()


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_and_in_equal_jax(case):
    got = _select(PORT, pt.TpuSession(device="cpu"), CASES[case](PORT))
    exp = _select(JAX, st.TpuSession(), CASES[case](JAX))
    assert got.schema == exp.schema
    assert got.equals(exp)


def test_null_predicate_rows_take_the_else_branch():
    """Not a vacuous pass: rows with a null predicate exist and get the
    ELSE value, not null."""
    at = _table()
    got = _select(PORT, pt.TpuSession(device="cpu"),
                  CASES["null_predicate_takes_else"](PORT))
    b = at.column("b").to_pylist()
    out = got.column("out").to_pylist()
    assert any(v is None for v in b)
    assert all(o == (1 if v else 0) for v, o in zip(b, out))


def test_case_without_else_has_nulls():
    got = _select(PORT, pt.TpuSession(device="cpu"),
                  CASES["no_else_is_null"](PORT))
    out = got.column("out").to_pylist()
    assert None in out and 1 in out and 2 in out
    assert got.schema.field("out").type == pa.int32()


@pytest.mark.parametrize("batch_rows", [1 << 20, 700])
def test_grouped_sum_of_case_when_equals_jax(batch_rows):
    """Q12's shape: sum(CASE WHEN ... THEN 1 ELSE 0) per group, int32
    summed into int64, complete and partial -> exchange -> final."""
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows}
    outs = []
    for E, s in ((PORT, pt.TpuSession(dict(conf), device="cpu")),
                 (JAX, st.TpuSession(dict(conf)))):
        flag = CASES["q12_flag"](E)
        df = (s.create_dataframe(_table(3))
              .filter(E.col("s").isin("MAIL", "SHIP", "a"))
              .group_by("s")
              .agg(E.F.sum(flag).alias("high"),
                   E.F.sum(E.F.when(E.col("i") > 0, E.col("i"))
                           .otherwise(0)).alias("pos"),
                   E.F.count("*").alias("n")))
        outs.append(df.sort("s").to_arrow())
    assert outs[0].schema.field("high").type == pa.int64()
    assert outs[0].equals(outs[1])
    assert outs[0].num_rows == 3
