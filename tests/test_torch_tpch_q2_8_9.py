"""TPC-H Q2, Q8 and Q9, end to end: the PyTorch port (on the CPU)
against the JAX package, its pandas oracle and chip_smoke's exact
references, on the three plans of `test_torch_tpch_q4_5_7.py` (whose
helpers this module uses; `test_torch_tpch_q13_14_17_20.py` uses this
module's).

Keys, decimals and counts must be equal exactly; a double column (Q8's
mkt_share, Q9's sum_profit, Q14's promo_revenue, Q17's avg_yearly)
within a relative 1e-9 of the JAX package's, since a sum of doubles
depends on the order of its rows, which the plans differ in. The pandas
oracle holds within its own rtol (1e-6) for money. Each query's
optimized plan equals the JAX optimizer's with join reordering off. Q2
runs a grouped min joined back, Q8 a ratio of two double sums per year,
Q9 CONTAINS on p_name, a two-key join with partsupp and a decimal128
product cast to double.
"""
import math

import pyarrow as pa
import pytest

from test_torch_tpch_q4_5_7 import (PLANS, SHUFFLED, _few_threads,  # noqa
                                    check_optimized_shape, check_oracle,
                                    pandas_tables, run_jax, run_port,
                                    tpch_tables)
import chip_smoke  # noqa: E402  (on the path the q4_5_7 helpers set)

RTOL = 1e-9
#: (query, keyword arguments, result rows at gen_all(0.01, 11))
CASES = {"q2": (2, {}, 7), "q8": (8, {}, 2), "q9": (9, {}, 156)}


def assert_tables_agree(got, exp, rtol=RTOL):
    """Row for row: doubles within rtol, every other column equal."""
    assert got.schema == exp.schema and got.num_rows == exp.num_rows
    for name in got.column_names:
        g, e = got.column(name).to_pylist(), exp.column(name).to_pylist()
        if pa.types.is_floating(got.schema.field(name).type):
            assert all((a is None and b is None) or math.isclose(
                a, b, rel_tol=rtol, abs_tol=0.0) for a, b in zip(g, e)), name
        else:
            assert g == e, name


def check_equal_jax(case, tables, plan, cases):
    n, kw, rows = cases[case]
    pconf, jconf = PLANS[plan]
    _, got = run_port(n, tables, pconf, **kw)
    exp = run_jax(n, tables, jconf, **kw)
    assert got.num_rows > 0
    if rows is not None:
        assert got.num_rows == rows
    assert_tables_agree(got, exp)


def check_chip_smoke_reference(n, tables, **kw):
    """The port's result (shuffled plan) against chip_smoke's exact
    reference, by chip_smoke's own check."""
    _, got = run_port(n, tables, SHUFFLED, **kw)
    chip_smoke.check_tpch(n, got, chip_smoke.TPCH_REFERENCES[n](
        tables, **kw), "the CPU")


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("case", list(CASES))
def test_query_equals_jax(tpch_tables, case, plan):
    check_equal_jax(case, tpch_tables, plan, CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_query_equals_the_pandas_oracle(tpch_tables, pandas_tables, case):
    n, kw, _ = CASES[case]
    check_oracle(n, tpch_tables, pandas_tables, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_query_equals_the_chip_smoke_reference(tpch_tables, case):
    n, kw, _ = CASES[case]
    check_chip_smoke_reference(n, tpch_tables, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_optimized_plan_equals_jax(tpch_tables, case):
    n, kw, _ = CASES[case]
    check_optimized_shape(n, tpch_tables, **kw)


def test_q9_casts_a_decimal128_product_to_double(tpch_tables):
    """A decimal(12,2) x decimal(12,2) product is decimal(25,4), as Q9's
    ps_supplycost * l_quantity: the products equal the JAX package's,
    and their decimal128 casts to double lie within one unit in the last
    place of its compiled ones (XLA multiplies by 10^-4 where the source
    divides by 10^4; `test_torch_divide_cast.py` holds the cast to the
    JAX package's eager quotient bit for bit)."""
    import numpy as np
    import spark_rapids_tpu as st
    from spark_rapids_tpu.expr import expressions as jx
    from spark_rapids_tpu.columnar import dtypes as jdt
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.expr import expressions as px
    from spark_rapids_tpu_torch.columnar import dtypes as pdt
    li = tpch_tables["lineitem"].slice(0, 20000)

    def run(X, T, session):
        e = (X.col("l_extendedprice") * X.col("l_quantity"))
        return session.create_dataframe(li).select(
            e.alias("p"), e.cast(T.FLOAT64).alias("f")).to_arrow()
    got = run(px, pdt, pt.TpuSession(device="cpu"))
    exp = run(jx, jdt, st.TpuSession())
    assert got.schema.field("p").type == pa.decimal128(25, 4)
    assert got.column("p").equals(exp.column("p"))
    np.testing.assert_array_max_ulp(got.column("f").to_numpy(),
                                    exp.column("f").to_numpy(), maxulp=1)
