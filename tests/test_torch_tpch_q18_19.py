"""TPC-H Q18 and Q19, end to end: the PyTorch port (on the CPU) against
the JAX package, its pandas oracle and chip_smoke's exact references, on
the three plans of `test_torch_tpch_q4_5_7.py` (whose helpers this
module uses). Q18 runs at the spec's quantity (300: 41 rows at this
scale, under the limit) and at 150 (the limit of 100 cuts): its
grouped decimal sum over every lineitem row is compared in decimal128
(`sum_qty > 300`) before a left-semi join. Q19 filters a join with part
by a disjunction of string, IN and decimal range predicates.
"""
import pytest

from test_torch_tpch_q4_5_7 import (PLANS, SHUFFLED, _few_threads,  # noqa
                                    check_equal_jax, check_optimized_shape,
                                    check_oracle, check_reference,
                                    pandas_tables, run_port, tpch_tables)

#: (query, keyword arguments) pairs
CASES = {"q18_qty300": (18, {"qty": 300}), "q18_qty150": (18, {"qty": 150}),
         "q19": (19, {})}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("case", list(CASES))
def test_query_equals_jax(tpch_tables, case, plan):
    n, kw = CASES[case]
    got = check_equal_jax(n, tpch_tables, plan, **kw)
    if case == "q18_qty300":
        assert got.num_rows == 41
    if case == "q18_qty150":
        assert got.num_rows == 100


@pytest.mark.parametrize("case", list(CASES))
def test_query_equals_the_pandas_oracle(tpch_tables, pandas_tables, case):
    n, kw = CASES[case]
    check_oracle(n, tpch_tables, pandas_tables, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_query_equals_the_chip_smoke_reference(tpch_tables, case):
    n, kw = CASES[case]
    check_reference(n, tpch_tables, **kw)


@pytest.mark.parametrize("case", ["q18_qty300", "q19"])
def test_optimized_plan_equals_jax(tpch_tables, case):
    n, kw = CASES[case]
    check_optimized_shape(n, tpch_tables, **kw)


def test_q18_sum_is_decimal128_and_compared_exactly(tpch_tables):
    """sum(l_quantity) is decimal(22,2), above precision 18: the filter
    `sum_qty > 300` runs on the decimal128 compare, and every order it
    keeps sums past 300 (the result's sum_qty is that same sum)."""
    import decimal
    import pyarrow as pa
    q, got = run_port(18, tpch_tables, SHUFFLED, qty=300)
    assert got.schema.field("sum_qty").type == pa.decimal128(22, 2)
    sums = got.column("sum_qty").to_pylist()
    assert sums and all(s > decimal.Decimal(300) for s in sums)
    import chip_smoke
    shape = chip_smoke.tpch_plan_shape(q.last_plan())
    assert shape["join_kinds"].count("left_semi") == 1


def test_q19_revenue_is_a_single_non_null_row(tpch_tables):
    _, got = run_port(19, tpch_tables, {})
    assert got.num_rows == 1 and got.column("revenue")[0].as_py() > 0
