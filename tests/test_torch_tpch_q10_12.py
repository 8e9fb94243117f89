"""TPC-H Q10 and Q12, end to end: the PyTorch port (on the CPU) against
the JAX package, its pandas oracle and chip_smoke's exact references, on
the three plans of `test_torch_tpch_q4_5_7.py` (whose helpers this
module uses). Q10 groups on six keys (four strings, a decimal and an
int64) and keeps the top 20 by a total order: compared row for row.
Q12 sums CASE WHEN flags (int32 into int64) under IN filters.
"""
import pytest

from test_torch_tpch_q4_5_7 import (PLANS, SHUFFLED, _few_threads,  # noqa
                                    check_equal_jax, check_optimized_shape,
                                    check_oracle, check_reference,
                                    filters_below_joins, pandas_tables,
                                    run_port, tpch_tables)

QUERIES = (10, 12)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("n", QUERIES)
def test_query_equals_jax(tpch_tables, n, plan):
    check_equal_jax(n, tpch_tables, plan)


@pytest.mark.parametrize("n", QUERIES)
def test_query_equals_the_pandas_oracle(tpch_tables, pandas_tables, n):
    check_oracle(n, tpch_tables, pandas_tables)


@pytest.mark.parametrize("n", QUERIES)
def test_query_equals_the_chip_smoke_reference(tpch_tables, n):
    check_reference(n, tpch_tables)


@pytest.mark.parametrize("n", QUERIES)
def test_optimized_plan_equals_jax(tpch_tables, n):
    filters = filters_below_joins(check_optimized_shape(n, tpch_tables))
    if n == 10:
        assert filters["Filter['l_returnflag']"] is False
        assert filters["Filter['o_orderdate']"] is False


def test_q10_six_key_group_runs_partial_exchange_final(tpch_tables):
    """On the shuffled plan the six-key group (strings, decimal, int64)
    goes through the exchange of its partial states."""
    import chip_smoke
    q, got = run_port(10, tpch_tables, SHUFFLED)
    shape = chip_smoke.tpch_plan_shape(q.last_plan())
    assert shape["aggregates"] == ["final", "partial"]
    assert got.num_rows == 20
    assert [f.name for f in got.schema][:6] == [
        "c_custkey", "c_name", "c_acctbal", "c_phone", "n_name", "c_address"]


def test_q12_counts_are_int64_and_cover_every_line(tpch_tables):
    import pyarrow as pa
    _, got = run_port(12, tpch_tables, SHUFFLED)
    assert got.schema.field("high_line_count").type == pa.int64()
    assert got.column("l_shipmode").to_pylist() == ["MAIL", "SHIP"]
    rows = got.to_pylist()
    assert all(r["high_line_count"] > 0 and r["low_line_count"] > 0
               for r in rows)
