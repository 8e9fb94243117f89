"""TPC-H Q13, Q14, Q17 and Q20, end to end: the PyTorch port (on the
CPU) against the JAX package, its pandas oracle and chip_smoke's exact
references, on the three plans of `test_torch_tpch_q4_5_7.py`, with the
checks of `test_torch_tpch_q2_8_9.py` (doubles within a relative 1e-9,
everything else exact).

Q13 drops orders by NOT LIKE, left-joins customer and counts twice.
Its pandas oracle drops orders whose comment matches the regex
`special.*requests`; the engine's LIKE '%special%requests%' (the JAX
package's) also drops "requests ... special" (docs/compatibility.md).
The generator never writes that order, so the two agree here;
chip_smoke's reference follows the engine's LIKE. Q14 takes a ratio of
sums under a STARTSWITH, Q17 compares each line with a fifth of its
part's average quantity, Q20 runs STARTSWITH, a grouped sum joined back
and a DISTINCT, at nations with suppliers that qualify at this scale
(CANADA, the spec's, has none).
"""
import pyarrow as pa
import pytest

from test_torch_tpch_q2_8_9 import (check_chip_smoke_reference,
                                    check_equal_jax)
from test_torch_tpch_q4_5_7 import (PLANS, _few_threads,  # noqa
                                    check_optimized_shape, check_oracle,
                                    pandas_tables, tpch_tables)
import chip_smoke  # noqa: E402  (on the path the q4_5_7 helpers set)

#: (query, keyword arguments, result rows at gen_all(0.01, 11))
CASES = {"q13": (13, {}, 24), "q14": (14, {}, 1), "q17": (17, {}, 1),
         "q20_germany": (20, {"nation": "GERMANY"}, 1),
         "q20_japan": (20, {"nation": "JAPAN"}, None)}


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


def test_q13_reference_follows_the_engines_like():
    """chip_smoke's Q13 reference drops "requests ... special" as the
    engine's LIKE does, where the oracle's regex keeps it."""
    orders = pa.table({
        "o_custkey": pa.array([0, 0, 1, 1, 2], pa.int64()),
        "o_comment": ["a special requests", "requests special", "plain",
                      "special", "specialrequests"]})
    customer = pa.table({"c_custkey": pa.array([0, 1, 2, 3], pa.int64())})
    rows = chip_smoke.q13_reference({"orders": orders,
                                     "customer": customer})
    # kept: customer 0 none, 1 two, 2 none, 3 none
    assert rows == [(0, 3), (2, 1)]
