"""TPC-H Q11, Q15, Q16, Q21 and Q22, end to end: the PyTorch port (on the
CPU) against the JAX package, its pandas oracle and chip_smoke's exact
references, on the three plans of `test_torch_tpch_q4_5_7.py`, with the
checks of `test_torch_tpch_q2_8_9.py`.

Q11 and Q15 cross-join a grouped double sum with its one-row total or
maximum, Q22 a filtered customer list with its average balance; Q16
counts distinct suppliers per (brand, type, size) and Q21 distinct
suppliers per order, both through the optimizer's two-level rewrite.
Keys, decimals and counts must be equal exactly. Q15's and Q22's doubles
equal the JAX package's bit for bit; Q11's part values lie within one
unit in the last place (a decimal128 product cast to double, which the
JAX package's XLA multiplies by 10^-2 where the port divides: ROADMAP
C.3), so the doubles are held within a relative 1e-9, as in the other
query files. The pandas oracle holds within its own rtol (1e-6) for
money. Q21 runs at the spec's SAUDI ARABIA and at GERMANY.

The JAX package's queries on the shuffled plan run in a fresh
interpreter (`run_jax_apart`): its lock-order witness
(`runtime/lockdep.py`, on for the whole suite) keys locks by class. The
shuffled plans of Q2, Q5, Q11 and Q20 hold a BroadcastExchangeExec lock
while the build runs a ShuffleExchangeExec; Q15's holds a
ShuffleExchangeExec lock while its cross join collects the broadcast.
Whichever comes second in one process raises LockOrderViolation, though
no two of those queries share a lock (ROADMAP C.5). The witness still
watches each query in its own interpreter.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

from test_torch_tpch_q2_8_9 import (assert_tables_agree,
                                    check_chip_smoke_reference)
from test_torch_tpch_q4_5_7 import (PLANS, SEED, SF,  # noqa
                                    _few_threads, check_optimized_shape,
                                    check_oracle, pandas_tables, run_jax,
                                    run_port, tpch_tables)

#: (query, keyword arguments, result rows at gen_all(0.01, 11))
CASES = {"q11": (11, {}, 157), "q15": (15, {}, 1), "q16": (16, {}, 279),
         "q21": (21, {}, 3), "q21_germany": (21, {"nation": "GERMANY"}, 2),
         "q22": (22, {}, 7)}


_APART = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import pyarrow as pa
import spark_rapids_tpu as st
from spark_rapids_tpu.workloads import tpch, tpch_queries
n, conf, kw, sf, seed, out = json.loads(sys.argv[1])
s = st.TpuSession(conf)
t = {k: s.create_dataframe(v) for k, v in tpch.gen_all(sf, seed).items()}
at = getattr(tpch_queries, f"q{n}")(t, **kw).to_arrow()
with pa.OSFile(out, "wb") as f, pa.ipc.new_file(f, at.schema) as w:
    w.write_table(at)
"""


def run_jax_apart(n, conf, **kw):
    """The JAX package's query n over gen_all(SF, SEED) in a fresh
    interpreter with this suite's environment."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "result.arrow")
        subprocess.run(
            [sys.executable, "-c", _APART,
             json.dumps([n, conf, kw, SF, SEED, out])], check=True,
            cwd=Path(__file__).resolve().parents[1], env=dict(os.environ))
        with pa.memory_map(out) as f:
            return pa.ipc.open_file(f).read_all()


def jax_result(n, tables, plan, **kw):
    jconf = PLANS[plan][1]
    if plan == "shuffled":
        return run_jax_apart(n, jconf, **kw)
    return run_jax(n, tables, jconf, **kw)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("case", list(CASES))
def test_query_equals_jax(tpch_tables, case, plan):
    n, kw, rows = CASES[case]
    _, got = run_port(n, tpch_tables, PLANS[plan][0], **kw)
    assert got.num_rows == rows
    assert_tables_agree(got, jax_result(n, tpch_tables, plan, **kw))


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
    shape = check_optimized_shape(n, tpch_tables, **kw)
    names = []

    def walk(sh):
        names.append(sh[0])
        for k in sh[1]:
            walk(k)
    walk(shape)
    # plain: Q15 aggregates its revenue view twice (once under the max);
    # Q16's one count(DISTINCT) and Q21's two become two aggregates each
    extra = {16: 1, 21: 2}.get(n, 0)
    plain = {11: 2, 15: 3, 16: 1, 21: 3, 22: 3}[n]
    assert names.count("Aggregate") == plain + extra


@pytest.mark.parametrize("case", ["q15", "q22"])
def test_doubles_equal_jax_bit_for_bit(tpch_tables, case):
    """No decimal128 cast lies under these doubles: the port's sums equal
    the JAX package's to the bit on every plan."""
    n, kw, _ = CASES[case]
    for plan, (pconf, _) in PLANS.items():
        _, got = run_port(n, tpch_tables, pconf, **kw)
        assert got.equals(jax_result(n, tpch_tables, plan, **kw))


def test_q11_part_values_lie_within_an_ulp_of_jax(tpch_tables):
    _, got = run_port(11, tpch_tables, {})
    exp = run_jax(11, tpch_tables, {})
    assert got.column("ps_partkey").equals(exp.column("ps_partkey"))
    np.testing.assert_array_max_ulp(got.column("part_value").to_numpy(),
                                    exp.column("part_value").to_numpy(),
                                    maxulp=1)
