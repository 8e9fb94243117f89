"""The 22 TPC-H queries on the adaptive plans: the default conf with
4096-row batches, a 64 KiB broadcast threshold and a 32 KiB advisory
partition size, so that at `gen_all(0.01, 11)` every feature acts (join
reorder, coalescing, join demotion, exchange reuse, the async broadcast
build).

Per query, the port's result must equal chip_smoke's exact reference (by
chip_smoke's own check: keys, decimals and counts exact, a double within
a relative 1e-9) and the port's result on the written plan (the same
conf with the four features off; doubles within 1e-9, since coalescing
regroups the partial sums), and the plan that ran must agree with its
decision records (`chip_smoke.check_plan_decisions`). Three queries, one
per feature that changes a plan's shape here (Q11: reorder and reuse,
Q15: reuse of the revenue view, Q17: a demoted join), are also held to
the JAX package on the same conf. The JAX package runs them in one
fresh interpreter with its lock-order witness renewed for each query,
as `test_torch_tpch_q11_15_16_21_22.py` explains.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pyarrow as pa
import pytest

from test_torch_tpch_q2_8_9 import assert_tables_agree
from test_torch_tpch_q4_5_7 import (SEED, SF, _few_threads,  # noqa: F401
                                    in_query_order, tpch_tables)
import chip_smoke  # noqa: E402  (on the path the q4_5_7 helpers set)
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.workloads import tpch as ptpch

ADAPTIVE = {"spark.rapids.tpu.sql.batchSizeRows": 4096,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 1 << 16,
            "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes":
            1 << 15}
WITH_JAX = (11, 15, 17)


@pytest.fixture(scope="module")
def expects(tpch_tables):
    li = tpch_tables["lineitem"]
    out = {n: chip_smoke.tpch_reference(n, tpch_tables)
           for n in chip_smoke.TPCH_QUERIES}
    out[1] = chip_smoke.q1_reference(li)
    out[3] = chip_smoke.q3_reference(*(tpch_tables[k] for k in (
        "customer", "orders", "lineitem")))
    out[6] = ptpch.q6_numpy_baseline(
        li.column("l_shipdate").to_numpy(),
        chip_smoke.unscaled(li, "l_discount"),
        chip_smoke.unscaled(li, "l_quantity"),
        chip_smoke.unscaled(li, "l_extendedprice"))
    return out


_APART = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import pyarrow as pa
import spark_rapids_tpu as st
from spark_rapids_tpu.runtime import lockdep
from spark_rapids_tpu.workloads import tpch, tpch_queries
queries, conf, kws, sf, seed, out = json.loads(sys.argv[1])
t = tpch.gen_all(sf, seed)
for n, kw in zip(queries, kws):
    if lockdep.enabled():
        lockdep.disable()
        lockdep.enable()
    s = st.TpuSession(conf)
    dfs = {k: s.create_dataframe(v) for k, v in t.items()}
    at = getattr(tpch_queries, f"q{n}")(dfs, **kw).to_arrow()
    with pa.OSFile(f"{out}/q{n}.arrow", "wb") as f, \\
            pa.ipc.new_file(f, at.schema) as w:
        w.write_table(at)
"""


@pytest.fixture(scope="module")
def jax_results(tpch_tables):
    """The JAX package's results of WITH_JAX on ADAPTIVE, from one fresh
    interpreter with this suite's environment."""
    kws = [chip_smoke.tpch_kw(n, tpch_tables) for n in WITH_JAX]
    with tempfile.TemporaryDirectory() as d:
        subprocess.run(
            [sys.executable, "-c", _APART,
             json.dumps([list(WITH_JAX), ADAPTIVE, kws, SF, SEED, d])],
            check=True, cwd=Path(__file__).resolve().parents[1],
            env=dict(os.environ))
        out = {}
        for n in WITH_JAX:
            with pa.memory_map(f"{d}/q{n}.arrow") as f:
                out[n] = pa.ipc.open_file(f).read_all()
        return out


def _run(n, tables, conf):
    s = pt.TpuSession(dict(conf), device="cpu")
    q = chip_smoke.query_of(n, s, tables)
    return q, q.to_arrow()


@pytest.mark.parametrize("n", chip_smoke.ALL_QUERIES)
def test_adaptive_plan_equals_the_reference_and_the_written_plan(
        tpch_tables, expects, n):
    q, got = _run(n, tpch_tables, ADAPTIVE)
    chip_smoke.check_query(n, got, expects[n], "the adaptive plan")
    chip_smoke.check_plan_decisions(q.last_plan(), q.last_aqe_decisions(),
                                    f"Q{n}")
    _, written = _run(n, tpch_tables, dict(ADAPTIVE,
                                           **chip_smoke.WRITTEN_CONF))
    assert_tables_agree(in_query_order(n, got), in_query_order(n, written))


def test_every_feature_acts_on_the_adaptive_plans(tpch_tables):
    """Over the 22 plans: a reordered chain, a coalesced stage, a
    demoted join, a reused exchange and an async build's overlap."""
    seen = {"reorder": 0, "coalesced": 0, "demoted": 0, "reused": 0,
            "overlap": 0}
    for n in chip_smoke.ALL_QUERIES:
        s = pt.TpuSession(dict(ADAPTIVE), device="cpu")
        q = chip_smoke.query_of(n, s, tpch_tables)
        q.to_arrow()
        info = chip_smoke.adaptive_info(q)
        seen["reorder"] += chip_smoke.join_order_differs(q)
        seen["coalesced"] += info["aqe"]["coalesced_away"] > 0
        seen["demoted"] += info["aqe"]["demotions"]
        seen["reused"] += info["reuse_hits"]
        seen["overlap"] += info["broadcast_build_overlap_ms"] > 0
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("n", WITH_JAX)
def test_adaptive_plan_equals_jax(tpch_tables, jax_results, n):
    _, got = _run(n, tpch_tables, ADAPTIVE)
    assert got.num_rows > 0
    assert_tables_agree(got, jax_results[n])
