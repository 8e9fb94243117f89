"""Cost-based device-vs-host placement (`plan/cbo.py` `apply_cbo`,
`sql.optimizer.cbo.enabled`, off by default), mirroring the JAX
package's `tests/test_cbo.py`: each case runs the same Arrow table
through both packages and compares the placement (a host node or not)
and the rows."""
import contextlib
import io

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.exec import host_fallback as jhost
from spark_rapids_tpu.plan.cbo import estimate_rows_selective as j_est
from spark_rapids_tpu_torch.exec import host_fallback as phost
from spark_rapids_tpu_torch.plan.cbo import estimate_rows_selective as p_est

CBO = {"spark.rapids.tpu.sql.optimizer.cbo.enabled": "true"}
TINY = {"a": pa.array([1, 2, 3]), "b": pa.array([1.5, 2.5, None])}


def _walk(root):
    stack, out = [root], []
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children)
    return out


def _hosts(q, port):
    if port:
        root = q.physical_plan()[0]
        mod = phost
    else:
        root = q._execute()[0]
        mod = jhost
    kinds = (mod.HostProjectExec, mod.HostFilterExec)
    return sorted(type(n).__name__ for n in _walk(root)
                  if isinstance(n, kinds))


def _both(conf, data, build):
    js = st.TpuSession(dict(conf))
    ps = pt.TpuSession(dict(conf), device="cpu")
    return (build(JF, js.create_dataframe(data)),
            build(PF, ps.create_dataframe(data)))


CASES = {
    "off_by_default_stays_on_device": (
        {}, TINY, lambda F, df: df.select((F.col("a") + 1).alias("x")), []),
    "tiny_coverable_project_to_host": (
        CBO, TINY, lambda F, df: df.select((F.col("a") + 1).alias("x"),
                                           F.col("b")),
        ["HostProjectExec"]),
    "tiny_filter_to_host": (
        CBO, TINY, lambda F, df: df.filter(F.col("a") >= 2),
        ["HostFilterExec"]),
    "large_input_stays_on_device": (
        CBO, {"a": pa.array(np.random.default_rng(1).integers(
            0, 100, 50_000))},
        lambda F, df: df.select((F.col("a") * 2).alias("x")), []),
    "host_uncoverable_expr_stays_on_device": (
        CBO, TINY, lambda F, df: df.select(F.hash(F.col("a")).alias("h")),
        []),
    "selective_filter_makes_a_project_tiny": (
        CBO, {"a": pa.array(np.arange(1000))},
        lambda F, df: df.filter(F.col("a") == 5).select(
            (F.col("a") * 3).alias("x")),
        ["HostProjectExec"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cbo_placement_and_rows_equal_jax(name):
    conf, data, build, hosts = CASES[name]
    jq, pq = _both(conf, data, build)
    assert _hosts(jq, False) == hosts
    assert _hosts(pq, True) == hosts
    assert pq.to_arrow().equals(jq.to_arrow())


def test_cbo_reason_in_explain_equals_jax():
    conf, data, build, _ = CASES["tiny_filter_to_host"]
    jq, pq = _both(conf, data, build)
    with contextlib.redirect_stdout(io.StringIO()):
        jx = jq.explain("NOT_ON_TPU").splitlines()[0]
        px = pq.explain("NOT_ON_TPU").splitlines()[0]
    reason = ("will run on CPU because CBO: ~3 input rows <= 64; host "
              "interpreter beats device dispatch at this size")
    assert px.startswith("!cpu [loreId=1] Filter[") and px.endswith(reason)
    assert jx.split("  <-- ")[1] == px.split("  <-- ")[1]
    # the tag and lore id agree too (both number the converted tree)
    assert jx.split(" Filter[")[0] == px.split(" Filter[")[0]


def test_cbo_is_a_no_op_with_the_fallback_off():
    conf = {**CBO, "spark.rapids.tpu.sql.allowCpuFallback": False}
    _, data, build, _ = CASES["tiny_filter_to_host"]
    jq, pq = _both(conf, data, build)
    assert _hosts(jq, False) == _hosts(pq, True) == []
    assert pq.to_arrow().equals(jq.to_arrow())


@pytest.mark.parametrize("build", [
    lambda F, df: df.filter(F.col("a") == 5),
    lambda F, df: df.filter((F.col("a") > 5) & (F.col("a") < 9)),
    lambda F, df: df.filter(~(F.col("a") == 5) | F.col("a").isNull()),
    lambda F, df: df.filter(F.col("a") > 1).select("a").filter(
        F.col("a").isin(1, 2)),
])
def test_selectivity_estimates_equal_jax(build):
    data = {"a": pa.array(list(range(1000)))}
    jq, pq = _both({}, data, build)
    assert p_est(pq._plan) == pytest.approx(j_est(jq._plan))
    assert p_est(pq._plan) <= 1000
