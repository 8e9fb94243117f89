"""The host fallback (`exec/host_fallback.py`, `expr/host_eval.py`) against
the JAX package at its default conf: a Project or Filter whose
expression the device cannot run evaluates on host rows, with the same
Arrow output and the same NOT_ON_TPU tags and reasons; with the
fallback off both packages refuse with the same text.

Both explains carry lore ids (`[loreId=N]`, numbered alike: pre-order
over the converted tree, before the JAX fusion pass), and they are
compared. A node's description is compared by its node name only, since
the JAX package prints some expressions as Python object reprs."""
import contextlib
import decimal
import io
import re

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu_torch.exec.host_fallback import (HostFilterExec,
                                                       HostProjectExec)
from spark_rapids_tpu_torch.expr.expressions import (
    UnsupportedExpr as PUnsupported)

OFF = {"spark.rapids.tpu.sql.allowCpuFallback": False,
       "spark.rapids.tpu.sql.exec.degradeToHost.enabled": False}


def _table(n=64, seed=3):
    rng = np.random.default_rng(seed)
    words = ["ab", "a%b", "x", "abc", "b", "a", "%", "ba%", "", "a_c"]
    s = [words[i] for i in rng.integers(0, len(words), n)]
    t = [words[i] for i in rng.integers(0, len(words), n)]
    null = rng.random(n) < 0.15
    return pa.table({
        "i": pa.array(rng.integers(-2**31, 2**31, n), pa.int32(),
                      mask=null),
        "l": pa.array(rng.integers(-2**62, 2**62, n), pa.int64()),
        "k": pa.array(rng.integers(0, 10, n), pa.int32()),
        "s": pa.array(s, mask=rng.random(n) < 0.1),
        "t": pa.array(t),
        "f": pa.array(rng.normal(0, 100, n)),
        "d": pa.array([decimal.Decimal(int(a) * 10**9 + int(b)).scaleb(-2)
                       for a, b in zip(rng.integers(-10**11, 10**11, n),
                                       rng.integers(0, 10**9, n))],
                      pa.decimal128(30, 2)),
        "dt": pa.array(rng.integers(0, 20000, n), pa.int32()).cast(
            pa.date32()),
        "ss": pa.array([str(v) for v in rng.integers(-50, 50, n)]),
    })


# each case: (F, df) -> DataFrame whose plan holds a host (!cpu) node
CASES = {
    "isin_int_against_strings": lambda F, df: df.select(
        "k", F.col("k").isin("1", "7").alias("r")),
    "like_with_an_escape": lambda F, df: df.filter(
        F.like(F.col("s"), "a\\%%")).select("s", "k"),
    "contains_two_columns": lambda F, df: df.select(
        F.contains(F.col("s"), F.col("t")).alias("c"), "s", "t"),
    "int32_and_int64_wrap_on_the_host": lambda F, df: df.select(
        (F.col("i") * 100003 + 7).alias("w32"),
        (F.col("l") * 977).alias("w64"),
        (-F.col("i")).alias("neg"),
        F.col("k").isin("3").alias("r")),
    "decimals_and_dates_ride_through": lambda F, df: df.select(
        "d", "dt", (F.col("d") + F.col("d")).alias("d2"),
        F.contains(F.col("s"), F.col("t")).alias("c")),
    "host_casts": lambda F, df: df.select(
        F.col("ss").cast("int").alias("si"),
        F.col("ss").cast("double").alias("sd"),
        F.col("ss").cast("boolean").alias("sb"),
        F.col("f").cast("string").alias("fs"),
        F.col("k").cast("boolean").alias("kb"),
        F.col("dt").cast("string").alias("dts"),
        F.contains(F.col("s"), F.col("t")).alias("c")),
    "filter_or_with_a_host_branch": lambda F, df: df.filter(
        (F.col("k") > 5) | F.like(F.col("s"), "%\\%")).select("k", "s"),
    "kleene_logic_and_nulls": lambda F, df: df.select(
        (F.col("s").isNull() | F.contains(F.col("s"), F.col("t")))
        .alias("o"),
        (F.col("i").isNotNull() & F.contains(F.col("t"), F.col("s")))
        .alias("a"),
        F.coalesce(F.col("s"), F.col("t")).alias("co"),
        F.contains(F.col("s"), F.col("t")).alias("c")),
    "host_filter_under_a_device_aggregate": lambda F, df: df.filter(
        F.contains(F.col("s"), F.col("t"))).group_by("k").agg(
        F.count("*").alias("n"), F.sum("l").alias("sl")).sort("k"),
}


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _tags(text):
    """(indent + tag + lore id + node name, reason) per explain line;
    findings lines whole."""
    out = []
    for line in text.splitlines():
        head, _, reason = line.partition("  <-- ")
        m = re.match(r"^(\s*)(\*|!cpu|!|!!|~)( \[loreId=\d+\])? (\w+)",
                     head)
        out.append((m.group(0), reason) if m else line)
    return out


def _both(name, conf=None):
    data = _table()
    js = st.TpuSession(dict(conf or {}))
    ps = pt.TpuSession(dict(conf or {}), device="cpu")
    jq = CASES[name](JF, js.create_dataframe(data))
    pq = CASES[name](PF, ps.create_dataframe(data))
    return jq, pq


@pytest.mark.parametrize("name", list(CASES))
def test_host_fallback_equals_jax_at_its_default_conf(name):
    jq, pq = _both(name)
    jt, pt_ = jq.to_arrow(), pq.to_arrow()
    assert pt_.schema == jt.schema
    assert pt_.equals(jt), (jt.to_pylist()[:5], pt_.to_pylist()[:5])
    jx = _quiet(lambda: jq.explain("NOT_ON_TPU"))
    px = _quiet(lambda: pq.explain("NOT_ON_TPU"))
    assert _tags(px) == _tags(jx)
    assert "!cpu" in px


@pytest.mark.parametrize("name", list(CASES))
def test_fallback_off_refuses_like_jax(name):
    jq, pq = _both(name, OFF)
    with pytest.raises(JUnsupported) as je:
        _quiet(jq.to_arrow)
    with pytest.raises(PUnsupported) as pe:
        pq.to_arrow()
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("name", list(CASES))
def test_validate_equals_jax_but_fused_stages_and_lore_ids(name):
    """VALIDATE: the audit tree and findings equal; the JAX package adds
    its fused stages (ROADMAP A.11) and lore ids (C.28)."""
    jq, pq = _both(name)
    jt = _quiet(lambda: jq.explain("VALIDATE")).splitlines()
    if "-- fused stages --" in jt:
        jt = jt[:jt.index("-- fused stages --")]
    pt_ = _quiet(lambda: pq.explain("VALIDATE")).splitlines()
    assert _tags("\n".join(pt_)) == _tags("\n".join(jt))


def test_host_nodes_carry_reason_metrics_and_cuda_free_batches():
    data = _table()
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 16},
                      device="cpu")
    q = CASES["like_with_an_escape"](PF, s.create_dataframe(data))
    root, _ = q.physical_plan()
    nodes, stack = [], [root]
    while stack:
        n = stack.pop()
        nodes.append(n)
        stack.extend(n.children)
    host = [n for n in nodes if isinstance(n, HostFilterExec)]
    assert len(host) == 1
    assert host[0].describe().endswith(
        "(CPU: LIKE escapes land with the regex transpiler)")
    out = q.to_arrow()
    want = [v for v in data.column("s").to_pylist()
            if v is not None and v.startswith("a%")]
    assert sorted(out.column("s").to_pylist()) == sorted(want)
    m = [v for k, v in q.last_metrics().items()
         if k.startswith("HostFilterExec")][0]
    assert m["hostEvalTime"] > 0 and m["numOutputRows"] == len(want)
    p = CASES["contains_two_columns"](PF, s.create_dataframe(data))
    assert isinstance(p.physical_plan()[0], HostProjectExec)


def test_startswith_on_an_int_fails_on_the_host_in_both():
    """`startswith(int, "1")`: both packages tag it !cpu, and both host
    interpreters then call a string method on a numpy integer
    (AttributeError): the reference's fault, reproduced (ROADMAP C.29)."""
    data = _table()
    for s, F in ((st.TpuSession(), JF), (pt.TpuSession(device="cpu"), PF)):
        q = s.create_dataframe(data).filter(
            F.startswith(F.col("k"), "1"))
        assert "!cpu" in _quiet(lambda: q.explain("NOT_ON_TPU"))
        with pytest.raises(AttributeError, match="startswith"):
            _quiet(q.to_arrow)


def test_decimal128_to_string_placement_differs_rows_equal():
    """CAST(decimal128 AS string) alone: the JAX planner places it on the
    device (`*`), where it breaks, and its degrade path answers on the
    host; the port's binder refuses it, so the port plans it `!cpu`
    (ROADMAP C.29). The rows are equal."""
    data = _table()
    outs, tags = [], []
    for s, F in ((st.TpuSession(), JF), (pt.TpuSession(device="cpu"), PF)):
        q = s.create_dataframe(data).select(
            F.col("d").cast("string").alias("ds"))
        outs.append(q.to_arrow())
        tags.append(_quiet(lambda: q.explain("NOT_ON_TPU")))
    assert outs[1].equals(outs[0])
    assert tags[0] == ""
    assert tags[1].startswith("!cpu [loreId=1] Project[")
