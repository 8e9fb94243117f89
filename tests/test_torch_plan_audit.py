"""The plan audit (`analysis/audit.py`) against the JAX package's, mirroring
its `tests/test_plan_audit.py` without the recompile-risk, python-exec
and event-log cases (the port issues no recompile_risk, has no python
exec until ROADMAP A.12 and no event log until A.13). Findings are
compared with the JAX lore ids stripped (ROADMAP C.28)."""
import contextlib
import decimal
import io

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.analysis import audit as jaudit
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu.plan import typesig as jsig
from spark_rapids_tpu.plan.planner import Planner as JPlanner
from spark_rapids_tpu_torch.analysis import audit as paudit
from spark_rapids_tpu_torch.expr.expressions import (
    UnsupportedExpr as PUnsupported)
from spark_rapids_tpu_torch.plan import typesig as psig
from spark_rapids_tpu_torch.plan.planner import PlanMeta
from spark_rapids_tpu_torch.plan.planner import Planner as PPlanner

STRICT = {"spark.rapids.tpu.sql.audit.strict": True}


def _findings(report):
    """The findings' text, lore ids included: both planners number the
    converted tree (pre-order, before the JAX fusion pass), so equal
    trees give equal ids."""
    return [v.describe() for v in report.findings]


def _reports(build, data, conf=None):
    out = []
    for S, F, P in ((st.TpuSession, JF, JPlanner),
                    (lambda c: pt.TpuSession(c, device="cpu"), PF,
                     PPlanner)):
        s = S(dict(conf or {}))
        q = build(F, s.create_dataframe(data))
        planner = P(s.conf)
        with contextlib.redirect_stdout(io.StringIO()):
            planner.plan(q._plan)
        out.append(planner.last_audit)
    return out


def _upper_q(F, df):
    return df.select(F.upper(F.col("s")).alias("u"))


STRINGS = {"s": pa.array(["a", "b", None])}


def _no_strings(d):
    return "kernel refuses strings" if type(d).__name__ == "StringType" \
        else None


def test_strict_audit_refuses_before_execution(monkeypatch):
    """A kernel-truth refinement (here one registered on Upper in both
    registries) makes strict mode fail the plan with the node path, and
    no operator runs."""
    from spark_rapids_tpu_torch.exec import nodes as pnodes
    monkeypatch.setitem(jsig.AUDIT_CHECKS, "Upper", (_no_strings, ""))
    monkeypatch.setitem(psig.AUDIT_CHECKS, "Upper", (_no_strings, ""))
    executed = []
    orig = pnodes.InMemoryScanExec.execute_partition

    def counting(self, ctx, pid):
        executed.append(pid)
        return orig(self, ctx, pid)

    monkeypatch.setattr(pnodes.InMemoryScanExec, "execute_partition",
                        counting)
    msgs = []
    for s, F, exc in ((st.TpuSession(STRICT), JF, JUnsupported),
                      (pt.TpuSession(STRICT, device="cpu"), PF,
                       PUnsupported)):
        with pytest.raises(exc) as e:
            _upper_q(F, s.create_dataframe(STRINGS)).to_arrow()
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "will_not_work [loreId=1] Project: Upper in Project expr 'u' " \
        "over string: kernel refuses strings" in msgs[1]
    assert executed == []


def test_non_strict_keeps_the_verdict(monkeypatch):
    monkeypatch.setitem(jsig.AUDIT_CHECKS, "Upper", (_no_strings, ""))
    monkeypatch.setitem(psig.AUDIT_CHECKS, "Upper", (_no_strings, ""))
    j, p = _reports(_upper_q, STRINGS)
    assert _findings(p) == _findings(j)
    bad = p.of_kind(paudit.WILL_NOT_WORK)
    assert len(bad) == 1 and bad[0].lore_id == 1    # the Project
    assert not p.ok


def test_unregistered_expression_tags_will_not_work(monkeypatch):
    monkeypatch.delitem(jsig.SIGS, "Upper")
    monkeypatch.delitem(psig.SIGS, "Upper")
    j, p = _reports(_upper_q, STRINGS)
    assert _findings(p) == _findings(j)
    assert any("unregistered expression Upper" in v.reason
               for v in p.of_kind(paudit.WILL_NOT_WORK))


def test_fallback_plan_is_will_fallback_and_strict_still_runs():
    build = lambda F, df: df.select(  # noqa: E731
        F.like(F.col("s"), "a\\%").alias("r"))
    data = {"s": pa.array(["a%", "ab", None])}
    j, p = _reports(build, data, STRICT)
    assert _findings(p) == _findings(j)
    assert p.of_kind(paudit.WILL_FALLBACK)
    assert not p.of_kind(paudit.WILL_NOT_WORK)
    got = build(PF, pt.TpuSession(STRICT, device="cpu").create_dataframe(
        data)).to_pydict()
    assert got["r"] == [True, False, None]


def test_clean_plan_has_no_findings():
    build = lambda F, df: df.filter(F.col("a") > 1).group_by("a").agg(  # noqa
        F.sum(F.col("b")).alias("s"))
    j, p = _reports(build, {"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]})
    assert p.findings == j.findings == []
    assert p.ok and p.node_count == j.node_count >= 3
    assert p.fusion_groups == []


@pytest.mark.parametrize("mode", ["VALIDATE", "NOT_ON_TPU"])
@pytest.mark.parametrize("case", ["clean", "fallback", "escape_filter"])
def test_explain_text_equals_jax_but_lore_ids_and_fused_stages(mode, case):
    builds = {
        "clean": lambda F, df: df.select(F.col("a")),
        "fallback": lambda F, df: df.select(
            F.col("a").isin("1").alias("r"), "a"),
        "escape_filter": lambda F, df: df.filter(
            F.like(F.col("s"), "%\\_%")).select("a"),
    }
    data = {"a": pa.array([1, 2, 3]), "s": pa.array(["x_", "y", "_"])}
    texts = []
    for s, F in ((st.TpuSession(), JF), (pt.TpuSession(device="cpu"), PF)):
        q = builds[case](F, s.create_dataframe(data))
        with contextlib.redirect_stdout(io.StringIO()):
            lines = q.explain(mode).splitlines()
        if "-- fused stages --" in lines:
            lines = lines[:lines.index("-- fused stages --")]
        texts.append(lines)
    assert texts[1] == texts[0]
    if mode == "VALIDATE":
        assert texts[1][0] == "== PLAN AUDIT =="
        if case == "clean":
            assert "no findings" in texts[1][-1]


def test_audit_runs_on_a_tagged_meta_without_conversion(monkeypatch):
    monkeypatch.setitem(psig.AUDIT_CHECKS, "Upper", (_no_strings, ""))
    s = pt.TpuSession(device="cpu")
    meta = PlanMeta(_upper_q(PF, s.create_dataframe(STRINGS))._plan)
    report = paudit.audit_plan(meta, s.conf)
    assert report.of_kind(paudit.WILL_NOT_WORK)
    assert report.of_kind(paudit.WILL_NOT_WORK)[0].lore_id is None
    assert "== PLAN AUDIT ==" in report.render()


def test_parquet_scan_fallback_reasons_equal_jax(tmp_path):
    """A gzip column chunk cannot decode on the device: a will_fallback
    finding naming the column and the codec, as in the JAX audit."""
    path = str(tmp_path / "g.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2, 3], pa.int64()),
                             "m": pa.array([{"x": 1}, None, {"x": 2}])}),
                   path, compression="gzip")
    reports = []
    for S, P in ((st.TpuSession, JPlanner),
                 (lambda: pt.TpuSession(device="cpu"), PPlanner)):
        s = S()
        planner = P(s.conf)
        with contextlib.redirect_stdout(io.StringIO()):
            planner.plan(s.read.parquet(path)._plan)
        reports.append(planner.last_audit)
    assert _findings(reports[1]) == _findings(reports[0])
    assert any("scan device-decode fallback (codec)" in f
               for f in _findings(reports[1]))


def test_decimal128_math_is_refused_at_bind_in_the_port():
    """sqrt over decimal(26,3): the JAX binder admits it and its audit
    flags will_not_work (its device path breaks); the port's binder
    refuses it, and no host rule exists for MathUnary in either package
    (ROADMAP C.17)."""
    arr = pa.array([decimal.Decimal("12345678901234567890123.456"),
                    decimal.Decimal("2.500")], pa.decimal128(26, 3))
    js = st.TpuSession()
    jq = js.create_dataframe({"d": arr}).select(
        JF.sqrt(JF.col("d")).alias("r"))
    planner = JPlanner(js.conf)
    with contextlib.redirect_stdout(io.StringIO()):
        planner.plan(jq._plan)
    assert planner.last_audit.of_kind(jaudit.WILL_NOT_WORK)
    with pytest.raises(PUnsupported):
        pt.TpuSession(device="cpu").create_dataframe({"d": arr}).select(
            PF.sqrt(PF.col("d")).alias("r"))


def test_explain_analyze_waits_for_the_profiler():
    """The profiler landed (ROADMAP A.13): ANALYZE runs the query and
    renders the tree that ran, each node with its lore id and rows, the
    JAX renderer's layout, and the timer note."""
    from spark_rapids_tpu_torch.profiler.analyze import TIMER_NOTE
    df = pt.TpuSession(device="cpu").create_dataframe({"a": [1, 2, 3]})
    with contextlib.redirect_stdout(io.StringIO()) as out:
        text = df.filter(PF.col("a") > 1).explain("ANALYZE")
    assert out.getvalue().rstrip("\n") == text
    lines = text.splitlines()
    assert lines[0] == "== EXPLAIN ANALYZE =="
    assert lines[1].startswith("[loreId=1] FilterExec[(a#0 > ")
    assert lines[2].startswith("  [loreId=2] InMemoryScanExec  rows=3")
    assert lines[-1] == TIMER_NOTE
