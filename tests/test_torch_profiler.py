"""The query profiler (`profiler/`, `utils/metrics.py`, `utils/lore.py`,
ROADMAP A.13's first half) against the JAX package.

The port's event log is read by the JAX package's own `read_event_log`
and `aggregate_ops`; its record kinds and operator keys (`lore_id:name`)
equal the JAX log's, with JAX stage fusion off (the JAX fused tree
renumbers nothing but merges nodes into FusedStages, which the port has
not: ROADMAP A.11). EXPLAIN ANALYZE equals the JAX rendering node for
node with the times masked: the lore id, the operator's description and
its rows. Metric levels, lore ids and a LORE dump replayed through
`load_input` are held against the JAX package too."""
import contextlib
import io
import json
import re

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.profiler.event_log import aggregate_ops
from spark_rapids_tpu.profiler.event_log import read_event_log
from spark_rapids_tpu.utils.lore import load_input as jload_input
from spark_rapids_tpu_torch.profiler.analyze import TIMER_NOTE
from spark_rapids_tpu_torch.profiler.event_log import op_time_seconds
from spark_rapids_tpu_torch.utils import lore as plore
from spark_rapids_tpu_torch.utils import metrics as pmetrics

NO_FUSION = {"spark.rapids.tpu.sql.exec.stageFusion.enabled": False}

#: JAX records the port cannot write yet (ROADMAP C.39): the query
#: service's admission records and the XLA compile accounting; the
#: port's `kernel_launches` record stands in the latter's place
JAX_ONLY = {"query_queued", "query_admitted", "xla_compile", "compile"}
PORT_ONLY = {"kernel_launches"}


def _conf(tmp_path, name, **extra):
    return {"spark.rapids.tpu.sql.batchSizeRows": 4096,
            "spark.rapids.tpu.sql.eventLog.enabled": True,
            "spark.rapids.tpu.sql.eventLog.dir": str(tmp_path / name),
            **extra}


def _pair(tmp_path, **extra):
    return (st.TpuSession({**_conf(tmp_path, "jax", **extra),
                           **NO_FUSION}),
            pt.TpuSession(_conf(tmp_path, "port", **extra), device="cpu"))


def q3ish(s, F):
    """The JAX `test_profiler.py` three-way join and aggregate."""
    col, lit = F.col, F.lit
    cust = s.create_dataframe({
        "c_custkey": list(range(50)),
        "c_seg": ["A" if i % 2 else "B" for i in range(50)]})
    orders = s.create_dataframe({
        "o_orderkey": list(range(200)),
        "o_custkey": [i % 50 for i in range(200)],
        "o_date": [i % 30 for i in range(200)]})
    li = s.create_dataframe({
        "l_orderkey": [i % 200 for i in range(1000)],
        "l_price": [float(i % 97) for i in range(1000)],
        "l_disc": [0.01 * (i % 5) for i in range(1000)]})
    rev = col("l_price") * (lit(1.0) - col("l_disc"))
    return (cust.filter(col("c_seg") == lit("A"))
            .join(orders.with_column("c_custkey", col("o_custkey")),
                  on=["c_custkey"], how="inner")
            .with_column("l_orderkey", col("o_orderkey"))
            .join(li, on=["l_orderkey"], how="inner")
            .group_by("o_date")
            .agg(F.sum(rev).alias("revenue")))


def _grouped(s, F):
    """A shuffled aggregate: partial, exchange, adaptive read, final."""
    rng = np.random.default_rng(3)
    df = s.create_dataframe({"k": pa.array(rng.integers(0, 7, 5000)),
                             "v": pa.array(rng.integers(0, 100, 5000))})
    return df.repartition(3).group_by("k").agg(F.sum("v").alias("s"))


QUERIES = {"q3ish": (q3ish, {}),
           "grouped": (_grouped, {"spark.rapids.tpu.sql.batchSizeRows":
                                  1024,
                                  "spark.rapids.tpu.sql.shuffle.partitions":
                                  4})}


def _gensym_free(text):
    """A join's hidden right-side names carry a process-wide counter
    (`__join_r<N>_`), which differs between two packages that built
    different numbers of joins before: masked."""
    return re.sub(r"__join_r\d+_", "__join_rN_", text)


def _log(s, q):
    q.to_arrow()
    return read_event_log(s.last_event_log)


def _kinds(evs, drop):
    out = []
    for e in evs:
        k = e["event"]
        if k in drop or (out and k == "trace_span" and out[-1] == k):
            continue
        out.append(k)
    return out


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_event_log_read_by_the_jax_reader_equals_jax(tmp_path, name):
    build, extra = QUERIES[name]
    js, ps = _pair(tmp_path, **extra)
    jev, pev = _log(js, build(js, JF)), _log(ps, build(ps, PF))
    assert _kinds(pev, PORT_ONLY) == _kinds(jev, JAX_ONLY)
    assert _kinds(pev, ())[:3] == ["query_start", "plan", "plan_audit"]
    qid = pev[0]["query_id"]
    assert all(e["query_id"] == qid and json.loads(json.dumps(e)) == e
               for e in pev)
    jops = aggregate_ops([o for e in jev if e["event"] == "op_metrics"
                          for o in e["ops"]])
    pops = aggregate_ops([o for e in pev if e["event"] == "op_metrics"
                          for o in e["ops"]])
    assert sorted(pops) == sorted(jops)
    for key in pops:
        assert _gensym_free(pops[key]["describe"]) == \
            _gensym_free(jops[key]["describe"]), key
        rows = pops[key]["metrics"].get("numOutputRows")
        if rows is not None and "numOutputRows" in jops[key]["metrics"]:
            assert rows == jops[key]["metrics"]["numOutputRows"], key
    # every physical node has a lore id and an op_metrics record
    plan = next(e["plan"] for e in pev if e["event"] == "plan")
    ids = []

    def walk(n):
        ids.append(n["lore_id"])
        for c in n["children"]:
            walk(c)

    walk(plan)
    assert ids == list(range(1, len(ids) + 1))
    assert {r["lore_id"] for e in pev if e["event"] == "op_metrics"
            for r in e["ops"]} == set(ids)
    end = pev[-1]
    assert end["event"] == "query_end" and end["status"] == "ok"
    launches = next(e for e in pev if e["event"] == "kernel_launches")
    root = next(r for e in pev if e["event"] == "op_metrics"
                for r in e["ops"] if r["lore_id"] == 1)
    assert launches["host_syncs"] == root["metrics"]["hostSyncs"] > 0
    assert launches["kernel_launches"] == 0    # the plain version on CPU


def test_event_log_off_by_default_and_records_a_failed_query(tmp_path):
    s = pt.TpuSession(device="cpu")
    s.create_dataframe({"a": [1, 2, 3]}).to_arrow()
    assert s.last_event_log is None
    s = pt.TpuSession({**_conf(tmp_path, "fail"),
                       "spark.rapids.tpu.sql.allowCpuFallback": False,
                       "spark.rapids.tpu.sql.exec.degradeToHost.enabled":
                       False}, device="cpu")
    import torch_udf_fns as fns
    from spark_rapids_tpu_torch.columnar import dtypes as pdt
    with pytest.raises(ValueError, match="udf says no"):
        s.create_dataframe({"a": [1, 2]}).select(PF.udf(
            fns.boom, pdt.INT64)(PF.col("a")).alias("b")).to_arrow()
    evs = read_event_log(s.last_event_log)
    assert evs[-1]["event"] == "query_end"
    assert evs[-1]["status"] == "error" and "udf says no" in \
        evs[-1]["error"]
    assert "op_metrics" in [e["event"] for e in evs]


def _analyze_lines(text):
    """(lore id + description, rows) a node line; times masked."""
    out = []
    for ln in text.splitlines():
        m = re.match(r"^(\s*\[loreId=\d+\] .*?)(  |$)", ln)
        if m:
            rows = re.search(r" rows=(\d+)", ln)
            out.append((_gensym_free(m.group(1)), rows and rows.group(1)))
    return out


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_analyze_equals_jax_with_times_masked(tmp_path, name):
    build, extra = QUERIES[name]
    texts = []
    for s, F in zip(_pair(tmp_path, **extra), (JF, PF)):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            texts.append(build(s, F).explain("ANALYZE"))
        assert out.getvalue().rstrip("\n") == texts[-1]
    j, p = texts
    assert _analyze_lines(p) == _analyze_lines(j)
    lines = p.splitlines()
    assert lines[0] == "== EXPLAIN ANALYZE =="
    assert "kernelLaunches=0" in lines[1] and "hostSyncs=" in lines[1]
    assert "criticalPath=" in lines[1]
    assert "time sink #1" in p and "total attributed op time" in p
    assert lines[-1] == TIMER_NOTE
    if name == "grouped":
        assert "shuffle=" in p and "AQEShuffleRead[coalesced" in p


def test_sql_explain_analyze_equals_the_dataframe_one(tmp_path):
    _, ps = _pair(tmp_path)
    ps.create_dataframe({"a": [1, 2, 2], "b": [1.0, 2.0, 3.0]}) \
        .create_or_replace_temp_view("t")
    with contextlib.redirect_stdout(io.StringIO()):
        txt = ps.sql("EXPLAIN ANALYZE SELECT a, sum(b) FROM t GROUP BY a") \
            .collect()[0][0]
        plain = ps.sql("EXPLAIN SELECT a, sum(b) FROM t GROUP BY a") \
            .collect()[0][0]
    assert "time=" in txt and "time sink #1" in txt
    # the ids explain prints are the ids ANALYZE reports
    assert set(re.findall(r"loreId=(\d+)", plain)) == \
        set(re.findall(r"loreId=(\d+)", txt))


@pytest.mark.parametrize("level", ["ESSENTIAL", "MODERATE", "DEBUG"])
def test_metric_levels_equal_jax(tmp_path, level):
    """Every metric is MODERATE in both packages: ESSENTIAL shows none,
    MODERATE and DEBUG all (the keys compared where both name them)."""
    key = "spark.rapids.tpu.sql.metrics.level"
    got = []
    for s, F in zip(_pair(tmp_path, **{key: level}), (JF, PF)):
        q = _grouped(s, F)
        q.to_arrow()
        got.append(q.last_metrics())
    j, p = got
    if level == "ESSENTIAL":
        assert all(v == {} for v in p.values())
        assert all(v == {} for v in j.values())
    else:
        assert any("hashPassTime" in v for v in p.values())
        assert any("numOutputRows" in v for v in p.values())
    assert pmetrics.parse_level(level) == {
        "ESSENTIAL": 0, "MODERATE": 1, "DEBUG": 2}[level]


def test_metrics_sync_timers_record(tmp_path):
    _, ps = _pair(tmp_path, **{"spark.rapids.tpu.sql.metrics.sync": True})
    q = ps.create_dataframe({"a": [1, 2, 3, 4] * 64}).group_by("a").agg(
        PF.count(PF.col("a")).alias("n"))
    with contextlib.redirect_stdout(io.StringIO()):
        text = q.explain("ANALYZE")
    assert any(v > 0 for snap in q.last_metrics().values()
               for k, v in snap.items() if k.endswith("Time"))
    assert TIMER_NOTE not in text           # the timers waited


def test_lore_ids_and_a_dump_replayed_equal_jax(tmp_path):
    """The filter's LORE id dumps its input; `load_input` reads it back
    in both packages, equal rows, and re-running the filter over the
    replayed input gives the original output."""
    rng = np.random.default_rng(8)
    data = {"k": pa.array(rng.integers(0, 50, 3000)),
            "v": pa.array(rng.integers(0, 9, 3000))}
    outs = []
    for name, S, F, load in (
            ("jax", lambda c: st.TpuSession({**c, **NO_FUSION}), JF,
             jload_input),
            ("port", lambda c: pt.TpuSession(c, device="cpu"), PF,
             plore.load_input)):
        path = str(tmp_path / f"lore_{name}")
        s = S({"spark.rapids.tpu.sql.batchSizeRows": 1000,
               "spark.rapids.tpu.sql.lore.idsToDump": "2",
               "spark.rapids.tpu.sql.lore.dumpPath": path})
        q = s.create_dataframe(data).filter(F.col("v") > 4).select(
            (F.col("k") * 2).alias("kk"))
        with contextlib.redirect_stdout(io.StringIO()):
            text = q.explain("ALL")
        assert re.search(r"\* \[loreId=2\] Filter\[", text)
        got = q.to_arrow()
        meta = json.load(open(f"{path}/lore-meta.json"))
        assert list(meta) == ["2"] and meta["2"].startswith("FilterExec[")
        # replayed in a session that dumps nothing (the dump's own
        # session would write into the files it reads)
        replay = load(S({"spark.rapids.tpu.sql.batchSizeRows": 1000}),
                      path, 2)
        rows = sorted(replay.to_arrow().to_pylist(),
                      key=lambda r: (r["k"], r["v"]))
        again = replay.filter(F.col("v") > 4).select(
            (F.col("k") * 2).alias("kk")).to_arrow()
        assert sorted(again.column(0).to_pylist()) == \
            sorted(got.column(0).to_pylist())
        outs.append(rows)
    assert outs[1] == outs[0] and len(outs[1]) == 3000


def test_plan_audit_record_carries_lore_ids(tmp_path):
    _, ps = _pair(tmp_path)
    q = ps.create_dataframe({"s": ["a%", "b"]}).filter(
        PF.like(PF.col("s"), "a\\%"))
    evs = _log(ps, q)
    (audit,) = [e for e in evs if e["event"] == "plan_audit"]
    assert audit["ok"] and audit["nodes"] == 2
    (f,) = audit["findings"]
    assert f["kind"] == "will_fallback" and f["lore_id"] == 1


def test_op_time_and_top_operators_read_the_records(tmp_path):
    from spark_rapids_tpu_torch.profiler.event_log import top_operators
    _, ps = _pair(tmp_path)
    evs = _log(ps, q3ish(ps, PF))
    ops = [o for e in evs if e["event"] == "op_metrics" for o in e["ops"]]
    assert sum(op_time_seconds(r["metrics"]) for r in ops) > 0
    top = top_operators(ops, 3)
    assert len(top) == 3
    assert top[0]["time_ms"] >= top[1]["time_ms"] >= top[2]["time_ms"]
