"""The port's tracing (`profiler/tracing.py`, `profiler/critical_path.py`,
`profiler/telemetry.py`): the span API and its parenting, deterministic
sampling, the span tree a query assembles in its event log, and the
critical-path shares, held against the JAX modules on the same inputs
(the span lists are made from a numpy seed)."""
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.profiler import critical_path as jcp
from spark_rapids_tpu.profiler import telemetry as jtel
from spark_rapids_tpu.profiler.event_log import read_event_log
from spark_rapids_tpu_torch.config import (TRACE_ENABLED,
                                           TRACE_SAMPLE_RATE, TpuConf)
from spark_rapids_tpu_torch.profiler import critical_path, telemetry
from spark_rapids_tpu_torch.profiler import tracing
from spark_rapids_tpu_torch.profiler.event_log import EventLogWriter


def test_span_nesting_and_parenting():
    tc = tracing.start_trace("unit-q1", TpuConf({}))
    assert tc is not None and tc.trace_id == "unit-q1"
    root = tracing.open_span("query", "query", tc)
    try:
        with tracing.use(tracing.TraceContext("unit-q1", root.span_id,
                                              True)):
            with tracing.span("plan", "plan") as p:
                p.set("nodes", 7)
                with tracing.span("aqe.stage_materialize", "aqe"):
                    pass
            assert tracing.current().span_id == root.span_id
    finally:
        root.end()
    spans = tracing.drain_trace("unit-q1")
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {"query", "plan", "aqe.stage_materialize"}
    assert by_name["query"]["parent_id"] is None
    assert by_name["plan"]["parent_id"] == root.span_id
    assert by_name["aqe.stage_materialize"]["parent_id"] \
        == by_name["plan"]["span_id"]
    assert by_name["plan"]["attrs"] == {"nodes": 7}
    for s in spans:
        assert s["end_ns"] >= s["start_ns"] and s["dur_ms"] >= 0
        assert s["proc"] == os.getpid()
        assert json.loads(json.dumps(s)) == s
    assert tracing.drain_trace("unit-q1") == []
    d0 = tracing.dropped_spans()
    tracing.open_span("late", "pool_task", tc).end()
    assert tracing.drain_trace("unit-q1") == []
    assert tracing.dropped_spans() == d0 + 1


def test_off_trace_is_noop_and_wait_spans_backdate():
    with tracing.use(None):
        assert tracing.current() is None
        sp = tracing.open_span("x", "pool_task")
        sp.set("a", 1)
        sp.end()
        with tracing.span("y", "plan") as sp2:
            sp2.set("b", 2)
        tracing.record_wait_span("w", "pool_wait", 50.0)
    tc = tracing.TraceContext("unit-wait", None, True)
    tracing.record_wait_span("exchange.pool_admission", "pool_wait", 125.0,
                             ctx=tc, mpid=3)
    (s,) = tracing.drain_trace("unit-wait")
    assert s["kind"] == "pool_wait" and s["dur_ms"] == 125.0
    assert s["end_ns"] - s["start_ns"] == int(125.0 * 1e6)
    assert s["end_ns"] <= time.time_ns() and s["attrs"] == {"mpid": 3}
    tracing.record_wait_span("w", "pool_wait", 0.0, ctx=tc)
    assert tracing.drain_trace("unit-wait") == []


def test_sampling_is_deterministic_and_equals_jax():
    from spark_rapids_tpu.config import TpuConf as JConf
    from spark_rapids_tpu.profiler import tracing as jtr
    assert tracing.start_trace("q", TpuConf({TRACE_ENABLED.key: False})) \
        is None
    assert tracing.start_trace("q", TpuConf({TRACE_SAMPLE_RATE.key: 0.0})) \
        is None
    half = {TRACE_SAMPLE_RATE.key: 0.5}
    ids = [f"query-{i}" for i in range(400)]
    first = [tracing.start_trace(q, TpuConf(half)) is not None
             for q in ids]
    assert first == [tracing.start_trace(q, TpuConf(half)) is not None
                     for q in ids]
    assert first == [jtr.start_trace(q, JConf(half)) is not None
                     for q in ids]
    assert 0.35 < sum(first) / len(first) < 0.65


def _random_spans(seed):
    """A rooted trace of 30 spans over 100 ms, kinds from the shared
    vocabulary, nested at random."""
    rng = np.random.default_rng(seed)
    kinds = ["plan", "aqe", "pool_task", "pool_wait", "degrade", "fetch",
             "spill_write", "compile", "queue"]
    spans = [{"trace_id": "t", "span_id": "r", "parent_id": None,
              "name": "query", "kind": "query", "start_ns": 0,
              "end_ns": 100_000_000, "dur_ms": 100.0, "proc": 1}]
    for i in range(30):
        parent = spans[int(rng.integers(0, len(spans)))]
        a = int(rng.integers(parent["start_ns"], parent["end_ns"] + 1))
        b = int(rng.integers(a, parent["end_ns"] + 1))
        spans.append({"trace_id": "t", "span_id": f"s{i}",
                      "parent_id": parent["span_id"], "name": f"n{i}",
                      "kind": kinds[int(rng.integers(0, len(kinds)))],
                      "start_ns": a, "end_ns": b,
                      "dur_ms": (b - a) / 1e6, "proc": 1})
    return spans


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("wall", [None, 0.25])
def test_critical_path_summary_equals_jax(seed, wall):
    spans = _random_spans(seed)
    got = critical_path.summarize(spans, wall)
    assert got == jcp.summarize(spans, wall)
    # each share is rounded to a microsecond
    assert sum(got["shares"].values()) == pytest.approx(got["total_ms"],
                                                        abs=0.01)
    assert critical_path.span_depths(spans) == jcp.span_depths(spans)
    assert critical_path.render_waterfall(spans) == \
        jcp.render_waterfall(spans)
    assert critical_path.dominant_of_pct(got["share_pct"]) == \
        got["dominant"]


def _session(tmp_path, **extra):
    return pt.TpuSession({
        "spark.rapids.tpu.sql.batchSizeRows": 512,
        "spark.rapids.tpu.sql.shuffle.partitions": 4,
        "spark.rapids.tpu.sql.exec.exchange.mapThreads": 2,
        "spark.rapids.tpu.sql.eventLog.enabled": True,
        "spark.rapids.tpu.sql.eventLog.dir": str(tmp_path / "events"),
        **extra}, device="cpu")


def _query(s):
    rng = np.random.default_rng(7)
    df = s.create_dataframe({"k": pa.array(rng.integers(0, 500, 4000)),
                             "v": pa.array(rng.integers(0, 13, 4000))})
    return df.filter(PF.col("v") > 2).group_by("k").agg(
        PF.sum(PF.col("v")).alias("sv"))


def test_a_query_assembles_one_span_tree_in_its_log(tmp_path):
    s = _session(tmp_path)
    q = _query(s)
    q.to_arrow()
    evs = read_event_log(s.last_event_log)
    qid = evs[0]["query_id"]
    spans = [e for e in evs if e["event"] == "trace_span"]
    assert {sp["trace_id"] for sp in spans} == {qid}
    by_id = {sp["span_id"]: sp for sp in spans}
    (root,) = [sp for sp in spans if sp["kind"] == "query"]
    assert root["parent_id"] is None and root["attrs"] == {
        "action": "collect"}
    names = [sp["name"] for sp in spans]
    assert names.count("plan") == 1
    # the final aggregate's exchange: one adaptive materialization, its
    # map tasks on the pool (one span a map partition, under it)
    (mat,) = [sp for sp in spans if sp["name"] == "aqe.stage_materialize"]
    maps = [sp for sp in spans if sp["name"] == "exchange.map"]
    assert sorted(sp["attrs"]["mpid"] for sp in maps) == list(range(8))
    assert all(sp["parent_id"] == mat["span_id"] for sp in maps)
    assert mat["parent_id"] == root["span_id"]
    assert all(sp["parent_id"] in by_id for sp in spans if sp is not root)
    (summ,) = [e for e in evs if e["event"] == "trace_summary"]
    assert summ["span_count"] == len(spans)
    assert summ["dominant"] in critical_path.CATEGORIES
    assert sum(summ["share_pct"].values()) == pytest.approx(100, abs=0.5)
    assert sum(summ["shares"].values()) == pytest.approx(
        summ["total_ms"], rel=1e-3)
    wall = next(e for e in evs if e["event"] == "query_end")["wall_s"]
    assert summ["total_ms"] >= wall * 1e3 * 0.99
    # the shares ride the root's metrics (EXPLAIN ANALYZE's criticalPath)
    rm = q.last_metrics()[q.last_plan()._op_id]
    cps = {k.split(".", 1)[1]: v for k, v in rm.items()
           if k.startswith("criticalPathShare.")}
    assert cps == {c: p for c, p in summ["share_pct"].items() if p}


def test_trace_conf_gates(tmp_path):
    for extra in ({"spark.rapids.tpu.sql.trace.enabled": False},
                  {"spark.rapids.tpu.sql.trace.sampleRate": 0.0}):
        s = _session(tmp_path, **extra)
        q = _query(s)
        q.to_arrow()
        evs = read_event_log(s.last_event_log)
        assert not [e for e in evs if e["event"] in ("trace_span",
                                                     "trace_summary")]
        assert not any(k.startswith("criticalPathShare.")
                       for m in q.last_metrics().values() for k in m)


def test_trace_closes_without_the_event_log(tmp_path):
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 512},
                      device="cpu")
    q = _query(s)
    q.to_arrow()
    rm = q.last_metrics()[q.last_plan()._op_id]
    shares = [v for k, v in rm.items() if k.startswith("criticalPathShare.")]
    assert shares and sum(shares) == pytest.approx(100, abs=0.5)
    with tracing._LOCK:
        assert not [t for t in tracing._TRACES if t.startswith("query-")]


def test_broadcast_build_and_degrade_spans(tmp_path, monkeypatch):
    """An async broadcast build is a `broadcast.build` pool task; an
    operator pinned to the host opens a `degrade.to_host` marker."""
    from spark_rapids_tpu_torch.exec import nodes as pnodes
    s = _session(tmp_path)
    fact = s.create_dataframe({"k": list(range(300)),
                               "v": [i % 7 for i in range(300)]})
    dim = s.create_dataframe({"k": list(range(0, 300, 3)),
                              "w": list(range(100))})
    q = fact.join(dim, on=["k"])
    q.to_arrow()
    names = [e["name"] for e in read_event_log(s.last_event_log)
             if e["event"] == "trace_span"]
    assert "broadcast.build" in names
    calls = [0]
    orig = pnodes.FilterExec.fusable_stage

    def failing(self):
        fn = orig(self)

        def stage(cvs, mask):
            calls[0] += 1
            if calls[0] <= 2:
                raise RuntimeError("injected device failure")
            return fn(cvs, mask)
        return stage

    monkeypatch.setattr(pnodes.FilterExec, "fusable_stage", failing)
    # four batches: the second failure pins the filter to the host
    s.create_dataframe({"v": [i % 7 for i in range(2000)]}).filter(
        PF.col("v") > 1).to_arrow()
    evs = read_event_log(s.last_event_log)
    names = [e["name"] for e in evs if e["event"] == "trace_span"]
    assert "degrade.to_host" in names
    assert "degrade_to_host" in [e["event"] for e in evs]


def test_telemetry_equals_jax_on_the_same_observations():
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.lognormal(0, 2, 500), [0.0, -1.0]])
    telemetry.reset()
    ph, jh = telemetry.histogram("lat_ms"), jtel.Histogram("lat_ms")
    for v in vals:
        ph.observe(v)
        jh.observe(v)
    ph.observe("junk")
    assert ph.summary() == jh.summary()
    telemetry.counter("queries").inc(3)
    telemetry.gauge("depth").set(2)
    telemetry.register_gauge_fn("pool", lambda: {"a": 1, "b": 2})
    snap = telemetry.snapshot()
    assert snap["counters"]["queries"] == 3
    assert snap["gauges"]["depth"] == 2 and snap["gauges"]["pool_a"] == 1
    assert "memory_device_peak_bytes" in snap["gauges"]
    assert "trace_spans_dropped" in snap["gauges"]
    text = telemetry.render_prometheus()
    assert "# TYPE srtpu_queries counter\nsrtpu_queries 3" in text
    assert 'srtpu_lat_ms{quantile="0.95"}' in text
    telemetry.reset()


def test_event_log_writer_concurrent_emit_and_dead_volume(tmp_path):
    path = str(tmp_path / "q.jsonl")
    w = EventLogWriter(path, "q")

    def emit(i):
        for j in range(50):
            w.emit("trace_span", i=i, j=j, pad="x" * 64)

    ts = [threading.Thread(target=emit, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    w.close()
    recs = read_event_log(path)
    assert len(recs) == 400
    assert {(r["i"], r["j"]) for r in recs} == {
        (i, j) for i in range(8) for j in range(50)}
    # an OSError mid-query (a full or yanked log volume) disables the
    # writer quietly; the prefix stays readable
    dead = str(tmp_path / "dead.jsonl")
    w2 = EventLogWriter(dead, "q2")
    w2.emit("alpha")
    os.close(w2._f.fileno())
    w2.emit("beta")
    w2.emit("gamma")
    w2.close()
    assert [e["event"] for e in read_event_log(dead)] == ["alpha"]
