"""Structured per-query event log (the Spark event-log analog), the
port of the JAX package's `profiler/event_log.py`.

One JSONL file per query under `spark.rapids.tpu.sql.eventLog.dir`, with
the JAX package's typed records, so its `read_event_log` and
`aggregate_ops` (and its profiling tool) read the port's logs:

  query_start   {query_id, action, ts}
  plan          {plan: nested {lore_id, name, describe, children}}
  plan_audit    {ok, nodes, findings: [{kind, reason, node, path,
                 lore_id}]}   (static auditor, analysis/audit.py)
  aqe_replan    {action, decisions: [...]}  (adaptive stage driver,
                 plan/aqe.py; when any replan decision was taken)
  degrade_to_host {op, op_id, failures, error}  (exec/degrade.py)
  op_metrics    {ops: [{lore_id, name, describe, metrics}]}
  concurrency_report{enabled, resources, orderEdges, maxOrderGraph,
                 acquires, findings}  (runtime/lockdep.py, when on)
  resource_ledger{enabled, kinds: {kind: {acquires, releases,
                 outstanding, peakOutstanding}}, balanceOk,
                 balancedQueries, imbalancedQueries, findings}
                (runtime/ledger.py, when on)
  race_report   {enabled, tracked, shared, accesses, findings,
                 perturbed}  (runtime/racedep.py, when on)
  watermarks    {devicePeakBytes, hostPeakBytes, spill?, hostPressure?,
                 queryAttribution?}  (memory/diagnostics.py)
  kernel_launches {host_syncs, kernel_launches, vector_launches,
                 scalar_launches}   (profiler/xla_stats.py; in place of
                 the JAX `xla_compile` record)
  trace_span    {trace_id, span_id, parent_id, name, kind, start_ns,
                 end_ns, dur_ms, proc, attrs?}  (profiler/tracing.py)
  trace_summary {total_ms, shares, share_pct, dominant, dominant_pct,
                 span_count}  (profiler/critical_path.py)
  query_end     {status: ok|error, wall_s, error?}

Records of the JAX schema the port cannot write yet: `query_queued`,
`query_admitted`, `query_cancelled`, `query_retry` and `fleet` (they
need the query manager and the fleet, ROADMAP A.15), `result_cache`
(A.15), `compile` and `xla_compile` (no compiled programs; see
`kernel_launches`), `stage_submit` / `stage_complete` / `fetch_retry`
(the distributed runner, A.15).

`session.py` wraps every action (`profile_query`). Metric values honor
`spark.rapids.tpu.sql.metrics.level`; op time is the sum of the
operator's `*Time` timers (see utils/metrics.py for the asynchronous
launch caveat and the `sql.metrics.sync` gate).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..config import EVENT_LOG_DIR, EVENT_LOG_ENABLED
from ..utils.metrics import DEBUG, snapshot

__all__ = ["EventLogWriter", "open_query_log", "read_event_log",
           "next_query_id", "plan_tree", "op_metrics_records",
           "aggregate_ops", "op_time_seconds", "top_operators",
           "profile_query"]

_QUERY_SEQ = itertools.count()


def next_query_id(prefix: str = "query") -> str:
    """Process-unique query id (also the event-log file stem)."""
    return f"{prefix}-{os.getpid()}-{next(_QUERY_SEQ)}"


def _json_default(o):
    try:
        return float(o)
    except Exception:
        return str(o)


class EventLogWriter:
    """Append-only JSONL writer; one file per query, flushed per event
    so a crashed query still leaves a readable prefix."""

    def __init__(self, path: str, query_id: str):
        self.path = path
        self.query_id = query_id
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, event: str, **fields):
        rec = {"event": event, "ts": round(time.time(), 6),
               "query_id": self.query_id}
        rec.update(fields)
        line = json.dumps(rec, default=_json_default)
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(line + "\n")
                self._f.flush()
            except OSError:
                # a full/yanked log volume must not fail the query; a
                # torn line is fine — the reader skips it
                f, self._f = self._f, None
                try:
                    f.close()
                except OSError:
                    pass

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


def open_query_log(conf, query_id: str) -> Optional[EventLogWriter]:
    """EventLogWriter for this query, or None when logging is off."""
    if not conf.get(EVENT_LOG_ENABLED):
        return None
    d = conf.get(EVENT_LOG_DIR)
    try:
        os.makedirs(d, exist_ok=True)
        return EventLogWriter(os.path.join(d, f"{query_id}.jsonl"),
                              query_id)
    except OSError:
        return None


def read_event_log(path: str) -> List[dict]:
    """Parse a JSONL event log; tolerates a torn trailing line."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


# ---------------------------------------------------------------------
# plan / metric snapshots (shared by session, cluster runner, tools)
# ---------------------------------------------------------------------
def plan_tree(root) -> dict:
    """Physical plan as a JSON-able tree keyed by lore_id (stable for
    the same plan in every process: the aggregation key)."""
    return {"lore_id": getattr(root, "lore_id", None),
            "name": root.node_name(),
            "describe": root.describe(),
            "children": [plan_tree(c) for c in root.children]}


def op_metrics_records(root, metrics_by_opid: Dict[str, object],
                       max_level: int = DEBUG) -> List[dict]:
    """Flatten the physical tree into per-operator metric records.
    `metrics_by_opid` maps `node._op_id` to the operator's metric dict
    (an ExecContext's `metrics`, or `DataFrame.last_metrics()`), shown
    at or below `max_level`."""
    recs = []

    def walk(node):
        ms = snapshot(metrics_by_opid.get(node._op_id) or {}, max_level)
        recs.append({"lore_id": getattr(node, "lore_id", None),
                     "name": node.node_name(),
                     "describe": node.describe(),
                     "metrics": dict(ms or {})})
        for c in node.children:
            walk(c)

    walk(root)
    return recs


def aggregate_ops(records: List[dict]) -> Dict[str, dict]:
    """Merge operator records across queries, keyed by `lore_id:name`
    (stable for the same plan in every process; the id()-based _op_ids
    are not). Numeric metrics sum."""
    out: Dict[str, dict] = {}
    for r in records:
        key = f"{r.get('lore_id')}:{r.get('name')}"
        cur = out.setdefault(key, {"lore_id": r.get("lore_id"),
                                   "name": r.get("name"),
                                   "describe": r.get("describe"),
                                   "metrics": {}})
        for k, v in (r.get("metrics") or {}).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                cur["metrics"][k] = v
            else:
                cur["metrics"][k] = cur["metrics"].get(k, 0) + v
    return out


def op_time_seconds(metrics: dict) -> float:
    """An operator's attributed time: the sum of its `*Time` timers
    (opTime, scanTime, buildTime, partitionTime, writeTime, ...)."""
    t = 0.0
    for k, v in (metrics or {}).items():
        if k.endswith("Time") and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            t += float(v)
    return t


def top_operators(records: List[dict], n: int = 5) -> List[dict]:
    """Top-n operators by attributed time (EXPLAIN ANALYZE's sink
    list)."""
    rows = []
    for r in records:
        m = r.get("metrics") or {}
        t = op_time_seconds(m)
        if t <= 0 and not m:
            continue
        rows.append({"op": r.get("describe"),
                     "loreId": r.get("lore_id"),
                     "time_ms": round(t * 1e3, 3),
                     "rows": m.get("numOutputRows")})
    rows.sort(key=lambda r: r["time_ms"], reverse=True)
    return rows[:n]


# ---------------------------------------------------------------------
# the per-action wrapper session.py runs every query inside
# ---------------------------------------------------------------------
@contextmanager
def profile_query(session, root, ctx, action: str, query_id: str):
    """Emit the full event sequence for one query action. No-op (beyond
    a cheap conf check) when event logging is disabled; the session
    closes the trace and adds the launch counts either way."""
    w = open_query_log(ctx.conf, query_id)
    if w is None:
        yield None
        return
    from ..memory import diagnostics
    from . import tracing, xla_stats
    if session is not None:
        session.last_event_log = w.path
    counts0 = xla_stats.snapshot()
    diagnostics.reset_watermarks()
    t0 = time.perf_counter()
    w.emit("query_start", action=action)
    w.emit("plan", plan=plan_tree(root))
    audit = getattr(root, "audit_report", None)
    if audit is not None:
        # static-audit verdicts keyed by lore id (analysis/audit.py)
        w.emit("plan_audit", ok=audit.ok, nodes=audit.node_count,
               findings=audit.to_events())
    status, err = "ok", None
    try:
        yield w
    except BaseException as e:
        status, err = "error", repr(e)
        raise
    finally:
        try:
            w.emit("op_metrics", ops=op_metrics_records(
                root, ctx.metrics, ctx.metrics_level))
            from ..runtime import ledger, lockdep, racedep
            lw = lockdep.witness()
            if lw is not None:
                w.emit("concurrency_report", **lw.report())
            lg = ledger.ledger()
            if lg is not None:
                w.emit("resource_ledger", **lg.report())
            rw = racedep.witness()
            if rw is not None:
                w.emit("race_report", **rw.report())
            w.emit("watermarks", **diagnostics.watermarks_snapshot())
            w.emit("kernel_launches", **xla_stats.delta(counts0))
            wall = time.perf_counter() - t0
            # end the root span, drain every span the query recorded
            # (the query thread and its pool workers) and reduce them
            # to the critical-path summary, failed queries included
            try:
                spans = tracing.finish(ctx, wall)
                for sp in spans:
                    w.emit("trace_span", **sp)
                if spans and ctx.trace_summary is not None:
                    w.emit("trace_summary", **ctx.trace_summary)
            except Exception:
                pass
            end = {"status": status, "wall_s": round(wall, 6)}
            if err is not None:
                end["error"] = err
            w.emit("query_end", **end)
        finally:
            w.close()
