"""Query profiler: the consumer half of the operator-metric story, the
port of the JAX package's `profiler/`.

The engine records per-operator metrics in its `ExecContext`
(utils/metrics.py for their levels); this package aggregates, persists
and renders them:

  - the structured per-query event log (`event_log.py`), whose records
    the JAX package's `read_event_log` and `aggregate_ops` parse;
  - the `EXPLAIN ANALYZE` plan renderer (`analyze.py`);
  - the per-query span trace (`tracing.py`) and its critical-path
    decomposition (`critical_path.py`);
  - the live telemetry registry (`telemetry.py`);
  - kernel launch and host-sync counts (`xla_stats.py`, the counterpart
    of the JAX module's XLA compile accounting).
"""
from .analyze import render_analyze
from .event_log import (EventLogWriter, aggregate_ops, next_query_id,
                        op_metrics_records, op_time_seconds,
                        open_query_log, plan_tree, profile_query,
                        read_event_log, top_operators)

__all__ = ["EventLogWriter", "aggregate_ops", "next_query_id",
           "op_metrics_records", "op_time_seconds", "open_query_log",
           "plan_tree", "profile_query", "read_event_log",
           "render_analyze", "top_operators"]
