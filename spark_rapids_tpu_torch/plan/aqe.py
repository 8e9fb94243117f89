"""Adaptive execution driver: re-plan at exchange boundaries.

The port of the JAX package's `plan/aqe.py` `run_stage_driver` and
`_maybe_demote` (`:82-203`; the reference's AdaptiveSparkPlanExec
driving query-stage materialization). Between planning and the
consumer's launch the driver walks the physical plan bottom-up,
materializes each shuffle stage and re-plans between the stage's end and
its consumer's start:

  1. JOIN DEMOTION: a shuffled hash join whose build side materializes
     at or under `autoBroadcastJoinThreshold` becomes, in place, a
     broadcast hash join over the already-shuffled build; the stream
     side reads its pre-exchange subtree, so its map phase never runs.
  2. COALESCE and SKEW SPLIT: every `AqeShufflePlan`'s task groups are
     computed here, at the stage boundary, rather than on first read.

Each decision is returned as a record (and kept by the session for
`DataFrame.last_aqe_decisions()`); the process counters `aqe_stats()`
sum them with the calibration table's. A stage that fails to
materialize fails the query. Each materialization is an `aqe` span of
the query's trace (`aqe.stage_materialize`,
`aqe.demote_build_materialize`), the critical path's `plan` edge. The JAX module's mesh branches
(`_maybe_demote_mesh`, the SPMD stage reshard) have no counterpart here.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List

from ..profiler import tracing

__all__ = ["run_stage_driver", "aqe_stats", "reset_stats"]

_STATS_LOCK = threading.Lock()
_STATS = {"coalesced_partitions": 0, "skew_splits": 0, "demotions": 0}


def aqe_stats() -> Dict[str, int]:
    """Process-lifetime decision counters, with the calibration table's
    counters."""
    with _STATS_LOCK:
        out: Dict[str, int] = dict(_STATS)
    from .stats import calibration_stats
    out.update(calibration_stats())
    return out


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str, amount: int = 1) -> None:
    if amount:
        with _STATS_LOCK:
            _STATS[key] += amount


def run_stage_driver(root, ctx, conf) -> List[Dict[str, Any]]:
    """The stage-wise adaptive pass over a physical plan, before the
    consumer runs. Returns the decision records; the rewrites are in
    place."""
    from ..config import ADAPTIVE_ENABLED
    if not conf.get(ADAPTIVE_ENABLED) or getattr(ctx, "planning", False):
        return []
    from ..exec.aqe import AQEShuffleReadExec
    from ..exec.join import HashJoinExec

    decisions: List[Dict[str, Any]] = []
    seen_plans: set = set()

    def visit(node):
        if isinstance(node, HashJoinExec):
            # judged before the stream subtree is visited: forcing the
            # stream reader's groups would run the very map phase that
            # demotion skips
            _maybe_demote(node, ctx, conf, decisions)
        for c in list(node.children):
            visit(c)
        if isinstance(node, AQEShuffleReadExec):
            # the stage barrier: materialize and re-plan
            with tracing.span("aqe.stage_materialize", "aqe", ctx,
                              lore_id=getattr(node, "lore_id", None)), \
                    ctx.timer(node._op_id, "stageMaterializeTime"):
                node.plan.groups(ctx)
            d = node.plan.decision
            if d is not None and id(node.plan) not in seen_plans:
                seen_plans.add(id(node.plan))
                decisions.append(d)
                if not getattr(node.plan, "_stats_counted", False):
                    node.plan._stats_counted = True
                    _bump("coalesced_partitions",
                          int(d.get("coalesced_away", 0)))
                    _bump("skew_splits", int(d.get("split_slices", 0)))

    visit(root)
    return decisions


def _maybe_demote(join, ctx, conf, decisions) -> None:
    """Shuffled hash join -> broadcast hash join at the build side's
    stage boundary: the build exchange's materialized pieces become the
    broadcast child; the stream side drops its exchange and reads the
    pre-shuffle subtree."""
    from ..config import ADAPTIVE_DEMOTE_ENABLED, BROADCAST_THRESHOLD
    prev = getattr(join, "_aqe_demoted", None)
    if prev is not None:
        decisions.append(prev)
        return
    thr = conf.get(BROADCAST_THRESHOLD)
    if not (conf.get(ADAPTIVE_DEMOTE_ENABLED) and thr >= 0
            and join.per_partition):
        return
    from ..exec.aqe import AQEShuffleReadExec
    from ..exec.exchange import ShuffleExchangeExec
    stream, build = join.children
    if not isinstance(stream, AQEShuffleReadExec) \
            or not isinstance(build, AQEShuffleReadExec):
        return
    sex = stream.children[0]
    # only a plain stream exchange whose map phase has not run can be
    # skipped: a reused exchange has no children of its own to unwrap
    if not isinstance(sex, ShuffleExchangeExec) or not sex.children \
            or sex._pieces is not None:
        return
    bex = build.children[0]        # ShuffleExchangeExec or reused
    if not hasattr(bex, "stage_stats"):
        return
    # the stage barrier: the build's map phase runs now and reports its
    # bytes, the runtime statistic the planning estimate missed
    with tracing.span("aqe.demote_build_materialize", "aqe", ctx), \
            ctx.timer(join._op_id, "stageMaterializeTime"):
        build_bytes = int(sum(bex.stage_stats(ctx)))
    if build_bytes > thr:
        return
    from ..exec.broadcast import BroadcastExchangeExec
    bcast = BroadcastExchangeExec(bex, bex.schema)
    join.children = [sex.children[0], bcast]
    join.per_partition = False
    d = {"rule": "demote_broadcast_join",
         "build_bytes": build_bytes, "threshold": int(thr)}
    join._aqe_demoted = d
    ctx.set_metric(join._op_id, "aqeDemotedBuildBytes", build_bytes)
    decisions.append(d)
    _bump("demotions")
