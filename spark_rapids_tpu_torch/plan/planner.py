"""Planner: logical plan -> physical plan of the port's execs.

One rule per logical node class, as in the JAX package's planner, for the
ported nodes. A grouped Aggregate over a multi-partition input becomes
the JAX package's three stages: a partial aggregate per input partition,
a hash exchange of the partial states on the grouping keys, and a final
aggregate per exchange partition. A Join becomes a broadcast hash join
(the build side behind a BroadcastExchangeExec) when the build side's
estimated bytes are at most `sql.autoBroadcastJoinThreshold`, else a
shuffled hash join (both sides hash-exchanged on their keys, joined per
partition); the estimate is the JAX planner's, from the scans' row
counts and a fixed width per type, so the choice is the same.

Where the JAX planner's defaults make a different plan with the same
rows, the port does not emulate them:
  - the AQE reader around a shuffled join's and an aggregate's exchanges
    (`sql.adaptive.enabled`, JAX `planner.py:164`, `:425-431`), and so
    its runtime demotion of a shuffled join to a broadcast one;
  - join reordering (`sql.optimizer.joinReorder.enabled`, `plan/cbo.py`):
    joins run in the order the DataFrame built them;
  - the async broadcast build (`sql.exec.exchange.asyncBroadcast.enabled`,
    JAX `exec/broadcast.py:99-165`): the build runs before the probe;
  - stage fusion (`sql.exec.stageFusion.enabled`): each operator runs
    its own ops.
A cross join without a condition is a broadcast hash join whatever the
threshold (`how="cross"`); a condition with no equi keys is a
`NestedLoopJoinExec`; any other condition rides the hash join. The
bloom-filter prefilter of a shuffled join is off by default in JAX and
not ported. A mesh exchange, a count(DISTINCT) that the optimizer's
rewrite leaves alone (JAX `CollectAggExec`), and any node without a rule
raise NotPorted; nothing falls back to another engine.
"""
from __future__ import annotations

from typing import Callable, Dict, Type

from ..config import (BATCH_SIZE_ROWS, BROADCAST_THRESHOLD, MESH_DEVICES,
                      SHUFFLE_PARTITIONS, TpuConf)
from ..errors import NotPorted
from ..exec import nodes as x
from ..exec.aggregate import HashAggregateExec, UngroupedAggExec
from ..exec.base import ExecContext, TpuExec
from ..exec.broadcast import BroadcastExchangeExec
from ..exec.join import HashJoinExec, NestedLoopJoinExec
from ..exec.coalesce import CoalesceBatchesExec
from ..exec.exchange import ShuffleExchangeExec
from ..exec.sort import SortExec
from ..expr.expressions import BoundRef, UnsupportedExpr
from . import logical as L
from .optimizer import optimize

__all__ = ["Planner"]

_RULES: Dict[Type[L.LogicalPlan], Callable] = {}


def _rule(cls):
    def deco(fn):
        _RULES[cls] = fn
        return fn
    return deco


@_rule(L.InMemoryScan)
def _scan(node, conv, conf) -> TpuExec:
    return x.InMemoryScanExec(node.arrow, node.schema)


@_rule(L.ParquetScan)
def _pq(node, conv, conf):
    scan = x.ParquetScanExec(node.paths, node.schema, node.columns,
                             filters=node.filters)
    if len(node.paths) > 1:
        # many small files: coalesce toward the batch target, fan-in
        # sized from the files' average row count (footer metadata)
        import pyarrow.parquet as pq
        try:
            counts = [pq.ParquetFile(p).metadata.num_rows
                      for p in node.paths]
            avg = sum(counts) // max(len(counts), 1)
        except Exception:
            avg = 0
        target = conf.get(BATCH_SIZE_ROWS)
        if 0 < avg < target // 2:
            fan_in = min(max(1, target // max(avg, 1)), len(node.paths))
            return CoalesceBatchesExec(scan, target, fan_in)
    return scan


@_rule(L.Project)
def _project(node, conv, conf):
    return x.ProjectExec(conv(node.child), node.bound, node.schema)


@_rule(L.Filter)
def _filter(node, conv, conf):
    return x.FilterExec(conv(node.child), node.bound)


@_rule(L.Aggregate)
def _agg(node, conv, conf):
    child = conv(node.child)
    names = [n for n, _ in node.bound_aggs]
    aggs = [a for _, a in node.bound_aggs]
    if any(getattr(a, "is_collect", False) for a in aggs):
        raise NotPorted(
            "CollectAggExec (count(DISTINCT) beside another aggregate, "
            "over several distinct children, or with "
            "sql.optimizer.distinctAggRewrite.enabled off)")
    if not node.keys:
        return UngroupedAggExec(child, names, aggs, node.schema)
    key_names = [k.name for k in node.keys]
    nparts = conf.get(SHUFFLE_PARTITIONS)
    if conf.get(MESH_DEVICES) > 1:
        raise NotPorted("mesh exchange (MeshExchangeExec)")
    if child.num_partitions(ExecContext(conf, None)) > 1 and nparts > 1:
        # partial per input partition (rows shrink to the group count),
        # exchange of the states on the keys, final merge per partition
        partial = HashAggregateExec(child, key_names, node.bound_keys,
                                    names, aggs, child.schema,
                                    mode="partial")
        pkeys = [BoundRef(i, k.dtype, f.name)
                 for i, (k, f) in enumerate(
                     zip(node.bound_keys, partial.schema.fields))]
        exch = ShuffleExchangeExec(partial, nparts, pkeys, partial.schema)
        return HashAggregateExec(exch, key_names, pkeys, names, aggs,
                                 node.schema, mode="final")
    return HashAggregateExec(child, key_names, node.bound_keys, names,
                             aggs, node.schema)


@_rule(L.Sort)
def _sort(node, conv, conf):
    return SortExec(conv(node.child), node.bound_orders, node.schema)


@_rule(L.Limit)
def _limit(node, conv, conf):
    return x.LimitExec(conv(node.child), node.n)


def _estimate_rows(node: L.LogicalPlan):
    """Best-effort row estimate from scan metadata (the broadcast
    decision's input; the JAX planner's, node for node)."""
    if isinstance(node, L.InMemoryScan):
        return node.arrow.num_rows
    if isinstance(node, L.ParquetScan):
        cached = getattr(node, "_est_rows_cache", False)
        if cached is not False:
            return cached
        import pyarrow.parquet as pq
        try:
            rows = sum(pq.ParquetFile(p).metadata.num_rows
                       for p in node.paths)
        except (OSError, ValueError):    # unreadable footer: no estimate
            rows = None
        node._est_rows_cache = rows
        return rows
    if isinstance(node, (L.Project, L.Filter, L.Sort, L.Repartition,
                         L.Aggregate)):
        # a filter keeps the upper bound (a conservative broadcast choice)
        return _estimate_rows(node.children[0])
    if isinstance(node, L.Limit):
        child = _estimate_rows(node.children[0])
        return node.n if child is None else min(node.n, child)
    return None


def _row_width_bytes(schema) -> int:
    w = 1  # validity
    for f in schema.fields:
        if f.dtype.is_variable_width:
            w += 24
        elif getattr(f.dtype, "is_decimal128", False):
            w += 16
        else:
            w += (f.dtype.np_dtype.itemsize if f.dtype.np_dtype else 8)
    return w


def _estimate_bytes(node: L.LogicalPlan):
    rows = _estimate_rows(node)
    if rows is None:
        return None
    return rows * _row_width_bytes(node.schema)


@_rule(L.Join)
def _join(node, conv, conf):
    left, right = conv(node.left), conv(node.right)
    if conf.get(MESH_DEVICES) > 1:
        raise NotPorted("mesh exchange (MeshExchangeExec)")
    thr = conf.get(BROADCAST_THRESHOLD)
    est = _estimate_bytes(node.right)
    broadcast_ok = thr >= 0 and est is not None and est <= thr
    equi = (node.how != "cross" and bool(node.bound_left_keys)
            and all(lk.dtype == rk.dtype for lk, rk in
                    zip(node.bound_left_keys, node.bound_right_keys)))
    cond = node.bound_condition
    if not equi and cond is not None:
        if node.bound_left_keys:
            # unusable equi keys: refusing beats joining on the residual
            # condition alone
            raise UnsupportedExpr(
                "equi-join keys have mismatched types "
                f"{[(lk.dtype, rk.dtype) for lk, rk in zip(node.bound_left_keys, node.bound_right_keys)]}; "
                "cast both sides to a common type")
        how = "inner" if node.how == "cross" else node.how
        return NestedLoopJoinExec(left, right, how, node.schema, cond)
    nparts = conf.get(SHUFFLE_PARTITIONS)
    if equi and not broadcast_ok and est is not None and nparts > 1:
        # a big build: hash-exchange both sides on the join keys, so
        # each partition joins its own slice of the build
        lex = ShuffleExchangeExec(left, nparts, node.bound_left_keys,
                                  left.schema)
        rex = ShuffleExchangeExec(right, nparts, node.bound_right_keys,
                                  right.schema)
        return HashJoinExec(lex, rex, node.bound_left_keys,
                            node.bound_right_keys, node.how, node.schema,
                            per_partition=True, condition=cond)
    return HashJoinExec(left, BroadcastExchangeExec(right, right.schema),
                        node.bound_left_keys, node.bound_right_keys,
                        node.how, node.schema, condition=cond)


@_rule(L.Repartition)
def _repart(node, conv, conf):
    if node.bound_keys and conf.get(MESH_DEVICES) == node.num_partitions \
            and node.num_partitions > 1:
        raise NotPorted("mesh exchange (MeshExchangeExec)")
    return ShuffleExchangeExec(conv(node.child), node.num_partitions,
                               node.bound_keys, node.schema)


class Planner:
    def __init__(self, conf: TpuConf):
        self.conf = conf

    def plan(self, root: L.LogicalPlan) -> TpuExec:
        return self._convert(optimize(root, self.conf))

    def _convert(self, node: L.LogicalPlan) -> TpuExec:
        rule = _RULES.get(type(node))
        if rule is None:
            raise NotPorted(f"plan node {node.node_name()}")
        return rule(node, self._convert, self.conf)
