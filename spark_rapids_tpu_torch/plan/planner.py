"""Planner: logical plan -> physical plan of the port's execs.

One rule per logical node class, as in the JAX package's planner, for the
ported nodes. A grouped Aggregate over a multi-partition input becomes
the JAX package's three stages: a partial aggregate per input partition,
a hash exchange of the partial states on the grouping keys, and a final
aggregate per exchange partition (without the AQE reader, which the
port does not have yet). A mesh exchange and any node without a rule
raise NotPorted; nothing falls back to another engine.
"""
from __future__ import annotations

from typing import Callable, Dict, Type

from ..config import (BATCH_SIZE_ROWS, MESH_DEVICES, SHUFFLE_PARTITIONS,
                      TpuConf)
from ..errors import NotPorted
from ..exec import nodes as x
from ..exec.aggregate import HashAggregateExec, UngroupedAggExec
from ..exec.base import ExecContext, TpuExec
from ..exec.coalesce import CoalesceBatchesExec
from ..exec.exchange import ShuffleExchangeExec
from ..exec.sort import SortExec
from ..expr.expressions import BoundRef
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
        return self._convert(optimize(root))

    def _convert(self, node: L.LogicalPlan) -> TpuExec:
        rule = _RULES.get(type(node))
        if rule is None:
            raise NotPorted(f"plan node {node.node_name()}")
        return rule(node, self._convert, self.conf)
