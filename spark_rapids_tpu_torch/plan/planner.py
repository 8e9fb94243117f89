"""Planner: logical plan -> physical plan of the port's execs.

One rule per logical node class, as in the JAX package's planner, for the
ported nodes. A grouped Aggregate over a multi-partition input becomes
the JAX package's three stages: a partial aggregate per input partition,
a hash exchange of the partial states on the grouping keys, and a final
aggregate per exchange partition; an aggregate whose result cannot ride
the partial states (count(DISTINCT) that the optimizer's rewrite leaves
alone, percentile, median, a string's first / last) becomes a hash
exchange of the raw rows on the keys and a `CollectAggExec` per
partition, or one `CollectAggExec` without keys. A Join becomes a
broadcast hash join (the build side behind a BroadcastExchangeExec) when
the build side's estimated bytes are at most
`sql.autoBroadcastJoinThreshold`, else a shuffled hash join (both sides
hash-exchanged on their keys, joined per partition); the estimate is the
JAX planner's, from the scans' row counts and a fixed width per type, so
the choice is the same. Under `sql.join.bloomFilter.enabled` (off by
default, as in JAX) a shuffled single-key inner, left semi or right join
whose build estimate is at most `sql.join.bloomFilter.maxBuildRows`
masks its stream side before the exchange with a bloom filter of the
build's keys (`exec/runtime_filter.py`), the build materialized once for
the filter and the build exchange.

At the JAX package's defaults the plan is adaptive, as there
(`sql.adaptive.enabled`): the exchange under a final aggregate and both
exchanges of a shuffled join sit behind `AQEShuffleReadExec`s
(`_aqe_wrap`), which the stage driver (`plan/aqe.py`) re-plans once each
stage has run; splitting a skewed partition is allowed only under an
inner, left, left semi or left anti join. Planning runs inside the
calibration scope (`plan/stats.py`), so the optimizer's join reorder
(`sql.optimizer.joinReorder.enabled`) reads observed cardinalities, and
each converted node carries its logical fingerprints for the harvest
after the run. The reuse pass (`plan/reuse.py`,
`sql.exec.exchange.reuse.enabled`) runs last and leaves its hit count on
the root as `exchange_reuse_hits`. Stage fusion
(`sql.exec.stageFusion.enabled`) is not ported: each operator runs its
own ops.

A Parquet scan carries its logical node's bind-time snapshot, Delta
deletion vectors and version into `ParquetScanExec`; a CSV, JSON, ORC or
Avro scan (`L.TextScan`) becomes the matching exec of
`exec/text_scan.py`. A cached scan serves its device batches
(`CachedScanExec`; once released, its source plan is planned instead);
an aggregate over a chain of one-child nodes down to a cached scan of at
most 2^21 rows takes the whole-input (complete) aggregate, as in the
JAX planner. Expand, Generate
and Union become `ExpandExec`, `GenerateExec` and `UnionExec`; a WindowOp
one `WindowExec` per distinct (partition, order) spec, chained, under a
projection that restores the requested column order. A nested
group, sort or join key is refused (UnsupportedExpr), as the JAX planner
refuses it.

A cross join without a condition is a broadcast hash join whatever the
threshold (`how="cross"`); a condition with no equi keys is a
`NestedLoopJoinExec`; any other condition rides the hash join. A mesh
exchange and any node without a rule raise NotPorted. The pandas nodes
become the python execs of `exec/python_exec.py`; a grouped or
cogrouped one always sits over a hash exchange on its keys (one on
each side), so every group is whole in one partition.

After conversion every physical node takes a lore id (pre-order,
`utils/lore.py`), which the audit and explain print; the ids in
`sql.lore.idsToDump` get their inputs dumped.

Placement has the JAX planner's three states (`PlanMeta`): `_tag` marks
a Project or Filter whose expression the device cannot run `!cpu`
under `sql.allowCpuFallback` (the default), and it becomes a
`HostProjectExec` / `HostFilterExec` (`exec/host_fallback.py`); with
the fallback off it is `!` and conversion raises UnsupportedExpr. Under
`sql.optimizer.cbo.enabled` a tiny Project or Filter the host
interpreter covers is tagged `!cpu` too (`plan/cbo.py` `apply_cbo`).
The plan audit (`analysis/audit.py`) runs after conversion and rides
the root as `audit_report`; `sql.explain` prints the tagged tree (ALL,
NOT_ON_TPU) or the audit (VALIDATE), and `sql.audit.strict` fails a
plan with a will_not_work verdict.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Type

from ..analysis.audit import audit_plan
from ..columnar import dtypes as dt
from ..config import (ADAPTIVE_CALIBRATION, ADAPTIVE_COALESCE_ENABLED,
                      ADAPTIVE_ENABLED, ADAPTIVE_SKEW_ENABLED,
                      ADAPTIVE_SKEW_FACTOR, ADAPTIVE_SKEW_MIN_BYTES,
                      ADAPTIVE_TARGET_BYTES, AUDIT_STRICT, BATCH_SIZE_ROWS,
                      BROADCAST_THRESHOLD, CBO_ENABLED, JOIN_BLOOM_ENABLED,
                      JOIN_BLOOM_MAX_BUILD_ROWS, MESH_DEVICES,
                      SHUFFLE_PARTITIONS, TpuConf)
from ..errors import NotPorted
from ..exec import nodes as x
from ..exec.aggregate import (CollectAggExec, HashAggregateExec,
                              UngroupedAggExec)
from ..exec.aqe import AqeShufflePlan, AQEShuffleReadExec
from ..exec.base import ExecContext, TpuExec
from ..exec.broadcast import BroadcastExchangeExec
from ..exec.join import HashJoinExec, NestedLoopJoinExec
from ..exec.coalesce import CoalesceBatchesExec
from ..exec.exchange import ShuffleExchangeExec
from ..exec.host_fallback import HostFilterExec, HostProjectExec
from ..exec.runtime_filter import RuntimeBloomFilterExec, SharedBuildExec
from ..exec.sort import SortExec
from ..expr.expressions import BoundRef, UnsupportedExpr
from ..utils.lore import apply_lore_dump, assign_lore_ids
from . import logical as L
from .cbo import apply_cbo
from .optimizer import optimize
from .reuse import reuse_exchanges
from .stats import attach_calibration_fps, calibration_scope

__all__ = ["Planner", "PlanMeta"]


class PlanMeta:
    """A logical node's placement (the RapidsMeta analog, JAX
    `planner.py:27-71`): it runs on the device (`*`), on the host CPU
    through the fallback interpreter (`!cpu`: the query still
    succeeds), or not at all (`!`: the query fails at conversion). A
    released cache's source plan is its child."""

    def __init__(self, node: L.LogicalPlan):
        self.node = node
        kids = list(node.children)
        if isinstance(node, L.CachedScan) and node.released:
            kids = [node.source]
        self.children = [PlanMeta(c) for c in kids]
        self.reasons: List[str] = []
        self.host_reasons: List[str] = []
        # the physical subtree this node converted to (set by
        # _convert): its lore id shows in explain, so an operator in a
        # profile maps straight to a lore.idsToDump replay id
        self.exec_node = None

    def will_not_work(self, reason: str):
        self.reasons.append(reason)

    def will_use_host(self, reason: str):
        self.host_reasons.append(reason)

    @property
    def can_run_on_tpu(self) -> bool:
        return not self.reasons

    def explain_lines(self, only_not_on_tpu: bool, indent=0) -> List[str]:
        lines = []
        tag = ("!cpu" if self.host_reasons and not self.reasons
               else "*" if self.can_run_on_tpu else "!")
        lore = getattr(self.exec_node, "lore_id", None)
        lore_tag = f" [loreId={lore}]" if lore is not None else ""
        desc = f"{'  ' * indent}{tag}{lore_tag} {self.node.describe()}"
        if self.reasons:
            desc += "  <-- cannot run on TPU because " + "; ".join(
                self.reasons)
        elif self.host_reasons:
            desc += ("  <-- will run on CPU because "
                     + "; ".join(self.host_reasons))
        if not only_not_on_tpu or self.reasons or self.host_reasons:
            lines.append(desc)
        for c in self.children:
            lines.extend(c.explain_lines(only_not_on_tpu, indent + 1))
        return lines


_RULES: Dict[Type[L.LogicalPlan], Callable] = {}


def _rule(cls):
    def deco(fn):
        _RULES[cls] = fn
        return fn
    return deco


@_rule(L.InMemoryScan)
def _scan(meta, conv, conf) -> TpuExec:
    node = meta.node
    return x.InMemoryScanExec(node.arrow, node.schema)


@_rule(L.CachedScan)
def _cached(meta, conv, conf):
    node = meta.node
    if node.released:
        return conv(meta.children[0])
    return x.CachedScanExec(node.batches, node.schema)


@_rule(L.ParquetScan)
def _pq(meta, conv, conf):
    node = meta.node
    scan = x.ParquetScanExec(node.paths, node.schema, node.columns,
                             filters=node.filters, dv=node.dv,
                             snapshot=node.snapshot,
                             delta_version=node.delta_version)
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


@_rule(L.TextScan)
def _textscan(meta, conv, conf):
    from ..exec.text_scan import (AvroScanExec, CsvScanExec, JsonScanExec,
                                  OrcScanExec)
    node = meta.node
    cls = {"csv": CsvScanExec, "json": JsonScanExec,
           "orc": OrcScanExec, "avro": AvroScanExec}[node.fmt]
    return cls(node.paths, node._full_schema, node.columns, node.options,
               snapshot=node.snapshot)


@_rule(L.Project)
def _project(meta, conv, conf):
    node = meta.node
    child = conv(meta.children[0])
    if any(b is None for b in node.bound) or meta.host_reasons:
        # _tag copied the bind errors into host_reasons: dedupe
        reason = "; ".join(dict.fromkeys(
            [e for e in node.bind_errors if e] + meta.host_reasons))
        if not conf.allow_cpu_fallback:
            raise UnsupportedExpr(reason)
        return HostProjectExec(child, node.exprs, node.schema, reason)
    return x.ProjectExec(child, node.bound, node.schema)


@_rule(L.Filter)
def _filter(meta, conv, conf):
    node = meta.node
    child = conv(meta.children[0])
    if node.bound is None or meta.host_reasons:
        reason = "; ".join(dict.fromkeys(
            ([node.bind_error] if node.bind_error else [])
            + meta.host_reasons))
        if not conf.allow_cpu_fallback:
            raise UnsupportedExpr(reason)
        return HostFilterExec(child, node.condition, reason)
    return x.FilterExec(child, node.bound)


def _aqe_wrap(exchange, conf, allow_split=False, plan=None,
              role="stream"):
    """The exchange behind an adaptive reader when `sql.adaptive.enabled`
    (JAX `planner.py:164-188`); a second exchange joins the first's
    plan, so both sides of a join re-plan alike. Returns (node, plan)."""
    if not conf.get(ADAPTIVE_ENABLED) or \
            not isinstance(exchange, ShuffleExchangeExec):
        return exchange, None
    if plan is None:
        plan = AqeShufflePlan([exchange],
                              conf.get(ADAPTIVE_TARGET_BYTES),
                              conf.get(ADAPTIVE_SKEW_FACTOR),
                              conf.get(ADAPTIVE_SKEW_MIN_BYTES),
                              allow_split
                              and conf.get(ADAPTIVE_SKEW_ENABLED),
                              allow_coalesce=conf.get(
                                  ADAPTIVE_COALESCE_ENABLED))
    else:
        plan.exchanges.append(exchange)
    return AQEShuffleReadExec(exchange, plan, role), plan


@_rule(L.Expand)
def _expand(meta, conv, conf):
    node = meta.node
    from ..exec.expand import ExpandExec
    return ExpandExec(conv(meta.children[0]), node.bound_keys,
                      node.include_masks, node.schema)


@_rule(L.Generate)
def _generate(meta, conv, conf):
    node = meta.node
    from ..exec.generate import GenerateExec
    return GenerateExec(conv(meta.children[0]), node.bound, node.schema)


@_rule(L.WindowOp)
def _window(meta, conv, conf):
    """One WindowExec per distinct (partition, order) spec, chained, each
    appending its columns; a projection above restores the requested
    column order (JAX `planner.py:482-516`; the reference splits the
    same way, GpuWindowExecMeta.scala:182)."""
    node = meta.node
    from ..columnar.table import Field, Schema
    from ..exec.window import WindowExec, spec_signature
    _refuse_nested([k for _, w in node.bound for k in
                    list(w.spec.partition_keys)
                    + [o.expr for o in w.spec.orders]], "window key")
    groups = {}
    for nm, w in node.bound:
        groups.setdefault(spec_signature(w.spec), []).append((nm, w))
    child = conv(meta.children[0])
    if len(groups) == 1:
        return WindowExec(child, [nm for nm, _ in node.bound],
                          [w for _, w in node.bound], node.schema)
    cur = child
    cur_fields = list(node.child.schema.fields)
    nchild = len(cur_fields)
    appended = {}
    for cols in groups.values():
        out_fields = cur_fields + [Field(nm, w.dtype) for nm, w in cols]
        for j, (nm, _) in enumerate(cols):
            appended[nm] = len(cur_fields) + j
        cur = WindowExec(cur, [nm for nm, _ in cols], [w for _, w in cols],
                         Schema(out_fields))
        cur_fields = out_fields
    refs = ([BoundRef(i, f.dtype, f.name)
             for i, f in enumerate(node.schema.fields[:nchild])]
            + [BoundRef(appended[f.name], f.dtype, f.name)
               for f in node.schema.fields[nchild:]])
    return x.ProjectExec(cur, refs, node.schema)


@_rule(L.Union)
def _union(meta, conv, conf):
    node = meta.node
    return x.UnionExec([conv(c) for c in meta.children], node.schema)


def _refuse_nested(keys, what: str):
    """A nested group, join or sort key is refused, as the JAX planner
    refuses it."""
    for k in keys:
        if k.dtype.is_nested:
            raise UnsupportedExpr(f"{what} {k!r} has nested type {k.dtype}")


def _small_cached_input(child: TpuExec) -> bool:
    """A chain of one-child nodes over a CachedScanExec of at most 2^21
    rows: the whole-input (complete) aggregate takes it in one pass (JAX
    `planner.py:255-270`)."""
    base = child
    while len(base.children) == 1:
        base = base.children[0]
    return isinstance(base, x.CachedScanExec) and \
        sum(b.capacity for b in base.batches) <= (1 << 21)


@_rule(L.Aggregate)
def _agg(meta, conv, conf):
    node = meta.node
    _refuse_nested(node.bound_keys, "group-by key")
    child = conv(meta.children[0])
    names = [n for n, _ in node.bound_aggs]
    aggs = [a for _, a in node.bound_aggs]
    has_collect = any(getattr(a, "is_collect", False) for a in aggs)
    if not node.keys:
        if has_collect:
            # count(DISTINCT x), median, ... without keys: one segment
            return CollectAggExec(child, [], [], names, aggs, node.schema)
        return UngroupedAggExec(child, names, aggs, node.schema)
    key_names = [k.name for k in node.keys]
    nparts = conf.get(SHUFFLE_PARTITIONS)
    if conf.get(MESH_DEVICES) > 1:
        raise NotPorted("mesh exchange (MeshExchangeExec, ROADMAP A.14)")
    multi_input = child.num_partitions(
        ExecContext(conf, None, planning=True)) > 1 and nparts > 1
    if has_collect:
        # these results cannot ride the partial / final state wire: the
        # raw rows hash-exchange on the keys, then each partition's sort
        # path is final (its keys are disjoint from the others')
        if multi_input:
            exch = ShuffleExchangeExec(child, nparts, node.bound_keys,
                                       child.schema)
            exch, _ = _aqe_wrap(exch, conf, allow_split=False)
            return CollectAggExec(exch, key_names, node.bound_keys, names,
                                  aggs, node.schema, per_partition=True)
        return CollectAggExec(child, key_names, node.bound_keys, names,
                              aggs, node.schema)
    if multi_input and not _small_cached_input(child):
        # partial per input partition (rows shrink to the group count),
        # exchange of the states on the keys, final merge per partition
        partial = HashAggregateExec(child, key_names, node.bound_keys,
                                    names, aggs, child.schema,
                                    mode="partial")
        pkeys = [BoundRef(i, k.dtype, f.name)
                 for i, (k, f) in enumerate(
                     zip(node.bound_keys, partial.schema.fields))]
        exch = ShuffleExchangeExec(partial, nparts, pkeys, partial.schema)
        # adaptive coalescing of small reduce partitions; splitting one
        # would break its groups
        exch, _ = _aqe_wrap(exch, conf, allow_split=False)
        return HashAggregateExec(exch, key_names, pkeys, names, aggs,
                                 node.schema, mode="final")
    return HashAggregateExec(child, key_names, node.bound_keys, names,
                             aggs, node.schema)


@_rule(L.Sort)
def _sort(meta, conv, conf):
    node = meta.node
    _refuse_nested([o.expr for o in node.bound_orders], "sort key")
    return SortExec(conv(meta.children[0]), node.bound_orders, node.schema)


@_rule(L.Limit)
def _limit(meta, conv, conf):
    node = meta.node
    return x.LimitExec(conv(meta.children[0]), node.n)


def _estimate_rows(node: L.LogicalPlan):
    """Best-effort row estimate from scan metadata (the broadcast
    decision's input; the JAX planner's, node for node)."""
    if isinstance(node, L.InMemoryScan):
        return node.arrow.num_rows
    if isinstance(node, L.CachedScan):
        if node.released:
            return _estimate_rows(node.source)
        return sum(b.num_rows for b in node.batches)
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
                         L.Aggregate, L.WindowOp)):
        # a filter keeps the upper bound (a conservative broadcast choice)
        return _estimate_rows(node.children[0])
    if isinstance(node, L.Limit):
        child = _estimate_rows(node.children[0])
        return node.n if child is None else min(node.n, child)
    if isinstance(node, L.Union):
        parts = [_estimate_rows(c) for c in node.children]
        return None if any(p is None for p in parts) else sum(parts)
    return None


def _row_width_bytes(schema) -> int:
    w = 1  # validity
    for f in schema.fields:
        if f.dtype.is_variable_width or isinstance(
                f.dtype, (dt.ArrayType, dt.MapType)):
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
def _join(meta, conv, conf):
    node = meta.node
    _refuse_nested(list(node.bound_left_keys) + list(node.bound_right_keys),
                   "join key")
    left, right = conv(meta.children[0]), conv(meta.children[1])
    if conf.get(MESH_DEVICES) > 1:
        raise NotPorted("mesh exchange (MeshExchangeExec, ROADMAP A.14)")
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
        left, right = _maybe_bloom_prefilter(left, right, node, meta, conf)
        lex = ShuffleExchangeExec(left, nparts, node.bound_left_keys,
                                  left.schema)
        rex = ShuffleExchangeExec(right, nparts, node.bound_right_keys,
                                  right.schema)
        # a skewed stream partition may split only where each output row
        # depends on one stream row and the whole build partition; a
        # right or full join tracks the build's matches across it
        allow_split = node.how in ("inner", "left", "left_semi",
                                   "left_anti")
        lex, plan = _aqe_wrap(lex, conf, allow_split=allow_split)
        rex, _ = _aqe_wrap(rex, conf, plan=plan, role="build")
        return HashJoinExec(lex, rex, node.bound_left_keys,
                            node.bound_right_keys, node.how, node.schema,
                            per_partition=True, condition=cond)
    return HashJoinExec(left, BroadcastExchangeExec(right, right.schema),
                        node.bound_left_keys, node.bound_right_keys,
                        node.how, node.schema, condition=cond)


def _maybe_bloom_prefilter(left, right, n, meta, conf):
    """Wrap the stream (left) side of a shuffled equi-join in a runtime
    bloom filter built from the join's OWN build side, so non-matching
    rows never reach the exchange (JAX `plan/planner.py:445-479`;
    reference: GpuBloomFilter* runtime filters via InSubqueryExec). The
    build subtree is wrapped in SharedBuildExec so the filter and the
    join's build exchange consume ONE materialization. Only for join
    types where an unmatched stream row contributes nothing. Returns
    (left', right')."""
    if not conf.get(JOIN_BLOOM_ENABLED):
        return left, right
    if n.how not in ("inner", "left_semi", "right"):
        return left, right
    if len(n.bound_left_keys or []) != 1:
        return left, right               # single-key filters only
    if n.bound_left_keys[0].dtype != n.bound_right_keys[0].dtype:
        # murmur3 hashes int32/int64 representations of equal values
        # differently: a mixed-width equi-join through the bloom filter
        # would silently drop matching stream rows
        return left, right
    est_rows = _estimate_rows(meta.children[1].node)
    if est_rows is None or est_rows > conf.get(JOIN_BLOOM_MAX_BUILD_ROWS):
        # no estimate: a filter sized blind can saturate and charge k
        # probes a stream row for no pruning
        return left, right
    shared = SharedBuildExec(right)
    return RuntimeBloomFilterExec(left, shared, n.bound_left_keys[0],
                                  n.bound_right_keys[0],
                                  max(64, int(est_rows))), shared


@_rule(L.MapInPandas)
def _map_in_pandas(meta, conv, conf):
    from ..exec.python_exec import ArrowEvalPythonExec
    n = meta.node
    return ArrowEvalPythonExec(conv(meta.children[0]), n.fn, n.schema)


@_rule(L.GroupedMapInPandas)
def _grouped_map_in_pandas(meta, conv, conf):
    from ..exec.python_exec import GroupedMapPythonExec
    from ..expr.expressions import col
    n = meta.node
    child = conv(meta.children[0])
    nparts = max(1, conf.get(SHUFFLE_PARTITIONS))
    keys = [col(k).bind(n.children[0].schema) for k in n.key_names]
    # ALWAYS exchange: even at nparts=1 a multi-partition child must
    # gather so a key spanning source partitions stays one group
    child = ShuffleExchangeExec(child, nparts, keys, child.schema)
    return GroupedMapPythonExec(child, n.fn, n.schema, n.key_names)


@_rule(L.CoGroupInPandas)
def _cogroup_in_pandas(meta, conv, conf):
    from ..exec.python_exec import CoGroupPythonExec
    from ..expr.expressions import col
    n = meta.node
    left = conv(meta.children[0])
    right = conv(meta.children[1])
    nparts = max(1, conf.get(SHUFFLE_PARTITIONS))
    # ALWAYS exchange (even nparts=1): aligns partition counts across
    # the two sides and gathers split groups
    lkeys = [col(k).bind(n.children[0].schema) for k in n.lkeys]
    rkeys = [col(k).bind(n.children[1].schema) for k in n.rkeys]
    left = ShuffleExchangeExec(left, nparts, lkeys, left.schema)
    right = ShuffleExchangeExec(right, nparts, rkeys, right.schema)
    return CoGroupPythonExec(left, right, n.fn, n.schema)


@_rule(L.Repartition)
def _repart(meta, conv, conf):
    node = meta.node
    if node.bound_keys and conf.get(MESH_DEVICES) == node.num_partitions \
            and node.num_partitions > 1:
        raise NotPorted("mesh exchange (MeshExchangeExec, ROADMAP A.14)")
    return ShuffleExchangeExec(conv(meta.children[0]), node.num_partitions,
                               node.bound_keys, node.schema)


class Planner:
    """Optimize, tag, place, convert, audit (JAX `planner.py:585-723`).
    `last_explain` holds the lines the `sql.explain` mode asked for (and
    printed), `last_audit` the plan audit of the last `plan()`."""

    def __init__(self, conf: TpuConf):
        self.conf = conf
        self.last_explain: List[str] = []
        self.last_audit = None

    def plan(self, root: L.LogicalPlan) -> TpuExec:
        # calibration lookups (observed cardinalities of earlier runs)
        # are live for the whole planning pass, join reorder included,
        # and only there (JAX `planner.py:595-605`)
        with calibration_scope(self.conf.get(ADAPTIVE_ENABLED)
                               and self.conf.get(ADAPTIVE_CALIBRATION)):
            return self._plan_scoped(root)

    def _plan_scoped(self, root: L.LogicalPlan) -> TpuExec:
        meta = PlanMeta(optimize(root, self.conf))
        self._tag(meta)
        if self.conf.get(CBO_ENABLED):
            apply_cbo(meta, self.conf)
        # a conversion failure still audits and prints the tagged tree,
        # then re-raises; the lore ids are assigned before the audit and
        # the explain, which print them
        root_exec, conv_err = None, None
        try:
            root_exec = self._convert(meta)
        except UnsupportedExpr as e:
            conv_err = e
        if root_exec is not None:
            assign_lore_ids(root_exec)
        report = audit_plan(meta, self.conf)
        self.last_audit = report
        if root_exec is not None:
            # duplicate exchange subtrees collapse to ReusedExchange nodes
            root_exec, hits = reuse_exchanges(root_exec, self.conf)
            root_exec.exchange_reuse_hits = hits
            root_exec.audit_report = report
        mode = self.conf.explain
        self.last_explain = []
        if mode in ("ALL", "NOT_ON_TPU", "VALIDATE"):
            if mode == "VALIDATE":
                self.last_explain = report.lines()
            else:
                self.last_explain = meta.explain_lines(mode == "NOT_ON_TPU")
                self.last_explain.extend(v.describe()
                                         for v in report.findings)
            for line in self.last_explain:
                print(line)
        if conv_err is not None:
            raise conv_err
        if self.conf.get(AUDIT_STRICT):
            report.raise_if_blocked()
        return apply_lore_dump(root_exec, self.conf)

    def _tag(self, meta: PlanMeta):
        node = meta.node
        if type(node) not in _RULES:
            meta.will_not_work(
                f"no TPU replacement rule for {node.node_name()}")
        if isinstance(node, L.Filter) and node.bound is None:
            if self.conf.allow_cpu_fallback:
                meta.will_use_host(node.bind_error)
            else:
                meta.will_not_work(node.bind_error)
        if isinstance(node, L.Project) and any(b is None
                                               for b in node.bound):
            reason = "; ".join(e for e in node.bind_errors if e)
            if self.conf.allow_cpu_fallback:
                meta.will_use_host(reason)
            else:
                meta.will_not_work(reason)
        for c in meta.children:
            self._tag(c)

    def _convert(self, meta: PlanMeta) -> TpuExec:
        rule = _RULES.get(type(meta.node))
        if rule is None:
            raise NotPorted(f"plan node {meta.node.node_name()}")
        if not meta.can_run_on_tpu:
            raise UnsupportedExpr("; ".join(meta.reasons))
        out = rule(meta, self._convert, self.conf)
        meta.exec_node = out
        # the harvest after the run keys observed rows by these
        attach_calibration_fps(meta.node, out)
        return out
