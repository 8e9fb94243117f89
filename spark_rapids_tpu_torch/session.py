"""Session and DataFrame: the entry points of the port.

The same surface as the JAX package's `TpuSession` for the ported slice:
`create_dataframe`, `read.parquet / csv / json / orc / avro / delta /
iceberg`, `write` (`io/writer.py`: Parquet, ORC, CSV, JSON, Hive text,
Delta, Iceberg, each mode, `partitionBy`), `write_parquet` and
`write_delta`, and `filter`, `select` (an explode
lifted into a Generate node, window expressions into a WindowOp node),
`with_column` (through `select`), `agg`, `group_by(...).agg`
and `.count()`, `rollup`, `cube` and `grouping_sets` (an Expand under
the aggregate, with `grouping_id`), `join` (equi-keys by name, an
expression `on`, a non-equi `condition`, cross), `sort`, `limit`,
`union`, `repartition`, `cache` / `uncache`, `schema`, `explain`
(ALL, NOT_ON_TPU, VALIDATE, ANALYZE), `create_or_replace_temp_view`,
`to_arrow`, `to_torch`, `to_pydict`, `collect` and `count` on a
DataFrame, the pandas transforms (`map_in_pandas`, and on a grouped
DataFrame `apply_in_pandas`, `agg_in_pandas` and `cogroup`, run in
pooled python worker processes: `exec/python_exec.py`),
`TpuSession.sql` (`sql/parser.py`) over the session's temp views,
`set_conf` and `builder_get_or_create`. A session runs on one
torch device: CUDA unless the caller asks for another. Every action
plans the logical tree afresh and executes it on that device: first the
adaptive stage driver (`plan/aqe.py`), which materializes the shuffle
stages and re-plans them, then the consumer; after it, the observed
cardinalities go into the calibration table (`plan/stats.py`). What the
device cannot evaluate in a Project or Filter runs on the host
interpreter (`sql.allowCpuFallback`, on by default, as in the JAX
package), and its output returns to the session's device.

Every action runs inside the query profiler, as in the JAX package
(`_action`): a trace of spans when `sql.trace.enabled` (planning, the
adaptive stages, the pools' tasks and waits), the event log when
`sql.eventLog.enabled` (`profiler/event_log.py`), and on the root
operator's metrics the action's host syncs and kernel launches
(`profiler/xla_stats.py`) and its critical-path shares; `last_metrics()`
honours `sql.metrics.level`.
"""
from __future__ import annotations

import itertools
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from .columnar import dtypes as dt
from .columnar.table import Schema
from .config import RETRY_COVERAGE_ENABLED, TpuConf
from .exec.base import ExecContext
from .exec.nodes import collect_to_arrow
from .exec.python_exec import close_plan_pools
from .expr.aggregates import AggExpr, CountStar
from .expr.collection_exprs import Explode
from .expr.expressions import (Alias, BoundRef, Coalesce, ColumnRef,
                               Expression, col)
from .functions import _to_expr
from .io.snapshot import refresh_plan_snapshots
from .memory.device import device_manager
from .memory.diagnostics import enable_retry_coverage
from .memory.semaphore import TpuSemaphore
from .memory.spill import spill_store
from .plan import logical as L
from .plan.aqe import run_stage_driver
from .plan.planner import Planner
from .plan.stats import harvest_calibration
from .profiler import tracing, xla_stats
from .profiler.event_log import next_query_id, profile_query
from .runtime import faults, ledger, lockdep, racedep
from .service.query_manager import _query_scope
from .utils.metrics import snapshot as metrics_snapshot

__all__ = ["TpuSession", "DataFrame", "GroupedData", "CoGroupedData"]

# a unique tag per join for the hidden names of colliding right-side
# columns, so the hidden keys of different joins in one chain differ
_JOIN_TAGS = itertools.count(1)


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TpuSession runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def _split_join_condition(expr, lschema, rschema):
    """A join-on expression as (left keys, right keys, residual): each
    top-level AND conjunct `left_expr == right_expr` becomes an equi key
    pair, everything else stays in the residual condition (JAX
    `session.py` `_split_join_condition`)."""
    from .expr.expressions import And, ColumnRef, Eq

    lnames, rnames = set(lschema.names), set(rschema.names)

    def refs(e):
        out, stack = set(), [e]
        while stack:
            x_ = stack.pop()
            if isinstance(x_, ColumnRef):
                out.add(x_.name)
            stack.extend(c for c in getattr(x_, "children", [])
                         if c is not None)
        return out

    def side(e):
        r = refs(e)
        if r and r <= lnames and not (r & rnames):
            return "left"
        if r and r <= rnames and not (r & lnames):
            return "right"
        return None

    def conjuncts(e):
        if isinstance(e, And):
            return conjuncts(e.children[0]) + conjuncts(e.children[1])
        return [e]

    lkeys, rkeys, residual = [], [], None
    for c in conjuncts(expr):
        if isinstance(c, Eq):
            a, b = c.children
            sa, sb = side(a), side(b)
            if sa == "left" and sb == "right":
                lkeys.append(a)
                rkeys.append(b)
                continue
            if sa == "right" and sb == "left":
                lkeys.append(b)
                rkeys.append(a)
                continue
        residual = c if residual is None else (residual & c)
    return lkeys, rkeys, residual


class TpuSession:
    """A session on one torch device. It owns the TpuSemaphore its
    queries' tasks share (`sql.concurrentTpuTasks` permits), and reaches
    the device manager and spill store of its conf and device
    (`memory/device.py` `device_manager`, `memory/spill.py`
    `spill_store`: sessions of one budget share them)."""

    #: the session made last, which `builder_get_or_create` returns
    _active: Optional["TpuSession"] = None

    def __init__(self, conf: Optional[Dict] = None, device=None):
        self.conf = TpuConf(conf)
        self.device = _resolve_device(device)
        self.read = DataFrameReader(self)
        self.semaphore = TpuSemaphore(self.conf.concurrent_tasks)
        #: the event-log file of the last action that wrote one
        #: (`sql.eventLog.enabled`), else None
        self.last_event_log: Optional[str] = None
        TpuSession._active = self
        # the runtime witnesses and the fault plan from the conf (JAX
        # `session.py:50-58`): a witness turned on here wraps only the
        # locks made from now on
        enable_retry_coverage(bool(self.conf.get(RETRY_COVERAGE_ENABLED)))
        lockdep.maybe_enable_from_conf(self.conf)
        ledger.maybe_enable_from_conf(self.conf)
        racedep.maybe_enable_from_conf(self.conf)
        faults.install_from_conf(self.conf)

    @staticmethod
    def builder_get_or_create(conf: Optional[Dict] = None,
                              device=None) -> "TpuSession":
        """The session made last, or a new one from `conf` (and `device`)
        when none was made yet; an existing session keeps its conf, as
        in the JAX package."""
        if TpuSession._active is None:
            TpuSession(conf, device)
        return TpuSession._active

    def set_conf(self, key, value):
        """Set one key for the actions planned from now on (the conf is
        a fresh snapshot; a running action keeps its own). The semaphore
        keeps the permits it was made with."""
        self.conf = self.conf.set(key, value)

    @property
    def device_manager(self):
        return device_manager(self.conf, self.device)

    @property
    def spill_store(self):
        return spill_store(self.conf, self.device)

    def create_dataframe(self, data, schema=None) -> "DataFrame":
        import pyarrow as pa
        if isinstance(data, pa.Table):
            at = data
        elif isinstance(data, dict):
            if schema is not None:
                at = pa.table(data, schema=schema.to_arrow()
                              if isinstance(schema, Schema) else schema)
            else:
                at = pa.table(data)
        else:
            raise TypeError(
                "create_dataframe expects a pyarrow Table or dict")
        return DataFrame(self, L.InMemoryScan(at))

    def sql(self, query: str) -> "DataFrame":
        """A DataFrame of one SQL statement over this session's temp
        views (`sql/parser.py`: SELECT with joins, WHERE, GROUP BY,
        HAVING, ORDER BY, LIMIT, CTEs, subqueries; EXPLAIN)."""
        from .sql.parser import parse_sql
        return parse_sql(self, query)


class DataFrameReader:
    def __init__(self, session: TpuSession):
        self._session = session

    def parquet(self, *paths: str, columns=None) -> "DataFrame":
        import glob as _glob
        import os
        expanded: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                expanded.extend(sorted(
                    _glob.glob(os.path.join(p, "*.parquet"))))
            elif any(ch in p for ch in "*?["):
                expanded.extend(sorted(_glob.glob(p)))
            else:
                expanded.append(p)
        return DataFrame(self._session,
                         L.ParquetScan(expanded, columns=columns))

    def csv(self, *paths: str, header=True, schema=None, delimiter=",",
            quote='"', escape="\\", comment=None,
            null_value="") -> "DataFrame":
        """A lazy streaming CSV scan (reference: GpuCSVScan.scala:57);
        the schema from a first-block sample unless given."""
        from .exec.text_scan import CsvOptions
        opts = CsvOptions(header=header, delimiter=delimiter, quote=quote,
                          escape=escape, comment=comment,
                          null_value=null_value)
        return DataFrame(self._session,
                         L.TextScan(list(paths), "csv", schema,
                                    options=opts))

    def orc(self, *paths: str) -> "DataFrame":
        """A lazy stripe-streaming ORC scan (reference: GpuOrcScan.scala:78
        PERFILE reader)."""
        return DataFrame(self._session, L.TextScan(list(paths), "orc"))

    def avro(self, *paths: str) -> "DataFrame":
        """A lazy block-streaming Avro scan (reference: GpuAvroScan)."""
        return DataFrame(self._session, L.TextScan(list(paths), "avro"))

    def iceberg(self, path: str, snapshot_id=None,
                as_of_timestamp=None) -> "DataFrame":
        """An Iceberg table: metadata json -> manifest list -> manifests
        -> live Parquet files (reference: GpuIcebergParquetScan), with
        time travel by snapshot id or timestamp."""
        from .io.iceberg import read_iceberg
        return read_iceberg(self._session, path, snapshot_id,
                            as_of_timestamp)

    def delta(self, path: str, version=None) -> "DataFrame":
        """A Delta table at its latest version, or at `version`."""
        from .io.delta import read_delta
        return read_delta(self._session, path, version)

    def json(self, *paths: str, schema=None) -> "DataFrame":
        """A lazy block-streaming JSON-lines scan (reference:
        GpuJsonScan.scala); the schema from a first-block sample unless
        given."""
        return DataFrame(self._session,
                         L.TextScan(list(paths), "json", schema))


class GroupingID:
    """Marker accepted in a rollup / cube / grouping_sets agg list: the
    grouping id of the row's set (`functions.grouping_id`)."""

    name = "grouping_id()"

    def alias(self, name):
        return Alias(self, name)


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence[Expression],
                 grouping_sets=None):
        self._df = df
        self._keys = list(keys)
        # one include mask (a bool a key) per grouping set, or None for
        # a plain GROUP BY
        self._grouping_sets = grouping_sets

    def agg(self, *aggs) -> "DataFrame":
        pairs, gid_cols = [], []
        for a in aggs:
            name, inner = a.name, a
            if isinstance(a, Alias):
                name, inner = a._name, a.child
            if isinstance(inner, GroupingID):
                gid_cols.append(name)
                continue
            if not isinstance(inner, AggExpr):
                raise TypeError(f"not an aggregate: {a!r}")
            pairs.append((name, inner))
        if self._grouping_sets is None:
            if gid_cols:
                raise ValueError("grouping_id() requires rollup/cube/"
                                 "grouping_sets")
            return DataFrame(self._df._session,
                             L.Aggregate(self._df._plan, self._keys, pairs))
        return self._agg_grouping_sets(pairs, gid_cols)

    def _agg_grouping_sets(self, pairs, gid_cols) -> "DataFrame":
        """ROLLUP / CUBE / GROUPING SETS: an Expand (one copy of the rows
        a set, the excluded keys null, and the grouping id), an aggregate
        by the keys and the id, then the user's columns."""
        knames = [f"#gset_k{i}" for i in range(len(self._keys))]
        gid = "#gset_gid"
        expand = L.Expand(self._df._plan, self._keys, knames,
                          self._grouping_sets, gid)
        gkeys = [ColumnRef(kn) for kn in knames] + [ColumnRef(gid)]
        agg_node = L.Aggregate(expand, gkeys, pairs)
        out = [Alias(ColumnRef(kn), k.name)
               for k, kn in zip(self._keys, knames)]
        out += [ColumnRef(nm) for nm, _ in pairs]
        out += [Alias(ColumnRef(gid), nm) for nm in gid_cols]
        return DataFrame(self._df._session, L.Project(agg_node, out))

    def count(self) -> "DataFrame":
        return self.agg(CountStar().alias("count"))

    def _key_names(self):
        names = [getattr(k, "name", None) for k in self._keys]
        if any(n is None for n in names):
            raise ValueError("pandas group transforms need plain column "
                             "keys (got computed expressions)")
        return names

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        """Per-group pandas transform: `fn(pandas.DataFrame) ->
        pandas.DataFrame` runs once per group in a pooled python worker
        (reference: GroupedData.applyInPandas /
        GpuFlatMapGroupsInPandasExec). Groups are repartitioned whole;
        oversized partitions chunk at group boundaries."""
        from .exec.python_exec import _GroupApply
        out = _out_schema(schema)
        names = self._key_names()
        return DataFrame(self._df._session, L.GroupedMapInPandas(
            self._df._plan, _GroupApply(fn, names), out, names))

    applyInPandas = apply_in_pandas

    def agg_in_pandas(self, _types=None, **named) -> "DataFrame":
        """AggregateInPandas (reference:
        GpuAggregateInPandasExec.scala:51): each kwarg is
        name=(fn, col[, col...]); fn receives pandas Series (one per
        col) for ONE group and returns a scalar. Output: key columns +
        one row per group. Aggregate outputs default to FLOAT64;
        non-float results declare their dtype via
        `_types={name: DataType}`."""
        from .columnar.table import Field
        from .exec.python_exec import _AggApply
        names = self._key_names()
        aggs = {}
        for out_name, spec in named.items():
            fn = spec[0]
            cols = [getattr(c, "name", c) for c in spec[1:]]
            aggs[out_name] = (fn, cols)
        child_schema = self._df._plan.schema
        fields = [Field(n, child_schema[child_schema.index_of(n)].dtype)
                  for n in names]
        fields += [Field(n, (_types or {}).get(n, dt.FLOAT64))
                   for n in aggs]
        return DataFrame(self._df._session, L.GroupedMapInPandas(
            self._df._plan, _AggApply(aggs, names), Schema(fields), names))

    def cogroup(self, other: "GroupedData") -> "CoGroupedData":
        """Pair two grouped frames for applyInPandas over matching key
        groups (reference: GpuFlatMapCoGroupsInPandasExec)."""
        return CoGroupedData(self, other)


class CoGroupedData:
    def __init__(self, left: GroupedData, right: GroupedData):
        self._left = left
        self._right = right

    def apply_in_pandas(self, fn, schema) -> "DataFrame":
        """`fn(left_df, right_df) -> pandas.DataFrame` per matching key
        group (either side may be empty)."""
        from .exec.python_exec import _CoGroupApply
        out = _out_schema(schema)
        lnames = self._left._key_names()
        rnames = self._right._key_names()
        if len(lnames) != len(rnames):
            raise ValueError("cogroup key counts differ")
        lcols = list(self._left._df.schema.names)
        rcols = list(self._right._df.schema.names)
        wrapper = _CoGroupApply(fn, lnames, rnames, lcols, rcols)
        return DataFrame(self._left._df._session, L.CoGroupInPandas(
            self._left._df._plan, self._right._df._plan, wrapper, out,
            lnames, rnames))

    applyInPandas = apply_in_pandas


def _out_schema(schema) -> Schema:
    """A pandas transform's declared output: a Schema, (name, DataType)
    pairs, or an Arrow schema."""
    from .columnar.table import Field
    if isinstance(schema, Schema):
        return schema
    if isinstance(schema, (list, tuple)):
        return Schema([Field(n, t) for n, t in schema])
    return Schema([Field(f.name, dt.from_arrow(f.type)) for f in schema])


def _cache_batches(root, ctx) -> List:
    from .exec.batch import maybe_compact
    from .exec.coalesce import concat_batches
    target = max(1, ctx.conf.batch_size_rows)
    out, pending, rows = [], [], 0
    for b in root.execute_all(ctx):
        b = maybe_compact(b, root.schema)
        if pending and rows + b.num_rows > target:
            out.append(concat_batches(pending, root.schema))
            pending, rows = [], 0
        pending.append(b)
        rows += b.num_rows
    if pending:
        out.append(concat_batches(pending, root.schema))
    return out


class DataFrame:
    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return list(self._plan.schema.names)

    def select(self, *exprs) -> "DataFrame":
        es = [_to_expr(e) for e in exprs]
        # an explode / posexplode becomes a Generate node under the
        # projection (the reference's GenerateExec planning)
        gens = [(i, e.child if isinstance(e, Alias) else e, e)
                for i, e in enumerate(es)
                if isinstance(e.child if isinstance(e, Alias) else e,
                              Explode)]
        if not gens:
            return self._select_windows(es)
        if len(gens) > 1:
            raise ValueError("only one explode per select")
        i, gen, orig = gens[0]
        bound_child = gen.child.bind(self._plan.schema)
        if isinstance(bound_child.dtype, dt.MapType):
            names = ["key", "value"]
        else:
            names = [orig._name if isinstance(orig, Alias) else "col"]
        if gen.with_position:
            names = ["pos"] + names
        # the generated columns take internal names in the Generate node
        # (an input column called col, key or pos would shadow them),
        # then the user's names above it
        internal = [f"#gen{id(gen) & 0xFFFF:04x}_{n}" for n in names]
        gplan = L.Generate(self._plan, gen, internal)
        repl = [Alias(ColumnRef(ii), n) for ii, n in zip(internal, names)]
        return DataFrame(self._session,
                         L.Project(gplan, es[:i] + repl + es[i + 1:]))

    def _select_windows(self, es) -> "DataFrame":
        """A projection; window expressions among `es` first become the
        columns of a WindowOp node under it (the planner's split of the
        reference's GpuWindowExecMeta)."""
        from .window import WindowExpr
        wcols, plain = [], []
        for e in es:
            inner = e.child if isinstance(e, Alias) else e
            if isinstance(inner, WindowExpr):
                name = e._name if isinstance(e, Alias) else \
                    f"_w{len(wcols)}"
                wcols.append((name, inner))
                plain.append(ColumnRef(name))
            else:
                plain.append(e)
        plan = L.WindowOp(self._plan, wcols) if wcols else self._plan
        return DataFrame(self._session, L.Project(plan, plain))

    def with_column(self, name: str, e) -> "DataFrame":
        es = [col(n) for n in self.columns if n != name]
        es.append(_to_expr(e).alias(name))
        return self.select(*es)

    withColumn = with_column

    def filter(self, cond) -> "DataFrame":
        return DataFrame(self._session,
                         L.Filter(self._plan, _to_expr(cond)))

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Join on equi-key column names (`on`) plus an optional non-equi
        `condition` over the combined schema (an ambiguous name resolves
        to the left side), pyspark's column layout: the `on` columns
        once (a right join takes them from the right side, a full join
        coalesces both), then the left's other columns, then the
        right's. An expression `on` splits into equi keys and a residual
        condition; with no equi keys the condition runs a nested-loop
        join; `how="cross"` with no `on` pairs every row of each side."""
        if isinstance(on, str):
            on = [on]
        if on is None:
            on = []
        if isinstance(on, Expression):
            lk_x, rk_x, extra = _split_join_condition(
                on, self._plan.schema, other._plan.schema)
            if condition is not None:
                extra = condition if extra is None else (extra & condition)
            return self._join_positional(other, [], how, lk_x, rk_x,
                                         condition=extra)
        if not (isinstance(on, (list, tuple))
                and all(isinstance(c, str) for c in on)):
            raise TypeError("join `on` must be column name(s) or an "
                            "expression")
        lk = [col(c) for c in on]
        rk = [col(c) for c in on]
        if not on and condition is None and how != "cross":
            raise ValueError("join needs `on` keys or a `condition`")
        if condition is not None or not on:
            # a condition binds by position over the combined schema
            return self._join_positional(other, list(on), how, lk, rk,
                                         condition=condition)
        if how in ("left_semi", "left_anti"):
            return DataFrame(self._session,
                             L.Join(self._plan, other._plan, lk, rk, how))
        lnames_list = list(self._plan.schema.names)
        rnames_list = list(other._plan.schema.names)
        if (len(set(lnames_list)) < len(lnames_list)
                or len(set(rnames_list)) < len(rnames_list)):
            # a side already has duplicate names (a previous join's
            # output): a projection by name would merge them
            return self._join_positional(other, on, how, lk, rk)
        # rename the colliding right-side columns before the join, so the
        # joined schema's names are unique and the projection above it
        # stays by name (column pruning and filter pushdown see through)
        lnames = set(lnames_list)
        tag = next(_JOIN_TAGS)
        rename = {f.name: f"__join_r{tag}_{f.name}"
                  for f in other._plan.schema.fields if f.name in lnames}
        rplan = other._plan
        if rename:
            rplan = L.Project(rplan, [
                col(f.name).alias(rename[f.name]) if f.name in rename
                else col(f.name) for f in other._plan.schema.fields])
        rk = [col(rename.get(c, c)) for c in on]
        jplan = L.Join(self._plan, rplan, lk, rk, how)
        on_set = set(on)
        exprs = []
        for name in on:
            rn = rename.get(name, name)
            if how == "right":
                exprs.append(col(rn).alias(name))
            elif how == "full":
                exprs.append(Coalesce(col(name), col(rn)).alias(name))
            else:
                exprs.append(col(name))
        for f in self._plan.schema.fields:
            if f.name not in on_set:
                exprs.append(col(f.name))
        for f in other._plan.schema.fields:
            if f.name in on_set:
                continue
            rn = rename.get(f.name, f.name)
            exprs.append(col(rn).alias(f.name) if rn != f.name
                         else col(f.name))
        return DataFrame(self._session, L.Project(jplan, exprs))

    def _join_positional(self, other: "DataFrame", on, how, lk, rk,
                         condition=None):
        """The post-join projection by position (BoundRef): exact for
        inputs with duplicate names, at the cost of name-based pruning
        above this join."""
        jplan = L.Join(self._plan, other._plan, lk, rk, how,
                       condition=condition)
        if how in ("left_semi", "left_anti"):
            return DataFrame(self._session, jplan)
        nl = len(self._plan.schema.fields)
        on_set = set(on)
        exprs = []
        jschema = jplan.schema
        for name in on:
            li = self._plan.schema.index_of(name)
            ri = nl + other._plan.schema.index_of(name)
            lref = BoundRef(li, jschema[li].dtype, name)
            rref = BoundRef(ri, jschema[ri].dtype, name)
            if how == "right":
                exprs.append(rref)
            elif how == "full":
                exprs.append(Coalesce(lref, rref).alias(name))
            else:
                exprs.append(lref)
        for i, f in enumerate(jschema.fields):
            if f.name in on_set:
                continue
            exprs.append(BoundRef(i, f.dtype, f.name))
        return DataFrame(self._session, L.Project(jplan, exprs))

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [_to_expr(k) for k in keys])

    groupBy = group_by

    def rollup(self, *keys) -> GroupedData:
        """GROUP BY ROLLUP: (k1..kn), (k1..kn-1), ..., ()."""
        ks = [_to_expr(k) for k in keys]
        n = len(ks)
        sets = [[i < j for i in range(n)] for j in range(n, -1, -1)]
        return GroupedData(self, ks, grouping_sets=sets)

    def cube(self, *keys) -> GroupedData:
        """GROUP BY CUBE: all 2^n subsets of the keys."""
        ks = [_to_expr(k) for k in keys]
        n = len(ks)
        sets = [[not (m >> (n - 1 - i)) & 1 == 1 for i in range(n)]
                for m in range(1 << n)]
        return GroupedData(self, ks, grouping_sets=sets)

    def grouping_sets(self, keys, sets) -> GroupedData:
        """Explicit GROUPING SETS: `sets` is a list of key-name lists,
        each a subset of `keys`."""
        ks = [_to_expr(k) for k in keys]
        names = [k.name for k in ks]
        masks = []
        for s_ in sets:
            want = set(s_)
            unknown = want - set(names)
            if unknown:
                raise ValueError(f"grouping set refers to unknown keys "
                                 f"{sorted(unknown)}")
            masks.append([nm in want for nm in names])
        return GroupedData(self, ks, grouping_sets=masks)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *orders, ascending=True) -> "DataFrame":
        sos = [o if isinstance(o, L.SortOrder)
               else L.SortOrder(_to_expr(o), ascending) for o in orders]
        return DataFrame(self._session, L.Sort(self._plan, sos))

    orderBy = sort

    def create_or_replace_temp_view(self, name: str):
        """Register this DataFrame under `name` (case-insensitive) for
        `TpuSession.sql`."""
        from .sql.parser import register_view
        register_view(self._session, name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    def distinct(self) -> "DataFrame":
        """The distinct rows: an aggregate keyed on every column, with no
        aggregate functions."""
        ks = [col(n) for n in self.columns]
        return DataFrame(self._session, L.Aggregate(self._plan, ks, []))

    dropDuplicates = distinct

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._session, L.Limit(self._plan, n))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position; the column types must agree."""
        return DataFrame(self._session, L.Union([self._plan, other._plan]))

    def cache(self) -> "DataFrame":
        """This DataFrame's result as device-resident batches: a new
        DataFrame over a CachedScan, whose queries skip the host decode
        and the copy to the device. The batches live outside the device
        budget, as in the JAX package, until `uncache`. Unlike the JAX
        package's, a sparse batch (a filter's mask) keeps only its live
        rows (`maybe_compact`), and consecutive small batches concatenate
        up to `sql.batchSizeRows`, so a query over the cache runs over
        fewer, dense batches."""
        with self._action("cache") as (root, ctx), \
                _query_scope(ctx.query_id):
            batches = _cache_batches(root, ctx)
        node = L.CachedScan(batches, self._plan.schema, source=self._plan)
        self._cached_node = node
        out = DataFrame(self._session, node)
        out._cached_node = node
        return out

    def uncache(self) -> "DataFrame":
        """Free the device batches of this DataFrame's cache (made by
        `cache`, on this DataFrame or the one it returned). Every
        DataFrame over the cache shares its batch list, so they go at
        once; the next action over the cache plans the cached DataFrame's
        own plan again."""
        node = getattr(self, "_cached_node", None)
        if node is not None:
            node.batches.clear()
            node.released = True
            self._cached_node = None
        return self

    def repartition(self, n: int, *keys) -> "DataFrame":
        ks = [_to_expr(k) for k in keys] or None
        return DataFrame(self._session, L.Repartition(self._plan, n, ks))

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        """Apply `fn(pandas.DataFrame) -> pandas.DataFrame` batch-wise in
        a pooled python WORKER PROCESS, batches crossing as Arrow IPC
        (reference: DataFrame.mapInPandas / GpuMapInPandasExec). `fn`
        must be picklable; `schema` is the output schema
        (Schema | list[(name, DataType)] | arrow schema)."""
        return DataFrame(self._session,
                         L.MapInPandas(self._plan, fn, _out_schema(schema)))

    mapInPandas = map_in_pandas

    def physical_plan(self):
        """(root exec, its ExecContext): a fresh plan of this DataFrame
        on the session's device. The file scans' snapshots are re-statted
        first (`io/snapshot.py`), so the plan pins the files as they are
        now and a file rewritten between actions is read anew."""
        s = self._session
        refresh_plan_snapshots(self._plan)
        return Planner(s.conf).plan(self._plan), ExecContext(
            s.conf, s.device, session=s)

    def explain(self, mode: str = "ALL") -> str:
        """Print and return the plan, planned with `sql.explain` at
        `mode` (JAX `session.py:1262-1277`): ALL gives the tagged tree of
        the optimized plan (`*` on the device, `!cpu` on the host
        fallback, `!` nowhere) and the audit's findings, then the
        physical tree; NOT_ON_TPU only the nodes that do not run on the
        device, and the findings; VALIDATE the plan audit
        (`report.lines()`). A plan that cannot run prints its tags, then
        raises. ANALYZE runs the query and renders the tree annotated with
        its runtime metrics (rows, batches, op time, shuffle bytes per
        node, the top time sinks flagged, the root's launches, syncs and
        critical path; `profiler/analyze.py`). Every node carries its
        lore id."""
        mode_u = str(mode).upper()
        if mode_u == "ANALYZE":
            return self._explain_analyze()
        if mode_u not in ("ALL", "NOT_ON_TPU", "VALIDATE"):
            raise ValueError(f"unknown explain mode {mode!r}")
        planner = Planner(self._session.conf.set(
            "spark.rapids.tpu.sql.explain", mode_u))
        root = planner.plan(self._plan)
        lines = list(planner.last_explain)
        if mode_u == "ALL":
            phys = ["== Physical Plan =="]

            def physical(node, depth):
                desc = getattr(node, "describe", None)
                phys.append("  " * depth + (desc() if desc
                                            else type(node).__name__))
                for c in node.children:
                    physical(c, depth + 1)
            physical(root, 0)
            for line in phys:
                print(line)
            lines += phys
        return "\n".join(lines)

    def _explain_analyze(self) -> str:
        from .profiler.analyze import TIMER_NOTE, render_analyze
        from .profiler.event_log import op_metrics_records, plan_tree
        self.to_arrow()
        root = self._last_plan
        recs = op_metrics_records(root, self._last_metrics)
        by_lore = {r["lore_id"]: r["metrics"] for r in recs}
        notes = [] if self._last_metrics_sync else [TIMER_NOTE]
        text = render_analyze(plan_tree(root), by_lore,
                              title="== EXPLAIN ANALYZE ==", notes=notes)
        print(text)
        return text

    @contextmanager
    def _action(self, action: str):
        """One action under the query profiler (JAX `session.py:
        968-1199`): the trace's root span opens before planning, the
        plan is made afresh inside a `plan` span, the stage driver runs
        (every shuffle stage materializes and re-plans before the
        consumer), then the caller's body, given (root, ctx). After it
        the plan's python workers stop, the root's metrics take the
        action's host syncs and kernel launches, the event log (when
        on) its records, and on success
        the root its critical-path shares and the calibration table the
        observed cardinalities. The query scope is open over these steps
        but not across the `yield`: the caller runs the plan under
        `_query_scope(ctx.query_id)`, a generator only between its own
        yields, so two interleaved streams never trade query ids."""
        conf = self._session.conf
        qid = next_query_id()
        lg = ledger.ledger()
        lease0 = (lg.report()["kinds"].get("staging_lease", {})
                  .get("acquires", 0) if lg is not None else 0)
        ended = False
        try:
            # the query scope tags this thread's reservations (and,
            # carried by the pools, their workers') with the query id
            with _query_scope(qid) as scope:
                tc = tracing.start_trace(qid, conf)
                rsp = None
                if tc is not None:
                    # the root first, so the plan span parents under it
                    rsp = tracing.open_span("query", "query", tc,
                                            action=action)
                    tc = tracing.TraceContext(tc.trace_id, rsp.span_id, True)
                try:
                    with tracing.span("plan", "plan", tc):
                        root, ctx = self.physical_plan()
                except BaseException:
                    if rsp is not None:
                        rsp.end()
                        tracing.drain_trace(qid)
                    raise
                ctx.trace, ctx._root_span = tc, rsp
                ctx.query_id = qid
                counts0 = xla_stats.snapshot()
                try:
                    with tracing.use(tc), profile_query(
                            self._session, root, ctx, action, qid) as w:
                        try:
                            t0 = time.perf_counter()
                            decisions = run_stage_driver(root, ctx, conf)
                            ctx.set_metric(root._op_id, "stageDriverTime",
                                           time.perf_counter() - t0)
                            self._last_plan = root
                            self._last_aqe_decisions = decisions
                            if decisions and w is not None:
                                w.emit("aqe_replan", action=action,
                                       decisions=decisions)
                            with scope.suspended():
                                yield root, ctx
                        finally:
                            # the launch and sync counts ride the root's
                            # metrics (in place of the JAX xlaCompiles /
                            # xlaDispatches), set before the event log
                            # snapshots them
                            d = xla_stats.delta(counts0)
                            rid = root._op_id
                            ctx.add_metric(rid, "hostSyncs", d["host_syncs"])
                            ctx.add_metric(rid, "kernelLaunches",
                                           d["kernel_launches"])
                            ctx.add_metric(rid, "kernelLaunches.vector",
                                           d["vector_launches"])
                            ctx.add_metric(rid, "kernelLaunches.scalar",
                                           d["scalar_launches"])
                            # spill handles a failed or abandoned operator
                            # left, and the python workers of its pandas
                            # execs
                            ctx.close()
                            close_plan_pools(root)
                            self._last_events = list(ctx.pending_events)
                            if w is not None:
                                for ev in ctx.pending_events:
                                    kw = dict(ev)
                                    w.emit(kw.pop("event"), **kw)
                finally:
                    # with the event log off the trace still closes here, so
                    # the summary exists and the span buffer drains
                    tracing.finish(ctx)
                for c, pct in (ctx.trace_summary or {}).get("share_pct",
                                                             {}).items():
                    if pct:
                        ctx.add_metric(root._op_id,
                                       f"criticalPathShare.{c}", pct)
                # the observed cardinalities close the adaptive loop; advisory,
                # it never fails the query (JAX `session.py:1050-1069`)
                try:
                    harvest_calibration(root, ctx)
                except Exception:
                    pass
                # the query's owner-scoped resources (leases, permits, rides)
                # balance, or ResourceLeakError (JAX QueryManager._finalize)
                ended = True
                ledger.note_query_end(qid, "FINISHED")
                if lg is not None:
                    # the ledger's verdict and this action's lease traffic on
                    # the root (JAX `session.py:1186-1197`)
                    rep = lg.report()
                    sk = rep["kinds"].get("staging_lease", {})
                    leases = int(sk.get("acquires", 0) - lease0)
                    rid = root._op_id
                    if leases:
                        ctx.add_metric(rid, "ledgerLeaseAcquires", leases)
                    ctx.add_metric(rid, "ledgerPeakLeases",
                                   int(sk.get("peakOutstanding", 0)))
                    ctx.add_metric(rid, "ledgerBalanced",
                                   int(bool(rep["balanceOk"])))
                self._last_metrics = {
                    op: metrics_snapshot(m, ctx.metrics_level)
                    for op, m in ctx.metrics.items()}
                self._last_metrics_sync = ctx.metrics_sync
        finally:
            if not ended:
                try:
                    ledger.note_query_end(qid, "FAILED")
                except ledger.ResourceLeakError:
                    pass    # recorded; the query's own error propagates

    def write_parquet(self, path: str, **kw):
        """Write the result as Parquet part files, one a physical
        partition, and a `_SUCCESS` marker (`io/parquet.py`)."""
        from .io.parquet import write_parquet
        write_parquet(self, path, **kw)

    def write_delta(self, path: str, mode: str = "append") -> int:
        """Commit the result to a Delta table; returns the new version."""
        from .io.delta import write_delta
        return write_delta(self, path, mode)

    @property
    def write(self):
        """The chained writer: `df.write.mode(...).partitionBy(...)
        .parquet / orc / csv / json / hive_text / delta / iceberg(path)`
        (`io/writer.py`)."""
        from .io.writer import DataFrameWriter
        return DataFrameWriter(self)

    def _iter_partition_tables(self):
        """The result partition by partition, as compacted host Arrow
        tables (every file writer's source)."""
        for _pid, at in self._partition_tables():
            yield at

    def _partition_tables(self):
        """(physical partition, its host Arrow table) for each partition
        that produced a batch, in partition order. Plans afresh, runs the
        stage driver (every shuffle stage before its consumer), then each
        partition on this thread: its batches' copies to the host happen
        here, so a writer pool never touches a device tensor. The
        context closes when the stream ends or is abandoned."""
        import pyarrow as pa

        from .exec.nodes import _batch_to_arrow
        with self._action("write") as (root, ctx):
            for pid in range(root.num_partitions(ctx)):
                tables = []
                # the scope over this partition's execution only: the
                # consumer runs between the yields
                with _query_scope(ctx.query_id):
                    for b in root.execute_partition(ctx, pid):
                        with ctx.timer(root._op_id, "collectTime"):
                            tables.append(_batch_to_arrow(b))
                if tables:
                    yield pid, pa.concat_tables(tables)

    def to_arrow(self):
        with self._action("collect") as (root, ctx), \
                _query_scope(ctx.query_id):
            return collect_to_arrow(root, ctx)

    def to_torch(self) -> Dict[str, tuple]:
        """The result as torch tensors already on the session's device,
        the ColumnarRdd analog (reference: sql-plugin-api ColumnarRdd,
        the zero-copy hand-off to ML): {column: (data, validity)}, the
        live rows compacted on the device, no host copy. Fixed-width
        columns only (a string raises TypeError; use to_arrow). The JAX
        package's counterpart is `to_jax`, which returns jax Arrays; the
        port imports no JAX (ROADMAP C)."""
        from .exec.batch import _torch_dtype
        from .ops.concat import concat_cvs, concat_masks
        from .ops.gather import compact
        fields = self.schema.fields
        for f in fields:
            if f.dtype.is_variable_width or f.dtype.is_nested:
                raise TypeError(
                    f"to_torch exports fixed-width columns; {f.name} is "
                    f"{f.dtype.simple_name()} (use to_arrow)")
        with self._action("to_torch") as (root, ctx), \
                _query_scope(ctx.query_id):
            batches = list(root.execute_all(ctx))
        dev = self._session.device
        if not batches:
            return {f.name: (torch.zeros(0, dtype=_torch_dtype(
                f.dtype.np_dtype), device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
                for f in fields}
        cvs = [concat_cvs([b.cvs()[i] for b in batches], f.dtype)
               for i, f in enumerate(fields)]
        mask = concat_masks([b.row_mask for b in batches])
        dense, n = compact(cvs, mask)
        return {f.name: (c.data[:n], c.validity[:n])
                for f, c in zip(fields, dense)}

    def last_plan(self):
        """The physical plan root of this DataFrame's most recent action,
        as it ran (a demoted join rewired): its nodes' `_op_id`s key
        `last_metrics()`, and `exchange_reuse_hits` on it counts the
        exchanges the reuse pass merged."""
        return getattr(self, "_last_plan", None)

    def last_aqe_decisions(self) -> List[Dict]:
        """The adaptive decisions of this DataFrame's most recent action:
        one `shuffle_read` record per re-planned stage (partitions before
        and after, coalesced away, skewed partitions and their slices)
        and one `demote_broadcast_join` record per demoted join (its
        build bytes and the threshold)."""
        return getattr(self, "_last_aqe_decisions", [])

    def last_events(self) -> List[Dict]:
        """The events of this DataFrame's most recent action: one
        `degrade_to_host` record an operator pinned to the host
        (`exec/degrade.py`)."""
        return getattr(self, "_last_events", [])

    def last_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-operator metrics of this DataFrame's most recent action:
        host seconds per layer (scanTime, decodeTime, hashPassTime,
        sortPassTime, mergeTime, mapTime, sliceTime, reduceTime, buildTime,
        probeTime, expandTime, sortTime, limitTime, collectTime,
        pythonEvalTime; summed over the collect's concurrent tasks, so a
        layer can exceed the wall) and counts (mapBatches,
        skippedRowGroups, inputBatches, hashPassBatches, sortPassBatches,
        mergePasses, numBucketSplits, numBucketRecursions, a join's
        streamBatches, directProbeBatches, sortedProbeBatches,
        countProbeBatches, fkOutputBatches, expandOutputBatches,
        numSubPartitions, numSubPartRecursions, the sort's
        oocRangePartitions, numGroupChunks; the root's semaphoreWaitMs,
        hostSyncs, kernelLaunches and criticalPathShare.*), at or below
        `sql.metrics.level` (every metric is MODERATE, as in the JAX
        package)."""
        return getattr(self, "_last_metrics", {})

    def collect(self) -> List[tuple]:
        at = self.to_arrow()
        cols = [at.column(i).to_pylist() for i in range(at.num_columns)]
        return list(zip(*cols)) if cols else []

    def to_pydict(self) -> Dict[str, list]:
        return self.to_arrow().to_pydict()

    def count(self) -> int:
        df = DataFrame(self._session, L.Aggregate(
            self._plan, [], [("count", CountStar())]))
        return df.collect()[0][0]
