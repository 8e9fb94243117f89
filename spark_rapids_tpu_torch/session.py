"""Session and DataFrame: the entry points of the port.

The same surface as the JAX package's `TpuSession` for the ported slice:
`create_dataframe`, `read.parquet`, and `filter`, `select`,
`with_column`, `agg`, `group_by(...).agg`, `join` (equi-keys by name,
an expression `on`, a non-equi `condition`, cross), `sort`, `limit`, `repartition`, `to_arrow` and `collect` on a
DataFrame. A session runs on
one torch device: CUDA unless the caller asks for another. Every action
plans the logical tree afresh and executes it on that device.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import torch

from .columnar.table import Schema
from .config import TpuConf
from .exec.base import ExecContext
from .exec.nodes import collect_to_arrow
from .expr.aggregates import AggExpr
from .expr.expressions import (Alias, BoundRef, Coalesce, Expression,
                               col)
from .functions import _to_expr
from .plan import logical as L
from .plan.planner import Planner

__all__ = ["TpuSession", "DataFrame", "GroupedData"]

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
    def __init__(self, conf: Optional[Dict] = None, device=None):
        self.conf = TpuConf(conf)
        self.device = _resolve_device(device)
        self.read = DataFrameReader(self)

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


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence[Expression]):
        self._df = df
        self._keys = list(keys)

    def agg(self, *aggs) -> "DataFrame":
        pairs = []
        for a in aggs:
            name, inner = a.name, a
            if isinstance(a, Alias):
                name, inner = a._name, a.child
            if not isinstance(inner, AggExpr):
                raise TypeError(f"not an aggregate: {a!r}")
            pairs.append((name, inner))
        return DataFrame(self._df._session,
                         L.Aggregate(self._df._plan, self._keys, pairs))


class DataFrame:
    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    @property
    def columns(self) -> List[str]:
        return list(self._plan.schema.names)

    def select(self, *exprs) -> "DataFrame":
        return DataFrame(self._session,
                         L.Project(self._plan, [_to_expr(e) for e in exprs]))

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

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *orders, ascending=True) -> "DataFrame":
        sos = [o if isinstance(o, L.SortOrder)
               else L.SortOrder(_to_expr(o), ascending) for o in orders]
        return DataFrame(self._session, L.Sort(self._plan, sos))

    orderBy = sort

    def distinct(self) -> "DataFrame":
        """The distinct rows: an aggregate keyed on every column, with no
        aggregate functions."""
        ks = [col(n) for n in self.columns]
        return DataFrame(self._session, L.Aggregate(self._plan, ks, []))

    dropDuplicates = distinct

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._session, L.Limit(self._plan, n))

    def repartition(self, n: int, *keys) -> "DataFrame":
        ks = [_to_expr(k) for k in keys] or None
        return DataFrame(self._session, L.Repartition(self._plan, n, ks))

    def physical_plan(self):
        """(root exec, its ExecContext): a fresh plan of this DataFrame
        on the session's device."""
        s = self._session
        return Planner(s.conf).plan(self._plan), ExecContext(s.conf,
                                                             s.device)

    def to_arrow(self):
        root, ctx = self.physical_plan()
        out = collect_to_arrow(root, ctx)
        self._last_metrics = ctx.metrics
        self._last_plan = root
        return out

    def last_plan(self):
        """The physical plan root of this DataFrame's most recent action:
        its nodes' `_op_id`s key `last_metrics()`."""
        return getattr(self, "_last_plan", None)

    def last_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-operator metrics of this DataFrame's most recent action:
        host seconds per layer (scanTime, decodeTime, hashPassTime,
        sortPassTime, mergeTime, mapTime, sliceTime, reduceTime, buildTime,
        probeTime, expandTime, sortTime, limitTime, collectTime) and
        counts (mapBatches, skippedRowGroups, inputBatches,
        hashPassBatches, sortPassBatches, mergePasses, numBucketRecursions,
        a join's streamBatches, directProbeBatches, sortedProbeBatches,
        countProbeBatches, fkOutputBatches, expandOutputBatches)."""
        return getattr(self, "_last_metrics", {})

    def collect(self) -> List[tuple]:
        at = self.to_arrow()
        cols = [at.column(i).to_pylist() for i in range(at.num_columns)]
        return list(zip(*cols)) if cols else []
