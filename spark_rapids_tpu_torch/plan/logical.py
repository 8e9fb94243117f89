"""Logical plan nodes built by the DataFrame API: the ported subset.

Scans (in-memory Arrow, Parquet), Project, Filter, Aggregate (grouped
or not), Join (every `how` of the JAX package; the planner raises on
`cross` and on a `condition`), Sort, Limit and Repartition. Expressions bind against the child schema when a node is
built, as in the JAX package; an expression the port cannot evaluate
raises there (NotPorted or UnsupportedExpr) instead of planning a host
fallback.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..columnar.table import Field, Schema
from ..expr import aggregates as agg
from ..expr.expressions import Expression

__all__ = ["LogicalPlan", "InMemoryScan", "ParquetScan", "Project",
           "Filter", "Aggregate", "Join", "SortOrder", "Sort", "Limit",
           "Repartition"]


class LogicalPlan:
    children: List["LogicalPlan"] = []

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def node_name(self) -> str:
        return type(self).__name__


class InMemoryScan(LogicalPlan):
    """Scan over a host (pyarrow) table; batches stream host -> device."""

    def __init__(self, arrow_table):
        self.arrow = arrow_table
        self.children = []
        self._schema = Schema.from_arrow(arrow_table.schema)

    @property
    def schema(self):
        return self._schema


class ParquetScan(LogicalPlan):
    def __init__(self, paths: Sequence[str], schema: Optional[Schema] = None,
                 columns: Optional[Sequence[str]] = None, filters=None):
        import pyarrow.parquet as pq
        self.paths = list(paths)
        self.columns = list(columns) if columns is not None else None
        # (name, op, value) conjuncts for row-group pruning, attached by
        # the optimizer from a Filter directly above the scan
        self.filters = list(filters) if filters else None
        if schema is None:
            schema = Schema.from_arrow(pq.read_schema(self.paths[0]))
            if self.columns is not None:
                schema = Schema([f for f in schema.fields
                                 if f.name in self.columns])
        self._schema = schema
        self.children = []

    @property
    def schema(self):
        return self._schema


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: Sequence[Expression]):
        self.child = child
        self.children = [child]
        self.exprs = list(exprs)
        self.bound = [e.bind(child.schema) for e in self.exprs]
        self._schema = Schema([Field(e.name, b.dtype)
                               for e, b in zip(self.exprs, self.bound)])

    @property
    def schema(self):
        return self._schema


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: Expression):
        self.child = child
        self.children = [child]
        self.condition = condition
        self.bound = condition.bind(child.schema)

    @property
    def schema(self):
        return self.child.schema


class Aggregate(LogicalPlan):
    """Grouped or ungrouped aggregation: aggs are (output_name, AggExpr)
    pairs, keys the grouping expressions."""

    def __init__(self, child: LogicalPlan, keys: Sequence[Expression],
                 aggs: Sequence[Tuple[str, agg.AggExpr]]):
        self.child = child
        self.children = [child]
        self.keys = list(keys)
        self.aggs = list(aggs)
        self.bound_keys = [k.bind(child.schema) for k in self.keys]
        self.bound_aggs = [(n, a.bind(child.schema)) for n, a in self.aggs]
        fields = [Field(k.name, bk.dtype)
                  for k, bk in zip(self.keys, self.bound_keys)]
        fields += [Field(n, a.dtype) for n, a in self.bound_aggs]
        self._schema = Schema(fields)

    @property
    def schema(self):
        return self._schema


class Join(LogicalPlan):
    """Equi-join of left (the stream side) and right (the build side) on
    `left_keys[i] == right_keys[i]`; semi/anti joins output the left
    columns only, every other join the left then the right columns. A
    non-equi `condition` binds over the combined schema."""

    HOWS = ("inner", "left", "right", "full", "left_semi", "left_anti",
            "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], how: str = "inner",
                 condition: Optional[Expression] = None):
        if how not in self.HOWS:
            raise ValueError(f"unknown join type {how!r}")
        self.left, self.right = left, right
        self.children = [left, right]
        self.how = how
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.bound_left_keys = [k.bind(left.schema) for k in self.left_keys]
        self.bound_right_keys = [k.bind(right.schema)
                                 for k in self.right_keys]
        lf = list(left.schema.fields)
        rf = list(right.schema.fields)
        self.condition = condition
        self.bound_condition = (condition.bind(Schema(lf + rf))
                                if condition is not None else None)
        self._schema = Schema(lf if how in ("left_semi", "left_anti")
                              else lf + rf)

    @property
    def schema(self):
        return self._schema


class SortOrder:
    def __init__(self, expr: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.expr = expr
        self.ascending = ascending
        # Spark default: nulls first for asc, nulls last for desc
        self.nulls_first = ascending if nulls_first is None else nulls_first

    def __repr__(self):
        d = "ASC" if self.ascending else "DESC"
        nf = "NULLS FIRST" if self.nulls_first else "NULLS LAST"
        return f"{self.expr!r} {d} {nf}"


class Sort(LogicalPlan):
    """A global sort: orders bind against the child schema."""

    def __init__(self, child: LogicalPlan, orders: Sequence[SortOrder]):
        self.child = child
        self.children = [child]
        self.orders = list(orders)
        self.bound_orders = [SortOrder(o.expr.bind(child.schema),
                                       o.ascending, o.nulls_first)
                             for o in self.orders]

    @property
    def schema(self):
        return self.child.schema


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        self.child = child
        self.children = [child]
        self.n = n

    @property
    def schema(self):
        return self.child.schema


class Repartition(LogicalPlan):
    def __init__(self, child: LogicalPlan, num_partitions: int,
                 keys: Optional[Sequence[Expression]] = None):
        self.child = child
        self.children = [child]
        self.num_partitions = num_partitions
        self.keys = list(keys) if keys else None
        self.bound_keys = ([k.bind(child.schema) for k in self.keys]
                           if self.keys else None)

    @property
    def schema(self):
        return self.child.schema
