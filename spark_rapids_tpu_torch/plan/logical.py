"""Logical plan nodes built by the DataFrame API: the ported subset.

Scans (in-memory Arrow, Parquet with its bind-time snapshot, Delta
deletion vectors and version, CSV / JSON / ORC / Avro, cached device
batches), Project, Filter, Aggregate (grouped or not), Expand (grouping
sets), Join (every `how` of the JAX package), Sort, Limit, Union,
Generate (explode), WindowOp, the pandas nodes (MapInPandas,
GroupedMapInPandas, CoGroupInPandas) and Repartition. Expressions bind against
the child schema when a node is built, as in the JAX package, and each
bound tree passes the type-signature gate (`typesig.check_tree`) at the
JAX package's bind sites. A Project or Filter whose expression the
device cannot run keeps the unbound tree and its bind error (and a
Project the output type the host interpreter gives it), for the
planner's host fallback; anywhere else such an expression raises
UnsupportedExpr (or NotPorted) here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..columnar import dtypes as dt
from ..columnar.table import Field, Schema
from ..expr import aggregates as agg
from ..expr.expressions import Expression, UnsupportedExpr
from ..expr.host_eval import host_output_dtype
from .typesig import check_tree as _tsig

__all__ = ["LogicalPlan", "InMemoryScan", "CachedScan", "ParquetScan",
           "TextScan", "Project", "Filter", "Aggregate", "Expand", "Join",
           "SortOrder", "Sort", "Limit", "Union", "Generate", "WindowOp",
           "MapInPandas", "GroupedMapInPandas", "CoGroupInPandas",
           "Repartition"]


class LogicalPlan:
    children: List["LogicalPlan"] = []

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def node_name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.node_name()


class InMemoryScan(LogicalPlan):
    """Scan over a host (pyarrow) table; batches stream host -> device."""

    def __init__(self, arrow_table):
        self.arrow = arrow_table
        self.children = []
        self._schema = Schema.from_arrow(arrow_table.schema)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"InMemoryScan[rows={self.arrow.num_rows}] {self._schema}"


class CachedScan(LogicalPlan):
    """Scan over device-resident batches (`DataFrame.cache`), the
    analog of the reference's GpuInMemoryTableScanExec: a query over it
    skips the host decode and the copy to the device. Once released
    (`DataFrame.uncache`) a query plans `source`, the plan it cached."""

    def __init__(self, batches, schema: Schema,
                 source: Optional[LogicalPlan] = None):
        self.batches = list(batches)
        self._schema = schema
        self.source = source
        self.released = False
        self.children = []

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"CachedScan[{len(self.batches)} device batches] "
                f"{self._schema}")


class ParquetScan(LogicalPlan):
    def __init__(self, paths: Sequence[str], schema: Optional[Schema] = None,
                 columns: Optional[Sequence[str]] = None, filters=None,
                 dv=None, delta_version=None):
        import pyarrow.parquet as pq

        from ..io.snapshot import scan_snapshot
        self.paths = list(paths)
        self.columns = list(columns) if columns is not None else None
        # (name, op, value) conjuncts for row-group pruning, attached by
        # the optimizer from a Filter directly above the scan
        self.filters = list(filters) if filters else None
        # {path: (table_root, deletionVector descriptor)}: dead-row
        # masks applied lazily inside the scan (Delta DVs)
        self.dv = dict(dv) if dv else None
        # bind-time snapshot: (path, mtime_ns, size) per file, plus the
        # Delta table version when read through read_delta. Every
        # action refreshes it before planning (DataFrame.physical_plan);
        # a file that changes mid-query raises (io/snapshot.py)
        self.snapshot = scan_snapshot(self.paths)
        self.delta_version = delta_version
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

    def describe(self):
        return f"ParquetScan[{len(self.paths)} files] {self._schema}"


class TextScan(LogicalPlan):
    """Lazy CSV / JSON-lines / ORC / Avro scan (reference: GpuCSVScan,
    GpuJsonScan, GpuOrcScan, GpuAvroScan). The schema comes from the
    file's metadata or a first-block sample; decode happens per batch at
    execution (exec/text_scan.py)."""

    def __init__(self, paths: Sequence[str], fmt: str,
                 schema: Optional[Schema] = None, columns=None,
                 options=None):
        from ..exec.text_scan import infer_text_schema
        from ..io.snapshot import scan_snapshot
        self.children = []
        self.paths = list(paths)
        self.fmt = fmt
        self.columns = list(columns) if columns else None
        self.options = options
        # bind-time file pinning, the same contract as ParquetScan's
        self.snapshot = scan_snapshot(self.paths)
        if schema is not None and not isinstance(schema, Schema):
            schema = Schema.from_arrow(schema)   # a pyarrow schema
        self._full_schema = schema or infer_text_schema(
            self.paths[0], fmt, options)
        if self.columns is not None:
            want = set(self.columns)
            self._schema = Schema([f for f in self._full_schema.fields
                                   if f.name in want])
        else:
            self._schema = self._full_schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        cols = f", columns={self.columns}" if self.columns else ""
        return f"TextScan[{self.fmt}, {len(self.paths)} files{cols}]"


class Project(LogicalPlan):
    """A projection. An expression the device cannot run (its bind or
    its type signature refuses it) keeps its unbound tree: `bound[i]` is
    None, `bind_errors[i]` the refusal, and the output type is the host
    interpreter's (`host_output_dtype`); without one it raises."""

    def __init__(self, child: LogicalPlan, exprs: Sequence[Expression]):
        self.child = child
        self.children = [child]
        self.exprs = list(exprs)
        self.bound: List[Optional[Expression]] = []
        self.bind_errors: List[Optional[str]] = []
        fields = []
        for e in self.exprs:
            try:
                b = _tsig(e.bind(child.schema),
                          where=f"Project expr {e.name!r}")
                self.bound.append(b)
                self.bind_errors.append(None)
                fields.append(Field(e.name, b.dtype))
            except UnsupportedExpr as err:
                hd = host_output_dtype(e)
                if hd is None:
                    raise
                self.bound.append(None)
                self.bind_errors.append(str(err))
                fields.append(Field(e.name, hd))
        self._schema = Schema(fields)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"Project[{', '.join(map(repr, self.exprs))}]"


class Filter(LogicalPlan):
    """A filter; a condition the device cannot run leaves `bound` None
    and its refusal in `bind_error`, for the host fallback."""

    def __init__(self, child: LogicalPlan, condition: Expression):
        self.child = child
        self.children = [child]
        self.condition = condition
        self.bind_error: Optional[str] = None
        try:
            self.bound = _tsig(condition.bind(child.schema),
                               where="Filter condition")
        except UnsupportedExpr as err:
            self.bound = None
            self.bind_error = str(err)

    @property
    def schema(self):
        return self.child.schema

    def describe(self):
        return f"Filter[{self.condition!r}]"


class Aggregate(LogicalPlan):
    """Grouped or ungrouped aggregation: aggs are (output_name, AggExpr)
    pairs, keys the grouping expressions."""

    def __init__(self, child: LogicalPlan, keys: Sequence[Expression],
                 aggs: Sequence[Tuple[str, agg.AggExpr]]):
        self.child = child
        self.children = [child]
        self.keys = list(keys)
        self.aggs = list(aggs)
        self.bound_keys = [_tsig(k.bind(child.schema),
                                 where=f"Aggregate key {k.name!r}")
                           for k in self.keys]
        self.bound_aggs = [(n, _tsig(a.bind(child.schema),
                                     where=f"Aggregate agg {n!r}"))
                           for n, a in self.aggs]
        fields = [Field(k.name, bk.dtype)
                  for k, bk in zip(self.keys, self.bound_keys)]
        fields += [Field(n, a.dtype) for n, a in self.bound_aggs]
        self._schema = Schema(fields)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"Aggregate[keys={[repr(k) for k in self.keys]}, "
                f"aggs={[n for n, _ in self.aggs]}]")


class Expand(LogicalPlan):
    """The grouping-sets expansion under an Aggregate (reference:
    GpuExpandExec.scala): the child's columns, then the grouping keys
    (null where a set excludes the key), then the grouping id."""

    def __init__(self, child: LogicalPlan, key_exprs: Sequence[Expression],
                 key_names: Sequence[str], include_masks, gid_name: str):
        self.child = child
        self.children = [child]
        self.key_exprs = list(key_exprs)
        self.key_names = list(key_names)
        self.include_masks = [tuple(m) for m in include_masks]
        self.gid_name = gid_name
        self.bound_keys = [_tsig(k.bind(child.schema),
                                 where=f"Expand key {k.name!r}")
                           for k in self.key_exprs]
        fields = list(child.schema.fields)
        fields += [Field(n, k.dtype)
                   for n, k in zip(self.key_names, self.bound_keys)]
        fields.append(Field(gid_name, dt.INT64))
        self._schema = Schema(fields)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"Expand[{len(self.include_masks)} sets, "
                f"keys={self.key_names}]")


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
        self.bound_left_keys = [_tsig(k.bind(left.schema),
                                      where=f"Join left key {k.name!r}")
                                for k in self.left_keys]
        self.bound_right_keys = [_tsig(k.bind(right.schema),
                                       where=f"Join right key {k.name!r}")
                                 for k in self.right_keys]
        lf = list(left.schema.fields)
        rf = list(right.schema.fields)
        self.condition = condition
        self.bound_condition = (_tsig(condition.bind(Schema(lf + rf)),
                                      where="Join condition")
                                if condition is not None else None)
        self._schema = Schema(lf if how in ("left_semi", "left_anti")
                              else lf + rf)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return (f"Join[{self.how}, "
                f"on={list(zip(self.left_keys, self.right_keys))}]")


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
        self.bound_orders = [SortOrder(
            _tsig(o.expr.bind(child.schema), where=f"Sort key {o.expr!r}"),
            o.ascending, o.nulls_first) for o in self.orders]

    @property
    def schema(self):
        return self.child.schema

    def describe(self):
        return f"Sort[{self.orders}]"


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        self.child = child
        self.children = [child]
        self.n = n

    @property
    def schema(self):
        return self.child.schema

    def describe(self):
        return f"Limit[{self.n}]"


class Union(LogicalPlan):
    """UNION ALL by position: the children's column types must agree;
    the names are the first child's."""

    def __init__(self, children: Sequence[LogicalPlan]):
        self.children = list(children)
        s0 = self.children[0].schema
        for c in self.children[1:]:
            if [f.dtype for f in c.schema.fields] != \
                    [f.dtype for f in s0.fields]:
                raise ValueError("UNION schema mismatch")
        self._schema = s0

    @property
    def schema(self):
        return self._schema


class Generate(LogicalPlan):
    """explode / posexplode: the child's columns, then [pos], then the
    element (col) or a map entry's key and value; one output row per
    element."""

    def __init__(self, child: LogicalPlan, generator, out_names):
        self.child = child
        self.children = [child]
        self.generator = generator              # unbound Explode
        self.bound = _tsig(generator.bind(child.schema),
                           where="Generate generator")
        self.out_names = list(out_names)
        gen_fields = []
        if self.bound.with_position:
            gen_fields.append(Field(self.out_names[0], dt.INT32))
        if isinstance(self.bound.child.dtype, dt.MapType):
            for f, nm in zip(self.bound.dtype.fields, self.out_names[-2:]):
                gen_fields.append(Field(nm, f.dtype))
        else:
            gen_fields.append(Field(self.out_names[-1], self.bound.dtype))
        self._schema = Schema(list(child.schema.fields) + gen_fields)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"Generate[{self.generator!r}]"


class WindowOp(LogicalPlan):
    """The child's columns, then one column a window expression
    (reference: GpuWindowExec planning in GpuWindowExecMeta.scala).
    `wcols` are (name, unbound WindowExpr) pairs; each window function's
    input passes the type-signature gate."""

    def __init__(self, child: LogicalPlan, wcols):
        self.child = child
        self.children = [child]
        self.wcols = list(wcols)
        self.bound = [(n, w.bind(child.schema)) for n, w in self.wcols]
        for n, w in self.bound:
            if getattr(w, "child", None) is not None:
                _tsig(w.child, where=f"WindowOp column {n!r}")
        self._schema = Schema(list(child.schema.fields)
                              + [Field(n, w.dtype) for n, w in self.bound])

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"WindowOp[{[n for n, _ in self.wcols]}]"


class MapInPandas(LogicalPlan):
    """Batch-wise pandas transform in a pooled python worker process
    (reference: GpuMapInPandasExec)."""

    def __init__(self, child: LogicalPlan, fn, schema: Schema):
        self.child = child
        self.children = [child]
        self.fn = fn
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def describe(self):
        name = getattr(self.fn, "__name__", "fn")
        return f"MapInPandas[{name}]"


class GroupedMapInPandas(LogicalPlan):
    """Per-group pandas transform (applyInPandas / AggregateInPandas):
    the planner repartitions by key so groups are whole per partition
    (reference: GpuFlatMapGroupsInPandasExec,
    GpuAggregateInPandasExec.scala:51). `fn` is the worker-side wrapper
    (already closed over the user function + keys)."""

    def __init__(self, child: LogicalPlan, fn, schema: Schema,
                 key_names):
        self.child = child
        self.children = [child]
        self.fn = fn
        self._schema = schema
        self.key_names = list(key_names)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"GroupedMapInPandas[keys={self.key_names}]"


class CoGroupInPandas(LogicalPlan):
    """Cogrouped pandas transform (reference:
    GpuFlatMapCoGroupsInPandasExec): both children repartition by their
    keys; fn is the worker-side _CoGroupApply wrapper."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan, fn,
                 schema: Schema, lkeys, rkeys):
        self.children = [left, right]
        self.fn = fn
        self._schema = schema
        self.lkeys = list(lkeys)
        self.rkeys = list(rkeys)

    @property
    def schema(self):
        return self._schema

    def describe(self):
        return f"CoGroupInPandas[{self.lkeys} x {self.rkeys}]"


class Repartition(LogicalPlan):
    def __init__(self, child: LogicalPlan, num_partitions: int,
                 keys: Optional[Sequence[Expression]] = None):
        self.child = child
        self.children = [child]
        self.num_partitions = num_partitions
        self.keys = list(keys) if keys else None
        self.bound_keys = ([_tsig(k.bind(child.schema),
                                  where=f"Repartition key {k.name!r}")
                            for k in self.keys]
                           if self.keys else None)

    @property
    def schema(self):
        return self.child.schema

    def describe(self):
        return f"Repartition[{self.num_partitions}]"
