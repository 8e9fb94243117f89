"""Logical optimizations: filter pushdown and column pruning.

The ported subset of the JAX package's optimizer, over the node types
the port has. `push_filters` sinks a Filter below a pass-through Project;
`prune` flows the required columns top-down and shrinks scans, and
attaches a Parquet scan's row-group pruning conjuncts from the Filter
directly above it.
"""
from __future__ import annotations

from typing import Optional, Set

from ..expr.expressions import BoundRef, ColumnRef, Expression
from . import logical as L

__all__ = ["optimize", "refs_of", "push_filters", "prune",
           "extract_conjuncts"]


def refs_of(e: Expression) -> Optional[Set[str]]:
    """Column names referenced by an unbound expression tree.
    None = unknown (contains a raw BoundRef) — disables pruning."""
    if isinstance(e, ColumnRef):
        return {e.name}
    if isinstance(e, BoundRef):
        return None
    out: Set[str] = set()
    for c in e.children:
        if c is None:
            continue
        r = refs_of(c)
        if r is None:
            return None
        out |= r
    return out


def _refs_of_all(exprs) -> Optional[Set[str]]:
    out: Set[str] = set()
    for e in exprs:
        if e is None:
            continue
        r = refs_of(e)
        if r is None:
            return None
        out |= r
    return out


def prune(plan: L.LogicalPlan,
          required: Optional[Set[str]]) -> L.LogicalPlan:
    if isinstance(plan, L.InMemoryScan):
        if required is not None:
            names = [n for n in plan.arrow.schema.names if n in required]
            if len(names) < len(plan.arrow.schema.names):
                return L.InMemoryScan(plan.arrow.select(names))
        return plan
    if isinstance(plan, L.ParquetScan):
        if required is not None:
            names = [f.name for f in plan.schema.fields
                     if f.name in required]
            if len(names) < len(plan.schema.fields):
                return L.ParquetScan(plan.paths, columns=names)
        return plan
    if isinstance(plan, L.Project):
        exprs = plan.exprs
        if required is not None:
            kept = [e for e in exprs if e.name in required]
            if kept:
                exprs = kept
        child = prune(plan.child, _refs_of_all(exprs))
        return L.Project(child, exprs)
    if isinstance(plan, L.Filter):
        creq = None
        if required is not None:
            r = refs_of(plan.condition)
            creq = None if r is None else (required | r)
        child = prune(plan.child, creq)
        if isinstance(child, L.ParquetScan):
            # the Filter stays above for exact row filtering
            conj = extract_conjuncts(plan.condition)
            if conj:
                child = L.ParquetScan(child.paths, child._schema,
                                      child.columns,
                                      (child.filters or []) + conj)
        return L.Filter(child, plan.condition)
    if isinstance(plan, L.Aggregate):
        creq = _refs_of_all(list(plan.keys) +
                            [a.child for _, a in plan.aggs])
        return L.Aggregate(prune(plan.child, creq), plan.keys, plan.aggs)
    if isinstance(plan, L.Sort):
        creq = None
        if required is not None:
            r = _refs_of_all([o.expr for o in plan.orders])
            creq = None if r is None else (required | r)
        return L.Sort(prune(plan.child, creq), plan.orders)
    if isinstance(plan, L.Repartition):
        return L.Repartition(prune(plan.child, None), plan.num_partitions,
                             plan.keys)
    return plan


def _rebuild(plan: L.LogicalPlan, kids) -> L.LogicalPlan:
    """Reconstruct a node over new children (re-binding expressions)."""
    if isinstance(plan, L.Project):
        return L.Project(kids[0], plan.exprs)
    if isinstance(plan, L.Filter):
        return L.Filter(kids[0], plan.condition)
    if isinstance(plan, L.Aggregate):
        return L.Aggregate(kids[0], plan.keys, plan.aggs)
    if isinstance(plan, L.Sort):
        return L.Sort(kids[0], plan.orders)
    if isinstance(plan, L.Repartition):
        return L.Repartition(kids[0], plan.num_partitions, plan.keys)
    return plan


def extract_conjuncts(cond: Expression):
    """(name, op, literal) conjuncts usable for row-group stats pruning;
    other branches are skipped (they simply do not prune)."""
    from ..expr.expressions import And, Eq, Ge, Gt, Le, Literal, Lt
    ops = {Ge: ">=", Gt: ">", Le: "<=", Lt: "<", Eq: "="}
    flip = {">=": "<=", ">": "<", "<=": ">=", "<": ">", "=": "="}
    out = []

    def walk(e):
        if isinstance(e, And):
            walk(e.children[0])
            walk(e.children[1])
            return
        t = type(e)
        if t in ops and len(e.children) == 2:
            l, r = e.children
            if isinstance(l, ColumnRef) and isinstance(r, Literal) \
                    and r.value is not None:
                out.append((l.name, ops[t], r.value))
            elif isinstance(r, ColumnRef) and isinstance(l, Literal) \
                    and l.value is not None:
                out.append((r.name, flip[ops[t]], l.value))

    walk(cond)
    return out


def _passthrough_names(project: L.Project) -> Set[str]:
    return {e.name for e in project.exprs if isinstance(e, ColumnRef)}


def push_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Sink Filters below pass-through Projects."""
    kids = [push_filters(c) for c in plan.children]
    plan = _rebuild(plan, kids)
    if not isinstance(plan, L.Filter):
        return plan
    child = plan.child
    refs = refs_of(plan.condition)
    if refs is None:
        return plan
    if isinstance(child, L.Project) and refs <= _passthrough_names(child):
        return L.Project(
            push_filters(L.Filter(child.child, plan.condition)),
            child.exprs)
    return plan


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    return prune(push_filters(plan), None)
