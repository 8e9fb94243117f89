"""Logical optimizations: filter pushdown and column pruning.

The ported subset of the JAX package's optimizer, over the node types
the port has. `push_filters` sinks a Filter below a pass-through Project
and into the matching side of a Join (inner: both sides; left, semi and
anti: the left; right: the right), adding one-sided weakenings of the
conjuncts it cannot move (`extract_within`); `prune` flows the required
columns top-down through Project, Filter, Aggregate, Sort, Limit and
Join, shrinks scans, and attaches a Parquet scan's row-group pruning
conjuncts from the Filter directly above it; `rewrite_distinct_aggs`
turns count(DISTINCT x) into two hash aggregates (on by
`sql.optimizer.distinctAggRewrite.enabled`). The JAX package's join
reorder is not ported.
"""
from __future__ import annotations

from typing import Optional, Set

from ..expr.expressions import Alias, BoundRef, ColumnRef, Expression
from . import logical as L

__all__ = ["optimize", "refs_of", "push_filters", "prune",
           "extract_conjuncts", "extract_within", "rewrite_distinct_aggs"]


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
    if isinstance(plan, L.Limit):
        return L.Limit(prune(plan.child, required), plan.n)
    if isinstance(plan, L.Join):
        lnames = set(plan.left.schema.names)
        rnames = set(plan.right.schema.names)
        lkr = _refs_of_all(plan.left_keys)
        rkr = _refs_of_all(plan.right_keys)
        ckr = (_refs_of_all([plan.condition])
               if plan.condition is not None else set())
        lreq = rreq = None
        if (required is not None and lkr is not None and rkr is not None
                and ckr is not None and not (lnames & rnames)):
            lreq = ({n for n in required if n in lnames} | lkr
                    | (ckr & lnames))
            rreq = ({n for n in required if n in rnames} | rkr
                    | (ckr & rnames))
        return L.Join(prune(plan.left, lreq), prune(plan.right, rreq),
                      plan.left_keys, plan.right_keys, plan.how,
                      condition=plan.condition)
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
    if isinstance(plan, L.Limit):
        return L.Limit(kids[0], plan.n)
    if isinstance(plan, L.Join):
        return L.Join(kids[0], kids[1], plan.left_keys, plan.right_keys,
                      plan.how, condition=plan.condition)
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


def _split_conjuncts(cond: Expression):
    from ..expr.expressions import And
    if isinstance(cond, And):
        return (_split_conjuncts(cond.children[0])
                + _split_conjuncts(cond.children[1]))
    return [cond]


def _and_all(preds):
    from ..expr.expressions import And
    out = preds[0]
    for p in preds[1:]:
        out = And(out, p)
    return out


def extract_within(cond: Expression, names: Set[str]):
    """A weaker predicate implied by `cond` that references only `names`,
    or None (Spark's extractPredicatesWithinOutputSet): And keeps either
    side, Or needs both."""
    from ..expr.expressions import And, Or
    if isinstance(cond, And):
        a = extract_within(cond.children[0], names)
        b = extract_within(cond.children[1], names)
        if a is not None and b is not None:
            return And(a, b)
        return a if a is not None else b
    if isinstance(cond, Or):
        a = extract_within(cond.children[0], names)
        b = extract_within(cond.children[1], names)
        if a is not None and b is not None:
            return Or(a, b)
        return None
    refs = refs_of(cond)
    if refs is not None and refs <= names:
        return cond
    return None


def push_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Sink Filters below pass-through Projects and into Join sides:
    whole one-sided conjuncts move (and leave the filter above); derived
    OR-extracted predicates are added below while the original filter
    stays."""
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
    if isinstance(child, L.Join):
        return _push_into_join(plan, child)
    return plan


def _push_into_join(plan: L.Filter, join: L.Join) -> L.LogicalPlan:
    lnames = set(join.left.schema.names)
    rnames = set(join.right.schema.names)
    # a name on both sides is ambiguous above the join: a conjunct that
    # touches one stays above
    shared = lnames & rnames
    lonly, ronly = lnames - shared, rnames - shared
    left_ok = join.how in ("inner", "left", "left_semi", "left_anti")
    right_ok = join.how in ("inner", "right")
    lparts, rparts, rest = [], [], []
    for c in _split_conjuncts(plan.condition):
        r = refs_of(c)
        if r is not None and r & shared:
            rest.append(c)
        elif r is not None and r <= lnames and left_ok:
            lparts.append(c)
        elif r is not None and r <= rnames and right_ok:
            rparts.append(c)
        else:
            rest.append(c)
    # one-sided weakenings of the conjuncts that stay
    for c in rest:
        if refs_of(c) is not None and refs_of(c) & shared:
            continue
        if left_ok:
            d = extract_within(c, lonly)
            if d is not None and refs_of(d) != refs_of(c):
                lparts.append(d)
        if right_ok:
            d = extract_within(c, ronly)
            if d is not None and refs_of(d) != refs_of(c):
                rparts.append(d)
    if not lparts and not rparts:
        return plan
    new_left, new_right = join.left, join.right
    if lparts:
        new_left = push_filters(L.Filter(new_left, _and_all(lparts)))
    if rparts:
        new_right = push_filters(L.Filter(new_right, _and_all(rparts)))
    out = L.Join(new_left, new_right, join.left_keys, join.right_keys,
                 join.how, condition=join.condition)
    return L.Filter(out, _and_all(rest)) if rest else out


def rewrite_distinct_aggs(plan: L.LogicalPlan) -> L.LogicalPlan:
    """count(DISTINCT x) -> two-level hash aggregation (the
    single-distinct-child case of Catalyst's RewriteDistinctAggregates):
    an inner DISTINCT Aggregate over (keys..., x) deduplicates, an outer
    Count over the deduped value finishes. Count skips nulls, so the
    inner null-x group drops out of the outer Count exactly as
    count(DISTINCT) skips it. Several distinct children, a distinct
    beside another aggregate, or duplicate key names stay as they are
    (the planner refuses them: `CollectAggExec` is not ported)."""
    from ..expr.aggregates import Count, CountDistinct

    def rewrite(node):
        node = _rebuild(node, [rewrite(c) for c in node.children])
        if not (isinstance(node, L.Aggregate) and node.aggs
                and all(type(a) is CountDistinct for _, a in node.aggs)):
            return node
        if len({repr(a.child) for _, a in node.aggs}) != 1:
            return node
        key_names = [k.name for k in node.keys]
        val = "__cd_val"
        if len(set(key_names)) != len(key_names) or val in key_names:
            return node
        x = node.aggs[0][1].child
        inner = L.Aggregate(node.children[0],
                            node.keys + [Alias(x, val)], [])
        return L.Aggregate(inner, [ColumnRef(nm) for nm in key_names],
                           [(nm, Count(ColumnRef(val)))
                            for nm, _ in node.aggs])

    return rewrite(plan)


def optimize(plan: L.LogicalPlan, conf=None) -> L.LogicalPlan:
    plan = push_filters(plan)
    if conf is not None:
        from ..config import DISTINCT_AGG_REWRITE
        if conf.get(DISTINCT_AGG_REWRITE):
            plan = rewrite_distinct_aggs(plan)
    return prune(plan, None)
