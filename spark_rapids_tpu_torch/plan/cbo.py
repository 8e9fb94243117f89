"""Cost-based join reordering: the port of the JAX package's
`plan/cbo.py` `reorder_joins` and its helpers.

The analog of Catalyst's `CostBasedJoinReorder` (conf
`sql.optimizer.joinReorder.enabled`, on by default): maximal chains of
INNER equi-joins are flattened into (relations, equi-edges), each
relation gets a row/NDV estimate from `plan/stats.py`, and a
Selinger-style dynamic program over left-deep orders picks the order
minimizing the summed intermediate cardinalities (chains longer than
`sql.optimizer.joinReorder.maxDpRelations` take a greedy
min-intermediate extension). Outer, semi, anti and cross joins and joins
with a condition are never reordered across: they bound the chains.
Each emitted join puts the smaller estimated side on the right (the
build side). The written order is kept unless the modeled win is at
least `_REWRITE_MIN_RATIO`; observed cardinalities from the calibration
table replace the model only when they show it off by
`_CALIBRATION_ERROR_FACTOR` or more.

The device-vs-host placement pass (`apply_cbo`, conf
`sql.optimizer.cbo.enabled`, off by default like the reference's
CostBasedOptimizer.scala + GpuCostModel): a tiny Project or Filter
whose expressions the host interpreter covers is tagged for the host
fallback, visible in explain as "CBO: ...". The bound is the JAX
package's `sql.optimizer.cbo.smallInputRows` (64), kept so that both
packages place alike; the port has not measured where a CUDA launch
stops being cheaper than the host interpreter.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import logical as L

__all__ = ["apply_cbo", "estimate_rows_selective", "reorder_joins"]

# rough per-conjunct selectivities (reference: spark CBO FilterEstimation)
_SEL = {"Eq": 0.05, "EqNullSafe": 0.05, "In": 0.1,
        "Lt": 0.33, "Le": 0.33, "Gt": 0.33, "Ge": 0.33,
        "Like": 0.1, "RLike": 0.1, "Contains": 0.1,
        "StartsWith": 0.1, "EndsWith": 0.1,
        "IsNull": 0.1, "IsNotNull": 0.9}


def _selectivity(e) -> float:
    name = type(e).__name__
    if name == "And":
        a, b = e.children
        return _selectivity(a) * _selectivity(b)
    if name == "Or":
        a, b = e.children
        return min(1.0, _selectivity(a) + _selectivity(b))
    if name == "Not":
        return max(0.0, 1.0 - _selectivity(e.children[0]))
    return _SEL.get(name, 0.5)


def estimate_rows_selective(node: L.LogicalPlan):
    """Row estimate WITH filter selectivities applied (the planner's
    broadcast input stays an upper bound; the CBO wants the expected
    size)."""
    from .planner import _estimate_rows
    if isinstance(node, L.Filter):
        child = estimate_rows_selective(node.children[0])
        if child is None:
            return None
        return child * _selectivity(node.condition)
    if isinstance(node, (L.Project, L.Sort, L.Repartition, L.WindowOp)):
        return estimate_rows_selective(node.children[0])
    return _estimate_rows(node)


def _host_covers(exprs) -> bool:
    from ..expr.host_eval import _RULES

    def covered(e):
        if e is None:
            return False
        if type(e).__name__ not in _RULES:
            return False
        return all(covered(c) for c in e.children if c is not None)

    return all(covered(e) for e in exprs)


def apply_cbo(meta, conf):
    """Walk the tagged PlanMeta tree; tag tiny host-coverable
    Project/Filter nodes for the host fallback. Mutates meta in place.
    A no-op when the fallback is off: a CBO tag must never turn a valid
    device plan into a failure."""
    from ..config import CBO_SMALL_INPUT_ROWS
    if not conf.allow_cpu_fallback:
        return
    _walk(meta, conf.get(CBO_SMALL_INPUT_ROWS))


def _walk(meta, small: int):
    node = meta.node
    if isinstance(node, (L.Project, L.Filter)) \
            and not meta.reasons and not meta.host_reasons:
        est = estimate_rows_selective(node.children[0])
        exprs = ([node.bound] if isinstance(node, L.Filter)
                 else list(node.exprs))
        if est is not None and est <= small and _host_covers(
                [e for e in exprs if e is not None]):
            meta.will_use_host(
                f"CBO: ~{int(est)} input rows <= {small}; host "
                f"interpreter beats device dispatch at this size")
    for c in meta.children:
        _walk(c, small)


# ======================================================================
# Cost-based join reordering
# ======================================================================

# The two gates below are the JAX package's values, kept so that both
# packages choose the same order (the JAX package set them from its own
# TPU runs; the port has not measured its own).
# Only overrule the written join order when the modeled cost win is at
# least this decisive: the estimates are coarse (sampled NDVs, fixed
# filter selectivities) and the model is blind to the broadcast
# threshold, so a marginal rewrite trades a known-good plan for noise.
_REWRITE_MIN_RATIO = 12.0

# Observed cardinalities replace the analytic model only when they show
# the written order's estimate off by at least this factor: observations
# that confirm the model add nothing it lacked.
_CALIBRATION_ERROR_FACTOR = 8.0


class _Edge:
    """One equi-join conjunct between two relations of a flattened
    chain: unbound key expressions plus the owning relation indices."""

    __slots__ = ("a", "b", "a_key", "b_key", "sel")

    def __init__(self, a: int, b: int, a_key, b_key):
        self.a, self.b = a, b
        self.a_key, self.b_key = a_key, b_key
        self.sel = 1.0          # filled in once stats are known


def _is_passthrough(project: L.Project) -> bool:
    """True when every output is a plain same-named column reference —
    the shape session.join emits above each inner join (key dedup /
    __join_r* drop). Flattening through it is safe: it neither renames
    nor computes, only selects."""
    from ..expr.expressions import ColumnRef
    return all(type(e) is ColumnRef for e in project.exprs)


def _reorderable_join(node: L.LogicalPlan) -> bool:
    return (isinstance(node, L.Join) and node.how == "inner"
            and node.condition is None and bool(node.left_keys))


def _flatten_chain(root: L.Join):
    """Flatten a maximal inner-equi-join chain (seeing through the
    pass-through projections between joins) into relations + edges.
    Returns (relations, edges) or None when the chain is not safely
    flattenable (ambiguous key ownership, duplicate column names)."""
    from .optimizer import refs_of
    relations: List[L.LogicalPlan] = []
    edges: List[_Edge] = []

    def owner(refs, idxs) -> Optional[int]:
        hit = None
        for i in idxs:
            if refs <= set(relations[i].schema.names):
                if hit is not None:
                    return None          # ambiguous (duplicate names)
                hit = i
        return hit

    def rec(node) -> Optional[List[int]]:
        if isinstance(node, L.Project) and _is_passthrough(node) \
                and _reorderable_join(node.children[0]):
            return rec(node.children[0])
        if _reorderable_join(node):
            li = rec(node.left)
            ri = rec(node.right)
            if li is None or ri is None:
                return None
            for lk, rk in zip(node.left_keys, node.right_keys):
                lrefs, rrefs = refs_of(lk), refs_of(rk)
                if not lrefs or not rrefs:
                    return None
                a = owner(lrefs, li)
                b = owner(rrefs, ri)
                if a is None or b is None:
                    return None
                edges.append(_Edge(a, b, lk, rk))
            return li + ri
        relations.append(node)
        return [len(relations) - 1]

    if rec(root) is None or len(relations) < 3:
        return None
    # global name uniqueness: rebinding keys by name over a rebuilt
    # chain is only sound when no two relations share a column name
    seen = set()
    for r in relations:
        for n in r.schema.names:
            if n in seen:
                return None
            seen.add(n)
    return relations, edges


def _edge_selectivities(edges: List[_Edge], stats) -> None:
    for e in edges:
        from .stats import _key_name
        an, bn = _key_name(e.a_key), _key_name(e.b_key)
        ndv_a = (stats[e.a].ndv_of(an) if an else None) or stats[e.a].rows
        ndv_b = (stats[e.b].ndv_of(bn) if bn else None) or stats[e.b].rows
        e.sel = 1.0 / max(ndv_a, ndv_b, 1.0)


def _set_rows(s: frozenset, stats, edges, cal=None) -> float:
    """Order-independent cardinality of a joined relation set: product
    of relation rows times the selectivity of every internal edge.
    `cal` (subset -> observed rows or None) overrides the analytic
    product with a cardinality an earlier execution of the same
    relation set actually measured — the AQE calibration loop."""
    if cal is not None:
        observed = cal(s)
        if observed is not None:
            return observed
    rows = 1.0
    for i in s:
        rows *= stats[i].rows
    for e in edges:
        if e.a in s and e.b in s:
            rows *= e.sel
    return rows


def _dp_order(n: int, stats, edges, cal=None) -> List[int]:
    """Selinger-style DP over left-deep orders: best (cost, order) per
    relation subset; extensions must stay connected (no cross products
    unless the chain itself is disconnected, which cannot happen — every
    flattened join contributed an edge). Cost = Σ intermediate rows plus
    the build-side rows of each step."""
    adj: Dict[int, set] = {i: set() for i in range(n)}
    for e in edges:
        adj[e.a].add(e.b)
        adj[e.b].add(e.a)
    best: Dict[frozenset, Tuple[float, List[int]]] = {
        frozenset({i}): (0.0, [i]) for i in range(n)}
    for size in range(2, n + 1):
        nxt: Dict[frozenset, Tuple[float, List[int]]] = {}
        for s, (cost, order) in best.items():
            if len(s) != size - 1:
                continue
            for j in range(n):
                if j in s or not (adj[j] & s):
                    continue
                s2 = frozenset(s | {j})
                rows = _set_rows(s2, stats, edges, cal)
                c2 = cost + _step_cost(_set_rows(s, stats, edges, cal),
                                       rows, stats[j].rows)
                cur = nxt.get(s2)
                if cur is None or c2 < cur[0]:
                    nxt[s2] = (c2, order + [j])
        best.update(nxt)
    full = frozenset(range(n))
    return best[full][1] if full in best else list(range(n))


def _step_cost(prev_rows: float, out_rows: float, rel_rows: float) -> float:
    """Cost of one left-deep extension: the build side is materialized
    once (min side), and the step streams max(probe input, output) rows.
    Charging the probe input, not just the output, matters: a fact
    spine of FK single-match joins streams its rows through in place
    (output <= input), and a model that only counts the output brands
    such written orders far worse than they run."""
    return max(prev_rows, out_rows) + min(rel_rows, prev_rows)


def _order_cost(order: List[int], stats, edges, cal=None) -> float:
    """Cost of one left-deep order under the DP's model (Σ _step_cost).
    Used both to rank candidate orders and to cost the WRITTEN order
    for the rewrite gate."""
    cost = 0.0
    s = {order[0]}
    for j in order[1:]:
        prev_rows = _set_rows(frozenset(s), stats, edges, cal)
        s.add(j)
        rows = _set_rows(frozenset(s), stats, edges, cal)
        cost += _step_cost(prev_rows, rows, stats[j].rows)
    return cost


def _greedy_order(n: int, stats, edges, cal=None) -> List[int]:
    """Beyond the DP bound: start from the smallest relation and
    repeatedly add the connected relation minimizing the intermediate
    cardinality."""
    adj: Dict[int, set] = {i: set() for i in range(n)}
    for e in edges:
        adj[e.a].add(e.b)
        adj[e.b].add(e.a)
    start = min(range(n), key=lambda i: stats[i].rows)
    order = [start]
    done = {start}
    while len(order) < n:
        cands = {j for i in done for j in adj[i]} - done
        if not cands:
            cands = set(range(n)) - done
        j = min(cands, key=lambda j_: _set_rows(
            frozenset(done | {j_}), stats, edges, cal))
        order.append(j)
        done.add(j)
    return order


def _contains_agg(node: L.LogicalPlan) -> bool:
    if isinstance(node, L.Aggregate):
        return True
    return any(_contains_agg(c) for c in node.children)


def _rebuild_chain(relations, edges, order, stats,
                   cal=None) -> L.LogicalPlan:
    """Left-deep rebuild in the chosen order; each step puts the smaller
    estimated side on the RIGHT so the planner's build/broadcast choice
    (right child) stays consistent with the reorder.

    Exception, as in the JAX package: a relation whose subtree holds an
    Aggregate is kept off the stream spine (the leftmost path) and
    becomes a build side instead."""
    cur = relations[order[0]]
    cur_set = {order[0]}
    cur_rows = stats[order[0]].rows
    # does the current stream spine (leftmost leaf path) hold an agg?
    spine_agg = _contains_agg(cur)
    for j in order[1:]:
        cur_keys, rel_keys = [], []
        for e in edges:
            if e.a in cur_set and e.b == j:
                cur_keys.append(e.a_key)
                rel_keys.append(e.b_key)
            elif e.b in cur_set and e.a == j:
                cur_keys.append(e.b_key)
                rel_keys.append(e.a_key)
        rel = relations[j]
        rel_rows = stats[j].rows
        rel_agg = _contains_agg(rel)
        if not cur_keys:
            # disconnected extension (cannot normally happen): keep a
            # cross join so semantics are preserved
            cur = L.Join(cur, rel, [], [], "cross")
        elif rel_agg:
            # agg relation builds; the spine stays whatever cur's was
            cur = L.Join(cur, rel, cur_keys, rel_keys, "inner")
        elif spine_agg:
            # evict the agg from the spine: the accumulated chain
            # (agg included) becomes a cached build, rel the new spine
            cur = L.Join(rel, cur, rel_keys, cur_keys, "inner")
            spine_agg = False
        elif rel_rows <= cur_rows:
            cur = L.Join(cur, rel, cur_keys, rel_keys, "inner")
        else:
            cur = L.Join(rel, cur, rel_keys, cur_keys, "inner")
        cur_set.add(j)
        out_set = frozenset(cur_set)
        cur_rows = _set_rows(out_set, stats, edges, cal)
    return cur


def reorder_joins(plan: L.LogicalPlan, conf) -> L.LogicalPlan:
    """Reorder maximal inner-equi-join chains by estimated cost. Only
    rewrites when every relation in a chain has a row estimate; the
    original column order is restored with a projection so the rewrite
    is invisible to everything above it."""
    from ..config import JOIN_REORDER_DP_RELATIONS
    from ..expr.expressions import ColumnRef
    from .optimizer import _rebuild
    from .stats import compute_stats
    max_dp = conf.get(JOIN_REORDER_DP_RELATIONS)

    def rewrite(node):
        if _reorderable_join(node):
            flat = _flatten_chain(node)
            if flat is not None:
                relations, edges = flat
                relations = [rewrite(r) for r in relations]
                stats = [compute_stats(r) for r in relations]
                if all(s.rows is not None for s in stats):
                    _edge_selectivities(edges, stats)
                    n = len(relations)
                    # AQE calibration: price a relation subset by the
                    # cardinality an earlier order of the same set
                    # actually produced (order-independent jset keys,
                    # plan/stats.py), falling back to the analytic
                    # product when nothing was observed
                    from .stats import calibration_lookup, logical_fp
                    rel_fps = [logical_fp(r) for r in relations]

                    def cal(s, _fps=rel_fps):
                        if len(s) < 2:
                            return None
                        return calibration_lookup(
                            ("jset", frozenset(_fps[i] for i in s)))
                    # re-optimize from observations only on a decisive
                    # estimate error (_CALIBRATION_ERROR_FACTOR): when
                    # they roughly confirm the model, plan exactly as
                    # the static estimates would
                    idorder = list(range(n))
                    written_static = _order_cost(idorder, stats, edges,
                                                 None)
                    written_cal = _order_cost(idorder, stats, edges,
                                              cal)
                    use_cal = (written_cal > 0 and written_static > 0
                               and max(written_static / written_cal,
                                       written_cal / written_static)
                               >= _CALIBRATION_ERROR_FACTOR)
                    c = cal if use_cal else None
                    order = (_dp_order(n, stats, edges, c)
                             if n <= max_dp
                             else _greedy_order(n, stats, edges, c))
                    # overrule the written order only on a decisive
                    # modeled win (_REWRITE_MIN_RATIO)
                    written = written_cal if use_cal else written_static
                    best = _order_cost(order, stats, edges, c)
                    if best * _REWRITE_MIN_RATIO <= written:
                        joined = _rebuild_chain(relations, edges, order,
                                                stats, cal)
                        # restore the original output schema (names +
                        # order)
                        return L.Project(joined,
                                         [ColumnRef(nm) for nm in
                                          node.schema.names])
        kids = [rewrite(c) for c in node.children]
        return _rebuild(node, kids)

    return rewrite(plan)
