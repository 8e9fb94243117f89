"""Bottom-up row / NDV statistics over logical plans, and the adaptive
calibration table.

The port of the JAX package's `plan/stats.py` over the port's logical
nodes. Every logical node gets an estimated row count and a per-column
number-of-distinct-values (NDV) estimate, propagated bottom-up: scans
sample their first 65,536 rows once (cached on the scan node) and
extrapolate NDV with a Chao1 estimator; filters scale rows by the
per-conjunct selectivities of `plan/cbo.py`; joins apply the
|L| * |R| / max(ndv(lk), ndv(rk)) equi-join formula; aggregates shrink
to the product of key NDVs. The join reorder (`plan/cbo.py`) ranks
left-deep orders by these estimates. Estimates are advisory: a bad one
can cost speed, never rows.

The calibration table closes the adaptive loop. After a query runs,
`harvest_calibration` records each operator's observed `numOutputRows`
keyed by the cardinality fingerprint of its logical subtree (and, for an
inner-equi join chain, by the order-independent set of its relations'
fingerprints). `compute_stats` and the reorder consult it first, but
only inside `calibration_scope(True)`, which the planner enters when
`sql.adaptive.enabled` and `sql.adaptive.calibration.enabled` are both
on: a session with either off plans as if the table did not exist. The
table is process-wide, as in the JAX package.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

from . import logical as L

__all__ = ["Stats", "compute_stats", "scan_column_ndv",
           "calibration_scope", "calibration_lookup", "logical_fp",
           "join_set_fp", "attach_calibration_fps",
           "harvest_calibration", "calibration_stats",
           "clear_calibration"]

# rows sampled (the head of the Arrow table) for NDV
SAMPLE_ROWS = 1 << 16

_CAL_LOCK = threading.Lock()
_CAL: Dict[Any, float] = {}
_CAL_STATS = {"calibration_hits": 0, "calibration_updates": 0}
_CAL_TLS = threading.local()


@contextmanager
def calibration_scope(enabled: bool):
    """Enable calibration lookups on this thread (planning only)."""
    prev = getattr(_CAL_TLS, "enabled", False)
    _CAL_TLS.enabled = bool(enabled)
    try:
        yield
    finally:
        _CAL_TLS.enabled = prev


def calibration_lookup(key) -> Optional[float]:
    """Observed row count for a fingerprint key, or None. Counts a hit
    only inside an enabled scope."""
    if key is None or not getattr(_CAL_TLS, "enabled", False):
        return None
    with _CAL_LOCK:
        v = _CAL.get(key)
        if v is not None:
            _CAL_STATS["calibration_hits"] += 1
        return v


def _calibration_record(key, rows: float) -> None:
    with _CAL_LOCK:
        _CAL[key] = float(rows)
        _CAL_STATS["calibration_updates"] += 1


def calibration_stats() -> Dict[str, int]:
    with _CAL_LOCK:
        out = dict(_CAL_STATS)
        out["calibration_entries"] = len(_CAL)
        return out


def clear_calibration() -> None:
    with _CAL_LOCK:
        _CAL.clear()
        for k in _CAL_STATS:
            _CAL_STATS[k] = 0


def logical_fp(node: L.LogicalPlan):
    """Cardinality fingerprint of a logical subtree, memoized on the node
    (a `_*_cache` attribute, which `expr_fp` skips).

    Row counts do not depend on projections or column pruning, so the
    fingerprint hashes only the cardinality skeleton (scans, filter
    conditions, join how and keys, grouping keys, limits) and sees
    through row-preserving Project, Sort, Repartition and WindowOp:
    lookups fire at the join-reorder stage (before pruning) while
    harvest keys come from the converted tree (after it)."""
    fp = getattr(node, "_calib_fp_cache", None)
    if fp is None:
        fp = node._calib_fp_cache = _card_fp(node)
    return fp


def _card_fp(node: L.LogicalPlan):
    from .fingerprint import expr_fp, exprs_fp
    if isinstance(node, (L.Project, L.Sort, L.Repartition, L.WindowOp)):
        return logical_fp(node.children[0])   # row-preserving
    if isinstance(node, L.Filter):
        return ("F", expr_fp(node.condition),
                logical_fp(node.children[0]))
    if isinstance(node, L.Join):
        return ("J", node.how,
                exprs_fp(node.left_keys), exprs_fp(node.right_keys),
                expr_fp(getattr(node, "condition", None)),
                logical_fp(node.children[0]),
                logical_fp(node.children[1]))
    if isinstance(node, L.Aggregate):
        # groups depend on the keys only
        return ("A", exprs_fp(node.keys), logical_fp(node.children[0]))
    if isinstance(node, L.Limit):
        return ("L", int(node.n), logical_fp(node.children[0]))
    if isinstance(node, L.Union):
        return ("U",) + tuple(logical_fp(c) for c in node.children)
    if isinstance(node, L.Expand):
        return ("X", "Expand", len(node.include_masks),
                logical_fp(node.children[0]))
    if isinstance(node, L.InMemoryScan):
        return ("S", "mem", id(node.arrow))
    if isinstance(node, L.ParquetScan):
        # rows depend on the files, the pushed row-group filters and
        # the data version, not on the projected columns
        return ("S", "parquet", tuple(node.paths),
                expr_fp(node.filters), expr_fp(node.snapshot))
    if not node.children:
        paths = getattr(node, "paths", None)
        if paths:
            return ("S", type(node).__qualname__, tuple(paths))
        return ("S", type(node).__qualname__, id(node))
    return ("X", type(node).__qualname__) + tuple(
        logical_fp(c) for c in node.children)


def _flatten_rels(node: L.LogicalPlan):
    """Relations of a flat inner-equi join chain, seeing through the
    pass-through projections between chained joins, as
    `cbo._flatten_chain` does; a non-inner join anywhere poisons the
    chain (None)."""
    from .cbo import _is_passthrough, _reorderable_join
    if isinstance(node, L.Project) and _is_passthrough(node) \
            and _reorderable_join(node.children[0]):
        return _flatten_rels(node.children[0])
    if isinstance(node, L.Join):
        if not _reorderable_join(node):
            return None
        lr = _flatten_rels(node.children[0])
        rr = _flatten_rels(node.children[1])
        if lr is None or rr is None:
            return None
        return lr + rr
    return [node]


def join_set_fp(node: L.LogicalPlan):
    """Order-independent key of an inner-equi join subtree: the frozenset
    of its flat relations' fingerprints (any order over one relation set
    gives the same rows)."""
    if not isinstance(node, L.Join):
        return None
    rels = _flatten_rels(node)
    if rels is None or len(rels) < 2:
        return None
    return ("jset", frozenset(logical_fp(r) for r in rels))


def attach_calibration_fps(logical: L.LogicalPlan, physical) -> None:
    """Stamp the planning-time fingerprints on the physical node, so the
    harvest after the run keys its observations without the logical
    tree (underscore attributes: invisible to the reuse pass)."""
    if physical is None or not getattr(_CAL_TLS, "enabled", False):
        return
    physical._calib_fp = logical_fp(logical)
    jfp = join_set_fp(logical)
    if jfp is not None:
        physical._calib_set_fp = jfp


def harvest_calibration(root_exec, ctx) -> int:
    """Record the observed output cardinalities of a finished run. Skipped
    when the tree holds a limit (a truncated pull underreports every
    producer below it) and when the conf gates calibration off. Returns
    the entries recorded."""
    from ..config import ADAPTIVE_CALIBRATION, ADAPTIVE_ENABLED
    conf = getattr(ctx, "conf", None)
    if conf is None or not (conf.get(ADAPTIVE_ENABLED)
                            and conf.get(ADAPTIVE_CALIBRATION)):
        return 0
    nodes, stack, seen = [], [root_exec], set()
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if "Limit" in type(node).__name__:
            return 0
        nodes.append(node)
        stack.extend(node.children)
    recorded = 0
    for node in nodes:
        ms = ctx.metrics.get(node._op_id)
        if ms is None:
            continue
        rows = ms.get("numOutputRows", 0)
        if not rows or rows <= 0:
            continue
        for attr in ("_calib_fp", "_calib_set_fp"):
            key = getattr(node, attr, None)
            if key is not None:
                _calibration_record(key, float(rows))
                recorded += 1
    return recorded


class Stats:
    """Row estimate and a lazy per-column NDV lookup. `rows` is None when
    the subtree has no estimable source; `ndv_of(name)` is an NDV
    estimate of an output column, or None when unknown."""

    __slots__ = ("rows", "_ndv_of")

    def __init__(self, rows: Optional[float],
                 ndv_of: Optional[Callable[[str], Optional[float]]] = None):
        self.rows = rows
        self._ndv_of = ndv_of or (lambda name: None)

    def ndv_of(self, name: str) -> Optional[float]:
        nd = self._ndv_of(name)
        if nd is None:
            return None
        if self.rows is not None:
            nd = min(nd, self.rows)
        return max(nd, 1.0)


def _chao1(counts, sample_n: int, total_rows: float) -> float:
    """The sample's distinct count extrapolated to the column: Chao1's
    d + f1^2 / (2 f2); an all-singleton sample reads as unique."""
    import numpy as np
    d = int(counts.shape[0])
    if sample_n >= total_rows:
        return float(d)
    f1 = int(np.count_nonzero(counts == 1))
    f2 = int(np.count_nonzero(counts == 2))
    if f1 >= sample_n or (f1 == d and f2 == 0):
        return float(total_rows)
    est = d + (f1 * f1) / (2.0 * max(f2, 1))
    return float(min(max(est, d), total_rows))


def _sample_arrow_column(node: L.LogicalPlan, name: str):
    """The first SAMPLE_ROWS of an in-memory scan's column, or of a
    cached scan's first batch (copied to the host once), or None."""
    if isinstance(node, L.InMemoryScan):
        if name not in node.arrow.schema.names:
            return None
        return node.arrow.column(name).slice(0, SAMPLE_ROWS)
    if isinstance(node, L.CachedScan):
        if not node.batches or name not in node.schema.names:
            return None
        at = getattr(node, "_stats_sample_cache", None)
        if at is None:
            from ..exec.nodes import _batch_to_arrow
            at = _batch_to_arrow(node.batches[0]).slice(0, SAMPLE_ROWS)
            node._stats_sample_cache = at
        return at.column(name) if name in at.schema.names else None
    return None


def scan_column_ndv(node: L.LogicalPlan, name: str) -> Optional[float]:
    """NDV estimate of one scan column, sampled once and cached on the
    node."""
    cache: Dict[str, Optional[float]] = getattr(node, "_ndv_cache", None)
    if cache is None:
        cache = node._ndv_cache = {}
    if name in cache:
        return cache[name]
    ndv: Optional[float] = None
    try:
        from .planner import _estimate_rows
        rows = _estimate_rows(node)
        arr = _sample_arrow_column(node, name)
        if arr is not None and rows:
            import numpy as np
            import pyarrow.compute as pc
            vc = pc.value_counts(arr)
            counts = np.asarray(vc.field("counts"))
            ndv = _chao1(counts, len(arr), float(rows))
    except Exception:
        ndv = None
    cache[name] = ndv
    return ndv


def _proj_ndv_map(exprs) -> Dict[str, Optional[str]]:
    """Output name -> source column of pass-through or renamed columns;
    computed expressions map to None (NDV unknown)."""
    from ..expr.expressions import Alias, ColumnRef
    out: Dict[str, Optional[str]] = {}
    for e in exprs:
        if isinstance(e, ColumnRef):
            out[e.name] = e.name
        elif isinstance(e, Alias) and isinstance(e.child, ColumnRef):
            out[e.name] = e.child.name
        else:
            out[getattr(e, "name", "?")] = None
    return out


def _key_name(expr) -> Optional[str]:
    """The one column a join or group key reads, else None."""
    from .optimizer import refs_of
    refs = refs_of(expr)
    if refs is not None and len(refs) == 1:
        return next(iter(refs))
    return None


def _join_rows(node: L.Join, ls: Stats, rs: Stats) -> Optional[float]:
    if ls.rows is None or rs.rows is None:
        return None
    if node.how in ("left_semi", "left_anti"):
        return ls.rows * 0.5
    rows = ls.rows * rs.rows
    for lk, rk in zip(node.left_keys, node.right_keys):
        ln, rn = _key_name(lk), _key_name(rk)
        ndv_l = (ls.ndv_of(ln) if ln else None) or ls.rows
        ndv_r = (rs.ndv_of(rn) if rn else None) or rs.rows
        rows /= max(ndv_l, ndv_r, 1.0)
    if node.how in ("left", "full"):
        rows = max(rows, ls.rows)
    if node.how in ("right", "full"):
        rows = max(rows, rs.rows)
    return rows


def compute_stats(node: L.LogicalPlan) -> Stats:
    """Bottom-up (rows, ndv) estimate of a logical subtree. Inside a
    calibration scope an observed cardinality of this exact subtree
    replaces the analytic row estimate (NDVs unchanged)."""
    s = _compute_stats_raw(node)
    rows = calibration_lookup(logical_fp(node)) \
        if getattr(_CAL_TLS, "enabled", False) else None
    if rows is not None:
        s = Stats(rows, s._ndv_of)
    return s


def _compute_stats_raw(node: L.LogicalPlan) -> Stats:
    from .cbo import _selectivity
    from .planner import _estimate_rows

    if isinstance(node, (L.InMemoryScan, L.CachedScan, L.ParquetScan,
                         L.TextScan)):
        rows = _estimate_rows(node)
        return Stats(None if rows is None else float(rows),
                     lambda n, _nd=node: scan_column_ndv(_nd, n))

    if isinstance(node, L.Filter):
        cs = compute_stats(node.children[0])
        rows = (None if cs.rows is None
                else cs.rows * _selectivity(node.condition))
        return Stats(rows, cs._ndv_of)

    if isinstance(node, L.Project):
        cs = compute_stats(node.children[0])
        m = _proj_ndv_map(node.exprs)

        def ndv(n, _m=m, _cs=cs):
            src = _m.get(n)
            return None if src is None else _cs.ndv_of(src)
        return Stats(cs.rows, ndv)

    if isinstance(node, L.Join):
        ls = compute_stats(node.children[0])
        rs = compute_stats(node.children[1])
        rows = _join_rows(node, ls, rs)
        lnames = set(node.left.schema.names)

        def ndv(n, _ls=ls, _rs=rs, _ln=lnames):
            return _ls.ndv_of(n) if n in _ln else _rs.ndv_of(n)
        return Stats(rows, ndv)

    if isinstance(node, L.Aggregate):
        cs = compute_stats(node.children[0])
        if cs.rows is None:
            return Stats(None)
        groups = 1.0
        known = True
        for k in node.keys:
            kn = _key_name(k)
            nd = cs.ndv_of(kn) if kn else None
            if nd is None:
                known = False
                break
            groups *= nd
        rows = min(groups, cs.rows) if known else \
            min(cs.rows, max(cs.rows ** 0.75, 1.0))
        key_names = {k.name for k in node.keys}

        def ndv(n, _cs=cs, _keys=key_names):
            return _cs.ndv_of(n) if n in _keys else None
        return Stats(max(rows, 1.0), ndv)

    if isinstance(node, L.Limit):
        cs = compute_stats(node.children[0])
        rows = (node.n if cs.rows is None
                else min(float(node.n), cs.rows))
        return Stats(float(rows), cs._ndv_of)

    if isinstance(node, L.Union):
        parts = [compute_stats(c) for c in node.children]
        if any(p.rows is None for p in parts):
            return Stats(None)
        return Stats(sum(p.rows for p in parts))

    if isinstance(node, (L.Sort, L.Repartition, L.WindowOp)):
        cs = compute_stats(node.children[0])
        return Stats(cs.rows, cs._ndv_of)

    rows = _estimate_rows(node)
    return Stats(None if rows is None else float(rows))
