"""Plan-level exchange reuse: the ReuseExchange rule.

The port of the JAX package's `plan/reuse.py` (`:30-273`) over the port's
exec nodes. A pass over the physical tree fingerprints every exchange
subtree (class names, the nodes' public attributes, expression
fingerprints from `plan/fingerprint.py`, child subtrees) and rewrites
each later duplicate to a `ReusedExchangeExec` that delegates to the
first occurrence: one map phase or broadcast build per distinct subtree
per query.

A value that cannot be fingerprinted makes its subtree unique, never
merged: a false negative costs a shuffle, a false positive would corrupt
rows. An adaptive reader's shared plan object is such a value, as in the
JAX package, so a subtree holding an adaptive reader is never reused.
The JAX module's mesh-exchange and fused-stage branches have no
counterpart in the port.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

from ..exec.base import ExecContext, TpuExec

__all__ = ["reuse_exchanges", "ReusedExchangeExec", "node_fp"]


#: public attributes that label a node rather than configure it
_SKIP_ATTRS = {"children", "lore_id", "audit_report",
               "exchange_reuse_hits"}


def _norm_names(fp):
    """Erase column-name attributes from an expr_fp tuple: exchange
    subtrees hold bound expressions, which emit by ordinal, so `k` and a
    join's rename `__join_r1_k` are the same data."""
    if isinstance(fp, tuple):
        if len(fp) == 2 and fp[0] == "_name" and isinstance(fp[1], str):
            return ("_name", "?")
        return tuple(_norm_names(x) for x in fp)
    return fp


def _value_fp(v) -> Optional[tuple]:
    """Structural fingerprint of one plan-config attribute value; None
    when it cannot be fingerprinted (the subtree becomes unique)."""
    from ..columnar.table import Schema
    from ..expr.expressions import Expression
    from .fingerprint import expr_fp
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return ("lit", v)
    if isinstance(v, Expression):
        return ("expr", _norm_names(expr_fp(v)))
    if isinstance(v, (list, tuple)):
        parts = tuple(_value_fp(x) for x in v)
        return None if any(p is None for p in parts) else ("seq", parts)
    if isinstance(v, dict):
        try:
            items = sorted(v.items())
        except TypeError:
            return None
        parts = tuple((k, _value_fp(x)) for k, x in items)
        return (None if any(p is None for _, p in parts)
                else ("map", parts))
    if isinstance(v, Schema):
        return ("schema", _schema_fp(v))
    if isinstance(v, TpuExec):
        fp = node_fp(v)
        return None if fp is None else ("exec", fp)
    try:
        import pyarrow as pa
        if isinstance(v, pa.Table):
            # memory identity: a self-join's two scans wrap one table's
            # buffers (same addresses, offsets and lengths: same bytes),
            # while a genuine copy stays unique
            parts = [tuple(str(f.type) for f in v.schema), v.num_rows]
            for column in v.columns:
                for ch in column.chunks:
                    parts.append((ch.offset, len(ch),
                                  tuple(b.address if b is not None else 0
                                        for b in ch.buffers())))
            return ("arrow", tuple(parts))
    except Exception:
        pass
    # anything else: the same object is the same data, and distinct but
    # equal objects stay unique
    return ("id", id(v))


def _schema_fp(schema) -> tuple:
    # dtypes only: after binding, column names are labels
    return tuple(str(f.dtype) for f in schema.fields)


def _is_identity_project(node) -> bool:
    """A bound Project that only renames: output i is (through Alias)
    BoundRef(i), covering the whole child schema."""
    from ..expr.expressions import Alias, BoundRef
    child = node.children[0]
    bound = getattr(node, "bound", None)
    if bound is None or len(bound) != len(child.schema.fields):
        return False
    for i, e in enumerate(bound):
        while isinstance(e, Alias):
            e = e.child
        if not (isinstance(e, BoundRef) and e.ordinal == i):
            return False
    return True


def _canonical(node: TpuExec) -> TpuExec:
    """See through pure-rename Projects, so `Exchange(Scan)` and
    `Exchange(Project[x AS __join_r1_x](Scan))` (every self-join's
    shape) fingerprint alike."""
    from ..exec.nodes import ProjectExec
    while (isinstance(node, ProjectExec) and node.children
           and _is_identity_project(node)):
        node = node.children[0]
    return node


def node_fp(node: TpuExec) -> Optional[tuple]:
    """Structural fingerprint of a physical subtree: public attributes
    are plan config, underscore attributes runtime state (skipped). Any
    public attribute that cannot be fingerprinted poisons the subtree
    (None)."""
    node = _canonical(node)
    parts = [("cls", type(node).__name__),
             ("schema", _schema_fp(node.schema))]
    for k in sorted(vars(node)):
        if k.startswith("_") or k in _SKIP_ATTRS:
            continue
        fp = _value_fp(vars(node)[k])
        if fp is None:
            return None
        parts.append((k, fp))
    kids = []
    for c in node.children:
        cfp = node_fp(c)
        if cfp is None:
            return None
        kids.append(cfp)
    parts.append(("children", tuple(kids)))
    return tuple(parts)


class ReusedExchangeExec(TpuExec):
    """Stand-in for a duplicate exchange subtree: every read delegates to
    the first occurrence's materialization, shared under the target's
    own lock. It carries the replaced node's lore id and renders the
    target's in describe(). No children: the shared subtree belongs to
    its first occurrence."""

    def __init__(self, target: TpuExec, original: TpuExec):
        super().__init__([], original.schema)
        self.target = target
        self.lore_id = getattr(original, "lore_id", None)
        self._hit_lock = threading.Lock()
        self._hit_ctxs = set()

    def describe(self):
        tid = getattr(self.target, "lore_id", "?")
        return f"ReusedExchange[loreId={self.lore_id} -> {tid}]"

    def num_partitions(self, ctx):
        return self.target.num_partitions(ctx)

    def _count_hit(self, ctx: ExecContext):
        """One exchangeReuseHits per (execution, node): a map phase or
        build this query did not run again."""
        with self._hit_lock:
            if id(ctx) in self._hit_ctxs:
                return
            if len(self._hit_ctxs) > 64:
                self._hit_ctxs.clear()
            self._hit_ctxs.add(id(ctx))
        ctx.add_metric(self._op_id, "exchangeReuseHits", 1)

    # ---- the exchange API, delegated (adaptive readers call these) ----
    def stage_stats(self, ctx: ExecContext):
        self._count_hit(ctx)
        return self.target.stage_stats(ctx)

    def read_slice(self, ctx: ExecContext, rpid: int, chunk: int = 0,
                   nchunks: int = 1):
        self._count_hit(ctx)
        return self.target.read_slice(ctx, rpid, chunk=chunk,
                                      nchunks=nchunks)

    def execute_partition(self, ctx: ExecContext, pid: int):
        self._count_hit(ctx)
        yield from self.target.execute_partition(ctx, pid)


def _reusable(node: TpuExec) -> bool:
    from ..exec.broadcast import BroadcastExchangeExec
    from ..exec.exchange import ShuffleExchangeExec
    return isinstance(node, (ShuffleExchangeExec, BroadcastExchangeExec))


def reuse_exchanges(root: TpuExec, conf) -> Tuple[TpuExec, int]:
    """Rewrite duplicate exchange subtrees to ReusedExchangeExec nodes.
    Returns (new root, hits)."""
    from ..config import EXCHANGE_REUSE
    from ..exec.aqe import AqeShufflePlan
    if not conf.get(EXCHANGE_REUSE):
        return root, 0
    seen = {}
    replaced = {}  # id(duplicate exchange) -> its ReusedExchangeExec
    hits = 0

    def walk(node: TpuExec) -> TpuExec:
        nonlocal hits
        if isinstance(node, ReusedExchangeExec):
            return node
        node.children = [walk(c) for c in node.children]
        # an AqeShufflePlan holds its exchanges outside the children
        # list and calls stage_stats on them: swap the duplicates there
        # too, or the map phase still runs twice
        p = getattr(node, "plan", None)
        if isinstance(p, AqeShufflePlan):
            p.exchanges = [replaced.get(id(e), e) for e in p.exchanges]
        if not _reusable(node):
            return node
        fp = node_fp(node)
        if fp is None:
            return node
        first = seen.get(fp)
        if first is not None and first is not node:
            hits += 1
            r = ReusedExchangeExec(first, node)
            replaced[id(node)] = r
            return r
        seen[fp] = node
        return node

    return walk(root), hits
