"""Plan-time static auditor: NOT_ON_TPU verdict tagging before execution.

The port's copy of the JAX package's `analysis/audit.py` (reference:
GpuOverrides.scala tagging + `spark.rapids.sql.explain=NOT_ON_GPU`): a
pre-execution walk over the tagged, bound plan that checks each bound
expression against the TypeSig registry (`plan/typesig.py`, with the
AUDIT_CHECKS kernel-truth refinements narrower than the binders) and
tags every node with a structured verdict:

  ok              runs on the device
  will_fallback   runs, but on the host CPU (the host fallback
                  interpreter), or a Parquet column decodes on the host
  will_not_work   will fail at runtime (unregistered expression, a
                  dtype the kernels cannot handle); with
                  `sql.audit.strict` these raise a plan-time
                  UnsupportedExpr carrying the node path
  recompile_risk  kept as a kind for the JAX package's vocabulary; an
                  eager engine compiles no per-shape program, so the
                  port never issues it (ROADMAP C.28)

Surfaced through `df.explain("VALIDATE")`, the ALL / NOT_ON_TPU
explain modes and the event log's `plan_audit` record
(`profiler/event_log.py`); each verdict carries its node's lore id
(`utils/lore.py`). The JAX auditor's fusion groups (ROADMAP A.11) are
not ported: `fusion_groups` stays empty. The JAX auditor's
will_fallback verdicts are all here: the CPU-bridge expressions
(FromJson, ToJson, ParseUrl: `_HOST_BRIDGE`; those never bind, so
their node carries the host fallback's verdict, as in the JAX package),
a python UDF the compiler could not translate (`PyUDF`, a host call per
batch) and the three pandas nodes (rows cross to a python worker
process).
"""
from __future__ import annotations

from typing import Callable, List, Optional

from ..expr.expressions import Expression, UnsupportedExpr

__all__ = ["Verdict", "AuditReport", "audit_plan", "OK", "WILL_FALLBACK",
           "WILL_NOT_WORK", "RECOMPILE_RISK"]

OK = "ok"
WILL_FALLBACK = "will_fallback"
WILL_NOT_WORK = "will_not_work"
RECOMPILE_RISK = "recompile_risk"

# severity order for a node's summary tag
_RANK = {OK: 0, RECOMPILE_RISK: 1, WILL_FALLBACK: 2, WILL_NOT_WORK: 3}
_TAG = {OK: "*", RECOMPILE_RISK: "~", WILL_FALLBACK: "!cpu",
        WILL_NOT_WORK: "!!"}

# bound-tree infrastructure nodes that deliberately carry no signature
_INFRA = {"BoundRef", "NamedLambdaVariable", "Alias"}

# expressions that evaluate on the host CPU bridge (their registry notes
# say "runs via CPU bridge")
_HOST_BRIDGE = {"FromJson", "ToJson", "ParseUrl"}


class Verdict:
    """One finding on one plan node."""

    __slots__ = ("kind", "reason", "node", "path", "lore_id")

    def __init__(self, kind: str, reason: str, node: str, path: str,
                 lore_id: Optional[int]):
        self.kind = kind
        self.reason = reason
        self.node = node
        self.path = path
        self.lore_id = lore_id

    def to_dict(self) -> dict:
        return {"kind": self.kind, "reason": self.reason,
                "node": self.node, "path": self.path,
                "lore_id": self.lore_id}

    def describe(self) -> str:
        lore = f" [loreId={self.lore_id}]" if self.lore_id is not None \
            else ""
        return f"{self.kind}{lore} {self.path}: {self.reason}"

    def __repr__(self):
        return f"Verdict({self.describe()})"


class AuditReport:
    """All non-ok findings plus a renderable per-node verdict tree."""

    def __init__(self, findings: List[Verdict], tree_lines: List[str],
                 node_count: int):
        self.findings = findings
        self.tree_lines = tree_lines
        self.node_count = node_count
        # the whole-stage fusion groups of the JAX planner; empty until
        # stage fusion is ported (ROADMAP A.11)
        self.fusion_groups: List[str] = []

    def to_events(self) -> List[dict]:
        """JSON-able findings for the `plan_audit` event-log record."""
        return [v.to_dict() for v in self.findings]

    def of_kind(self, kind: str) -> List[Verdict]:
        return [v for v in self.findings if v.kind == kind]

    @property
    def ok(self) -> bool:
        return not self.of_kind(WILL_NOT_WORK)

    def lines(self) -> List[str]:
        """The VALIDATE explain rendering: the verdict-tagged plan tree
        followed by one line per finding."""
        out = ["== PLAN AUDIT =="]
        out.extend(self.tree_lines)
        if self.findings:
            out.append("-- findings --")
            out.extend(v.describe() for v in self.findings)
        else:
            out.append("-- no findings: plan runs fully on TPU --")
        if self.fusion_groups:
            out.append("-- fused stages --")
            out.extend(self.fusion_groups)
        return out

    def render(self) -> str:
        return "\n".join(self.lines())

    def raise_if_blocked(self):
        """Strict mode: any will_not_work verdict fails the plan now,
        with the node path of every blocked site."""
        blocked = self.of_kind(WILL_NOT_WORK)
        if blocked:
            raise UnsupportedExpr(
                "plan audit: " + "; ".join(v.describe() for v in blocked))


def _audit_expr(expr, role: str, add: Callable[[str, str], None],
                seen_ids=None):
    """Walk one bound expression tree, checking every node against the
    registry (coverage + primary-input dtype) and the AUDIT_CHECKS
    kernel-truth refinements."""
    from ..plan import typesig
    if expr is None or not isinstance(expr, Expression):
        return
    if seen_ids is None:
        seen_ids = set()
    if id(expr) in seen_ids:       # diamond-shared subtrees audit once
        return
    seen_ids.add(id(expr))
    name = type(expr).__name__
    kids = getattr(expr, "children", None) or []
    ent = typesig.SIGS.get(name)
    if ent is None and name not in _INFRA:
        add(WILL_NOT_WORK,
            f"unregistered expression {name} in {role}: no TypeSig "
            f"registration — device support unknown (register it in "
            f"plan/typesig.py, or with an explicit permissive sig + "
            f"note)")
    cdt = getattr(kids[0], "dtype", None) if kids else None
    if ent is not None and cdt is not None and not ent[0].supports(cdt):
        add(WILL_NOT_WORK,
            f"{name} in {role} does not support input type {cdt} "
            f"(supported: {ent[0].describe()})")
    reason = typesig.audit_check(name, cdt)
    if reason is not None:
        add(WILL_NOT_WORK, f"{name} in {role} over {cdt}: {reason}")
    if name in _HOST_BRIDGE:
        add(WILL_FALLBACK,
            f"{name} in {role} runs via the CPU bridge (host row "
            f"interpreter)")
    if name == "PyUDF":
        add(WILL_FALLBACK,
            f"python UDF {getattr(expr, 'name', '?')!r} in {role} was "
            f"not AST-compiled: evaluates via a host call (each batch's "
            f"columns copy to the host, the function runs over numpy, "
            f"its result copies back)")
    for c in kids:
        _audit_expr(c, role, add, seen_ids)
    # a bound WindowExpr carries bound partition keys / sort orders in
    # its spec, outside .children
    spec = getattr(expr, "spec", None)
    if name == "WindowExpr" and spec is not None:
        for k in getattr(spec, "partition_keys", []) or []:
            _audit_expr(k, f"{role} partition key", add, seen_ids)
        for o in getattr(spec, "orders", []) or []:
            _audit_expr(getattr(o, "expr", None), f"{role} order key",
                        add, seen_ids)


def _bound_exprs(node):
    """Yield (role, bound expression) pairs for every expression a
    logical node carries, by node type."""
    from ..plan import logical as L
    if isinstance(node, L.Project):
        for e, b in zip(node.exprs, node.bound):
            if b is not None:
                yield f"Project expr {e.name!r}", b
    elif isinstance(node, L.Filter):
        if node.bound is not None:
            yield "Filter condition", node.bound
    elif isinstance(node, L.Aggregate):
        for k in node.bound_keys:
            yield f"Aggregate key {k.name!r}", k
        for n, a in node.bound_aggs:
            yield f"Aggregate agg {n!r}", a
    elif isinstance(node, L.Expand):
        for k in node.bound_keys:
            yield f"Expand key {k.name!r}", k
    elif isinstance(node, L.Join):
        for k in node.bound_left_keys or []:
            yield f"Join left key {k.name!r}", k
        for k in node.bound_right_keys or []:
            yield f"Join right key {k.name!r}", k
        if node.bound_condition is not None:
            yield "Join condition", node.bound_condition
    elif isinstance(node, L.Sort):
        for o in node.bound_orders:
            yield f"Sort key {o.expr!r}", o.expr
    elif isinstance(node, L.WindowOp):
        for n, w in node.bound:
            yield f"WindowOp column {n!r}", w
    elif isinstance(node, L.Generate):
        yield "Generate generator", node.bound
    elif isinstance(node, L.Repartition):
        for k in node.bound_keys or []:
            yield f"Repartition key {k.name!r}", k


def _audit_parquet_scan(node, add: Callable[[str, str], None]):
    """Plan-time device-decode audit of a ParquetScan: read the FIRST
    file's footer (cheap, metadata only) and report, per selected
    column, why the device decode path would fall back to host pyarrow
    — codec / physical type / encoding / nested — so 'why did this
    scan fall back' is answerable before running anything. Best-effort:
    unreadable files stay silent (the runtime path re-checks)."""
    try:
        import pyarrow.parquet as pq

        from ..io.parquet_device import fallback_reasons
        pf = pq.ParquetFile(node.paths[0])
        if pf.metadata.num_row_groups == 0:
            return
        cols = (node.columns if node.columns is not None
                else [f.name for f in node.schema.fields])
        for name, (cat, detail) in fallback_reasons(pf, 0,
                                                    cols).items():
            add(WILL_FALLBACK,
                f"scan device-decode fallback ({cat}): column "
                f"'{name}' decodes on host pyarrow — {detail}")
    except Exception:
        return


def _audit_node(meta, path: str, depth: int, findings: List[Verdict],
                tree_lines: List[str], conf, counter: List[int]):
    from ..plan import logical as L
    counter[0] += 1
    node = meta.node
    lore = getattr(meta.exec_node, "lore_id", None)
    local: List[Verdict] = []

    def add(kind: str, reason: str):
        local.append(Verdict(kind, reason, node.node_name(), path, lore))

    # planner tagging verdicts (RapidsMeta willNotWork / host analogs)
    for r in meta.reasons:
        add(WILL_NOT_WORK, r)
    for r in meta.host_reasons:
        add(WILL_FALLBACK, f"host fallback: {r}")
    # operators that are host/python by construction
    if isinstance(node, (L.MapInPandas, L.GroupedMapInPandas,
                         L.CoGroupInPandas)):
        add(WILL_FALLBACK,
            "python_exec: rows cross to a pooled python worker process "
            "as Arrow IPC (device pipeline breaks at this node)")
    if isinstance(node, L.ParquetScan):
        _audit_parquet_scan(node, add)
    # every bound expression the node carries
    for role, b in _bound_exprs(node):
        _audit_expr(b, role, add)

    findings.extend(local)
    worst = max((v.kind for v in local), key=_RANK.get, default=OK)
    lore_tag = f" [loreId={lore}]" if lore is not None else ""
    line = f"{'  ' * depth}{_TAG[worst]}{lore_tag} {node.describe()}"
    if local:
        line += "  <-- " + "; ".join(
            f"{v.kind}: {v.reason}" for v in local)
    tree_lines.append(line)
    many = len(meta.children) > 1
    for i, c in enumerate(meta.children):
        step = f"{i}:{c.node.node_name()}" if many else c.node.node_name()
        _audit_node(c, f"{path}/{step}", depth + 1, findings, tree_lines,
                    conf, counter)


def audit_plan(meta, conf) -> AuditReport:
    """Audit a tagged (and, when conversion succeeded, converted)
    PlanMeta tree. Safe to run on every plan(): a pure tree walk, no
    device work."""
    findings: List[Verdict] = []
    tree_lines: List[str] = []
    counter = [0]
    root_name = meta.node.node_name()
    _audit_node(meta, root_name, 0, findings, tree_lines, conf, counter)
    return AuditReport(findings, tree_lines, counter[0])
