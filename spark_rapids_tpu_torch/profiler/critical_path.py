"""Critical-path extraction over an assembled per-query span trace: a
copy of the JAX package's `profiler/critical_path.py` (pure Python).

Input: the `trace_span` records of one query (profiler/tracing.py),
assembled across the query thread and its pool workers. Output: where
the END-TO-END wall clock went, decomposed into a small fixed
vocabulary of edges (the port opens no compile, shuffle_fetch,
collective, spill, queue or peer_fetch span yet, so those stay 0; the
vocabulary is kept so records read alike in both packages):

  queue          admission/queue wait in the query service
  plan           logical->physical planning + AQE stage decisions
  compile        sync compiles on the dispatch path
  shuffle_fetch  remote block fetches (incl. injected delays)
  collective     fused SPMD collective launches
  spill          spill write/read (device<->host<->disk)
  pool_wait      waits for exchange-map/broadcast pool admission
  retry          backoff sleeps, fetch retries, degradation recovery
  compute        everything else inside the query window

The decomposition is a TIMELINE SWEEP, not a graph longest-path: the
engine blocks-on-results at every stage barrier, so at any instant the
query's latency is attributable to the DEEPEST span covering that
instant (ties: non-compute beats compute, later-opened beats earlier).
The sweep projects every span onto the root window and integrates per
category, so shares always sum to the root wall time — robust to
executor clock skew at the edges (spans are clamped to the window) and
to overlapping concurrent workers (depth picks the most specific
blame). The dominant edge is simply the largest non-compute share if
any edge exceeds `DOMINANT_FLOOR` of the window, else "compute" — the
name EXPLAIN ANALYZE prints as `criticalPath=`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["CATEGORIES", "category_of", "summarize", "span_depths",
           "render_waterfall", "dominant_of_pct", "DOMINANT_FLOOR"]

#: edge vocabulary, in render order
CATEGORIES = ("queue", "plan", "compile", "shuffle_fetch", "collective",
              "spill", "pool_wait", "retry", "peer_fetch", "compute")

#: span kind -> edge category (kinds not listed count as compute)
_KIND_CATEGORY = {
    "queue": "queue",
    "plan": "plan",
    "aqe": "plan",
    "compile": "compile",
    "fetch": "shuffle_fetch",
    "shuffle_fetch": "shuffle_fetch",
    "collective": "collective",
    "spill": "spill",
    "spill_write": "spill",
    "spill_read": "spill",
    "pool_wait": "pool_wait",
    "retry": "retry",
    "backoff": "retry",
    "degrade": "retry",
    # fleet peer-cache fetches (fleet/peer_cache.py): a slow peer shows
    # up as its own edge rather than hiding inside compute, so "was the
    # fleet worth it" is answerable per query
    "peer_fetch": "peer_fetch",
}

#: a non-compute edge must cover at least this fraction of the query
#: window to be named dominant (below it, noise would flip the label
#: between runs)
DOMINANT_FLOOR = 0.05


def category_of(kind: Optional[str]) -> str:
    return _KIND_CATEGORY.get(kind or "", "compute")


def dominant_of_pct(share_pct: Dict[str, float]) -> str:
    """The dominant-edge rule applied to a percentage-share dict — used
    by consumers (EXPLAIN ANALYZE) that only kept the numeric shares."""
    dominant, best = "compute", 0.0
    for c, pct in share_pct.items():
        if c == "compute":
            continue
        if pct > best:
            best, dominant = pct, c
    return dominant if best >= DOMINANT_FLOOR * 100.0 else "compute"


def span_depths(spans: List[dict]) -> Dict[str, int]:
    """span_id -> ancestor count within this trace (roots are 0).
    Parent links that point outside the trace (a pruned/unsampled
    ancestor) count as roots."""
    by_id = {s.get("span_id"): s for s in spans}
    depths: Dict[str, int] = {}

    def depth(sid, hops=0):
        if sid in depths:
            return depths[sid]
        if hops > len(by_id) + 1:       # cycle guard: corrupt links
            return 0
        s = by_id.get(sid)
        parent = s.get("parent_id") if s else None
        d = 0 if parent not in by_id else depth(parent, hops + 1) + 1
        depths[sid] = d
        return d

    for s in spans:
        depth(s.get("span_id"))
    return depths


def _window(spans: List[dict]):
    """(start_ns, end_ns) of the query window: the hull of every span.
    The hull — not just the root 'query' span — because the queue span
    is back-dated to BEFORE the root opened (admission happens before
    the query thread runs) and background compiles can outlive the
    root; both must still earn their share."""
    start = min(s.get("start_ns", 0) for s in spans)
    end = max(s.get("end_ns", 0) for s in spans)
    return start, max(end, start)


def summarize(spans: List[dict],
              wall_s: Optional[float] = None) -> Optional[dict]:
    """Latency-share decomposition of one assembled trace.

    Returns {total_ms, shares: {category: ms}, share_pct, dominant,
    dominant_pct, span_count} or None for an empty trace. `wall_s`,
    when given (profile_query knows the true action wall), scales the
    window so the summary matches the query_end record even if some
    edge spans were clipped."""
    spans = [s for s in spans if s.get("end_ns", 0)
             >= s.get("start_ns", 0)]
    if not spans:
        return None
    w0, w1 = _window(spans)
    if w1 <= w0:
        return None
    depths = span_depths(spans)

    # elementary-interval sweep over every span boundary in the window
    cuts = set()
    clipped = []
    for s in spans:
        if s.get("kind") == "query":
            continue
        a = max(s["start_ns"], w0)
        b = min(s["end_ns"], w1)
        if b <= a:
            continue
        clipped.append((a, b, depths.get(s.get("span_id"), 0),
                        category_of(s.get("kind"))))
        cuts.add(a)
        cuts.add(b)
    cuts.add(w0)
    cuts.add(w1)
    edges = sorted(cuts)

    shares = {c: 0.0 for c in CATEGORIES}
    for i in range(len(edges) - 1):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        mid_cover = [(d, 0 if cat == "compute" else 1, cat)
                     for (sa, sb, d, cat) in clipped
                     if sa <= a and sb >= b]
        if mid_cover:
            cat = max(mid_cover)[2]
        else:
            cat = "compute"
        shares[cat] += (b - a) / 1e6

    total_ms = (w1 - w0) / 1e6
    if wall_s is not None and wall_s > 0:
        # rescale to the action's true wall so shares line up with
        # query_end even when tracing missed the first/last slivers
        scale = (wall_s * 1e3) / total_ms if total_ms > 0 else 1.0
        if scale > 1.0:
            shares["compute"] += wall_s * 1e3 - total_ms
            total_ms = wall_s * 1e3

    share_pct = {c: round(100.0 * v / total_ms, 2) if total_ms else 0.0
                 for c, v in shares.items()}
    dominant = "compute"
    best = 0.0
    for c in CATEGORIES:
        if c == "compute":
            continue
        if shares[c] > best:
            best, dominant = shares[c], c
    if best < DOMINANT_FLOOR * total_ms:
        dominant = "compute"
    return {"total_ms": round(total_ms, 3),
            "shares": {c: round(v, 3) for c, v in shares.items()},
            "share_pct": share_pct,
            "dominant": dominant,
            "dominant_pct": share_pct[dominant],
            "span_count": len(spans)}


# ---------------------------------------------------------------------
# waterfall rendering (tools/profile_report.py --trace)
# ---------------------------------------------------------------------
def render_waterfall(spans: List[dict], width: int = 48,
                     max_rows: int = 60) -> str:
    """Text waterfall: spans start-ordered, indented by trace depth,
    with a proportional bar over the query window."""
    spans = sorted(spans, key=lambda s: (s.get("start_ns", 0),
                                         s.get("end_ns", 0)))
    if not spans:
        return "(no spans)"
    w0, w1 = _window(spans)
    total = max(w1 - w0, 1)
    depths = span_depths(spans)
    lines = []
    shown = spans[:max_rows]
    for s in shown:
        a = max(s.get("start_ns", w0), w0)
        b = min(s.get("end_ns", w0), w1)
        off = int(width * (a - w0) / total)
        bar = max(1, int(width * max(b - a, 0) / total))
        bar = min(bar, width - off)
        gutter = " " * off + "#" * bar
        gutter = gutter.ljust(width)
        d = depths.get(s.get("span_id"), 0)
        name = "  " * d + str(s.get("name"))
        ms = s.get("dur_ms", (b - a) / 1e6)
        proc = s.get("proc", "")
        lines.append(f"|{gutter}| {ms:9.2f}ms  {name} "
                     f"[{s.get('kind')}@{proc}]")
    if len(spans) > max_rows:
        lines.append(f"... {len(spans) - max_rows} more spans")
    return "\n".join(lines)
