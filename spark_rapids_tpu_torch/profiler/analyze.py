"""EXPLAIN ANALYZE renderer: the plan tree annotated with runtime
metrics per node, top time sinks flagged; the port of the JAX package's
`profiler/analyze.py`.

(reference: the SQL-UI per-node metric display wired by GpuExec /
GpuMetrics.scala, rendered as text.) Works from the JSON plan tree and
lore-keyed metric dicts of profiler.event_log, so the same renderer
serves `DataFrame.explain("ANALYZE")`, SQL `EXPLAIN ANALYZE` and a log
read after the fact. The root's annotations carry the action's kernel
launches and host syncs (profiler/xla_stats.py) where the JAX renderer
prints its XLA compile and dispatch counts. A note closes the text:
the op times are host seconds to enqueue the device work unless
`sql.metrics.sync` is on (utils/metrics.py).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from .event_log import op_time_seconds

__all__ = ["render_analyze", "fmt_bytes", "TIMER_NOTE"]

#: the closing note of a render whose timers did not wait for the device
TIMER_NOTE = ("note: op times are host seconds to enqueue each "
              "operator's device work (CUDA launches are asynchronous); "
              "set spark.rapids.tpu.sql.metrics.sync for per-operator "
              "execution times")

_SHUFFLE_BYTE_KEYS = ("shuffleBytesWritten", "shuffleBytesRead",
                      "rawBytes")


def fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024
    return f"{n:.1f}GiB"


def render_analyze(tree: dict, metrics_by_lore: Dict[Optional[int], dict],
                   top_n: int = 3, title: Optional[str] = None,
                   notes: Sequence[str] = ()) -> str:
    """Render the plan tree with per-node rows/batches/op-time/shuffle/
    spill annotations; the `top_n` largest time sinks are flagged with
    their share of total attributed operator time. `notes` follow the
    total line."""
    times = []

    def collect(node):
        m = metrics_by_lore.get(node.get("lore_id")) or {}
        times.append((node.get("lore_id"), op_time_seconds(m)))
        for c in node.get("children", ()):
            collect(c)

    collect(tree)
    total = sum(t for _, t in times)
    sinks = sorted((e for e in times if e[1] > 0), key=lambda e: -e[1])
    rank = {lid: i + 1 for i, (lid, _) in enumerate(sinks[:top_n])}

    lines = [] if title is None else [title]

    def walk(node, indent):
        lid = node.get("lore_id")
        m = metrics_by_lore.get(lid) or {}
        t = op_time_seconds(m)
        line = f"{'  ' * indent}[loreId={lid}] {node.get('describe')}"
        ann = []
        if "numOutputRows" in m:
            ann.append(f"rows={int(m['numOutputRows'])}")
        if "numOutputBatches" in m:
            ann.append(f"batches={int(m['numOutputBatches'])}")
        if t > 0:
            ann.append(f"time={t * 1e3:.1f}ms")
        shuffle = sum(m.get(k, 0) for k in _SHUFFLE_BYTE_KEYS)
        if shuffle:
            ann.append(f"shuffle={fmt_bytes(shuffle)}")
        if m.get("spillBytes"):
            ann.append(f"spill={fmt_bytes(m['spillBytes'])}")
        if m.get("deviceDecodedChunks"):
            ann.append(f"devDecoded={int(m['deviceDecodedChunks'])}")
        if m.get("decompressBusySecs"):
            ann.append(
                f"decompress={m['decompressBusySecs'] * 1e3:.1f}ms")
        if m.get("prefetchWaitSecs") is not None:
            ann.append(
                f"prefetchWait={m['prefetchWaitSecs'] * 1e3:.1f}ms")
        # per-column device-decode fallback reasons: why this scan (or
        # part of it) still decodes on the host — the printf-free answer
        fb = {k.split(".", 1)[1]: int(v) for k, v in m.items()
              if k.startswith("deviceDecodeFallback.")}
        if fb:
            ann.append("fallback={" + ", ".join(
                f"{k}:{v}" for k, v in sorted(fb.items())) + "}")
        # the action's launches of the hand-written kernels and its
        # host syncs (root node; profiler/xla_stats.py)
        if m.get("kernelLaunches") is not None:
            ann.append(f"kernelLaunches={int(m['kernelLaunches'])}")
        if m.get("hostSyncs") is not None:
            ann.append(f"hostSyncs={int(m['hostSyncs'])}")
        # exchange pipeline: parallel-map pool waits, async broadcast
        # overlap, and plan-level reuse hits
        if m.get("mapPoolWaitMs") is not None:
            ann.append(f"mapPoolWaitMs={float(m['mapPoolWaitMs']):.1f}")
        if m.get("broadcastBuildOverlapMs") is not None:
            ann.append("broadcastBuildOverlapMs="
                       f"{float(m['broadcastBuildOverlapMs']):.1f}")
        if m.get("broadcastTimeoutFallbacks"):
            ann.append("broadcastTimeoutFallbacks="
                       f"{int(m['broadcastTimeoutFallbacks'])}")
        if m.get("exchangeReuseHits"):
            ann.append(
                f"exchangeReuseHits={int(m['exchangeReuseHits'])}")
        # adaptive replan decisions: coalesce/skew on the
        # shuffle readers, demotion on the rewritten join, plus the
        # exact per-reduce-partition byte distribution on exchanges
        if m.get("aqePartitionsBefore") is not None:
            ann.append(f"AQEShuffleRead[coalesced "
                       f"{int(m['aqePartitionsBefore'])}"
                       f"→{int(m['aqePartitionsAfter'])}]")
        if m.get("aqeSkewSplits"):
            ann.append(f"aqeSkewSplits={int(m['aqeSkewSplits'])}")
        if m.get("aqeDemotedBuildBytes") is not None:
            ann.append("aqeDemotedToBroadcast="
                       f"{fmt_bytes(m['aqeDemotedBuildBytes'])}")
        if m.get("shufflePartitionBytesMax") is not None:
            ann.append(
                "shufflePartitionBytes="
                f"{fmt_bytes(m.get('shufflePartitionBytesMin', 0))}"
                f"/{fmt_bytes(m.get('shufflePartitionBytesMedian', 0))}"
                f"/{fmt_bytes(m['shufflePartitionBytesMax'])}")
        # time the root's tasks were blocked on the TpuSemaphore
        if m.get("semaphoreWaitMs") is not None:
            ann.append(
                f"semaphoreWaitMs={float(m['semaphoreWaitMs']):.1f}")
        # critical-path attribution (root node): where the END-TO-END
        # wall clock went, reduced from the query's trace
        # (profiler/critical_path.py) — dominant edge plus every share
        # above the noise floor
        cps = {k.split(".", 1)[1]: float(v) for k, v in m.items()
               if k.startswith("criticalPathShare.")}
        if cps:
            from .critical_path import dominant_of_pct
            dom = dominant_of_pct(cps)
            tops = ", ".join(
                f"{c}:{cps[c]:.0f}%" for c in sorted(
                    cps, key=cps.get, reverse=True)
                if cps[c] >= 1.0)
            ann.append(f"criticalPath={dom} [{tops}]")
        # the resource ledger (root node, when the ledger is on):
        # staging-lease traffic this action and the balance verdict
        if m.get("ledgerBalanced") is not None:
            parts = []
            if m.get("ledgerLeaseAcquires"):
                parts.append(f"leases={int(m['ledgerLeaseAcquires'])}")
            if m.get("ledgerPeakLeases"):
                parts.append(f"peak={int(m['ledgerPeakLeases'])}")
            parts.append("balanced=" + ("yes" if m["ledgerBalanced"]
                                        else "NO"))
            ann.append("ledger[" + " ".join(parts) + "]")
        if ann:
            line += "  " + " ".join(ann)
        if lid in rank:
            pct = (100.0 * t / total) if total > 0 else 0.0
            line += (f"  <-- time sink #{rank[lid]} "
                     f"({pct:.0f}% of op time)")
        lines.append(line)
        for c in node.get("children", ()):
            walk(c, indent + 1)

    walk(tree, 0)
    if total > 0:
        lines.append(f"total attributed op time: {total * 1e3:.1f}ms")
    lines.extend(notes)
    return "\n".join(lines)
