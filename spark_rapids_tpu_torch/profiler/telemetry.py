"""Live telemetry: process-global counters, gauges and log-bucket
histograms, scrapeable while queries run; the port of the JAX package's
`profiler/telemetry.py`.

The event log is per-query and post-hoc; this registry is the LIVE
surface: a process's latency distributions, critical-path shares and
memory watermarks right now. `snapshot()` returns it as one JSON-able
dict and `render_prometheus()` as a text exposition (the JAX package
serves both through its service gateway's `metrics` verb, which waits
for ROADMAP A.15 here).

Histograms are log-bucketed (geometric buckets, ~19% relative width:
base 2^0.25) so p50/p95/p99 come out of ~100 integers per instrument
without storing samples: O(1) memory and a dict-increment per
observation, cheap enough to stay always-on. Quantiles are the
geometric midpoint of the covering bucket, exact to within one bucket
width.

Gauges come in two flavors: set-value (`gauge(name).set(v)`) and
callback (`register_gauge_fn(name, fn)`); callbacks are sampled at
snapshot time, which keeps watermark reporting out of every hot path.
The built-in gauges read the port's `memory/diagnostics.py` watermarks
(peaks and the spill stores' counters) and the dropped-span count; the
JAX module's program-cache, result-cache and compile-pool gauges wait
for ROADMAP A.11 and A.15. The registry's lock is lockdep's
`telemetry._LOCK`, and every registry access is noted to the data-race
witness (`telemetry.registry`).

Instruments auto-create on first touch and live for the process; the
registry never raises into engine code (a telemetry failure must not
fail a query).
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional

from ..runtime import lockdep, racedep

__all__ = ["counter", "gauge", "histogram", "register_gauge_fn",
           "snapshot", "render_prometheus", "reset", "Histogram"]

_LOCK = lockdep.lock("telemetry._LOCK")
_COUNTERS: Dict[str, "Counter"] = {}
_GAUGES: Dict[str, "Gauge"] = {}
_GAUGE_FNS: Dict[str, Callable[[], object]] = {}
_HISTOGRAMS: Dict[str, "Histogram"] = {}

#: bucket boundaries grow by 2^(1/4) per bucket — ~19% relative error,
#: ~110 buckets span 1e-3 .. 1e9
_LOG_BASE = 2.0 ** 0.25
_LN_BASE = math.log(_LOG_BASE)


class Counter:
    __slots__ = ("name", "_lock", "_n")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


class Gauge:
    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self):
        with self._lock:
            return self._v


class Histogram:
    """Log-bucketed distribution: p50/p95/p99 without samples."""

    __slots__ = ("name", "_lock", "_buckets", "_count", "_sum", "_min",
                 "_max")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    @staticmethod
    def _bucket_of(v: float) -> int:
        if v <= 0.0:
            return -(10 ** 6)          # dedicated zero/negative bucket
        return int(math.floor(math.log(v) / _LN_BASE))

    @staticmethod
    def _bucket_mid(b: int) -> float:
        if b <= -(10 ** 6):
            return 0.0
        # geometric midpoint of [base^b, base^(b+1))
        return _LOG_BASE ** (b + 0.5)

    def observe(self, v) -> None:
        try:
            v = float(v)
        except (TypeError, ValueError):
            return
        b = self._bucket_of(v)
        with self._lock:
            self._buckets[b] = self._buckets.get(b, 0) + 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._count:
                return None
            target = q * self._count
            seen = 0
            for b in sorted(self._buckets):
                seen += self._buckets[b]
                if seen >= target:
                    mid = self._bucket_mid(b)
                    # clamp to the observed range: the edge buckets'
                    # midpoints can overshoot the true extremes
                    return min(max(mid, self._min), self._max)
            return self._max

    def summary(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        out = {"count": count, "sum": round(total, 6)}
        if count:
            out.update({
                "min": round(lo, 6), "max": round(hi, 6),
                "mean": round(total / count, 6),
                "p50": round(self.quantile(0.50), 6),
                "p95": round(self.quantile(0.95), 6),
                "p99": round(self.quantile(0.99), 6)})
        return out


# ---------------------------------------------------------------------
# registry access
# ---------------------------------------------------------------------
def counter(name: str) -> Counter:
    with _LOCK:
        racedep.note_access("telemetry.registry", name, write=True)
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter(name)
        return c


def gauge(name: str) -> Gauge:
    with _LOCK:
        racedep.note_access("telemetry.registry", name, write=True)
        g = _GAUGES.get(name)
        if g is None:
            g = _GAUGES[name] = Gauge(name)
        return g


def histogram(name: str) -> Histogram:
    with _LOCK:
        racedep.note_access("telemetry.registry", name, write=True)
        h = _HISTOGRAMS.get(name)
        if h is None:
            h = _HISTOGRAMS[name] = Histogram(name)
        return h


def register_gauge_fn(name: str, fn: Callable[[], object]) -> None:
    """Pull-gauge: `fn()` is sampled at snapshot/scrape time (memory
    watermarks, pool depths, cache sizes — zero hot-path cost).
    Re-registering replaces (sessions/pools recreate across tests)."""
    with _LOCK:
        _GAUGE_FNS[name] = fn


def reset() -> None:
    """Drop every instrument (tests only)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _GAUGE_FNS.clear()
        _HISTOGRAMS.clear()


# ---------------------------------------------------------------------
# built-in pull gauges: sampled lazily so the registry reflects live
# process state without any instrumentation on the hot paths
# ---------------------------------------------------------------------
def _builtin_gauges() -> Dict[str, object]:
    out: Dict[str, object] = {}
    try:
        from ..memory import diagnostics
        wm = diagnostics.watermarks_snapshot()
        out["memory_device_peak_bytes"] = wm.get("devicePeakBytes", 0)
        out["memory_host_peak_bytes"] = wm.get("hostPeakBytes", 0)
        for k, v in (wm.get("spill") or {}).items():
            out[f"spill_{k}"] = v
    except Exception:
        pass
    try:
        from . import tracing
        out["trace_spans_dropped"] = tracing.dropped_spans()
    except Exception:
        pass
    return out


def snapshot() -> dict:
    """The whole registry as one JSON-able dict."""
    with _LOCK:
        racedep.note_access("telemetry.registry")
        counters = {n: c.value for n, c in _COUNTERS.items()}
        gauges = {n: g.value for n, g in _GAUGES.items()}
        fns = dict(_GAUGE_FNS)
        hists = dict(_HISTOGRAMS)
    for n, fn in fns.items():
        try:
            v = fn()
        except Exception:
            continue
        if isinstance(v, dict):
            for k, sub in v.items():
                gauges[f"{n}_{k}"] = sub
        else:
            gauges[n] = v
    gauges.update(_builtin_gauges())
    return {"counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": {n: hists[n].summary()
                           for n in sorted(hists)}}


def _prom_name(name: str) -> str:
    return "srtpu_" + "".join(
        ch if ch.isalnum() or ch == "_" else "_" for ch in name)


def render_prometheus() -> str:
    """Prometheus text exposition (counters, gauges, and histograms as
    summary-typed quantile series)."""
    snap = snapshot()
    lines = []
    for n, v in snap["counters"].items():
        pn = _prom_name(n)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {v}")
    for n, v in snap["gauges"].items():
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            continue
        pn = _prom_name(n)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v}")
    for n, s in snap["histograms"].items():
        pn = _prom_name(n)
        lines.append(f"# TYPE {pn} summary")
        for q in ("p50", "p95", "p99"):
            if q in s:
                lines.append(
                    f'{pn}{{quantile="0.{q[1:]}"}} {s[q]}')
        lines.append(f"{pn}_sum {s['sum']}")
        lines.append(f"{pn}_count {s['count']}")
    return "\n".join(lines) + "\n"
