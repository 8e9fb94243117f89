"""Allocation diagnostics: the retry scope and its coverage, the memory
watermarks, per-query attribution and the leak check.

The port of the JAX package's `memory/diagnostics.py`, the analog of
the reference's AllocationRetryCoverageTracker.scala (which flags
device allocations made outside the OOM-retry framework: those are the
allocations that kill a query instead of spilling) and its shutdown
leak checks (Plugin.scala:625).

- `retry_scope` marks the dynamic extent of an OOM-retry region on a
  thread (`with_retry` / `retry_no_split` enter it). Coverage tracking
  is opt-in (`memory.retryCoverage.enabled`): when on, every
  `DeviceManager.reserve` records the engine call site and whether a
  retry scope was active; `coverage_report()` lists them.
- The device and host managers record their peak reservations
  (`watermarks_snapshot`) and, per query (the thread's
  `service/query_manager.py` scope), the bytes they hold and the spill
  pressure they caused (`query_attribution`).
- `leak_report(store)` / `assert_no_leaks(store)` show that every spill
  handle closed and every reservation returned. They take the store:
  the port keeps one store per conf and device, where the JAX package
  has one process-wide store (ROADMAP C.44).
"""
from __future__ import annotations

import sys
import threading
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["retry_scope", "in_retry_scope", "enable_retry_coverage",
           "record_allocation", "coverage_report", "reset_coverage",
           "leak_report", "assert_no_leaks", "record_device_watermark",
           "record_host_watermark", "reset_watermarks",
           "watermarks_snapshot", "record_query_bytes",
           "record_query_spill", "query_attribution",
           "reset_query_attribution"]

_tls = threading.local()
_enabled = False
_lock = threading.Lock()
# site -> [covered_count, uncovered_count]
_sites: Dict[str, list] = defaultdict(lambda: [0, 0])


class retry_scope:
    """Marks the dynamic extent of an OOM-retry region on this thread."""

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.depth = getattr(_tls, "depth", 1) - 1
        return False


def in_retry_scope() -> bool:
    return getattr(_tls, "depth", 0) > 0


def enable_retry_coverage(on: bool = True):
    global _enabled
    _enabled = on


_PKG = "spark_rapids_tpu_torch"


def _call_site() -> str:
    """The first frame of the engine outside `memory/`: the operator
    whose reservation this is."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if _PKG in fn and "/memory/" not in fn:
            short = fn.split(_PKG + "/", 1)[-1]
            return f"{short}:{f.f_lineno}"
        f = f.f_back
    return "<external>"


def record_allocation():
    """Called by DeviceManager.reserve when coverage tracking is on."""
    if not _enabled:
        return
    site = _call_site()
    with _lock:
        _sites[site][0 if in_retry_scope() else 1] += 1


def coverage_report() -> Dict[str, dict]:
    with _lock:
        return {s: {"covered": c, "uncovered": u}
                for s, (c, u) in sorted(_sites.items())}


def reset_coverage():
    with _lock:
        _sites.clear()


# -- memory watermarks ---------------------------------------------------
_WM_LOCK = threading.Lock()
_wm = {"devicePeakBytes": 0, "hostPeakBytes": 0}


def record_device_watermark(reserved_bytes: int):
    with _WM_LOCK:
        if reserved_bytes > _wm["devicePeakBytes"]:
            _wm["devicePeakBytes"] = reserved_bytes


def record_host_watermark(reserved_bytes: int):
    with _WM_LOCK:
        if reserved_bytes > _wm["hostPeakBytes"]:
            _wm["hostPeakBytes"] = reserved_bytes


def reset_watermarks():
    """Re-arm the peak gauges (the profiler calls this at query start;
    concurrent queries in one process share the gauges)."""
    with _WM_LOCK:
        _wm["devicePeakBytes"] = 0
        _wm["hostPeakBytes"] = 0


def watermarks_snapshot() -> dict:
    """Peak device and host reservations since the last reset, plus the
    spill stores' cumulative counters (summed over the process's
    stores), the host manager's pressure metrics and the current
    query's attribution (only for what already exists: reading a gauge
    must not make a memory manager)."""
    with _WM_LOCK:
        out = dict(_wm)
    from . import host as _host
    from . import spill as _spill
    with _spill._STORES_LOCK:
        stores = list(_spill._STORES.values())
    if stores:
        tot: Dict[str, int] = {}
        for st in stores:
            for k, v in st.metrics.items():
                tot[k] = tot.get(k, 0) + v
        out["spill"] = tot
    hm = _host._GLOBAL
    if hm is not None:
        out["hostPressure"] = dict(hm.metrics)
    qid = _current_query_id()
    if qid is not None:
        rec = query_attribution(qid)
        if rec:
            out["queryAttribution"] = rec
    return out


# -- per-query attribution ----------------------------------------------
# The action tags its threads with its query id (service/query_manager.py
# _query_scope); the memory managers report every reserve / release /
# spill-pressure event here, so concurrent queries' footprints stay
# separable in the event log.
_QA_LOCK = threading.Lock()
# query_id -> {"deviceBytes", "devicePeakBytes", "hostBytes",
#              "hostPeakBytes", "spillPressureBytes"}
_query_attr: Dict[str, dict] = {}


def _current_query_id():
    from ..service.query_manager import current_query_id
    return current_query_id()


def _record(qid: str) -> dict:
    # caller holds _QA_LOCK
    return _query_attr.setdefault(qid, {
        "deviceBytes": 0, "devicePeakBytes": 0,
        "hostBytes": 0, "hostPeakBytes": 0,
        "spillPressureBytes": 0})


def record_query_bytes(kind: str, delta: int):
    """Attribute a device or host reservation delta (`kind` 'device'
    or 'host', delta signed) to the current thread's query, if any."""
    qid = _current_query_id()
    if qid is None:
        return
    with _QA_LOCK:
        rec = _record(qid)
        cur_key, peak_key = f"{kind}Bytes", f"{kind}PeakBytes"
        rec[cur_key] = max(0, rec[cur_key] + int(delta))
        if rec[cur_key] > rec[peak_key]:
            rec[peak_key] = rec[cur_key]


def record_query_spill(nbytes: int):
    """Attribute spill pressure (bytes the spill cascade was asked to
    free) to the query that triggered it."""
    qid = _current_query_id()
    if qid is None:
        return
    with _QA_LOCK:
        _record(qid)["spillPressureBytes"] += int(nbytes)


def query_attribution(query_id: Optional[str] = None):
    """Attribution snapshot: one query's record, or all of them."""
    with _QA_LOCK:
        if query_id is not None:
            return dict(_query_attr.get(query_id) or {})
        return {q: dict(r) for q, r in _query_attr.items()}


def reset_query_attribution(query_id: Optional[str] = None):
    with _QA_LOCK:
        if query_id is None:
            _query_attr.clear()
        else:
            _query_attr.pop(query_id, None)


# -- leak checking ------------------------------------------------------
def leak_report(store) -> dict:
    """The store's open spill handles (count and bytes, by state and
    priority) and its device manager's outstanding reservation."""
    with store._lock:
        handles = list(store._handles.values())
    by_state: Dict[str, int] = defaultdict(int)
    by_prio: Dict[int, int] = defaultdict(int)
    total = 0
    for h in handles:
        by_state[str(h.state)] += 1
        by_prio[h.priority] += 1
        total += h.nbytes
    return {"openHandles": len(handles), "openBytes": total,
            "byState": dict(by_state), "byPriority": dict(by_prio),
            "deviceReservedBytes": store.dm.reserved}


def assert_no_leaks(store, allow_reserved_bytes: int = 0):
    """Raises when spill handles remain open or the device reservation
    exceeds `allow_reserved_bytes`."""
    rep = leak_report(store)
    if rep["openHandles"] or rep["deviceReservedBytes"] \
            > allow_reserved_bytes:
        raise AssertionError(f"resource leak: {rep}")
