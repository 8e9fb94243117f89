"""Allocation diagnostics: the retry scope, the memory watermarks and the
leak check.

The port of the part of the JAX package's `memory/diagnostics.py` the
memory runtime needs: `retry_scope` marks the dynamic extent of an
OOM-retry region on a thread (`with_retry` / `retry_no_split` enter
it), the device and host managers record their peak reservations, and
`leak_report` / `assert_no_leaks` show that every spill handle closed
and every reservation returned (the reference's shutdown leak checks,
Plugin.scala:625). Per-query attribution and the retry-coverage report
are not ported.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict

__all__ = ["retry_scope", "in_retry_scope", "record_device_watermark",
           "record_host_watermark", "reset_watermarks",
           "watermarks_snapshot", "leak_report", "assert_no_leaks"]

_tls = threading.local()


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
    with _WM_LOCK:
        _wm["devicePeakBytes"] = 0
        _wm["hostPeakBytes"] = 0


def watermarks_snapshot() -> dict:
    """Peak device and host reservations since the last reset."""
    with _WM_LOCK:
        return dict(_wm)


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
