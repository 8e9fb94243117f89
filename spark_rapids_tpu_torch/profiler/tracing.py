"""Per-query tracing: spans with context propagation, the port of the
JAX package's `profiler/tracing.py`.

The event log (profiler/event_log.py) records WHAT happened; spans
record WHERE the wall clock went once a query fans out across the
adaptive stage driver and the exchange-map and broadcast-build pools.
One trace per query (trace_id == query_id), assembled into
`trace_span` records in the query's event log and reduced to latency
shares by profiler/critical_path.py.

Design constraints, in order:

1. CHEAP WHEN OFF. `span()` resolves the active TraceContext with one
   attribute read; an unsampled/disabled trace yields a shared no-op
   span and touches nothing else. Spans open per stage, per map task
   and per build, never per batch.
2. ONE TRACE PER QUERY ACROSS THREADS. The context is three fields
   (trace_id, span_id, sampled) and rides `ExecContext.trace` on the
   query thread and a thread-local on worker threads (`use()`: the
   exchange map pool, the broadcast build pool). The JAX module's
   propagation across the cluster RPC boundary (`to_wire`,
   `inject_into_conf`, `adopt_from_conf`, `absorb_spans`) and its
   admission-queue span wait for the cluster and service layers
   (ROADMAP A.15).
3. CLOCKS. start/end are `time.time_ns()`; durations additionally
   carry the monotonic-derived `dur_ms` so a clock step cannot corrupt
   a span's own length.

Span records are plain dicts (JSON-able):

  {trace_id, span_id, parent_id, name, kind, start_ns, end_ns,
   dur_ms, proc, attrs?}

Every span MUST be closed via `with span(...)` or a try/finally around
`open_span`/`Span.end`.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import zlib
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["TraceContext", "Span", "start_trace", "current", "use",
           "span", "open_span", "record_span", "drain_trace",
           "record_wait_span", "finish", "dropped_spans"]

_SEQ = itertools.count(1)
_TLS = threading.local()

_LOCK = threading.Lock()
_TRACES: Dict[str, List[dict]] = {}     # trace_id -> finished span dicts
#: cap per trace: a runaway span producer must not grow memory without
#: bound; overflow increments the dropped counter instead (the
#: telemetry registry surfaces it)
_MAX_SPANS_PER_TRACE = 4096
_DROPPED = [0]
#: traces already finished: a straggler span (a pool task outliving its
#: query) must not re-create the trace's buffer, which would never be
#: drained again. Bounded ring of recent trace ids; membership drops
#: the span (counted).
_CLOSED: "OrderedDict[str, bool]" = OrderedDict()
_MAX_CLOSED = 512


def _new_span_id() -> str:
    # pid-prefixed so the ids of two processes never collide
    return f"{os.getpid():x}.{next(_SEQ):x}"


class TraceContext:
    """The three propagated fields; immutable by convention."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: Optional[str],
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"sampled={self.sampled})")


class Span:
    """One open span. End it exactly once (with-statement or finally);
    ending records the finished dict into the per-trace buffer."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "start_ns", "attrs", "_t0", "_done", "_restore")

    def __init__(self, trace_id, span_id, parent_id, name, kind, attrs):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter()
        self._done = False
        self._restore = None

    def set(self, key: str, value) -> None:
        """Attach one attribute (retry counts, byte sizes, fault tags)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        dur = time.perf_counter() - self._t0
        rec = {"trace_id": self.trace_id, "span_id": self.span_id,
               "parent_id": self.parent_id, "name": self.name,
               "kind": self.kind, "start_ns": self.start_ns,
               "end_ns": self.start_ns + int(dur * 1e9),
               "dur_ms": round(dur * 1e3, 4),
               "proc": os.getpid()}
        if self.attrs:
            rec["attrs"] = self.attrs
        record_span(rec)


class _NoopSpan:
    __slots__ = ()

    def set(self, key, value):
        pass

    def end(self):
        pass


_NOOP = _NoopSpan()


# ---------------------------------------------------------------------
# context resolution
# ---------------------------------------------------------------------
def start_trace(query_id: str, conf) -> Optional[TraceContext]:
    """Root TraceContext for a query, or None when tracing is off or
    this query is sampled out. Sampling is DETERMINISTIC on the query
    id (crc32 bucket vs sql.trace.sampleRate), so every thread of a
    query agrees on the decision without any coordination."""
    from ..config import TRACE_ENABLED, TRACE_SAMPLE_RATE
    if not conf.get(TRACE_ENABLED):
        return None
    rate = float(conf.get(TRACE_SAMPLE_RATE))
    if rate <= 0.0:
        return None
    if rate < 1.0:
        bucket = zlib.crc32(query_id.encode("utf-8")) % 10000
        if bucket >= rate * 10000:
            return None
    return TraceContext(query_id, None, True)


def current() -> Optional[TraceContext]:
    """The thread's active TraceContext (None off-trace)."""
    return getattr(_TLS, "ctx", None)


@contextmanager
def use(tc: Optional[TraceContext]):
    """Install `tc` as this thread's context for the duration: the
    bridge onto worker threads (pool map tasks, broadcast builds) that
    have no ExecContext of their own."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = tc
    try:
        yield tc
    finally:
        _TLS.ctx = prev


def _resolve(ctx) -> Optional[TraceContext]:
    """TraceContext from an explicit TraceContext / ExecContext-like
    carrier, falling back to the thread-local."""
    if ctx is not None:
        if isinstance(ctx, TraceContext):
            return ctx if ctx.sampled else None
        tc = getattr(ctx, "trace", None)
        if tc is not None:
            return tc if tc.sampled else None
    return getattr(_TLS, "ctx", None)


# ---------------------------------------------------------------------
# span lifecycle
# ---------------------------------------------------------------------
def open_span(name: str, kind: str, ctx=None, **attrs):
    """Open a span without the with-statement (callers that must end it
    in an async callback, or the query's root span). MUST be paired
    with `.end()` in a finally. Returns a no-op span off-trace."""
    tc = _resolve(ctx)
    if tc is None:
        return _NOOP
    return Span(tc.trace_id, _new_span_id(), tc.span_id, name, kind,
                attrs or None)


@contextmanager
def span(name: str, kind: str, ctx=None, **attrs):
    """Open/close one span around a block. While the block runs, the
    thread-local context points at this span, so nested `span()` calls
    (and worker threads seeded via `use(current())`) parent under it."""
    tc = _resolve(ctx)
    if tc is None:
        yield _NOOP
        return
    sp = Span(tc.trace_id, _new_span_id(), tc.span_id, name, kind,
              attrs or None)
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = TraceContext(tc.trace_id, sp.span_id, True)
    try:
        yield sp
    finally:
        _TLS.ctx = prev
        sp.end()


def record_span(rec: dict) -> None:
    """Append one finished span to its trace buffer (bounded)."""
    with _LOCK:
        if rec["trace_id"] in _CLOSED:
            _DROPPED[0] += 1          # straggler after the query ended
            return
        buf = _TRACES.setdefault(rec["trace_id"], [])
        if len(buf) >= _MAX_SPANS_PER_TRACE:
            _DROPPED[0] += 1
            return
        buf.append(rec)


def record_wait_span(name: str, kind: str, wait_ms, ctx=None,
                     **attrs) -> None:
    """Synthesize a back-dated span for a wait that already happened
    (pool-permit waits, a join's wait for its broadcast build) measured
    after the fact. One TLS read and out when off-trace."""
    tc = _resolve(ctx)
    if tc is None or not wait_ms or wait_ms <= 0:
        return
    now = time.time_ns()
    rec = {"trace_id": tc.trace_id, "span_id": _new_span_id(),
           "parent_id": tc.span_id, "name": name, "kind": kind,
           "start_ns": now - int(wait_ms * 1e6), "end_ns": now,
           "dur_ms": round(float(wait_ms), 4), "proc": os.getpid()}
    if attrs:
        rec["attrs"] = attrs
    record_span(rec)


def drain_trace(trace_id: str, close: bool = True) -> List[dict]:
    """Remove and return the trace's finished spans, start-ordered.

    `close=True` (at query end) additionally marks the trace finished
    so stragglers are dropped instead of re-creating an undrainable
    buffer."""
    with _LOCK:
        spans = _TRACES.pop(trace_id, [])
        if close:
            _CLOSED[trace_id] = True
            _CLOSED.move_to_end(trace_id)
            while len(_CLOSED) > _MAX_CLOSED:
                _CLOSED.popitem(last=False)
    spans.sort(key=lambda s: s.get("start_ns", 0))
    return spans


def finish(ctx, wall_s=None) -> List[dict]:
    """Close out a query's trace from its ExecContext: end the root
    span, drain the assembled spans, store the critical-path summary on
    `ctx.trace_summary` and feed the per-category share histograms of
    the live telemetry registry. Idempotent; returns the drained spans
    (empty on a later call or off-trace)."""
    tc = getattr(ctx, "trace", None)
    rsp = getattr(ctx, "_root_span", None)
    if tc is None or rsp is None:
        return []
    rsp.end()
    spans = drain_trace(tc.trace_id)
    if not spans:
        return []
    from . import critical_path
    summ = critical_path.summarize(spans, wall_s)
    ctx.trace_summary = summ
    if summ is not None:
        try:
            from . import telemetry
            for c, pct in summ["share_pct"].items():
                telemetry.histogram(
                    f"critical_path_share_pct_{c}").observe(pct)
        except Exception:
            pass
    return spans


def dropped_spans() -> int:
    with _LOCK:
        return _DROPPED[0]
