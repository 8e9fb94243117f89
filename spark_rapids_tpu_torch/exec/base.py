"""Physical operator base: columnar and pull-based.

Every operator yields DeviceBatches per partition. The ExecContext
carries the conf snapshot and the torch device the query runs on, so
scans upload there and every op works on tensors already there, and the
run's memory resources: the device manager and spill store of its conf
and device (the session's), the session (for its semaphore), and the
spill handles operators registered, which `close()` closes when the run
ends (an operator closes its own handles as it goes; the registry
catches a generator abandoned mid-stream), and the run's shared
materializations (`shared_handles`: a SharedBuildExec's parked batches,
which several consumers read, so none of them closes them), which
`close()` closes too (JAX `exec/base.py:56`, `:72-79`). It also
carries the metric level and the `sql.metrics.sync` barrier of its conf
(`utils/metrics.py`), and the query's trace context (`trace`, None when
tracing is off; `profiler/tracing.py`).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Generic, Iterator, List, Optional, TypeVar

import torch

from ..columnar.table import Schema
from ..config import METRICS_LEVEL, METRICS_SYNC, TpuConf
from ..runtime import lockdep, racedep
from ..utils.metrics import parse_level, stream_barrier
from .batch import DeviceBatch

__all__ = ["TpuExec", "ExecContext", "OpMetrics", "collapse_fusable",
           "Once"]

T = TypeVar("T")


class Once(Generic[T]):
    """A value an operator computes once for all its consumers (an
    exchange's map side, a broadcast's build). The owner's instance lock
    guards the handoff only: the first caller computes outside it while
    later callers wait for its end, and run the computation themselves
    if it failed. So no lock is held while the operator's subtree runs
    (ROADMAP C.5). `clear()` drops the value; a computation running at
    that moment returns to its own caller and publishes nothing."""

    def __init__(self, lock):
        self._lock = lock
        self._value: Optional[T] = None
        self._running: Optional[threading.Event] = None
        self._epoch = 0             # bumped by clear()

    @property
    def value(self) -> Optional[T]:
        """The value if computed, without blocking; else None."""
        return self._value

    def get(self, compute: Callable[[], T]) -> T:
        while True:
            with self._lock:
                if self._value is not None:
                    return self._value
                running = self._running
                if running is None:
                    running = self._running = threading.Event()
                    epoch = self._epoch
                    break
            running.wait()
        try:
            value = compute()
            with self._lock:
                if epoch == self._epoch:
                    self._value = value
            return value
        finally:
            with self._lock:
                self._running = None
            running.set()

    def clear(self):
        with self._lock:
            self._value = None
            self._epoch += 1



class ExecContext:
    """Per-query execution context: conf snapshot, device, metrics. A
    scan's prefetch thread and a broadcast build's thread add metrics
    beside the calling thread, so every update holds a lock, and notes
    its access to the data-race witness (`runtime/racedep.py`, the JAX
    package's `MetricSet._values`). `planning`
    marks the planner's probes (`num_partitions` at plan time), which
    must not materialize an adaptive stage."""

    def __init__(self, conf: TpuConf, device: torch.device,
                 planning: bool = False, session=None):
        self.conf = conf
        self.device = device
        self.planning = planning
        self.session = session
        # the action's query id (`DataFrame._action`); the caller runs the
        # plan under `_query_scope(ctx.query_id)`
        self.query_id: Optional[str] = None
        self.metrics: Dict[str, Dict[str, float]] = {}
        # the metric store's lock (the JAX package's MetricSet._lock),
        # which also guards the handles and the degrade state
        self._lock = lockdep.lock("MetricSet._lock")
        self._handles: List = []
        # SharedBuildExec's per-run materialization cache:
        # {id(node): {pid: [spill handles]}}, closed by close()
        self.shared_handles: Dict[int, dict] = {}
        # device->host degradation state (exec/degrade.py): device
        # failures a node, the nodes pinned to the host for the rest of
        # the query, and the degrade_to_host events
        self.device_failures: Dict[str, int] = {}
        self.degraded: Dict[str, bool] = {}
        self.pending_events: List[dict] = []
        # metric verbosity and the conf-gated device barrier in timers
        # (utils/metrics.py on the asynchronous-launch timer skew)
        self.metrics_level = parse_level(conf.get(METRICS_LEVEL))
        self.metrics_sync = bool(conf.get(METRICS_SYNC))
        # the query's trace (profiler/tracing.py): its context, the
        # root span the session opened and, once finished, the
        # critical-path summary; None when tracing is off
        self.trace = None
        self._root_span = None
        self.trace_summary = None

    @property
    def device_manager(self):
        from ..memory.device import device_manager
        return device_manager(self.conf, self.device)

    @property
    def spill_store(self):
        from ..memory.spill import spill_store
        return spill_store(self.conf, self.device)

    def track(self, handle):
        """Register a spill handle for `close()`; returns it."""
        with self._lock:
            self._handles.append(handle)
        return handle

    def close(self):
        """Release the run's resources: every registered spill handle
        still open and every shared materialization closes (close is
        idempotent)."""
        with self._lock:
            handles, self._handles = self._handles, []
            shared, self.shared_handles = self.shared_handles, {}
        for per_node in shared.values():
            for hs in per_node.values():
                handles.extend(hs)
        for h in handles:
            h.close()

    def add_metric(self, op_id: str, name: str, value: float):
        with self._lock:
            racedep.note_access("MetricSet._values", f"{op_id}.{name}",
                                write=True)
            m = self.metrics.setdefault(op_id, {})
            m[name] = m.get(name, 0) + value

    def set_metric(self, op_id: str, name: str, value: float):
        with self._lock:
            racedep.note_access("MetricSet._values", f"{op_id}.{name}",
                                write=True)
            self.metrics.setdefault(op_id, {})[name] = value

    def metrics_for(self, op_id: str) -> "OpMetrics":
        return OpMetrics(self, op_id)

    @contextlib.contextmanager
    def timer(self, op_id: str, name: str):
        """Adds the host seconds spent in the block to a metric. Device
        work is asynchronous: a block that ends in a host sync (a D2H
        copy) also absorbs the device work queued before it; under
        `sql.metrics.sync` every timer waits for the device before it
        stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.metrics_sync:
                stream_barrier(self.device)
            self.add_metric(op_id, name, time.perf_counter() - t0)


class OpMetrics:
    """One operator's metrics in an ExecContext (`add`, `set`, `timer`),
    for code that records on an operator's behalf."""

    def __init__(self, ctx: ExecContext, op_id: str):
        self.ctx = ctx
        self.op_id = op_id

    def add(self, name: str, value: float):
        self.ctx.add_metric(self.op_id, name, value)

    def set(self, name: str, value: float):
        self.ctx.set_metric(self.op_id, name, value)

    def timer(self, name: str):
        return self.ctx.timer(self.op_id, name)


class TpuExec:
    """Base physical operator."""

    def __init__(self, children: List["TpuExec"], schema: Schema):
        self.children = children
        self._schema = schema
        self._op_id = f"{type(self).__name__}@{id(self):x}"

    @property
    def schema(self) -> Schema:
        return self._schema

    def node_name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.node_name()

    def num_partitions(self, ctx: ExecContext) -> int:
        if self.children:
            return self.children[0].num_partitions(ctx)
        return 1

    def execute_partition(self, ctx: ExecContext,
                          pid: int) -> Iterator[DeviceBatch]:
        raise NotImplementedError

    def release(self):
        """Free long-lived resources this operator holds (recursing into
        its children)."""
        for c in self.children:
            c.release()

    def fusable_stage(self):
        """A pure per-batch transform (cvs, mask) -> (cvs, mask) that a
        parent may apply inline, or None."""
        return None

    def preserves_ordinals(self) -> bool:
        """Does fusable_stage keep the child's columns where they were (a
        filter does, a projection does not)?"""
        return False

    def execute_all(self, ctx: ExecContext) -> Iterator[DeviceBatch]:
        for pid in range(self.num_partitions(ctx)):
            yield from self.execute_partition(ctx, pid)


def collapse_fusable(node: TpuExec, require_ordinals: bool = False):
    """Walk down a chain of filter/project stages and return
    (base_child, composed_fn, n_stages); composed_fn applies the stages
    bottom-up to a base batch's (cvs, mask). require_ordinals stops at a
    stage that renumbers columns, for a parent that reads the base
    batch's columns by ordinal."""
    stages = []
    while True:
        fn = node.fusable_stage()
        if fn is None or (require_ordinals
                          and not node.preserves_ordinals()):
            break
        stages.append(fn)
        node = node.children[0]
    stages.reverse()

    def composed(cvs, mask):
        for fn in stages:
            cvs, mask = fn(cvs, mask)
        return cvs, mask

    return node, composed, len(stages)
