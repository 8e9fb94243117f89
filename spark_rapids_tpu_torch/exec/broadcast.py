"""Broadcast exchange: the build side of a broadcast hash join, collected
once, on a background thread when the join asks for it.

The port of the JAX package's `exec/broadcast.py` (`:33-165`; the
reference's GpuBroadcastExchangeExec). The node owns its materialized
batches, so every consumer (a reused duplicate too) shares one build
under the instance lock. With `sql.exec.exchange.asyncBroadcast.enabled`
the join calls `submit_build` when it starts, works on its stream side
while the build runs on the `_build_pool`, and waits in `await_build`,
bounded by `sql.exec.exchange.broadcastTimeoutSecs`.

On the card the build thread enqueues on the CUDA stream that was
current on the submitting thread, so every kernel of the build is
ordered before the probe's, which the joining thread enqueues after the
build returns. An exception raised in the build reaches the caller of
`await_build`. On timeout the waiting thread counts
`broadcastTimeoutFallbacks` and joins the build (or, if it has not
started, runs it): the build never runs twice at once (the instance
lock hands it to one thread, which builds outside the lock while the
others wait for it). A build whose subtree holds another broadcast join
runs that nested build inline (`on_build_pool`): waiting on the pool
from one of its own workers could park every worker behind itself. The
build is a `broadcast.build` span of the query's trace, and a join's
wait for it a back-dated `broadcast.await_build` span (kind
`pool_wait`). The instance locks are lockdep's
`BroadcastExchangeExec._lock` and `._future_lock`, and `await_build`
checks that no build worker waits on its own pool
(`lockdep.check_pool_wait`).
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import List, Optional

import torch

from ..profiler import tracing
from ..runtime import lockdep
from ..service.query_manager import _query_scope, current_query_id
from .base import ExecContext, Once, TpuExec

__all__ = ["BroadcastExchangeExec", "on_build_pool", "BUILD_POOL_PREFIX"]

_POOL_LOCK = threading.Lock()
_POOL = None

# the build pool's worker-name prefix, which on_build_pool() keys off
BUILD_POOL_PREFIX = "tpu-bcast-build"


def _build_pool():
    """The shared daemon pool of async broadcast builds."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = cf.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix=BUILD_POOL_PREFIX)
        return _POOL


def on_build_pool() -> bool:
    """Whether the current thread is a broadcast-build pool worker."""
    return threading.current_thread().name.startswith(BUILD_POOL_PREFIX)


class BroadcastExchangeExec(TpuExec):
    def __init__(self, child: TpuExec, schema):
        super().__init__([child], schema)
        self._lock = lockdep.rlock("BroadcastExchangeExec._lock")
        self._batches: Once[List] = Once(self._lock)
        self._future = None
        self._future_lock = lockdep.lock(
            "BroadcastExchangeExec._future_lock")
        self._submit_t: Optional[float] = None

    def describe(self):
        return "BroadcastExchangeExec"

    def num_partitions(self, ctx):
        return 1

    def _materialize(self, ctx: ExecContext) -> List:
        """The build, once (`Once`: it runs outside the instance lock)."""
        return self._batches.get(lambda: self._build(ctx))

    def _build(self, ctx: ExecContext) -> List:
        child = self.children[0]
        out = []
        with ctx.timer(self._op_id, "buildTime"):
            for bpid in range(child.num_partitions(ctx)):
                out.extend(child.execute_partition(ctx, bpid))
        ctx.add_metric(self._op_id, "numOutputBatches", len(out))
        return out

    def build_done(self) -> bool:
        """Whether the build is ready without blocking."""
        if self._batches.value is not None:
            return True
        f = self._future
        return f is not None and f.done()

    def submit_build(self, ctx: ExecContext):
        """Start the build on the pool; one future per instance, shared
        by every consumer."""
        with self._future_lock:
            if self._future is None:
                self._submit_t = time.perf_counter()
                stream = (torch.cuda.current_stream(ctx.device)
                          if ctx.device is not None
                          and ctx.device.type == "cuda" else None)
                tc = ctx.trace or tracing.current()
                qid = current_query_id()

                def _build_task():
                    # the build runs on a pool thread: seed it with the
                    # submitting query's trace context and query scope
                    with _query_scope(qid), tracing.use(tc), tracing.span(
                            "broadcast.build", "pool_task"):
                        if stream is None:
                            return self._materialize(ctx)
                        with torch.cuda.stream(stream):
                            return self._materialize(ctx)

                self._future = _build_pool().submit(_build_task)
            return self._future

    def await_build(self, ctx: ExecContext, timeout_secs: float) -> List:
        """The build's batches, waiting at most timeout_secs (0: forever);
        past it, count the fallback and join or run the build on this
        thread."""
        fut = self.submit_build(ctx)
        # blocking on a build future from a build worker parks the
        # bounded pool behind itself (the join's on_build_pool() gate
        # makes this unreachable; the witness proves it stays that way)
        lockdep.check_pool_wait(BUILD_POOL_PREFIX)
        t_await = time.perf_counter()
        try:
            batches = fut.result(timeout_secs if timeout_secs
                                 and timeout_secs > 0 else None)
        except cf.TimeoutError:
            ctx.add_metric(self._op_id, "broadcastTimeoutFallbacks", 1)
            fut.cancel()        # a build not yet started runs here
            batches = self._materialize(ctx)
        # the time the join was blocked on the build: a pool_wait edge
        # of the critical path (the overlap before it is free)
        waited = time.perf_counter() - t_await
        if waited > 1e-3:
            tracing.record_wait_span("broadcast.await_build", "pool_wait",
                                     waited * 1e3, ctx)
        # the build time that ran while the stream side worked
        if self._submit_t is not None:
            overlap = max(0.0, t_await - self._submit_t)
            ctx.add_metric(self._op_id, "broadcastBuildOverlapMs",
                           round(overlap * 1e3, 3))
            self._submit_t = None
        return batches

    def execute_partition(self, ctx: ExecContext, pid: int):
        yield from self._materialize(ctx)
