"""Asynchronous write path with host-memory traffic control.

The JAX package's `io/async_io.py`, copied (reference: the io/async
package, `AsyncOutputStream.scala`, `TrafficController.scala`): file
encode and disk I/O run on a small writer pool off the thread that runs
the plan, while a TrafficController bounds the host bytes held by
scheduled-but-unfinished writes so a slow disk cannot pile the whole
query's output into host memory. The pool does host work only: every
device-to-host copy has already happened on the plan's thread, so no
pool thread touches a CUDA tensor.

The unit of work is a whole output FILE part (an Arrow table already on
the host), not a stream chunk. Throttling, deferred error propagation
and the always-admit-one rule match the reference's TrafficController.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

from ..service.query_manager import _query_scope, current_query_id

__all__ = ["TrafficController", "AsyncWriteQueue", "controller_for",
           "async_stats"]


class TrafficController:
    """Bounds total in-flight (scheduled, unfinished) write bytes.

    `acquire(nbytes)` blocks while admitting the task would exceed the
    budget — EXCEPT when nothing is in flight, where one task is always
    admitted so a single file larger than the budget still writes
    (reference: TrafficController's ThrottlingAppender always admits
    the first buffer)."""

    def __init__(self, max_in_flight_bytes: int, host_mgr=None):
        self.max_bytes = int(max_in_flight_bytes)
        self.host_mgr = host_mgr
        self._bytes = 0
        self._tasks = 0
        self._wait_s = 0.0
        self._cv = threading.Condition()

    def acquire(self, nbytes: int):
        import time
        t0 = time.monotonic()
        with self._cv:
            while (self._tasks > 0
                   and self._bytes + nbytes > self.max_bytes):
                self._cv.wait(timeout=0.5)
            self._bytes += nbytes
            self._tasks += 1
            self._wait_s += time.monotonic() - t0
        if self.host_mgr is not None:
            # in-flight write buffers draw from the GLOBAL host budget
            # (memory/host.py): pressure demotes the spill store's
            # host tier to disk; bounded wait, then soft-admit (a
            # deferred write error must never deadlock the pipeline)
            from ..memory.host import HostBudgetExceeded
            deadline = time.monotonic() + 30
            while True:
                try:
                    self.host_mgr.reserve(nbytes)
                    return
                except HostBudgetExceeded:
                    if time.monotonic() > deadline:
                        # soft-admit: charge anyway so every release
                        # pairs; later reservations see the pressure
                        self.host_mgr.force_reserve(nbytes)
                        return
                    time.sleep(0.1)

    def release(self, nbytes: int):
        if self.host_mgr is not None:
            self.host_mgr.release(nbytes)
        with self._cv:
            self._bytes -= nbytes
            self._tasks -= 1
            self._cv.notify_all()

    @property
    def in_flight_bytes(self) -> int:
        with self._cv:
            return self._bytes

    @property
    def throttle_wait_seconds(self) -> float:
        with self._cv:
            return self._wait_s


class AsyncWriteQueue:
    """Schedules file-part writes on a writer pool under a
    TrafficController budget. Submission never reorders *naming* (the
    caller assigns part numbers before submit); completion order is
    irrelevant because parts are independent files. The first failure
    is re-raised on the next submit or on drain() — the reference's
    deferred-exception contract (`AsyncOutputStream.scala` lastError)."""

    def __init__(self, controller: TrafficController, num_threads: int):
        self.controller = controller
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, num_threads),
            thread_name_prefix="tpu-async-write")
        self._futures: List = []
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def _raise_if_failed(self):
        with self._lock:
            if self._error is not None:
                err = self._error
                raise RuntimeError(
                    f"async write failed: {err}") from err

    def submit(self, nbytes: int, fn: Callable, *args):
        """Blocks under the byte budget, then schedules fn(*args)."""
        self._raise_if_failed()
        self.controller.acquire(nbytes)
        # the write works for the submitting query: carry its scope
        qid = current_query_id()

        def run():
            try:
                with _query_scope(qid):
                    return fn(*args)
            except BaseException as e:      # noqa: BLE001 - deferred
                with self._lock:
                    if self._error is None:
                        self._error = e
                raise
            finally:
                self.controller.release(nbytes)

        self._futures.append(self._pool.submit(run))

    def drain(self) -> list:
        """Waits for every scheduled write; returns their results in
        submission order. Raises the first failure."""
        out = []
        try:
            for f in self._futures:
                try:
                    out.append(f.result())
                except Exception:       # task errors are recorded by the
                    pass                # wrapper and re-raised below;
                                        # KeyboardInterrupt etc propagate
        finally:
            self._futures = []
        self._raise_if_failed()
        return out

    def close(self):
        try:
            self.drain()
        finally:
            self._pool.shutdown(wait=True)


# -- per-conf controller (one budget per session conf, like the
# reference's one TrafficController per executor plugin). Stored ON the
# conf object: id()-keyed registries leak and can alias a recycled id
# to a stale controller with the wrong budget ---------------------------
_controllers_lock = threading.Lock()


def controller_for(conf) -> TrafficController:
    from ..config import ASYNC_WRITE_MAX_IN_FLIGHT
    with _controllers_lock:
        c = getattr(conf, "_srtpu_async_controller", None)
        if c is None:
            from ..memory.host import host_manager
            c = TrafficController(conf.get(ASYNC_WRITE_MAX_IN_FLIGHT),
                                  host_mgr=host_manager(conf))
            try:
                conf._srtpu_async_controller = c
            except AttributeError:
                pass        # conf forbids attributes: fresh per call
        return c


def async_stats(conf) -> dict:
    """Observability hook: current in-flight bytes + cumulative
    throttle wait for the conf's controller."""
    c = controller_for(conf)
    return {"inFlightBytes": c.in_flight_bytes,
            "throttleWaitSeconds": c.throttle_wait_seconds}
