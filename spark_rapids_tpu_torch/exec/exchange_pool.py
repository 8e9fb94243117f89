"""The bounded worker pool of an exchange's map side.

The port of the JAX package's `exec/exchange_pool.py` (reference:
RapidsShuffleThreadedWriter: the multithreaded shuffle writer runs map
tasks on a bounded pool while the GpuSemaphore still bounds DEVICE
admission). Two pieces live here:

- `resolve_map_threads`: `sql.exec.exchange.mapThreads` -> the pool's
  width (0 = auto, min(4, cores)), clamped to the partition count.
- `PermitRider`: device admission for map workers that cannot deadlock
  against the caller's own TpuSemaphore permit.

The deadlock `PermitRider` avoids: the thread that materializes an
exchange usually HOLDS a permit already (`collect_to_arrow`'s task
acquires one around `next(it)`, and advancing the iterator is what
runs the map side). With `sql.concurrentTpuTasks` = 1, map workers that
block in `sem.acquire` would wait forever for a permit their own caller
holds; with chained exchanges every real permit can be held by collect
tasks that themselves wait on this exchange's lock. So ONE worker at a
time rides the caller's permit, and every other worker polls: it takes
a real permit only when one is free (`try_acquire`), and otherwise
waits briefly for the ride slot. The pool always progresses (at worst
it runs one step at a time on the ridden permit), and the device never
runs more tasks than there are permits: the ride spends admission the
calling task already holds.

An admission wait that stalled a step over a millisecond is a
back-dated `exchange.pool_admission` span (kind `pool_wait`) in the
query's trace, as in the JAX package. A ride is noted to the lock-order
witness as `PermitRider.ride` and to the resource ledger as the `ride`
kind; a real permit notes itself in `TpuSemaphore`.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import contextmanager

from ..runtime import ledger, lockdep

__all__ = ["resolve_map_threads", "PermitRider"]

#: the longest a step that caught an OOM waits for the others to end
_ALONE_WAIT_S = 10.0


def resolve_map_threads(ctx, nparts: int) -> int:
    """Pool width for an exchange's map side: the conf's value, 0 = auto
    (min(4, cpu cores)), clamped to the partition count."""
    from ..config import EXCHANGE_MAP_THREADS
    t = ctx.conf.get(EXCHANGE_MAP_THREADS)
    if t is None or int(t) <= 0:
        t = min(4, os.cpu_count() or 1)
    return max(1, min(int(t), max(nparts, 1)))


class PermitRider:
    """Grants map workers admission for one device step each (see the
    module docstring):

        with rider.step():
            hosts = with_retry(batch, map_one)

    The seconds workers waited for admission add up in `waited_secs`
    (the exchange's `mapPoolWaitMs`).

    Under memory pressure a step runs alone: an OOM caught inside a step
    (the scan's upload, the map pass) recovers and retries only after
    every other worker's step in flight has ended, and no step starts
    meanwhile, so the retry meets the device as the serial map side
    would. Steps that wait to run alone go in the order they asked; one
    that fails again while running alone, with others waiting (each
    holding its batch), lets them go first. Each wait is bounded by
    `_ALONE_WAIT_S` (a step that waits on something the retrying worker
    holds, such as a chained exchange it is materializing, cannot
    deadlock the pool); `alone_steps` counts the steps that ran alone
    (the exchange's `mapPoolAloneSteps`)."""

    #: the lockdep resource key of the ride slot (any instance)
    RIDE = "PermitRider.ride"

    def __init__(self, sem):
        self._sem = sem
        self._rider = threading.Semaphore(1)
        self._lock = threading.Lock()
        self._gate = threading.Condition(self._lock)
        self._waited = 0.0
        self._riding = None     # the thread on the ride slot
        self._active = 0        # admitted steps in flight, not alone
        self._queue = collections.deque()   # steps waiting to run alone
        self._alone = None      # the thread whose step runs alone
        self._alone_steps = 0

    @property
    def waited_secs(self) -> float:
        with self._lock:
            return self._waited

    @property
    def alone_steps(self) -> int:
        with self._lock:
            return self._alone_steps

    def debug_state(self) -> dict:
        """Who rides the caller's permit, who runs alone, and the seconds
        waited so far."""
        with self._lock:
            return {"riding": self._riding, "alone": self._alone,
                    "active": self._active, "waitedSecs": self._waited}

    @contextmanager
    def step(self):
        # Never block indefinitely in `sem.acquire` (see the module
        # docstring): alternate between the ride slot, which frees each
        # time the riding worker ends a step, and a real permit taken
        # only when one is free.
        t0 = time.perf_counter()
        while True:
            if self._rider.acquire(blocking=False):
                break
            if self._sem.try_acquire():
                try:
                    with self._gated(t0):
                        yield
                finally:
                    self._sem.release()
                return
            if self._rider.acquire(timeout=0.05):
                break
        lockdep.note_acquired(self.RIDE)
        ledger.note_acquire("ride", tag="PermitRider.step")
        try:
            with self._gated(t0, riding=True):
                yield
        finally:
            lockdep.note_released(self.RIDE)
            ledger.note_release("ride")
            self._rider.release()

    @contextmanager
    def _gated(self, t0: float, riding: bool = False):
        """An admitted step: in flight beside the others until an OOM
        inside it asks to run alone (`retry.on_pressure`). Steps are
        counted only once admitted, so a step waiting here for a permit
        never holds up one that waits to run alone."""
        from ..memory.retry import on_pressure
        me = threading.current_thread().name
        with self._gate:
            while self._alone is not None or self._queue:
                self._gate.wait()
            self._active += 1
            waited = time.perf_counter() - t0
            self._waited += waited
            if riding:
                self._riding = me
        alone, counted = [False], [False]

        def run_alone():
            with self._gate:
                if alone[0]:
                    if not self._queue:
                        return      # nobody else holds a batch: retry
                    # failed again alone while others wait, each holding
                    # its batch: let them retry first
                    self._alone, alone[0] = None, False
                else:
                    self._active -= 1
                turn = object()
                self._queue.append(turn)
                self._gate.notify_all()
                deadline = time.monotonic() + _ALONE_WAIT_S
                while self._active or self._alone is not None \
                        or self._queue[0] is not turn:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._gate.wait(left)
                self._queue.remove(turn)
                if self._alone is None:
                    self._alone, alone[0] = me, True
                    if not counted[0]:
                        self._alone_steps += 1
                        counted[0] = True
                else:
                    self._active += 1   # another runs alone: go on beside
                self._gate.notify_all()

        try:
            if waited > 1e-3:
                # the admission wait that stalled this map step: a
                # pool_wait edge of the query's trace (the worker was
                # seeded by tracing.use); inside the try, so the step
                # is always counted out
                from ..profiler import tracing
                tracing.record_wait_span("exchange.pool_admission",
                                         "pool_wait", waited * 1e3)
            with on_pressure(run_alone):
                yield
        finally:
            with self._gate:
                if alone[0]:
                    self._alone = None
                else:
                    self._active -= 1
                if riding:
                    self._riding = None
                self._gate.notify_all()
