"""TpuSemaphore: bound the tasks that run on the device at once.

The port of the JAX package's `memory/semaphore.py` (reference:
GpuSemaphore.scala:183, PrioritySemaphore.scala): a counting semaphore
granted in priority order (smallest value first, then arrival). A task
holds a permit while it runs device work and releases it around host
work (the D2H copy and the Arrow conversion of the collect), so another
task's kernels can run meanwhile. `acquire` takes an optional cancel
token (an object whose `check()` raises) and returns the seconds it
waited. Every permit granted and returned is noted to the lock-order
witness as `TpuSemaphore.permit` and to the resource ledger as the
`permit` kind (`runtime/lockdep.py`, `runtime/ledger.py`).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from contextlib import contextmanager

from ..runtime import ledger, lockdep

__all__ = ["TpuSemaphore"]

# the lockdep resource key for any permit of any TpuSemaphore instance:
# class-keying lets the witness see permit-then-lock against
# lock-then-permit inversions across threads
PERMIT = "TpuSemaphore.permit"


class TpuSemaphore:
    def __init__(self, permits: int = 2):
        self._permits = permits
        self._available = permits
        self._cond = threading.Condition(threading.Lock())
        self._waiters = []          # heap of (priority, seq)
        self._dead = set()          # abandoned waiter entries (cancelled)
        self._seq = itertools.count()
        self._holders = {}          # thread name -> permits held
        self.metrics = {"acquireWaitTime": 0.0, "acquires": 0,
                        "peakHeld": 0}

    def _purge_dead(self):
        while self._waiters and self._waiters[0] in self._dead:
            self._dead.discard(heapq.heappop(self._waiters))

    def _note_held(self, delta: int):
        # caller holds self._cond
        name = threading.current_thread().name
        n = self._holders.get(name, 0) + delta
        if n <= 0:
            self._holders.pop(name, None)
        else:
            self._holders[name] = n
        self.metrics["peakHeld"] = max(self.metrics["peakHeld"],
                                       self._permits - self._available)

    def acquire(self, priority: int = 0, token=None) -> float:
        """Block until a permit is granted in priority order; returns
        seconds spent waiting. With a cancel token the wait polls it, and
        a tripped token abandons the slot (its exception propagates)."""
        t0 = time.perf_counter()
        with self._cond:
            ent = (priority, next(self._seq))
            heapq.heappush(self._waiters, ent)
            try:
                while True:
                    self._purge_dead()
                    if self._available > 0 and self._waiters[0] == ent:
                        break
                    if token is not None:
                        self._cond.wait(timeout=0.05)
                        token.check()
                    else:
                        self._cond.wait()
            except BaseException:
                # leave no ghost head blocking the heap
                self._dead.add(ent)
                self._cond.notify_all()
                raise
            heapq.heappop(self._waiters)
            self._available -= 1
            waited = time.perf_counter() - t0
            self.metrics["acquires"] += 1
            self.metrics["acquireWaitTime"] += waited
            self._note_held(+1)
            self._cond.notify_all()
        lockdep.note_acquired(PERMIT)
        ledger.note_acquire("permit", tag="TpuSemaphore.acquire")
        return waited

    def try_acquire(self) -> bool:
        """A permit only when one is free AND nobody is queued for it:
        never steals from a waiter."""
        with self._cond:
            self._purge_dead()
            got = self._available > 0 and not self._waiters
            if got:
                self._available -= 1
                self.metrics["acquires"] += 1
                self._note_held(+1)
        if got:
            lockdep.note_acquired(PERMIT)
            ledger.note_acquire("permit", tag="TpuSemaphore.try_acquire")
        return got

    def release(self):
        with self._cond:
            self._available += 1
            self._note_held(-1)
            self._cond.notify_all()
        lockdep.note_released(PERMIT)
        ledger.note_release("permit")

    @contextmanager
    def hold(self, priority: int = 0, token=None):
        self.acquire(priority, token=token)
        try:
            yield
        finally:
            self.release()

    def reset_peak(self):
        """Start the held-at-once high-water mark again from now."""
        with self._cond:
            self.metrics["peakHeld"] = self._permits - self._available

    def debug_state(self) -> dict:
        """Who holds permits, and how many wait, at this moment."""
        with self._cond:
            return {
                "permits": self._permits,
                "available": self._available,
                "holders": dict(self._holders),
                "waiters": len(self._waiters) - len(self._dead),
            }
