"""Device memory budget: the RMM-pool analog.

The port of the JAX package's `memory/device.py`. Operators reserve the
bytes of the batches they park (the spill store's handles) against one
analytic budget; a reservation that does not fit first runs the spill
hooks (the spill store demotes handles to host memory or disk), then,
while another live thread that is not itself waiting holds a
reservation, waits for a release (the exchange's map workers run
concurrently), and raises `BudgetExceeded` when none of that can make
room and something else is still reserved: like the host budget, the
device budget admits one reservation of any size, so a batch bigger
than the whole budget can still be parked and brought back. The retry
framework (`memory/retry.py`) treats that exception like a real
`torch.OutOfMemoryError` from the CUDA caching allocator: both split or
spill and run again (reference: GpuDeviceManager.scala:182,
DeviceMemoryEventHandler.scala:36).

The budget on CUDA is `torch.cuda.mem_get_info()`'s total times
`memory.tpu.allocFraction`, unless `memory.tpu.poolBytes` sets it. A CPU
session has no device memory to ask: its default is
`CPU_DEFAULT_BYTES` times the fraction, or the explicit budget.

Every reservation records the retry coverage of its call site (when
`memory.retryCoverage.enabled`), the peak gauge and the query's
attribution (`memory/diagnostics.py`), and notes the `device_bytes`
kind to the resource ledger, whose holders' dump a `BudgetExceeded`
carries (`runtime/ledger.py`).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

from ..runtime import ledger

__all__ = ["DeviceManager", "BudgetExceeded", "device_manager",
           "CPU_DEFAULT_BYTES"]

#: the budget base of a CPU session without `memory.tpu.poolBytes`
CPU_DEFAULT_BYTES = 16 << 30
#: passes that may skip the hooks because a release raced the shortfall
#: check and another reservation then took the room (a live budget
#: cannot make `reserve` spin forever)
_MAX_RACES = 64
#: the longest a reservation waits for other threads' releases
_WAIT_S = 60.0
#: how often a waiting reservation looks again at who holds bytes
_LOOK_S = 0.5


class BudgetExceeded(Exception):
    """A device reservation that cannot be satisfied even after spilling
    everything spillable."""


class DeviceManager:
    def __init__(self, budget_bytes: Optional[int] = None,
                 alloc_fraction: float = 0.85,
                 device: Optional[torch.device] = None):
        self._lock = threading.RLock()
        # notified on every release: a reservation that cannot fit while
        # another thread holds bytes waits for them
        self._released = threading.Condition(self._lock)
        self._by_thread: Dict[int, int] = {}   # reserved bytes per owner
        self._waiting: Set[int] = set()   # owners waiting for a release
        self._reserved = 0
        self._spill_hooks: List[Callable[[int], int]] = []
        if budget_bytes is None:
            budget_bytes = self._detect_budget(alloc_fraction, device)
        self.budget = int(budget_bytes)

    @staticmethod
    def _detect_budget(fraction: float,
                       device: Optional[torch.device]) -> int:
        if device is not None and torch.device(device).type == "cuda":
            _, total = torch.cuda.mem_get_info(torch.device(device))
            return int(total * fraction)
        return int(CPU_DEFAULT_BYTES * fraction)

    # ------------------------------------------------------------------
    def register_spill_hook(self, hook: Callable[[int], int]):
        """hook(bytes_needed) -> bytes_freed; called under pressure."""
        with self._lock:
            self._spill_hooks.append(hook)

    @property
    def reserved(self) -> int:
        with self._lock:
            return self._reserved

    def _charge(self, owner: int, delta: int):
        """Move `owner`'s reserved bytes by delta (caller holds the
        lock)."""
        n = self._by_thread.get(owner, 0) + delta
        if n > 0:
            self._by_thread[owner] = n
        else:
            self._by_thread.pop(owner, None)

    def try_reserve(self, nbytes: int) -> bool:
        with self._lock:
            if self._reserved + nbytes > self.budget:
                return False
            self._reserved += nbytes
            self._charge(threading.get_ident(), nbytes)
            cur = self._reserved
        self._note_reserved(nbytes, cur, "DeviceManager.try_reserve")
        return True

    @staticmethod
    def _note_reserved(nbytes: int, cur: int, tag: str):
        """A reservation was granted: the peak gauge, the query's
        attribution and the resource ledger's `device_bytes` kind."""
        from .diagnostics import record_device_watermark, \
            record_query_bytes
        record_device_watermark(cur)
        record_query_bytes("device", nbytes)
        ledger.note_acquire("device_bytes", nbytes, tag=tag)

    def reserve(self, nbytes: int):
        """Reserve, spilling as needed. When the spill hooks cannot make
        room and another live thread that is not itself waiting here
        holds a reservation, wait for a release (at most `_WAIT_S` in
        all) and try again; otherwise raise BudgetExceeded at once,
        unless nothing else is reserved (one reservation of any size is
        admitted). Retry coverage records once per logical reservation,
        here at entry."""
        from .diagnostics import record_allocation
        record_allocation()
        if self.try_reserve(nbytes):
            return
        with self._lock:
            hooks = list(self._spill_hooks)
        deadline = time.monotonic() + _WAIT_S
        while True:
            if self._spill_and_reserve(nbytes, hooks):
                return
            with self._lock:
                # one reservation is always admitted (the host budget's
                # rule): a batch bigger than the whole budget parks alone
                me = threading.get_ident()
                if self._reserved == 0:
                    self._reserved = nbytes
                    self._charge(me, nbytes)
                    break
                left = deadline - time.monotonic()
                if left <= 0 or not self._release_may_come(me):
                    exc = BudgetExceeded(
                        f"need {nbytes} bytes, reserved {self._reserved} "
                        f"of {self.budget} and spill store exhausted")
                    # who holds the budget, by thread and query
                    ledger.attach_dump(exc)
                    raise exc
                # another task holds bytes (two pool workers each merging
                # more than the budget): wait for a release, looking
                # again now and then (a holder may exit or start waiting)
                self._waiting.add(me)
                try:
                    self._released.wait(min(left, _LOOK_S))
                finally:
                    self._waiting.discard(me)
        self._note_reserved(nbytes, nbytes, "DeviceManager.reserve")

    def _release_may_come(self, me: int) -> bool:
        """Whether another thread that holds bytes can still release
        them: one that is alive and not itself waiting here for a
        release (two waiters that each hold bytes would wait for each
        other; bytes charged to a thread that exited have no live owner
        to release them). The caller holds the lock."""
        alive = {t.ident for t in threading.enumerate()}
        return any(owner != me and owner in alive
                   and owner not in self._waiting
                   for owner in self._by_thread)

    def _spill_and_reserve(self, nbytes: int, hooks) -> bool:
        """Run the spill hooks and try the reservation again, pass after
        pass while they free bytes. A pass that skipped a hook because
        another task's release had made room, which a third task then
        took, runs again too (at most `_MAX_RACES` times): it did not ask
        the hooks."""
        races = 0
        while True:
            freed, raced = 0, False
            for hook in hooks:
                # the shortfall again before every hook: other threads'
                # reservations move it between calls
                with self._lock:
                    needed = nbytes - (self.budget - self._reserved)
                if needed > 0:
                    from .diagnostics import record_query_spill
                    record_query_spill(needed)
                    freed += int(hook(needed) or 0)
                else:
                    raced = True
                if self.try_reserve(nbytes):
                    return True
            if freed:
                continue
            if not raced or races >= _MAX_RACES:
                return False
            races += 1

    def release(self, nbytes: int, owner: Optional[int] = None):
        """Give back bytes that thread `owner` (the calling thread by
        default) reserved: a spill hook releases another thread's
        handle on that thread's account."""
        with self._lock:
            self._reserved = max(0, self._reserved - nbytes)
            self._charge(threading.get_ident() if owner is None else owner,
                         -nbytes)
            self._released.notify_all()
        from .diagnostics import record_query_bytes
        record_query_bytes("device", -nbytes)
        ledger.note_release("device_bytes", nbytes)

    def trigger_spill(self, nbytes: Optional[int] = None):
        """Ask the spill hooks to free memory proactively (the retry
        framework's pressure valve between attempts)."""
        need = nbytes if nbytes is not None else max(self.budget // 4, 1)
        with self._lock:
            hooks = list(self._spill_hooks)
        for hook in hooks:
            hook(need)


_MANAGERS: Dict[Tuple, DeviceManager] = {}
_GLOBAL_LOCK = threading.Lock()


def device_manager(conf=None, device=None) -> DeviceManager:
    """The process-wide manager of `device` under the conf's budget keys
    (`memory.tpu.poolBytes`, `memory.tpu.allocFraction`): sessions whose
    confs agree share one budget, as the card's memory is one. Conf-less
    callers get the default budget of the CPU, or of `device`."""
    budget, frac = None, 0.85
    if conf is not None:
        from ..config import HBM_POOL_BYTES, HBM_POOL_FRACTION
        budget = conf.get(HBM_POOL_BYTES)
        frac = conf.get(HBM_POOL_FRACTION)
    dev = torch.device(device) if device is not None \
        else torch.device("cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (str(dev), budget, frac)
    with _GLOBAL_LOCK:
        dm = _MANAGERS.get(key)
        if dm is None:
            dm = _MANAGERS[key] = DeviceManager(budget, frac, dev)
        return dm
