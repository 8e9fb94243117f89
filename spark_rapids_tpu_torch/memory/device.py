"""Device memory budget: the RMM-pool analog.

The port of the JAX package's `memory/device.py`. Operators reserve the
bytes of the batches they park (the spill store's handles) against one
analytic budget; a reservation that does not fit first runs the spill
hooks (the spill store demotes handles to host memory or disk), and
raises `BudgetExceeded` only when they cannot free enough and something
else is still reserved: like the host budget, the device budget admits
one reservation of any size, so a batch bigger than the whole budget
can still be parked and brought back. The retry
framework (`memory/retry.py`) treats that exception like a real
`torch.OutOfMemoryError` from the CUDA caching allocator: both split or
spill and run again (reference: GpuDeviceManager.scala:182,
DeviceMemoryEventHandler.scala:36).

The budget on CUDA is `torch.cuda.mem_get_info()`'s total times
`memory.tpu.allocFraction`, unless `memory.tpu.poolBytes` sets it. A CPU
session has no device memory to ask: its default is
`CPU_DEFAULT_BYTES` times the fraction, or the explicit budget.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["DeviceManager", "BudgetExceeded", "device_manager",
           "CPU_DEFAULT_BYTES"]

#: the budget base of a CPU session without `memory.tpu.poolBytes`
CPU_DEFAULT_BYTES = 16 << 30


class BudgetExceeded(Exception):
    """A device reservation that cannot be satisfied even after spilling
    everything spillable."""


class DeviceManager:
    def __init__(self, budget_bytes: Optional[int] = None,
                 alloc_fraction: float = 0.85,
                 device: Optional[torch.device] = None):
        self._lock = threading.RLock()
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

    def try_reserve(self, nbytes: int) -> bool:
        with self._lock:
            if self._reserved + nbytes > self.budget:
                return False
            self._reserved += nbytes
            cur = self._reserved
        from .diagnostics import record_device_watermark
        record_device_watermark(cur)
        return True

    def reserve(self, nbytes: int):
        """Reserve, spilling as needed; raises BudgetExceeded when a pass
        of the spill hooks frees nothing, the bytes still do not fit and
        other reservations are outstanding (with none, any size is
        admitted)."""
        if self.try_reserve(nbytes):
            return
        with self._lock:
            hooks = list(self._spill_hooks)
        while True:
            # the hooks again while they free something: another
            # thread's reservation may take what one pass freed
            freed = 0
            for hook in hooks:
                # the shortfall again before every hook: other threads'
                # reservations move it between calls
                with self._lock:
                    needed = nbytes - (self.budget - self._reserved)
                if needed > 0:
                    freed += int(hook(needed) or 0)
                if self.try_reserve(nbytes):
                    return
            if not freed:
                break
        with self._lock:
            # one reservation is always admitted (the host budget's rule):
            # a batch bigger than the whole budget parks alone
            admitted = self._reserved == 0
            if admitted:
                self._reserved = nbytes
        if admitted:
            from .diagnostics import record_device_watermark
            record_device_watermark(nbytes)
            return
        raise BudgetExceeded(
            f"need {nbytes} bytes, reserved {self.reserved} of "
            f"{self.budget} and spill store exhausted")

    def release(self, nbytes: int):
        with self._lock:
            self._reserved = max(0, self._reserved - nbytes)

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
