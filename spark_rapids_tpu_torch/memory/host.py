"""Global host-memory budget and the pinned staging pool (the HostAlloc
analog).

The reference bounds executor host DRAM with one HostAlloc pool
(HostAlloc.scala:36; limits RapidsConf.scala:337-353): pinned pool +
non-pinned limit. The port keeps the JAX package's shape of it: ONE
process-wide byte budget (`memory.host.limitBytes`) that host-resident
consumers draw from (the spill stores' host tier, the staging pool's
cached buffers), with pressure hooks that demote spilled batches from
host memory to disk, and ONE reusable pool of size-bucketed
staging buffers for the device Parquet scan (raw chunk reads, snappy
decompression targets, H2D upload sources).

On a CUDA session the pool's buffers are page-locked
(`torch.empty(..., pin_memory=True)`), so an upload from them is a true
asynchronous DMA; on a CPU session they are plain host buffers. Each
buffer is a uint8 tensor with a numpy view of the same bytes
(`readinto` and the decompressor write through the view). Allocating
pinned memory is expensive (`cudaHostAlloc`), so the pool keeps every
buffer it made, up to `memory.host.stagingPoolBytes`, for the next
chunk, row group, file and query.

Reservations note the `host_bytes` kind and leases the `staging_lease`
kind to the resource ledger (`runtime/ledger.py`), and count toward the
current query's attribution (`memory/diagnostics.py`); in the ledger's
poison mode a released cached buffer is filled with 0xAB.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import torch

from ..runtime import ledger

__all__ = ["HostMemoryManager", "HostBudgetExceeded", "host_manager",
           "PinnedStagingPool", "StagingBuffer", "staging_pool"]


class HostBudgetExceeded(MemoryError):
    pass


class HostMemoryManager:
    """One byte budget (0 = unlimited). Like the reference's
    TrafficController, ONE outstanding reservation is always admitted so
    a single oversized buffer cannot wedge the process. Pressure hooks
    (the spill stores register their host->disk cascade) free host bytes
    when a `reserve` would overflow; one that still cannot fit raises
    HostBudgetExceeded, so the caller routes around host memory (a
    spill goes straight to disk)."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._reserved = 0
        self._holders = 0
        self._lock = threading.RLock()
        self._hooks: List[Callable[[int], int]] = []
        self.metrics = {"pressureCalls": 0, "pressureFreed": 0}

    def register_pressure_hook(self, fn: Callable[[int], int]):
        """fn(bytes_needed) -> bytes freed (e.g. host->disk demotion)."""
        with self._lock:
            if fn not in self._hooks:
                self._hooks.append(fn)

    @property
    def reserved(self) -> int:
        with self._lock:
            return self._reserved

    def try_reserve(self, nbytes: int) -> bool:
        with self._lock:
            if not (self.budget <= 0
                    or self._reserved + nbytes <= self.budget
                    or self._holders == 0):
                return False
            self._reserved += nbytes
            self._holders += 1
            cur = self._reserved
        from .diagnostics import record_host_watermark, record_query_bytes
        record_host_watermark(cur)
        record_query_bytes("host", nbytes)
        ledger.note_acquire("host_bytes", nbytes,
                            tag="HostMemoryManager.try_reserve")
        return True

    def reserve(self, nbytes: int):
        """Reserve host bytes, firing the pressure hooks when over
        budget. Raises HostBudgetExceeded when the hooks cannot make room
        and other reservations are outstanding."""
        if self.try_reserve(nbytes):
            return
        with self._lock:
            self.metrics["pressureCalls"] += 1
            hooks = list(self._hooks)
        from .diagnostics import record_query_spill
        record_query_spill(nbytes)
        for fn in hooks:
            freed = int(fn(nbytes) or 0)
            with self._lock:
                self.metrics["pressureFreed"] += freed
            if self.try_reserve(nbytes):
                return
        exc = HostBudgetExceeded(
            f"host reservation of {nbytes} bytes over budget "
            f"{self.budget} ({self.reserved} reserved)")
        ledger.attach_dump(exc)   # who holds the budget, by thread/query
        raise exc

    def force_reserve(self, nbytes: int):
        """Unconditional reservation (soft admit): the accounting may
        exceed the budget; later reservations see the pressure."""
        with self._lock:
            self._reserved += nbytes
            self._holders += 1
            cur = self._reserved
        from .diagnostics import record_host_watermark, record_query_bytes
        record_host_watermark(cur)
        record_query_bytes("host", nbytes)
        ledger.note_acquire("host_bytes", nbytes,
                            tag="HostMemoryManager.force_reserve")

    def release(self, nbytes: int):
        with self._lock:
            self._reserved = max(0, self._reserved - nbytes)
            self._holders = max(0, self._holders - 1)
        from .diagnostics import record_query_bytes
        record_query_bytes("host", -nbytes)
        ledger.note_release("host_bytes", nbytes)


# ----------------------------------------------------------------------
# Pinned staging pool
# ----------------------------------------------------------------------
_STAGING_FLOOR = 64 * 1024


def _staging_bucket(nbytes: int) -> int:
    """Pow2 size class, so one buffer serves every chunk of its class."""
    c = _STAGING_FLOOR
    while c < nbytes:
        c <<= 1
    return c


class StagingBuffer:
    """One leased staging buffer: a pow2-capacity uint8 tensor (`tensor`,
    the H2D source) and its numpy view (`array`), plus the caller's
    requested length. Return it with release() so the next chunk reuses
    the allocation."""

    __slots__ = ("tensor", "array", "nbytes", "_pool", "_cached")

    def __init__(self, tensor: torch.Tensor, nbytes: int,
                 pool: "PinnedStagingPool", cached: bool):
        self.tensor = tensor          # torch.uint8[capacity]
        self.array = tensor.numpy()   # the same bytes, as numpy
        self.nbytes = int(nbytes)     # live prefix the caller asked for
        self._pool = pool
        self._cached = cached         # counted against the pool budget

    @property
    def capacity(self) -> int:
        return int(self.tensor.shape[0])

    def view(self) -> memoryview:
        """Writable view of the live prefix (readinto target)."""
        return memoryview(self.array)[:self.nbytes]

    def release(self):
        self._pool.release(self)


class PinnedStagingPool:
    """Reusable size-bucketed host staging buffers for raw-chunk uploads
    (reference: HostAlloc.scala pinned pool / PinnedMemoryPool).

    Leases are pow2-bucketed; a released buffer waits in its bucket for
    the next lease of that size. Cached bytes count against the global
    host budget; when the pool is full (or the budget refuses), extra
    leases are served as transient buffers that simply drop on release.
    `pinned` selects page-locked buffers (CUDA sessions)."""

    def __init__(self, max_bytes: int,
                 manager: Optional[HostMemoryManager] = None,
                 pinned: bool = False):
        self.max_bytes = int(max_bytes)
        self.pinned = bool(pinned)
        self._manager = manager
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._held = 0                       # cached bytes (free + leased)
        self._lock = threading.Lock()
        self.metrics = {"stagingPoolHits": 0, "stagingPoolMisses": 0,
                        "stagingPoolTransient": 0,
                        "stagingPoolHeldBytes": 0}

    def acquire(self, nbytes: int) -> StagingBuffer:
        cap = _staging_bucket(max(int(nbytes), 1))
        with self._lock:
            lst = self._free.get(cap)
            if lst:
                self.metrics["stagingPoolHits"] += 1
                buf = StagingBuffer(lst.pop(), nbytes, self, True)
                ledger.note_acquire("staging_lease", cap, token=id(buf),
                                    tag="PinnedStagingPool.acquire")
                return buf
            grow = self._held + cap <= self.max_bytes
            if grow:
                self._held += cap
                self.metrics["stagingPoolHeldBytes"] = self._held
                self.metrics["stagingPoolMisses"] += 1
            else:
                self.metrics["stagingPoolTransient"] += 1
        if grow and self._manager is not None \
                and not self._manager.try_reserve(cap):
            # the host budget refused: serve this lease transient
            with self._lock:
                self._held -= cap
                self.metrics["stagingPoolHeldBytes"] = self._held
            grow = False
        t = torch.empty(cap, dtype=torch.uint8, pin_memory=self.pinned)
        buf = StagingBuffer(t, nbytes, self, grow)
        ledger.note_acquire("staging_lease", cap, token=id(buf),
                            tag="PinnedStagingPool.acquire")
        return buf

    def release(self, buf: StagingBuffer):
        ledger.note_release("staging_lease", buf.capacity, token=id(buf))
        if not buf._cached:
            return                            # transient: let GC take it
        if ledger.poison_enabled():
            # a use-after-release reads 0xAB, not whatever the next
            # lease happens to write
            buf.array.fill(ledger.POISON_BYTE)
        with self._lock:
            self._free.setdefault(buf.capacity, []).append(buf.tensor)

    def clear(self) -> int:
        """Drop all cached free buffers, releasing their host budget.
        Returns bytes freed (pressure-hook shape)."""
        with self._lock:
            drops = [(cap, len(lst)) for cap, lst in self._free.items()]
            freed = sum(cap * n for cap, n in drops)
            self._free.clear()
            self._held -= freed
            self.metrics["stagingPoolHeldBytes"] = self._held
        if self._manager is not None:
            for cap, n in drops:              # one reservation per buffer
                for _ in range(n):
                    self._manager.release(cap)
        return freed

    @property
    def held_bytes(self) -> int:
        with self._lock:
            return self._held


_STAGING: Dict[bool, PinnedStagingPool] = {}
_GLOBAL: Optional[HostMemoryManager] = None
_LOCK = threading.Lock()


def host_manager(conf=None) -> HostMemoryManager:
    """The process-wide host budget, sized by the first configured
    caller (a conf-less first caller leaves it unlimited until one
    comes)."""
    from ..config import HOST_MEMORY_LIMIT
    global _GLOBAL
    with _LOCK:
        if _GLOBAL is None:
            _GLOBAL = HostMemoryManager(
                conf.get(HOST_MEMORY_LIMIT) if conf is not None else 0)
        elif conf is not None and _GLOBAL.budget == 0:
            _GLOBAL.budget = conf.get(HOST_MEMORY_LIMIT)
        return _GLOBAL


def staging_pool(conf=None, pinned: bool = False) -> PinnedStagingPool:
    """The process-wide staging pool of pinned (CUDA sessions) or plain
    (CPU sessions) buffers, sized once by its first configured caller;
    conf-less callers get the default cap."""
    from ..config import HOST_STAGING_POOL_BYTES
    pinned = bool(pinned)
    pool = _STAGING.get(pinned)
    if pool is None:
        cap = (conf.get(HOST_STAGING_POOL_BYTES) if conf is not None
               else HOST_STAGING_POOL_BYTES.default)
        mgr = host_manager(conf)          # takes _LOCK itself: call first
        with _LOCK:
            pool = _STAGING.setdefault(
                pinned, PinnedStagingPool(cap, mgr, pinned=pinned))
    return pool
