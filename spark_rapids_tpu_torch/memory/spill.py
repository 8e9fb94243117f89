"""Handle-based spill framework: device -> host memory -> disk.

The port of the JAX package's `memory/spill.py` (reference:
spill/SpillFramework.scala:51-140). Operators park batches as
`SpillableBatchHandle`s instead of holding raw tensors; the store may
demote any handle that is not pinned when the device budget
(`memory/device.py`) or the host budget (`memory/host.py`) is under
pressure, and `materialize()` brings it back to the device. Lower
priority values spill first, then bigger handles.

A handle copies every buffer of its batch (each column's data,
validity and string or list offsets, decimal128 `[n, 2]` limbs included,
a nested column's children depth first, and the row mask) into ONE pageable host buffer, each buffer at a 16 B aligned
offset, so the round trip is byte for byte and the way back is one
copy and views. The copies never allocate pinned memory: the CUDA
pinned-host cache keeps every pinned block it ever made, and a spill
store exists to hold more than the card. Host-tier bytes are charged to
the process's host budget (`host_manager`), whose pressure hooks demote
them to disk; past `memory.host.spillStorageSize` they cascade to disk
as well. A disk file is the raw host buffer under `memory.spill.dir`,
deleted when the handle comes back or closes.

One lock serializes every handle's state changes across all stores
(a spill hook of one store may fire while another store's handle is
being materialized on the same thread): lockdep's `SpillStore._lock`.
A handle notes the `spill_handle` kind to the resource ledger from its
registration to its close, and the disk write is the `spill.write`
fault point (`runtime/faults.py`).
"""
from __future__ import annotations

import os
import threading
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.table import Table
from ..runtime import faults, ledger, lockdep
from .device import DeviceManager, device_manager
from .host import HostBudgetExceeded, HostMemoryManager

__all__ = ["SpillStore", "SpillableBatchHandle", "spill_store"]

DEVICE, HOST, DISK = "device", "host", "disk"

# lockdep's SpillStore._lock (made at import: wrapped only when the
# witness is on from the env before the engine imports)
_LOCK = lockdep.rlock("SpillStore._lock")
_ALIGN = 16


def _tensors(batch) -> List[torch.Tensor]:
    return [t for c in batch.table.columns for t in c.buffers()] \
        + [batch.row_mask]


def _to_host(tensors) -> Tuple[torch.Tensor, list]:
    """Every tensor's bytes in one pageable host buffer: (buffer,
    layout [(offset, nbytes, dtype, shape)])."""
    layout, total = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        layout.append((total, nb, t.dtype, tuple(t.shape)))
        total += -(-nb // _ALIGN) * _ALIGN
    host = torch.empty(max(total, 1), dtype=torch.uint8)
    for t, (o, nb, _, _) in zip(tensors, layout):
        if nb:
            host[o:o + nb].copy_(t.contiguous().reshape(-1)
                                 .view(torch.uint8))
    return host, layout


def _from_host(host: torch.Tensor, layout, device) -> List[torch.Tensor]:
    """The tensors of `_to_host` on `device`: one copy, then views (on
    the CPU, views of the host buffer itself)."""
    buf = host if device.type == "cpu" else host.to(device)
    return [buf[o:o + nb].view(dtype).reshape(shape)
            for o, nb, dtype, shape in layout]


class SpillableBatchHandle:
    """One spillable columnar batch."""

    def __init__(self, store: "SpillStore", batch, priority: int = 0):
        self.store = store
        self.priority = priority
        self.id = uuid.uuid4().hex
        self.state = DEVICE
        self.nbytes = batch.nbytes
        self.device = batch.device
        self._batch = batch
        self._host: Optional[torch.Tensor] = None
        self._layout = None
        self._disk_path: Optional[str] = None
        cols = batch.table.columns
        self._meta = (list(batch.table.names),
                      [(c.dtype, c.length) for c in cols],
                      batch.num_rows)
        self._pinned = 0
        self._host_reserved = False
        self.closed = False
        # the thread whose device reservation this handle holds
        self._owner = threading.get_ident()

    # -- spill path ----------------------------------------------------
    def _leave_device(self):
        """The device copy is gone: give its reservation back, on the
        account of the thread that made it."""
        self._batch = None
        self.store.dm.release(self.nbytes, self._owner)

    def spill_to_host(self, charge_budget: bool = True) -> int:
        """Demote to host memory; returns the bytes freed on the device
        (0 when pinned or not on the device). A host budget that refuses
        the bytes sends them straight to disk."""
        with _LOCK:
            if self.state != DEVICE or self._pinned or self.closed:
                return 0
            hm = self.store.host_mgr
            if charge_budget and hm is not None:
                try:
                    hm.reserve(self.nbytes)
                except HostBudgetExceeded:
                    return self.spill_to_disk()
                self._host_reserved = True
            self._host, self._layout = _to_host(_tensors(self._batch))
            self._leave_device()
            self.state = HOST
            if charge_budget:
                self.store._count("spillToHost", self.nbytes)
            return self.nbytes

    def _release_host(self):
        if self._host_reserved:
            self.store.host_mgr.release(self.nbytes)
            self._host_reserved = False

    def spill_to_disk(self) -> int:
        """Demote to a file under the store's spill directory; returns
        the bytes written (0 when pinned or already on disk)."""
        with _LOCK:
            if self._pinned or self.closed or self.state == DISK:
                return 0
            if faults.ACTIVE:
                # before any state moves: a failed write leaves the
                # handle where it was
                faults.hit("spill.write")
            if self.state == DEVICE:
                self._host, self._layout = _to_host(_tensors(self._batch))
                self._leave_device()
            os.makedirs(self.store.spill_dir, exist_ok=True)
            path = os.path.join(self.store.spill_dir,
                                f"spill-{self.id}.bin")
            self._host.numpy().tofile(path)
            self._release_host()
            self._disk_path = path
            self._host = None
            self.state = DISK
            self.store._count("spillToDisk", self.nbytes)
            return self.nbytes

    # -- promote back ----------------------------------------------------
    def materialize(self):
        """The batch on the device, promoted back from host memory or
        disk if it was spilled, by the thread that owns the handle.
        Pinned meanwhile, so the reservation below cannot demote this
        handle."""
        from ..exec.batch import DeviceBatch
        with _LOCK:
            if self.closed:
                raise RuntimeError(f"spill handle {self.id} is closed")
            if self.state == DEVICE:
                return self._batch
            self.pin()
        try:
            # outside the lock: the reservation may wait for another
            # task's release, and that task needs the lock to close its
            # handles
            self.store.dm.reserve(self.nbytes)
            with _LOCK:
                self._owner = threading.get_ident()
                try:
                    if self.state == DISK:
                        raw = np.fromfile(self._disk_path, dtype=np.uint8)
                        self._host = torch.from_numpy(raw)
                        os.unlink(self._disk_path)
                        self._disk_path = None
                        self.state = HOST
                    it = iter(_from_host(self._host, self._layout,
                                         self.device))
                    names, cols, num_rows = self._meta
                    table = Table(names, [
                        Column.from_buffers(dtype, length, it)
                        for dtype, length in cols])
                    self._batch = DeviceBatch(table, num_rows, next(it))
                except BaseException:
                    self.store.dm.release(self.nbytes)
                    raise
                self._host = None
                self._release_host()
                self.state = DEVICE
                return self._batch
        finally:
            self.unpin()

    def pin(self):
        with _LOCK:
            self._pinned += 1

    def unpin(self):
        with _LOCK:
            self._pinned = max(0, self._pinned - 1)

    def close(self):
        """Free every tier's copy: the device reservation, the host
        budget, the disk file. Idempotent."""
        with _LOCK:
            if self.closed:
                return
            self.closed = True
            if self._disk_path is not None:
                if os.path.exists(self._disk_path):
                    os.unlink(self._disk_path)
                self._disk_path = None
            if self.state == DEVICE:
                self._leave_device()
            self._release_host()
            self._host = None
            self.store._remove(self)
        ledger.note_release("spill_handle", token=self.id)


class SpillStore:
    """Registry of spillable handles, with the device manager's spill
    hook and the host manager's pressure hook (the reference's device
    and host store pair)."""

    def __init__(self, dm: Optional[DeviceManager] = None,
                 spill_dir: Optional[str] = None,
                 host_limit: int = 32 << 30,
                 host_mgr: Optional[HostMemoryManager] = None):
        from ..config import SPILL_DIR
        self.dm = dm or device_manager()
        self.spill_dir = spill_dir or SPILL_DIR.default
        self.host_limit = host_limit
        self.host_mgr = host_mgr
        self._lock = _LOCK
        self._handles: Dict[str, SpillableBatchHandle] = {}
        self.metrics = {"spillToHost": 0, "spillToDisk": 0,
                        "spillBytes": 0}
        self.dm.register_spill_hook(self.spill)
        if host_mgr is not None:
            # host pressure from any consumer demotes this store's host
            # tier to disk
            host_mgr.register_pressure_hook(self.host_pressure)

    def _count(self, metric: str, nbytes: int):
        self.metrics[metric] += 1
        self.metrics["spillBytes"] += nbytes

    def add_batch(self, batch, priority: int = 0) -> SpillableBatchHandle:
        """Park a device batch: reserves its bytes (spilling others as
        needed; BudgetExceeded when nothing more can go). The handle is
        registered, pinned, before the reservation, so no reservation is
        ever outside a handle that another thread's spill can see."""
        h = SpillableBatchHandle(self, batch, priority)
        h._pinned = 1
        with _LOCK:
            self._handles[h.id] = h
        try:
            self.dm.reserve(batch.nbytes)
        except BaseException:
            with _LOCK:           # nothing reserved: nothing to release
                h.closed = True
                self._handles.pop(h.id, None)
            raise
        ledger.note_acquire("spill_handle", h.nbytes, token=h.id,
                            tag=f"SpillStore.add_batch[{h.id[:8]}]")
        h.unpin()
        return h

    def _remove(self, h: SpillableBatchHandle):
        with _LOCK:
            self._handles.pop(h.id, None)

    def _victims(self, state: str):
        return sorted((h for h in self._handles.values()
                       if h.state == state and not h._pinned),
                      key=lambda h: (h.priority, -h.nbytes))

    def spill(self, bytes_needed: int) -> int:
        """The device manager's hook: demote device handles (lowest
        priority first, biggest first) until enough is freed, then
        cascade the host tier to disk past `host_limit`."""
        freed = 0
        with _LOCK:
            for h in self._victims(DEVICE):
                if freed >= bytes_needed:
                    break
                freed += h.spill_to_host()
            host_bytes = sum(h.nbytes for h in self._handles.values()
                             if h.state == HOST)
            for h in self._victims(HOST):
                if host_bytes <= self.host_limit:
                    break
                host_bytes -= h.spill_to_disk()
        return freed

    def host_pressure(self, bytes_needed: int) -> int:
        """The host manager's hook: demote host-tier handles to disk."""
        freed = 0
        with _LOCK:
            for h in self._victims(HOST):
                if freed >= bytes_needed:
                    break
                freed += h.spill_to_disk()
        return freed

    @property
    def open_handles(self) -> int:
        with _LOCK:
            return len(self._handles)


_STORES: Dict[Tuple, SpillStore] = {}
_STORES_LOCK = threading.Lock()


def spill_store(conf=None, device=None) -> SpillStore:
    """The process-wide store over `device_manager(conf, device)` with the
    conf's spill directory and host limit; conf-less callers get the
    defaults."""
    from ..config import HOST_SPILL_LIMIT, SPILL_DIR
    from .host import host_manager
    dm = device_manager(conf, device)
    if conf is not None:
        spill_dir, limit = conf.get(SPILL_DIR), conf.get(HOST_SPILL_LIMIT)
    else:
        spill_dir, limit = SPILL_DIR.default, HOST_SPILL_LIMIT.default
    key = (id(dm), spill_dir, limit)
    hm = host_manager(conf)
    with _STORES_LOCK:
        store = _STORES.get(key)
        if store is None:
            store = _STORES[key] = SpillStore(dm, spill_dir, limit, hm)
        return store
