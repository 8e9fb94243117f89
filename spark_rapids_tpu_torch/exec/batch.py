"""DeviceBatch, the unit of execution, and the host<->device copies.

A batch is a Table plus a live-row mask: filters clear mask bits instead
of compacting, and padding rows (if any) are False. Consumers that need
dense rows (the exchange, the coalescer) compact; the aggregate reads the
mask; the join compacts a sparse batch first (`maybe_compact`).

`to_device` and `to_host` are the port's only H2D and D2H paths. On CUDA
each packs all buffers of a call into one pinned host buffer, so a batch
moves in ONE copy on the current stream; on the CPU they only wrap or
unwrap the numpy buffers. Every buffer of a packed copy, a string
column's offsets and bytes included, starts on a 16 B boundary, so a
kernel may read it in 16 B vectors.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..columnar.table import Table
from ..ops.kernel_utils import CV
from ..utils import transfer

__all__ = ["DeviceBatch", "to_device", "to_host", "maybe_compact"]

# buffer offsets inside a packed transfer, so every piece can be viewed
# as its own dtype in place
_ALIGN = 16


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _numpy_dtype(torch_dtype: torch.dtype):
    return torch.empty(0, dtype=torch_dtype).numpy().dtype


def _layout(nbytes: Sequence[int]):
    offs, total = [], 0
    for nb in nbytes:
        offs.append(total)
        total += -(-nb // _ALIGN) * _ALIGN
    return offs, total


def to_device(arrays: Sequence[np.ndarray],
              device: torch.device) -> List[torch.Tensor]:
    """Host numpy buffers -> tensors on `device`."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if device.type == "cpu":
        return [torch.from_numpy(a if a.flags.writeable else a.copy())
                for a in arrays]
    offs, total = _layout([a.nbytes for a in arrays])
    staging = torch.empty(max(total, 1), dtype=torch.uint8,
                          pin_memory=True)
    host = staging.numpy()
    for a, o in zip(arrays, offs):
        host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = staging.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(_torch_dtype(a.dtype)).reshape(a.shape)
            for a, o in zip(arrays, offs)]


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors -> host numpy arrays. On CUDA: one device-side pack, one
    D2H into pinned memory, one stream synchronize; the arrays are views
    of that pinned buffer."""
    tensors = [t.contiguous() for t in tensors]
    if tensors:
        transfer.note_sync()
    if not tensors or all(t.device.type == "cpu" for t in tensors):
        return [t.numpy() for t in tensors]
    nbytes = [t.numel() * t.element_size() for t in tensors]
    offs, total = _layout(nbytes)
    pieces = []
    for t, nb in zip(tensors, nbytes):
        pieces.append(t.reshape(-1).view(torch.uint8))
        pad = -(-nb // _ALIGN) * _ALIGN - nb
        if pad:
            pieces.append(torch.zeros(pad, dtype=torch.uint8,
                                      device=t.device))
    packed = torch.cat(pieces) if pieces else torch.zeros(
        1, dtype=torch.uint8, device=tensors[0].device)
    staging = torch.empty(max(total, 1), dtype=torch.uint8,
                          pin_memory=True)
    staging[:packed.numel()].copy_(packed, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    host = staging.numpy()
    return [host[o:o + nb].view(_numpy_dtype(t.dtype)).reshape(t.shape)
            for t, o, nb in zip(tensors, offs, nbytes)]


class DeviceBatch:
    def __init__(self, table: Table, num_rows: Optional[int] = None,
                 row_mask: Optional[torch.Tensor] = None,
                 device: Optional[torch.device] = None):
        self.table = table
        if num_rows is None:
            num_rows = table.num_rows
        self.num_rows = int(num_rows)   # upper bound of live rows
        if row_mask is None:
            if table.columns:
                cap = table.columns[0].capacity
                device = table.columns[0].validity.device
            else:
                cap = self.num_rows
            row_mask = torch.arange(cap, device=device) < self.num_rows
        self.row_mask = row_mask

    @property
    def capacity(self) -> int:
        return int(self.row_mask.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_mask.device

    def cvs(self) -> List[CV]:
        return [c.cv() for c in self.table.columns]

    @property
    def nbytes(self) -> int:
        """Bytes of every buffer of every column, and the row mask."""
        return sum(t.numel() * t.element_size()
                   for c in self.table.columns for t in c.buffers()) \
            + self.capacity

    def __repr__(self):
        return (f"DeviceBatch(rows<={self.num_rows}, cap={self.capacity}, "
                f"cols={len(self.table.columns)})")


#: a batch at most this long is never compacted (the JAX package's
#: smallest capacity bucket): the live-row read would cost more
_COMPACT_FLOOR = 128


def maybe_compact(batch: DeviceBatch, schema, factor: int = 4):
    """A sparse batch (live rows at most 1/factor of its length) with its
    live rows gathered to the front, at exactly the live-row count; any
    other batch as it is. Holey masks ride through filters and FK joins
    for free, but a join's build and probe pay for every row. Costs one
    host read of the live count (counted), and a gather when it shrinks
    the batch; strings cost one more read (their byte count)."""
    from ..ops.gather import compaction_perm, gather_cols
    from .nodes import make_table
    if batch.capacity <= _COMPACT_FLOOR * factor:
        return batch
    live = transfer.fetch_int(batch.row_mask.sum())
    if live * factor > batch.capacity:
        return batch
    perm, _ = compaction_perm(batch.row_mask)
    out = gather_cols(batch.cvs(), perm[:live], None)
    return DeviceBatch(make_table(schema, out, live), live,
                       device=batch.device)
