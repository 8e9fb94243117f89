"""Carry batch data between the JAX package and the port as numpy.

`batch_from_numpy` builds a port DeviceBatch from the host buffers of a
JAX-package DeviceBatch (`np.asarray(cv.data)`, `np.asarray(cv.validity)`
and `np.asarray(batch.row_mask)`), padding rows and the [n, 2] decimal128
layout included; a string or binary column adds its int32 offsets
(`np.asarray(cv.offsets)`, capacity + 1 of them) after the validity, and
its data is the byte buffer, which may run past the last offset (the
JAX package pads it). A nested column's buffers are a flat tuple in the
port's `buffer_names` order (its own data, validity and offsets, then
each child's, depth first). `batch_to_numpy` is its inverse. Only numpy
crosses, so neither package imports the other.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .columnar import dtypes as dt
from .columnar.column import Column, buffer_names
from .columnar.table import Schema, Table
from .exec.batch import DeviceBatch, to_device, to_host
from .session import _resolve_device

__all__ = ["batch_from_numpy", "batch_to_numpy"]


def batch_from_numpy(schema: Schema,
                     buffers: Sequence[Tuple[np.ndarray, np.ndarray]],
                     num_rows: int, row_mask: np.ndarray,
                     device=None) -> DeviceBatch:
    """buffers: per schema field (data, validity), each of the batch's
    capacity (data [cap, 2] for decimal128), or (bytes, validity,
    offsets) for a string or binary field. The device defaults to CUDA,
    as a session's does."""
    dev = _resolve_device(device)
    cap = len(row_mask)
    flat = []
    for f, bufs in zip(schema.fields, buffers):
        if f.dtype.is_nested:
            if len(bufs) != len(buffer_names(f.dtype)) or len(bufs[1]) != cap:
                raise ValueError(f"column {f.name}: {len(bufs)} buffers do "
                                 f"not match {f.dtype} at capacity {cap}")
            flat += [np.asarray(b) for b in bufs]
            continue
        var = f.dtype.is_variable_width
        data, valid = bufs[0], bufs[1]
        data = np.asarray(data, dtype=f.dtype.np_dtype)
        if var:
            off = np.asarray(bufs[2], dtype=np.int32) \
                if len(bufs) == 3 else None
            ok = (off is not None and off.shape == (cap + 1,)
                  and data.ndim == 1 and len(valid) == cap
                  and (cap == 0 or int(off[-1]) <= data.shape[0]))
        else:
            ok = (len(bufs) == 2 and len(valid) == cap
                  and data.shape == dt.alloc_shape(f.dtype, cap))
        if not ok:
            raise ValueError(f"column {f.name}: buffers "
                             f"{[np.shape(b) for b in bufs]} do not match "
                             f"capacity {cap} of {f.dtype}")
        flat += [data, np.asarray(valid, dtype=np.bool_)] \
            + ([off] if var else [])
    dev_bufs = to_device(flat + [np.asarray(row_mask, np.bool_)], dev)
    it = iter(dev_bufs[:-1])
    cols = [Column.from_buffers(f.dtype, num_rows, it)
            for f in schema.fields]
    return DeviceBatch(Table(schema.names, cols), num_rows, dev_bufs[-1])


def batch_to_numpy(batch: DeviceBatch):
    """(buffers, num_rows, row_mask) of a port batch, as numpy: per
    column (data, validity), or (bytes, validity, offsets) for a string
    or binary column."""
    cols = batch.table.columns
    host = to_host([t for c in cols for t in c.buffers()]
                   + [batch.row_mask])
    buffers: List[Tuple[np.ndarray, ...]] = []
    i = 0
    for c in cols:
        w = len(c.buffers())
        buffers.append(tuple(host[i:i + w]))
        i += w
    return buffers, batch.num_rows, host[-1]
