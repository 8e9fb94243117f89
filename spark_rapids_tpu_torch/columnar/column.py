"""Device column: Arrow layout in torch tensors.

A column is a data tensor plus a bool validity tensor (True = valid) of
one length; a string or binary column adds int32 offsets [n + 1] over
uint8 bytes, as Arrow lays them out. A list or map column has int32
offsets [n + 1] into one child column of elements (a map's elements are
struct<key, value>); a struct column has one child column per field,
each of n rows, under its own validity. A nested column's data tensor
is empty, and its children's lengths are their tensors' lengths. Unlike the JAX package, which pads every buffer to a
power-of-two capacity to bound XLA recompiles, the port keeps columns at
their true length: eager PyTorch compiles nothing per shape. A column may
still arrive padded (`interop.batch_from_numpy` takes the JAX package's
padded buffers); `length` is then the logical row count and `capacity`
the buffer length.

Host decode and export are numpy <-> Arrow; the move between host and
device is `exec/batch.py`'s `to_device` / `to_host`. On the host a
column is a buffer tree: a dict of "data", "validity", "offsets" (var
width and lists) and "children" (a list of such dicts, nested types);
every transfer lists its buffers flat, in `buffer_names` order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..errors import NotPorted
from ..ops.kernel_utils import CV
from . import dtypes as dt

__all__ = ["Column", "buffer_names", "child_dtypes", "tree_from_flat",
           "tree_to_flat"]


def child_dtypes(dtype: dt.DataType):
    """The types of a column's children: a list's element, a struct's
    fields; none for a flat column."""
    if isinstance(dtype, (dt.ArrayType, dt.MapType)):
        return [dt.element_dtype(dtype)]
    if isinstance(dtype, dt.StructType):
        return [f.dtype for f in dtype.fields]
    return []


def _own_names(dtype: dt.DataType):
    if dtype.is_variable_width or isinstance(dtype, (dt.ArrayType,
                                                     dt.MapType)):
        return ("data", "validity", "offsets")
    return ("data", "validity")


def buffer_names(dtype: dt.DataType):
    """The host/device buffers of a column of `dtype`, in the order every
    transfer lists them: its own, then each child's, depth first (a
    child's names prefixed "ch<j>.")."""
    out = list(_own_names(dtype))
    for j, c in enumerate(child_dtypes(dtype)):
        out += [f"ch{j}.{n}" for n in buffer_names(c)]
    return tuple(out)


def tree_from_flat(dtype: dt.DataType, it) -> dict:
    """A column's buffer tree from an iterator over its flat buffers."""
    tree = {k: next(it) for k in _own_names(dtype)}
    kids = child_dtypes(dtype)
    if kids:
        tree["children"] = [tree_from_flat(c, it) for c in kids]
    return tree


def tree_to_flat(dtype: dt.DataType, tree: dict) -> list:
    """Inverse of `tree_from_flat`."""
    out = [tree[k] for k in _own_names(dtype)]
    for c, sub in zip(child_dtypes(dtype), tree.get("children", ())):
        out += tree_to_flat(c, sub)
    return out


class Column:
    """An immutable device column."""

    def __init__(self, dtype: dt.DataType, length: int, data: torch.Tensor,
                 validity: torch.Tensor,
                 offsets: Optional[torch.Tensor] = None,
                 children: Sequence["Column"] = ()):
        self.dtype = dtype
        self.length = int(length)
        self.data = data
        self.validity = validity
        self.offsets = offsets
        self.children = list(children)

    def buffers(self):
        """This column's tensors in `buffer_names` order."""
        out = [getattr(self, b) for b in _own_names(self.dtype)]
        for c in self.children:
            out += c.buffers()
        return out

    @staticmethod
    def from_buffers(dtype: dt.DataType, length: int, it) -> "Column":
        """A column from an iterator over its tensors in `buffer_names`
        order."""
        own = [next(it) for _ in _own_names(dtype)]
        kids = [Column.from_buffers(c, 0, it) for c in child_dtypes(dtype)]
        for k in kids:
            k.length = k.capacity
        return Column(dtype, length, *own, children=kids)

    def cv(self) -> CV:
        return CV(self.data, self.validity, self.offsets,
                  tuple(c.cv() for c in self.children))

    @staticmethod
    def from_cv(dtype: dt.DataType, length: int, cv: CV) -> "Column":
        kids = [Column.from_cv(c, ccv.capacity, ccv)
                for c, ccv in zip(child_dtypes(dtype), cv.children)]
        return Column(dtype, length, cv.data, cv.validity, cv.offsets, kids)

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    def __repr__(self):
        return (f"Column({self.dtype}, length={self.length}, "
                f"capacity={self.capacity})")

    # ------------------------------------------------------------------
    @staticmethod
    def host_from_arrow(arr, dtype: Optional[dt.DataType] = None):
        """Decode a pyarrow array into host numpy buffers (no transfer).
        Returns (dtype, length, {"data", "validity"[, "offsets"]})."""
        import pyarrow as pa
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        dtype = dtype or dt.from_arrow(arr.type)
        n = len(arr)
        has_nulls = arr.null_count > 0
        validity = (np.logical_not(np.asarray(arr.is_null()))
                    if has_nulls else np.ones(n, np.bool_))

        if dtype.is_variable_width:
            # Arrow's own layout, rebased to start at byte 0; null rows
            # become empty, so they own no bytes
            if pa.types.is_large_string(arr.type):
                arr = arr.cast(pa.string())
            if pa.types.is_large_binary(arr.type):
                arr = arr.cast(pa.binary())
            if has_nulls:
                arr = arr.fill_null(
                    "" if isinstance(dtype, dt.StringType) else b"")
            bufs = arr.buffers()
            off = np.frombuffer(bufs[1], dtype=np.int32, count=n + 1 +
                                arr.offset)[arr.offset:]
            start, nbytes = int(off[0]), int(off[-1] - off[0])
            data = (np.frombuffer(bufs[2], dtype=np.uint8,
                                  count=start + nbytes)[start:]
                    if bufs[2] is not None and nbytes
                    else np.zeros(0, np.uint8))
            return dtype, n, {"data": data, "validity": validity,
                              "offsets": (off - off[0]).astype(np.int32)}

        if isinstance(dtype, dt.DecimalType):
            # The unscaled value is the int128 little-endian word pair. A
            # decimal128 of any precision already stores it; a cast from
            # int64 would rescale instead of reinterpreting.
            filled = arr.fill_null(0) if has_nulls else arr
            if not (pa.types.is_decimal128(filled.type)
                    and filled.type.scale == dtype.scale):
                filled = filled.cast(pa.decimal128(38, dtype.scale))
            words = np.frombuffer(filled.buffers()[1], dtype=np.int64)
            o = filled.offset
            if dtype.is_decimal128:
                data = words[2 * o:2 * (o + n)].reshape(n, 2).copy()
            else:
                data = words[2 * o:2 * (o + n):2].copy()
            return dtype, n, {"data": data, "validity": validity}

        if isinstance(dtype, (dt.ArrayType, dt.MapType)):
            # offsets rebased to start at 0 over the elements they span
            # (a null row keeps whatever range Arrow gave it; every op
            # masks a row's elements by its validity)
            if pa.types.is_large_list(arr.type):
                arr = arr.cast(pa.list_(arr.type.value_type))
            off = np.frombuffer(arr.buffers()[1], dtype=np.int32,
                                count=n + 1 + arr.offset)[arr.offset:]
            lo, hi = (int(off[0]), int(off[-1])) if n else (0, 0)
            values = arr.values.slice(lo, hi - lo)
            _, _, child = Column.host_from_arrow(
                values, dt.element_dtype(dtype))
            return dtype, n, {"data": np.zeros(0, np.int8),
                              "validity": validity,
                              "offsets": (off - lo).astype(np.int32),
                              "children": [child]}
        if isinstance(dtype, dt.StructType):
            kids = [Column.host_from_arrow(arr.field(i), f.dtype)[2]
                    for i, f in enumerate(dtype.fields)]
            return dtype, n, {"data": np.zeros(0, np.int8),
                              "validity": validity, "children": kids}

        if isinstance(dtype, dt.DateType):
            data = np.asarray(arr.fill_null(0).cast(pa.int32()))
        elif isinstance(dtype, dt.TimestampType):
            data = np.asarray(arr.fill_null(0).cast(pa.timestamp("us"))
                              .cast(pa.int64()))
        elif isinstance(dtype, dt.NullType):
            data = np.zeros(n, np.int8)
            validity = np.zeros(n, np.bool_)
        elif isinstance(dtype, (dt.BooleanType, dt.ByteType, dt.ShortType,
                                dt.IntegerType, dt.LongType, dt.FloatType,
                                dt.DoubleType)):
            fill = False if isinstance(dtype, dt.BooleanType) else 0
            filled = arr.fill_null(fill) if has_nulls else arr
            data = np.asarray(filled).astype(dtype.np_dtype, copy=False)
        else:
            raise NotPorted(f"{dtype.simple_name()} columns")
        return dtype, n, {"data": np.ascontiguousarray(data),
                          "validity": validity}

    @staticmethod
    def arrow_from_host(dtype: dt.DataType, n: int,
                        bufs: Dict[str, np.ndarray]):
        """Assemble a pyarrow array of the first n rows of fetched host
        buffers. Null slots are zeroed first, so the array never carries
        leftover values of masked-out rows."""
        import pyarrow as pa
        validity = np.asarray(bufs["validity"])[:n]
        if isinstance(dtype, dt.NullType):
            return pa.nulls(n)
        all_valid = bool(validity.all())
        if dtype.is_nested:
            return _nested_arrow(dtype, n, bufs, validity, all_valid)
        if dtype.is_variable_width:
            off = np.asarray(bufs["offsets"])[:n + 1].astype(np.int32)
            bitmap = (None if all_valid else
                      pa.py_buffer(np.packbits(validity,
                                               bitorder="little")))
            data = np.ascontiguousarray(np.asarray(bufs["data"]))
            return pa.Array.from_buffers(
                dt.to_arrow(dtype), n,
                [bitmap, pa.py_buffer(off.tobytes()),
                 pa.py_buffer(data.tobytes())])
        vals = np.asarray(bufs["data"])[:n]
        if not all_valid:
            keep = validity.reshape((n,) + (1,) * (vals.ndim - 1))
            vals = np.where(keep, vals, np.zeros((), vals.dtype))
        if isinstance(dtype, dt.DecimalType):
            if dtype.is_decimal128:
                words = np.ascontiguousarray(vals, dtype=np.int64)
            else:
                lo = vals.astype(np.int64)
                words = np.empty((n, 2), np.int64)
                words[:, 0] = lo
                words[:, 1] = np.where(lo < 0, np.int64(-1), np.int64(0))
            bitmap = (None if all_valid else
                      pa.py_buffer(np.packbits(validity,
                                               bitorder="little")))
            return pa.Array.from_buffers(
                pa.decimal128(38, dtype.scale), n,
                [bitmap, pa.py_buffer(words.tobytes())]).cast(
                    dt.to_arrow(dtype))
        mask = None if all_valid else ~validity
        if isinstance(dtype, dt.DateType):
            return pa.array(vals, type=pa.int32(), mask=mask).cast(
                pa.date32())
        if isinstance(dtype, dt.TimestampType):
            return pa.array(vals, type=pa.timestamp("us"), mask=mask).cast(
                dt.to_arrow(dtype))
        return pa.array(vals, type=dt.to_arrow(dtype), mask=mask)


def _nested_arrow(dtype, n: int, bufs, validity, all_valid: bool):
    """A list, map or struct Arrow array from its host buffer tree. A
    list's elements are gathered to a dense layout of its valid rows, so
    the array never references elements of a null row."""
    import pyarrow as pa
    kids = bufs["children"]
    if isinstance(dtype, dt.StructType):
        arrs = [Column.arrow_from_host(f.dtype, n, cb)
                for f, cb in zip(dtype.fields, kids)]
        mask = None if all_valid else pa.array(~validity)
        return pa.StructArray.from_arrays(
            arrs, [f.name for f in dtype.fields], mask=mask)
    off = np.asarray(bufs["offsets"])[:n + 1].astype(np.int64)
    lens = np.where(validity, off[1:] - off[:-1], 0) if n else \
        np.zeros(0, np.int64)
    dense = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=dense[1:])
    total = int(dense[-1])
    idx = (np.repeat(off[:-1] - dense[:-1], lens)
           + np.arange(total, dtype=np.int64))
    cb = kids[0]
    ecap = int(np.asarray(cb["validity"]).shape[0])
    edt = dt.element_dtype(dtype)
    child = Column.arrow_from_host(edt, ecap, cb)
    if not (total == ecap and (idx == np.arange(total)).all()):
        child = child.take(pa.array(idx, type=pa.int64()))
    mask = None if all_valid else np.concatenate([~validity, [False]])
    off_arr = pa.array(dense.astype(np.int32), type=pa.int32(), mask=mask)
    if isinstance(dtype, dt.MapType):
        return pa.MapArray.from_arrays(off_arr, child.field(0),
                                       child.field(1))
    return pa.ListArray.from_arrays(off_arr, child,
                                    type=dt.to_arrow(dtype))
