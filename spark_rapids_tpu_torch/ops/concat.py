"""Device concatenation of column values (cudf `Table.concatenate`).

The port's copy of the JAX package's `ops/concat.py`. A string
concatenation rebuilds a gap-free byte layout from each part's row
starts and lengths: shifting the raw offsets alone would let a part's
last row run into the zero bytes a gather leaves after its last row. A
list concatenates its element children recursively and rebuilds the
same way over elements (`_concat_nested`); a struct concatenates field
by field.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..columnar import dtypes as dt
from .gather import elem_map, gather_bytes, take
from .kernel_utils import CV

__all__ = ["concat_cvs", "concat_masks"]


def concat_cvs(parts: Sequence[CV], dtype: dt.DataType) -> CV:
    if len(parts) == 1:
        return parts[0]
    if parts[0].children:
        return _concat_nested(parts, dtype)
    data = torch.cat([p.data for p in parts])
    valid = torch.cat([p.validity for p in parts])
    if parts[0].offsets is None:
        return CV(data, valid)
    starts, lens = [], []
    shift = 0
    for p in parts:
        starts.append(p.offsets[:-1].to(torch.int64) + shift)
        lens.append(p.offsets[1:] - p.offsets[:-1])
        shift += p.data.shape[0]
    off, out = gather_bytes(data, torch.cat(starts), torch.cat(lens),
                            data.shape[0])
    return CV(out, valid, off)


def _concat_nested(parts: Sequence[CV], dtype: dt.DataType) -> CV:
    """Concatenate list or struct columns (JAX `ops/concat.py:41`)."""
    valid = torch.cat([p.validity for p in parts])
    if isinstance(dtype, dt.StructType):
        kids = tuple(concat_cvs([p.children[i] for p in parts], f.dtype)
                     for i, f in enumerate(dtype.fields))
        return CV(parts[0].data, valid, None, kids)
    child = concat_cvs([p.child for p in parts], dt.element_dtype(dtype))
    starts, lens = [], []
    shift = 0
    for p in parts:
        ln = p.offsets[1:] - p.offsets[:-1]
        lens.append(torch.where(p.validity, ln, 0))
        starts.append(p.offsets[:-1].to(torch.int64) + shift)
        shift += p.child.capacity
    lens = torch.cat(lens)
    n = lens.shape[0]
    new_off = torch.zeros(n + 1, dtype=torch.int32, device=valid.device)
    if n:
        torch.cumsum(lens, 0, dtype=torch.int32, out=new_off[1:])
    src, ok = elem_map(new_off, torch.cat(starts), n, child.capacity)
    out = take(child, src.clamp(0, max(child.capacity - 1, 0)), ok)
    return CV(parts[0].data, valid, new_off, (out,))


def concat_masks(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(masks))
