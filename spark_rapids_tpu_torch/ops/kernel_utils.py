"""Kernel-layer value type: one column as tensors.

`CV` is the port's counterpart of the JAX package's traced column value:
a data tensor and a bool validity tensor of the same length (decimal128
data is [n, 2]); a variable-width column (string, binary) adds int32
offsets [n + 1] and its data is the uint8 bytes, row i being
data[offsets[i]:offsets[i + 1]]. A list (or map) column has int32
offsets [n + 1] into one element child, row i being elements
offsets[i]:offsets[i + 1] of `children[0]`; a struct has one child per
field, each of n rows, and its own validity apart from theirs. A nested
column's data is an empty int8 tensor. Every op takes and returns CVs;
PyTorch runs them eagerly on the device the tensors live on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["CV", "and_validity", "fma", "null_cv", "cv_buffers"]


@dataclasses.dataclass
class CV:
    data: torch.Tensor       # [n] ([n, 2] decimal128; uint8 bytes strings)
    validity: torch.Tensor   # bool [n]; True = valid
    offsets: Optional[torch.Tensor] = None   # int32 [n + 1], var-width
    children: tuple = ()     # list element / struct fields

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def child(self) -> "CV":
        return self.children[0]

    @property
    def is_struct(self) -> bool:
        return bool(self.children) and self.offsets is None


def and_validity(*cvs: CV) -> torch.Tensor:
    v = cvs[0].validity
    for c in cvs[1:]:
        v = v & c.validity
    return v


def cv_buffers(cv: CV) -> list:
    """A CV's tensors in the flat order of `columnar.column.buffer_names`:
    its own data, validity and offsets, then each child's, depth first."""
    out = [cv.data, cv.validity]
    if cv.offsets is not None:
        out.append(cv.offsets)
    for c in cv.children:
        out += cv_buffers(c)
    return out


def null_cv(dtype, n: int, device) -> CV:
    """An all-null column of `dtype`, n rows, zeroed buffers (a list's
    rows are empty, a struct's fields null too)."""
    from ..columnar import dtypes as dt
    none = torch.zeros(n, dtype=torch.bool, device=device)
    empty = torch.zeros(0, dtype=torch.int8, device=device)
    if isinstance(dtype, (dt.ArrayType, dt.MapType)):
        return CV(empty, none, torch.zeros(n + 1, dtype=torch.int32,
                                           device=device),
                  (null_cv(dt.element_dtype(dtype), 0, device),))
    if isinstance(dtype, dt.StructType):
        return CV(empty, none, None,
                  tuple(null_cv(f.dtype, n, device) for f in dtype.fields))
    if dtype.is_variable_width:
        return CV(torch.zeros(0, dtype=torch.uint8, device=device), none,
                  torch.zeros(n + 1, dtype=torch.int32, device=device))
    return CV(torch.zeros(dt.alloc_shape(dtype, n),
                          dtype=dt.torch_dtype(dtype), device=device), none)


_SPLIT = 134217729.0     # 2^27 + 1: Dekker's split of a float64


def fma(a, b, c):
    """a * b + c rounded once, from plain float64 ops (Dekker's exact
    product, Knuth's exact sum), the same bits on any device: the fused
    multiply-add that XLA makes of the JAX package's percentile
    interpolation and of its string -> double parse. Where the split
    overflows (|a| or |b| near the top of the range) or a value is not
    finite, plain a * b + c."""
    p = a * b

    def split(v):
        t = _SPLIT * v
        hi = t - (t - v)
        return hi, v - hi

    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    r = s + (((p - (s - bb)) + (c - bb)) + err)
    return torch.where(torch.isfinite(r), r, p + c)
