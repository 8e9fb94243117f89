"""Kernel-layer value type: one column as tensors.

`CV` is the port's counterpart of the JAX package's traced column value:
a data tensor and a bool validity tensor of the same length (decimal128
data is [n, 2]); a variable-width column (string, binary) adds int32
offsets [n + 1] and its data is the uint8 bytes, row i being
data[offsets[i]:offsets[i + 1]]. Every op takes and returns CVs; PyTorch
runs them eagerly on the device the tensors live on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["CV", "and_validity", "fma"]


@dataclasses.dataclass
class CV:
    data: torch.Tensor       # [n] ([n, 2] decimal128; uint8 bytes strings)
    validity: torch.Tensor   # bool [n]; True = valid
    offsets: Optional[torch.Tensor] = None   # int32 [n + 1], var-width

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])


def and_validity(*cvs: CV) -> torch.Tensor:
    v = cvs[0].validity
    for c in cvs[1:]:
        v = v & c.validity
    return v


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
