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

__all__ = ["CV", "and_validity"]


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
