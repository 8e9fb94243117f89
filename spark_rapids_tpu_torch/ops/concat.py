"""Device concatenation of column values (cudf `Table.concatenate`).

The port's copy of the JAX package's `ops/concat.py` for fixed-width and
string columns. A string concatenation rebuilds a gap-free byte layout
from each part's row starts and lengths: shifting the raw offsets alone
would let a part's last row run into the zero bytes a gather leaves
after its last row.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..columnar import dtypes as dt
from .gather import gather_bytes
from .kernel_utils import CV

__all__ = ["concat_cvs", "concat_masks"]


def concat_cvs(parts: Sequence[CV], dtype: dt.DataType) -> CV:
    if len(parts) == 1:
        return parts[0]
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


def concat_masks(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(masks))
