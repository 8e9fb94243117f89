"""String kernels over Arrow-layout (offsets + bytes) columns: the
compares.

The port's copy of the JAX package's `ops/strings.py` pieces the Q3
slice needs: the byte -> row map, byte lengths, the literal equality
(length check, then big-endian 4-byte chunks, the chunk keys of
`ops/sortkeys.py`) and the general byte-lexicographic compare, which
walks the left column's byte domain and takes each row's first
differing byte with a `scatter_reduce_("amin")` (the JAX `segment_min`).
The other string expressions (case maps, substring, LIKE, ...) wait for
the slices that need them.
"""
from __future__ import annotations

import torch

from .kernel_utils import CV

__all__ = ["byte_row_map", "str_len_bytes", "equals_literal", "compare"]

_NO_DIFF = 1 << 30


def byte_row_map(offsets: torch.Tensor, dcap: int) -> torch.Tensor:
    """Row index (int64) of every byte position of the data buffer
    (clipped to the last row for positions past the last offset)."""
    pos = torch.arange(dcap, dtype=offsets.dtype, device=offsets.device)
    n = offsets.shape[0] - 1
    row = torch.searchsorted(offsets[1:].contiguous(), pos, right=True)
    return row.clamp(0, max(n - 1, 0))


def str_len_bytes(cv: CV) -> torch.Tensor:
    return cv.offsets[1:] - cv.offsets[:-1]


def equals_literal(cv: CV, raw: bytes) -> torch.Tensor:
    """bool per row: row == the constant bytes `raw`. Equal length and
    equal zero-padded chunks <=> equal bytes, whatever the bytes are (a
    trailing 0x00 changes the length)."""
    from .sortkeys import string_chunk_keys
    lens = str_len_bytes(cv)
    ok = lens == len(raw)
    nch = (len(raw) + 3) // 4
    if nch:
        for i, k in enumerate(string_chunk_keys(cv, nch)):
            word = int.from_bytes(raw[i * 4:(i + 1) * 4].ljust(4, b"\0"),
                                  "big")
            ok = ok & (k == word)
    return ok


def compare(a: CV, b: CV) -> torch.Tensor:
    """Per-row byte-lexicographic compare of two string columns of one
    row count: int8 in {-1, 0, 1}. Walks a's byte domain, then breaks a
    common prefix by length."""
    n = a.offsets.shape[0] - 1
    dev = a.offsets.device
    la = str_len_bytes(a).to(torch.int64)
    lb = str_len_bytes(b).to(torch.int64)
    dcap, bcap = a.data.shape[0], b.data.shape[0]
    first_diff = torch.full((n,), _NO_DIFF, dtype=torch.int64, device=dev)
    if dcap and bcap and n:
        row = byte_row_map(a.offsets, dcap)
        pos = torch.arange(dcap, dtype=torch.int64, device=dev)
        rel = pos - a.offsets[row].to(torch.int64)
        within = (rel >= 0) & (rel < torch.minimum(la, lb)[row])
        bsrc = (b.offsets[row].to(torch.int64) + rel).clamp(0, bcap - 1)
        differs = within & (a.data != b.data[bsrc])
        first_diff.scatter_reduce_(
            0, row, torch.where(differs, rel, _NO_DIFF), "amin",
            include_self=True)
    has_diff = first_diff < _NO_DIFF
    fd = torch.where(has_diff, first_diff, 0)
    av = a.data[(a.offsets[:-1].to(torch.int64) + fd).clamp(
        0, max(dcap - 1, 0))].to(torch.int32) if dcap else \
        torch.zeros(n, dtype=torch.int32, device=dev)
    bv = b.data[(b.offsets[:-1].to(torch.int64) + fd).clamp(
        0, max(bcap - 1, 0))].to(torch.int32) if bcap else \
        torch.zeros(n, dtype=torch.int32, device=dev)
    out = torch.where(has_diff, torch.sign(av - bv).to(torch.int64),
                      torch.sign(la - lb))
    return out.to(torch.int8)
