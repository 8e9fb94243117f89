"""String kernels over Arrow-layout (offsets + bytes) columns: the
compares, the literal finders and substring.

The port's copy of the JAX package's `ops/strings.py` pieces the TPC-H
queries need: the byte -> row map, byte lengths, the literal equality
(length check, then big-endian 4-byte chunks, the chunk keys of
`ops/sortkeys.py`), the general byte-lexicographic compare, which walks
the left column's byte domain and takes each row's first differing byte
with a `scatter_reduce_("amin")` (the JAX `segment_min`), the literal
finders behind CONTAINS / STARTSWITH / ENDSWITH / LIKE, and substring.

The finders work in the byte domain as the JAX `_find_literal` does: a
bool per byte position, "the pattern starts here, inside its row",
reduced per row by a `scatter_reduce_("amax")` (the JAX
`segment_max`). Where the JAX package gathers data[pos + j] once per
pattern byte, the port compares the shifted view data[j:] (a match
never reads past its row's end, so the view never runs out), and a
prefix or suffix test reads only the bytes at each row's start or end.
Byte `wildcard` of a pattern (LIKE's `_`) matches any byte; an empty
pattern matches every row. The case maps, trim, pad and the other
string functions wait for the slices that need them.
"""
from __future__ import annotations

import torch

from .kernel_utils import CV

__all__ = ["byte_row_map", "str_len_bytes", "equals_literal", "compare",
           "contains", "startswith", "endswith", "substring"]

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


def _all_rows(cv: CV) -> torch.Tensor:
    return torch.ones(cv.offsets.shape[0] - 1, dtype=torch.bool,
                      device=cv.offsets.device)


def _find_literal(cv: CV, pattern: bytes, wildcard=None):
    """bool per byte position: `pattern` matches starting here, inside
    the row. Returns (match, row, rel, lens): each position's row, its
    offset in the row, and the rows' byte lengths (int64)."""
    dcap = cv.data.shape[0]
    row = byte_row_map(cv.offsets, dcap)
    pos = torch.arange(dcap, dtype=torch.int64, device=row.device)
    rel = pos - cv.offsets[row].to(torch.int64)
    lens = str_len_bytes(cv).to(torch.int64)
    ok = (rel >= 0) & (rel + len(pattern) <= lens[row])
    for j, pb in enumerate(pattern):
        if pb != wildcard:
            # a match ends inside its row, so position pos + j < dcap
            ok[:max(dcap - j, 0)] &= cv.data[j:] == pb
    return ok, row, rel, lens


def contains(cv: CV, pattern: bytes, wildcard=None,
             skip_prefix: int = 0, skip_suffix: int = 0) -> torch.Tensor:
    """bool per row: `pattern` occurs within [skip_prefix, len -
    skip_suffix) of the row (LIKE's bounds: the bytes its prefix and
    suffix runs consumed)."""
    n = cv.offsets.shape[0] - 1
    if not pattern:
        return _all_rows(cv)
    if n == 0 or cv.data.shape[0] == 0:
        return torch.zeros(n, dtype=torch.bool, device=cv.offsets.device)
    ok, row, rel, lens = _find_literal(cv, pattern, wildcard)
    if skip_prefix:
        ok &= rel >= skip_prefix
    if skip_suffix:
        ok &= rel + len(pattern) <= lens[row] - skip_suffix
    hit = torch.zeros(n, dtype=torch.int32, device=ok.device)
    return hit.scatter_reduce_(0, row, ok.to(torch.int32), "amax") > 0


def _match_at(cv: CV, starts: torch.Tensor, pattern: bytes, wildcard):
    """bool per row: `pattern` equals the row's bytes from `starts` on
    (the caller checks that they lie inside the row)."""
    ok = _all_rows(cv)
    last = cv.data.shape[0] - 1
    for j, pb in enumerate(pattern):
        if pb != wildcard:
            ok &= cv.data[(starts + j).clamp(0, max(last, 0))] == pb
    return ok


def startswith(cv: CV, pattern: bytes, wildcard=None) -> torch.Tensor:
    if not pattern:
        return _all_rows(cv)
    fits = str_len_bytes(cv) >= len(pattern)
    if cv.data.shape[0] == 0:
        return fits
    return fits & _match_at(cv, cv.offsets[:-1].to(torch.int64), pattern,
                            wildcard)


def endswith(cv: CV, pattern: bytes, wildcard=None) -> torch.Tensor:
    if not pattern:
        return _all_rows(cv)
    fits = str_len_bytes(cv) >= len(pattern)
    if cv.data.shape[0] == 0:
        return fits
    return fits & _match_at(cv, cv.offsets[1:].to(torch.int64)
                            - len(pattern), pattern, wildcard)


def substring(cv: CV, start: int, length=None) -> CV:
    """Spark substring over bytes: a 1-based start, a negative start
    counting from the end, start 0 as 1, and a length of None for the
    rest of the row. The output's rows are the clipped byte ranges (the
    JAX `rebuild_strings` layout, built by `gather_bytes`); its byte
    buffer keeps the input's length, zero past the last row."""
    from .gather import gather_bytes
    lens = str_len_bytes(cv)
    if start > 0:
        s = torch.clamp(lens, max=start - 1)
    elif start == 0:
        s = torch.zeros_like(lens)
    else:
        s = torch.clamp(lens + start, min=0)
    ln = lens - s
    if length is not None:
        ln = ln.clamp(max=max(length, 0))
    off, data = gather_bytes(cv.data, cv.offsets[:-1] + s, ln,
                             cv.data.shape[0])
    return CV(data, cv.validity, off)
