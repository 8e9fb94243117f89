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
pattern matches every row.

The rest of the JAX module follows it: the character length (bytes less
UTF-8 continuation bytes, from one cumsum), the ASCII case maps (other
bytes pass unchanged, as in the JAX package), trim, reverse (of bytes),
the first match's position, lpad / rpad (of bytes, to a fixed length),
repeat, concatenation and the concat_ws separator column. An op whose
output can grow sizes its byte buffer from the JAX package's bound (the
inputs' buffers, n * target, the buffer times the count), so none reads
the device back; bytes past the last row are zero.
"""
from __future__ import annotations

import torch

from .kernel_utils import CV

__all__ = ["byte_row_map", "str_len_bytes", "str_len_chars", "upper",
           "lower", "equals_literal", "compare", "contains", "startswith",
           "endswith", "substring", "rebuild_strings", "concat_strings",
           "trim", "reverse", "find_first", "pad", "repeat_str",
           "literal_column", "str_equal_rowmap"]

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


def str_len_chars(cv: CV) -> torch.Tensor:
    """UTF-8 character count per row: bytes less continuation bytes
    (0b10xxxxxx), counted by a cumsum over the byte buffer."""
    cont = ((cv.data & 0xC0) == 0x80).to(torch.int32)
    cs = torch.zeros(cv.data.shape[0] + 1, dtype=torch.int32,
                     device=cv.data.device)
    if cv.data.shape[0]:
        torch.cumsum(cont, 0, dtype=torch.int32, out=cs[1:])
    off = cv.offsets.to(torch.int64)
    return str_len_bytes(cv) - (cs[off[1:]] - cs[off[:-1]])


def _map_case(cv: CV, to_upper: bool) -> CV:
    """ASCII case map; every other byte (UTF-8 multi-byte sequences too)
    passes unchanged, as in the JAX package."""
    d = cv.data
    if to_upper:
        out = torch.where((d >= 97) & (d <= 122), d - 32, d)
    else:
        out = torch.where((d >= 65) & (d <= 90), d + 32, d)
    return CV(out, cv.validity, cv.offsets)


def upper(cv: CV) -> CV:
    return _map_case(cv, True)


def lower(cv: CV) -> CV:
    return _map_case(cv, False)


def _out_row_map(new_off: torch.Tensor, out_cap: int):
    """(row, offset in the row) of each output byte of a layout."""
    n = new_off.shape[0] - 1
    pos = torch.arange(out_cap, dtype=torch.int64, device=new_off.device)
    row = torch.searchsorted(new_off[1:].contiguous(), pos.to(
        new_off.dtype), right=True).clamp(0, max(n - 1, 0))
    return pos, row, pos - new_off[row].to(torch.int64)


def _offsets_of(lens: torch.Tensor) -> torch.Tensor:
    off = torch.zeros(lens.shape[0] + 1, dtype=torch.int32,
                      device=lens.device)
    if lens.shape[0]:
        torch.cumsum(lens, 0, dtype=torch.int32, out=off[1:])
    return off


def rebuild_strings(cv: CV, new_starts, new_lens,
                    out_data_capacity=None, wrap=None) -> CV:
    """A string column whose row i is cv.data[new_starts[i]:][:new_lens[i]]
    (with `wrap`, the source bytes repeat every wrap[i] bytes: repeat()).
    The byte buffer is out_data_capacity (default the input's)."""
    from .gather import gather_bytes
    new_lens = new_lens.clamp(min=0)
    cap = (cv.data.shape[0] if out_data_capacity is None
           else out_data_capacity)
    if wrap is None:
        off, data = gather_bytes(cv.data, new_starts, new_lens, cap)
        return CV(data, cv.validity, off)
    off = _offsets_of(new_lens)
    n = new_lens.shape[0]
    if n == 0 or cap == 0 or cv.data.shape[0] == 0:
        return CV(torch.zeros(cap, dtype=torch.uint8,
                              device=cv.data.device), cv.validity, off)
    pos, row, rel = _out_row_map(off, cap)
    rel = torch.remainder(rel, wrap.to(torch.int64)[row].clamp(min=1))
    src = (new_starts.to(torch.int64)[row] + rel).clamp(
        0, cv.data.shape[0] - 1)
    data = torch.where(pos < off[n], cv.data[src],
                       torch.zeros((), dtype=torch.uint8,
                                   device=cv.data.device))
    return CV(data, cv.validity, off)


def concat_strings(cvs, out_data_capacity: int) -> CV:
    """Row-wise concatenation (null if any input is null, Spark's
    concat); the byte buffer is out_data_capacity."""
    n = cvs[0].offsets.shape[0] - 1
    dev = cvs[0].offsets.device
    lens = [str_len_bytes(c).to(torch.int64) for c in cvs]
    valid = cvs[0].validity
    for c in cvs[1:]:
        valid = valid & c.validity
    off = _offsets_of(torch.where(valid, sum(lens), 0))
    out = torch.zeros(out_data_capacity, dtype=torch.uint8, device=dev)
    if n == 0 or out_data_capacity == 0:
        return CV(out, valid, off)
    pos, row, rel = _out_row_map(off, out_data_capacity)
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    for c, ln in zip(cvs, lens):
        a = acc[row]
        in_this = (rel >= a) & (rel < a + ln[row])
        if c.data.shape[0]:
            src = (c.offsets.to(torch.int64)[row] + (rel - a)).clamp(
                0, c.data.shape[0] - 1)
            out = torch.where(in_this, c.data[src], out)
        acc = acc + ln
    out = torch.where(pos < off[n], out, torch.zeros_like(out))
    return CV(out, valid, off)


def trim(cv: CV, left: bool = True, right: bool = True) -> CV:
    """Strip ASCII spaces (Spark trim / ltrim / rtrim with the default
    ' '): each row's first and last non-space byte from one pass over the
    byte domain."""
    lens = str_len_bytes(cv).to(torch.int64)
    n = lens.shape[0]
    dev = lens.device
    starts = cv.offsets[:-1].to(torch.int64)
    first = torch.full((n,), _NO_DIFF, dtype=torch.int64, device=dev)
    last = torch.full((n,), -1, dtype=torch.int64, device=dev)
    dcap = cv.data.shape[0]
    if dcap and n:
        row = byte_row_map(cv.offsets, dcap)
        rel = torch.arange(dcap, dtype=torch.int64, device=dev) \
            - starts[row]
        non_space = (rel >= 0) & (rel < lens[row]) & (cv.data != 32)
        first.scatter_reduce_(0, row, torch.where(non_space, rel,
                                                  _NO_DIFF), "amin")
        last.scatter_reduce_(0, row, torch.where(non_space, rel, -1),
                             "amax")
    all_space = first >= _NO_DIFF
    lead = torch.where(all_space, lens, first) if left \
        else torch.zeros_like(lens)
    end = last + 1 if right else lens
    new_len = torch.where(all_space, 0, (end - lead).clamp(min=0))
    return rebuild_strings(cv, starts + lead, new_len)


def reverse(cv: CV) -> CV:
    """Each row's bytes reversed (bytes, not characters, as in the JAX
    package)."""
    dcap = cv.data.shape[0]
    if dcap == 0:
        return cv
    row = byte_row_map(cv.offsets, dcap)
    off = cv.offsets.to(torch.int64)
    rel = torch.arange(dcap, dtype=torch.int64, device=off.device) \
        - off[row]
    lens = off[1:] - off[:-1]
    src = (off[row] + (lens[row] - 1 - rel)).clamp(0, dcap - 1)
    in_range = (rel >= 0) & (rel < lens[row])
    data = torch.where(in_range, cv.data[src], torch.zeros_like(cv.data))
    return CV(data, cv.validity, cv.offsets)


def find_first(cv: CV, pattern: bytes) -> torch.Tensor:
    """1-based byte position of the first occurrence of `pattern` in each
    row, 0 when absent; 1 for the empty pattern (Spark instr / locate)."""
    n = cv.offsets.shape[0] - 1
    dev = cv.offsets.device
    if not pattern:
        return torch.ones(n, dtype=torch.int32, device=dev)
    first = torch.full((n,), _NO_DIFF, dtype=torch.int64, device=dev)
    if n and cv.data.shape[0]:
        ok, row, rel, _ = _find_literal(cv, pattern)
        first.scatter_reduce_(0, row, torch.where(ok, rel, _NO_DIFF),
                              "amin")
    return torch.where(first < _NO_DIFF, first + 1, 0).to(torch.int32)


def pad(cv: CV, target_len: int, pad_bytes: bytes, left: bool) -> CV:
    """lpad / rpad to target_len bytes with the pad repeated; a longer
    row is cut to target_len. Bytes, not characters, as in the JAX
    package (docs/compatibility.md). A negative target gives empty rows;
    an empty pad never extends a row, it only cuts."""
    target_len = max(int(target_len), 0)
    lens = str_len_bytes(cv).to(torch.int64)
    n = lens.shape[0]
    dev = lens.device
    if not pad_bytes:
        return rebuild_strings(cv, cv.offsets[:-1],
                               lens.clamp(max=target_len))
    new_off = torch.arange(n + 1, dtype=torch.int32, device=dev) \
        * target_len
    out_cap = max(n * target_len, 1)
    if n == 0:
        return CV(torch.zeros(out_cap, dtype=torch.uint8, device=dev),
                  cv.validity, new_off)
    pos = torch.arange(out_cap, dtype=torch.int64, device=dev)
    row = torch.div(pos, max(target_len, 1),
                    rounding_mode="floor").clamp(0, n - 1)
    rel = pos - row * target_len
    cur = lens.clamp(max=target_len)[row]
    starts = cv.offsets[:-1].to(torch.int64)[row]
    plen = len(pad_bytes)
    if left:
        npad = target_len - cur
        from_pad = rel < npad
        src = starts + (rel - npad)
        pad_idx = torch.remainder(rel, plen)
    else:
        from_pad = rel >= cur
        src = starts + rel
        pad_idx = torch.remainder(rel - cur, plen)
    pad_arr = torch.tensor(list(pad_bytes), dtype=torch.uint8, device=dev)
    body = cv.data[src.clamp(0, max(cv.data.shape[0] - 1, 0))] \
        if cv.data.shape[0] else torch.zeros_like(pos, dtype=torch.uint8)
    out = torch.where(from_pad, pad_arr[pad_idx], body)
    return CV(out, cv.validity, new_off)


def repeat_str(cv: CV, times: int, out_data_capacity: int) -> CV:
    """Each row repeated `times` times (Spark repeat; times <= 0 gives
    empty rows)."""
    times = max(times, 0)
    lens = str_len_bytes(cv)
    return rebuild_strings(cv, cv.offsets[:-1], lens * times,
                           out_data_capacity, wrap=lens)


def literal_column(raw: bytes, present, capacity: int) -> CV:
    """A string column holding `raw` where `present`, '' elsewhere, every
    row valid (concat_ws's separators); the byte buffer is capacity."""
    n = present.shape[0]
    dev = present.device
    off = _offsets_of(torch.where(present, len(raw), 0))
    out_cap = max(capacity, 1)
    nb = max(len(raw), 1)
    if n == 0:
        return CV(torch.zeros(out_cap, dtype=torch.uint8, device=dev),
                  torch.ones(0, dtype=torch.bool, device=dev), off)
    pos, _, rel = _out_row_map(off, out_cap)
    src = torch.tensor(list(raw.ljust(nb, b"\0")), dtype=torch.uint8,
                       device=dev)
    data = torch.where(pos < off[n], src[rel.clamp(0, nb - 1)],
                       torch.zeros((), dtype=torch.uint8, device=dev))
    return CV(data, torch.ones(n, dtype=torch.bool, device=dev), off)


def str_equal_rowmap(ecv: CV, vcv: CV, rows, live) -> torch.Tensor:
    """bool per element: element string e equals vcv's row rows[e],
    compared in the element byte domain with no replication gather."""
    n = ecv.offsets.shape[0] - 1
    le = str_len_bytes(ecv).to(torch.int64)
    lv_e = str_len_bytes(vcv).to(torch.int64)[rows]
    any_diff = torch.zeros(n, dtype=torch.int32, device=le.device)
    dcap = ecv.data.shape[0]
    if dcap and n and vcv.data.shape[0]:
        rowb = byte_row_map(ecv.offsets, dcap)
        rel = torch.arange(dcap, dtype=torch.int64, device=le.device) \
            - ecv.offsets[rowb].to(torch.int64)
        within = (rel >= 0) & (rel < torch.minimum(le, lv_e)[rowb])
        vsrc = (vcv.offsets.to(torch.int64)[rows[rowb]] + rel).clamp(
            0, vcv.data.shape[0] - 1)
        differs = within & (ecv.data != vcv.data[vsrc])
        any_diff.scatter_reduce_(0, rowb, differs.to(torch.int32), "amax")
    return ((le == lv_e) & (any_diff == 0) & ecv.validity
            & vcv.validity[rows] & live)
