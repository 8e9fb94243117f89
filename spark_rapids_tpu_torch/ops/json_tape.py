"""Device-side get_json_object over the string byte tape, as torch ops.

The port of the JAX package's `ops/json_tape.py` (the analog of the
reference's JNI ``JSONUtils.getJsonObject``, GpuGetJsonObject.scala):
instead of a per-row character state machine, the WHOLE column's byte
tape is classified in parallel with global-cumsum-rebased segmented
scans:

  * escape parity (run length of preceding backslashes, via a clamped
    cummax of non-backslash positions),
  * in-string parity (cumsum of unescaped quotes per row),
  * structural depth (cumsum of +/-1 braces outside strings),
  * next-non-whitespace (reverse cummin of non-ws positions),

and each static path step (field / array index: SCALAR paths) narrows a
per-row [start, end) span with one masked segment-min per probe (a
`scatter_reduce_("amin")`). The result span is sliced out with the
shared string-rebuild gather and simple escapes are folded on the (much
smaller) result column.

Deviations (documented in docs/compatibility.md): \\uXXXX escapes pass
through verbatim; malformed JSON yields null (Spark's error behavior on
malformed rows is also null, but the boundary cases differ); wildcard
paths stay on the host bridge.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .kernel_utils import CV
from .strings import byte_row_map, rebuild_strings

__all__ = ["device_path_supported", "get_json_object_tape"]

_BIG = 2 ** 30


def device_path_supported(steps: List[Tuple[str, object]]) -> bool:
    """Scalar paths only: field and non-negative index steps."""
    return all(kind == "field" or (kind == "index" and arg >= 0)
               for kind, arg in steps)


def _seg_cumsum_excl(x, row, offsets):
    """Per-row EXCLUSIVE prefix sum over the byte tape: global cumsum
    rebased at each row start."""
    c = torch.cumsum(x, 0)
    excl = c - x
    base = torch.cat([c.new_zeros(1), c])[offsets[:-1]]
    return excl - base[row]


def _escaped(d, pos, in_row, row_start):
    """Is each byte escaped: j = last non-backslash position STRICTLY
    before pos (clamped to row_start-1); the run of backslashes is
    pos-1-j, and a byte is escaped iff that run is odd."""
    non_bs = torch.where((d != 92) | ~in_row, pos, -_BIG)
    nb_cm = torch.cummax(non_bs, 0).values
    prev_nb = torch.cat([nb_cm.new_full((1,), -1), nb_cm[:-1]])
    j = torch.maximum(prev_nb, row_start - 1)
    return ((pos - 1 - j) % 2) == 1


def _is_ws(d, in_row):
    return in_row & ((d == 32) | (d == 9) | (d == 10) | (d == 13))


def _classify(data, offsets, row):
    """Per-byte flags for the whole tape."""
    pos = torch.arange(data.shape[0], dtype=torch.int64, device=data.device)
    d = data.to(torch.int64)
    row_start = offsets[:-1][row]
    row_end = offsets[1:][row]
    in_row = (pos >= row_start) & (pos < row_end)
    escaped = _escaped(d, pos, in_row, row_start)

    quote = (d == 34) & ~escaped & in_row
    qpar = _seg_cumsum_excl(quote.to(torch.int64), row, offsets)
    in_str = (qpar % 2) == 1          # content + CLOSING quote bytes

    structural = ~in_str & in_row
    opens = structural & ((d == 123) | (d == 91))     # { [
    closes = structural & ((d == 125) | (d == 93))    # } ]
    delta = opens.to(torch.int64) - closes.to(torch.int64)
    # EXCLUSIVE depth: '{' at depth D -> its content bytes AND its
    # matching '}' byte all see D+1 (the closer's own -1 is excluded
    # from its exclusive prefix)
    depth = _seg_cumsum_excl(delta, row, offsets)

    # next non-ws position >= pos (within the tape; row bound is checked
    # at use sites): reverse cummin of non-ws positions
    nws = torch.where(~_is_ws(d, in_row), pos, _BIG)
    nnw = torch.flip(torch.cummin(torch.flip(nws, [0]), 0).values, [0])
    return pos, d, in_row, escaped, in_str, depth, nnw


def _first_where(cond, pos, row, n):
    """Per-row first position satisfying cond (else _BIG)."""
    out = torch.full((n,), _BIG, dtype=torch.int64, device=pos.device)
    out.scatter_reduce_(0, row, torch.where(cond, pos, _BIG), "amin",
                        include_self=True)
    return out


def get_json_object_tape(cv: CV, steps, out_data_capacity: int) -> CV:
    """Evaluate a scalar JSON path over a string column on the device."""
    data, validity = cv.data, cv.validity
    offsets = cv.offsets.to(torch.int64)
    n = offsets.shape[0] - 1
    B = data.shape[0]
    if B == 0 or n == 0:
        # no bytes: every row is empty, which is no JSON value
        return CV(torch.zeros(out_data_capacity, dtype=torch.uint8,
                              device=data.device),
                  torch.zeros_like(validity),
                  torch.zeros(n + 1, dtype=torch.int32, device=data.device))
    row = byte_row_map(offsets, B).to(torch.int64)
    pos, d, in_row, escaped, in_str, depth, nnw = _classify(data, offsets,
                                                            row)

    def clampget(arr, idx):
        return arr[idx.clamp(0, arr.shape[0] - 1)]

    # current value span per row: v = first non-ws byte
    v = clampget(nnw, offsets[:-1])
    e = offsets[1:]
    ok = (v < e) & validity

    structural_quote = (d == 34) & ~in_str & in_row

    for kind, arg in steps:
        dv = clampget(depth, v)
        if kind == "field":
            key = arg.encode("utf-8")
            k = len(key)
            # value must be an object
            ok = ok & (clampget(d, v) == 123)
            # candidate key quotes at depth dv+1 inside [v, e)
            match = (structural_quote
                     & (depth == dv[row] + 1)
                     & (pos > v[row]) & (pos < e[row]) & ok[row])
            # key content match (static unroll over key bytes), no
            # escapes inside, closing quote right after
            for i, b in enumerate(key):
                at = pos + 1 + i
                db = clampget(d, at)
                match = match & (db == b) & ~clampget(escaped, at) \
                    & (db != 92)
            close_q = pos + 1 + k
            match = match & (clampget(d, close_q) == 34) \
                & clampget(in_str, close_q)
            # then ':' as next non-ws
            colon = clampget(nnw, close_q + 1)
            match = match & (clampget(d, colon) == 58) & (colon < e[row])
            kp = _first_where(match, pos, row, n)
            ok = ok & (kp < _BIG)
            kp_safe = kp.clamp(0, B - 1)
            colon_r = clampget(nnw, kp_safe + 2 + k)
            new_v = clampget(nnw, colon_r + 1)
            v = torch.where(ok, new_v, v)
        else:  # index
            idx_want = int(arg)
            ok = ok & (clampget(d, v) == 91)
            inside = (pos > v[row]) & (pos < e[row]) & ok[row] & in_row
            comma = inside & ~in_str & (d == 44) & (depth == dv[row] + 1)
            if idx_want == 0:
                new_v = clampget(nnw, (v + 1).clamp(0, B - 1))
                # empty array -> not found
                ok = ok & (clampget(d, new_v) != 93)
            else:
                ccount = _seg_cumsum_excl(comma.to(torch.int64), row,
                                          offsets)
                nth = comma & (ccount == idx_want - 1)
                cp = _first_where(nth, pos, row, n)
                ok = ok & (cp < _BIG)
                new_v = clampget(nnw, cp.clamp(0, B - 1) + 1)
                ok = ok & (clampget(d, new_v) != 93)
            v = torch.where(ok, new_v, v)
        # narrow e to the end of the selected value
        dv2 = clampget(depth, v)
        first_b = clampget(d, v)
        is_container = (first_b == 123) | (first_b == 91)
        closer = torch.where(first_b == 123, 125, 93)
        after_v = (pos > v[row]) & in_row
        cont_end = _first_where(
            after_v & ~in_str & (d == closer[row])
            & (depth == dv2[row] + 1), pos, row, n)
        is_string = first_b == 34
        str_end = _first_where(
            after_v & (d == 34) & ~escaped & in_str, pos, row, n)
        scal_end = _first_where(
            after_v & ~in_str & ((d == 44) | (d == 125) | (d == 93))
            & (depth == dv2[row]), pos, row, n)
        new_e = torch.where(is_container, cont_end + 1,
                            torch.where(is_string, str_end + 1, scal_end))
        new_e = torch.minimum(new_e, e)
        ok = ok & (new_e > v)
        e = torch.where(ok, new_e, e)

    # ---- extract [v, e) ------------------------------------------------
    first_b = clampget(d, v)
    is_string = first_b == 34
    # strings: strip surrounding quotes
    out_s = torch.where(is_string, v + 1, v)
    out_e = torch.where(is_string, e - 1, e)
    # scalars: trim trailing whitespace ('{"a": 1 }' -> '1', not '1 ')
    # via the last non-ws position at or before out_e-1
    pnw = torch.cummax(torch.where(~_is_ws(d, in_row) & in_row, pos,
                                   -_BIG), 0).values
    trimmed = clampget(pnw, out_e - 1) + 1
    out_e = torch.where(is_string, out_e,
                        torch.minimum(torch.maximum(trimmed, out_s), out_e))
    lens = (out_e - out_s).clamp(min=0)
    # JSON null -> SQL NULL (match 'null' exactly)
    is_null_lit = ((lens == 4)
                   & (clampget(d, out_s) == 110)
                   & (clampget(d, out_s + 1) == 117)
                   & (clampget(d, out_s + 2) == 108)
                   & (clampget(d, out_s + 3) == 108)
                   & ~is_string)
    ok = ok & ~is_null_lit
    lens = torch.where(ok, lens, 0)
    raw = rebuild_strings(CV(data, validity, cv.offsets), out_s, lens,
                          out_data_capacity=out_data_capacity)
    # ONLY string results unescape: container results are the raw JSON
    # substring and must stay verbatim (their inner escapes are still
    # quoted JSON)
    return _unescape_simple(CV(raw.data, ok, raw.offsets),
                            apply_row=is_string)


def _unescape_simple(cv: CV, apply_row=None) -> CV:
    """Fold simple escapes (\\" \\\\ \\/ \\n \\t \\r \\b \\f) in place;
    \\uXXXX passes through verbatim (documented). Rows where apply_row
    is False pass through untouched."""
    data = cv.data
    offsets = cv.offsets.to(torch.int64)
    B = data.shape[0]
    n = offsets.shape[0] - 1
    row = byte_row_map(offsets, B).to(torch.int64)
    pos = torch.arange(B, dtype=torch.int64, device=data.device)
    d = data.to(torch.int64)
    row_start = offsets[:-1][row]
    in_row = (pos >= row_start) & (pos < offsets[1:][row])
    escaped = _escaped(d, pos, in_row, row_start)
    if apply_row is not None:
        # non-apply rows keep every byte verbatim: escape detection and
        # byte mapping are disabled there, but in_row/keep stay intact
        app = apply_row[row]
        escaped = escaped & app
    else:
        app = torch.ones(B, dtype=torch.bool, device=data.device)
    nxt = torch.cat([d[1:], d.new_zeros(1)])
    simple = (nxt == 34) | (nxt == 92) | (nxt == 47) | (nxt == 110) \
        | (nxt == 116) | (nxt == 114) | (nxt == 98) | (nxt == 102)
    drop = in_row & app & (d == 92) & ~escaped & simple
    # map the escaped byte to its value
    mapped = torch.where(escaped & (d == 110), 10, d)          # \n
    mapped = torch.where(escaped & (d == 116), 9, mapped)      # \t
    mapped = torch.where(escaped & (d == 114), 13, mapped)     # \r
    mapped = torch.where(escaped & (d == 98), 8, mapped)       # \b
    mapped = torch.where(escaped & (d == 102), 12, mapped)     # \f
    keep = in_row & ~drop
    # compact kept bytes across the tape (per-row contiguity follows
    # because rows are contiguous and lengths shrink)
    keep_i = keep.to(torch.int64)
    new_pos = torch.cumsum(keep_i, 0) - keep_i
    out = torch.zeros(B + 1, dtype=data.dtype, device=data.device)
    out.index_put_((torch.where(keep, new_pos, B),), mapped.to(data.dtype))
    kept_per_row = torch.zeros(n, dtype=torch.int64, device=data.device)
    kept_per_row.index_add_(0, row, keep_i)
    new_off = torch.zeros(n + 1, dtype=torch.int32, device=data.device)
    torch.cumsum(kept_per_row, 0, dtype=torch.int32, out=new_off[1:])
    return CV(out[:B], cv.validity, new_off)
