"""Vectorized NFA execution over string columns, as torch ops.

The port of the JAX package's `ops/regex_exec.py` (reference: jni
RegexProgram usage in stringFunctions.scala). Bit-parallel Thompson
simulation: per lane a state bitmask (at most 32 states, held in int64);
each scan step gathers one byte per lane and advances every active
state at once, with no per-row control flow.

The step (`_advance`) differs in form from the JAX one, which loops over
the states (three ops a state). Here the states split into bytes of 8,
and for each byte of states a table maps (input byte, those 8 state
bits) to the OR of their transitions: a step is one gather a byte of
states and an OR, whatever the state count. The tables are built on the
host from the compiled NFA and give the JAX step's bits exactly.

Two scans:
- `nfa_match` (rlike): one lane per ROW, scan over character positions.
- `match_spans` (extract/replace): one lane per BYTE POSITION: for every
  position whether a match starts there and its greedy-longest length;
  `_leftmost_nonoverlap` then picks the matches a left-to-right scan
  would, by pointer-jumping over the skip chain.

Steps past every row's end change nothing, so `nfa_match` takes as many
steps as the longest row (at most MAX_SCAN), and `match_spans` stops
once no lane holds a live state; the answers are those of the JAX
package's fixed step counts. Documented deviations
(docs/compatibility.md Regex): byte-domain (ASCII exact; multi-byte
UTF-8 matched bytewise), greedy-longest instead of backtracking order
for alternations of different lengths, zero-length matches at
end-of-string are not replaced, and a MAX_SCAN-byte scan bound.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .kernel_utils import CV
from .regex_nfa import CompiledRegex

__all__ = ["nfa_match", "match_spans", "replace_all", "extract_first",
           "MAX_SCAN"]

# scan-length safety bound: matches past this byte offset in longer rows
# are missed (documented in docs/compatibility.md Regex)
MAX_SCAN = 256

#: match_spans checks for a live lane once every this many steps
_LIVE_CHECK = 16


def _step_tables(rx: CompiledRegex):
    """int64 [groups, 256 * 256]: for state byte g, entry
    (input byte * 256 + the 8 state bits) is the OR of the transitions of
    the set states on that byte's class."""
    trans = rx.trans.astype(np.int64)          # [n_states, n_classes]
    n_groups = (rx.n_states + 7) // 8
    by_byte = trans[:, rx.class_table.astype(np.int64)]   # [S, 256]
    sub = np.arange(256)
    out = np.zeros((n_groups, 256, 256), np.int64)
    for g in range(n_groups):
        for b in range(8):
            s = 8 * g + b
            if s >= rx.n_states:
                break
            has = ((sub >> b) & 1).astype(bool)       # subsets holding s
            out[g][:, has] |= by_byte[s][:, None]
    return out.reshape(n_groups, 256 * 256)


class _Stepper:
    """The NFA's step tables on one device (kept on the compiled regex,
    one copy a device)."""

    def __init__(self, rx: CompiledRegex, device):
        cache = rx.__dict__.setdefault("_step_tables", {})
        key = str(device)
        if key not in cache:
            cache[key] = [torch.from_numpy(t).to(device)
                          for t in _step_tables(rx)]
        self.tabs = cache[key]

    def advance(self, state, byte):
        """One NFA step for all lanes: state int64 masks, byte the input
        byte (int64) of each lane."""
        base = byte * 256
        nxt = None
        for g, tab in enumerate(self.tabs):
            sb = (state >> (8 * g)) & 255 if g else state & 255
            t = tab[base + sb]
            nxt = t if nxt is None else nxt | t
        return nxt


def _rows(cv: CV):
    n = cv.offsets.shape[0] - 1
    return n, cv.offsets.to(torch.int64)


def nfa_match(rx: CompiledRegex, cv: CV, max_len: int):
    """bool[n]: does each row match (Spark rlike = unanchored search).
    `max_len` steps are taken: past the longest row they change
    nothing."""
    n, off = _rows(cv)
    dev = cv.validity.device
    starts = off[:-1]
    lens = off[1:] - starts
    data = cv.data
    dcap = data.shape[0]
    start_mask, accept = rx.start_mask, rx.accept_mask

    state = torch.full((n,), start_mask, dtype=torch.int64, device=dev)
    zero_ok = bool(start_mask & accept)
    if zero_ok:
        # the empty match: always for unanchored-end; at len==0 otherwise
        matched0 = (torch.ones(n, dtype=torch.bool, device=dev)
                    if not rx.anchored_end else lens == 0)
    else:
        matched0 = torch.zeros(n, dtype=torch.bool, device=dev)
    matched = matched0
    final = torch.where(lens == 0, state, 0)
    if dcap == 0:
        max_len = 0
    step = _Stepper(rx, dev) if max_len else None
    for t in range(int(max_len)):
        inb = t < lens
        byte = data[(starts + t).clamp(0, dcap - 1)].to(torch.int64)
        nxt = step.advance(state, byte)
        if not rx.anchored_start:
            nxt = nxt | start_mask    # search: a match may start anywhere
        nxt = torch.where(inb, nxt, state)
        if rx.anchored_end:
            final = torch.where(t + 1 == lens, nxt, final)
        else:
            matched = matched | (inb & ((nxt & accept) != 0))
        state = nxt
    if rx.anchored_end:
        matched = matched0 | ((final & accept) != 0)
    return matched & cv.validity


def _byte_rows(cv: CV):
    """(pos, row, in_row) of every byte position of the data buffer."""
    from .strings import byte_row_map
    B = cv.data.shape[0]
    row = byte_row_map(cv.offsets, B).to(torch.int64)
    pos = torch.arange(B, dtype=torch.int64, device=row.device)
    off = cv.offsets.to(torch.int64)
    in_row = (pos >= off[0]) & (pos < off[-1])
    return pos, row, in_row


def match_spans(rx: CompiledRegex, cv: CV, max_match: int):
    """(ok bool[B], length int64[B]): for every byte position, whether a
    match starts there (anchored at that position) and its greedy-longest
    length, bounded by max_match bytes. Matches never cross row ends."""
    data = cv.data
    B = data.shape[0]
    pos, row, in_row = _byte_rows(cv)
    off = cv.offsets.to(torch.int64)
    row_end = off[1:][row]
    accept = rx.accept_mask
    state = torch.full((B,), rx.start_mask, dtype=torch.int64,
                       device=pos.device)
    zero_ok = bool(rx.start_mask & accept)
    best = torch.full((B,), 0 if (zero_ok and not rx.anchored_end) else -1,
                      dtype=torch.int64, device=pos.device)
    step = _Stepper(rx, pos.device) if B and max_match else None
    for j in range(int(max_match) if B else 0):
        p = pos + j
        inb = p < row_end
        byte = data[p.clamp(max=B - 1)].to(torch.int64)
        nxt = torch.where(inb, step.advance(state, byte), 0)
        hit = (nxt & accept) != 0
        if rx.anchored_end:
            hit = hit & ((p + 1) == row_end)
        best = torch.where(hit, j + 1, best)
        state = nxt
        if j % _LIVE_CHECK == _LIVE_CHECK - 1 and j + 1 < max_match:
            from ..utils.transfer import fetch_int
            # no live lane: every later step would change nothing
            if not fetch_int(state.any()):
                break
    ok = best >= 0
    if rx.anchored_start:
        ok = ok & (pos == off[:-1][row])
    ok = ok & in_row
    return ok, best.clamp(min=0)


def _leftmost_nonoverlap(cv: CV, ok, length):
    """Positions a left-to-right scan would select: walk each row from its
    start, skipping max(len,1) at a match else 1. Pointer-jumping over the
    skip chain marks the visited positions in O(log B) doubling steps."""
    B = ok.shape[0]
    pos, row, in_row = _byte_rows(cv)
    step = torch.where(ok, length.clamp(min=1), 1)
    jump = (pos + step).clamp(max=B)
    off = cv.offsets.to(torch.int64)
    visited = (pos == off[:-1][row]) & in_row
    n_steps = max(1, int(math.ceil(math.log2(max(B, 2)))) + 1)
    sentinel = torch.full((1,), B, dtype=torch.int64, device=pos.device)
    for _ in range(n_steps):
        newly = torch.zeros(B + 1, dtype=torch.bool, device=pos.device)
        newly.index_fill_(0, torch.where(visited, jump, B), True)
        visited = visited | newly[:B]
        jump = torch.cat([jump, sentinel])[jump]
    return visited & ok


def replace_all(rx: CompiledRegex, cv: CV, repl: bytes,
                max_match: int) -> CV:
    """Replace every selected (leftmost, non-overlapping) match with the
    literal `repl`. Output layout: at a match start the replacement bytes
    are emitted; bytes covered by a match are dropped; everything else
    copies through. The byte buffer is exactly the output's bytes (one
    host read of its size)."""
    from ..utils.transfer import fetch_int
    n, off = _rows(cv)
    B = cv.data.shape[0]
    dev = cv.validity.device
    if B == 0 or n == 0:
        # no bytes: only zero-length matches, which this replace skips
        # at the end of a string, as the JAX package does
        return CV(torch.zeros(0, dtype=torch.uint8, device=dev),
                  cv.validity, torch.zeros(n + 1, dtype=torch.int32,
                                           device=dev))
    ok, length = match_spans(rx, cv, max_match)
    sel = _leftmost_nonoverlap(cv, ok, length)
    pos, row, in_row = _byte_rows(cv)
    sel = sel & in_row

    # bytes covered by a selected match: +1 at its start, -1 at its end
    edges = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    ones = torch.ones(B, dtype=torch.int64, device=dev)
    edges.index_add_(0, torch.where(sel, pos, B), ones)
    edges.index_add_(0, torch.where(sel, (pos + length).clamp(max=B), B),
                     -ones)
    covered = torch.cumsum(edges[:B], 0) > 0
    keep = in_row & ~covered

    rl = len(repl)
    contrib = torch.where(sel, rl, 0) + keep.to(torch.int64)
    out_len = torch.zeros(n, dtype=torch.int64, device=dev)
    out_len.index_add_(0, row, torch.where(in_row, contrib, 0))
    new_off = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    torch.cumsum(out_len, 0, dtype=torch.int32, out=new_off[1:])
    # rows are contiguous and in order, so a byte's output position is
    # the exclusive prefix of every contribution before it
    dst = torch.cumsum(contrib, 0) - contrib
    total = fetch_int(new_off[-1])
    out = torch.zeros(total + 1, dtype=torch.uint8, device=dev)
    # a byte that is not written goes to the sacrificial slot `total`
    out.index_put_((torch.where(keep, dst + torch.where(sel, rl, 0),
                                total),), cv.data[:B])
    for k in range(rl):
        out.index_put_((torch.where(sel, dst + k, total),),
                       torch.tensor(repl[k], dtype=torch.uint8, device=dev))
    return CV(out[:total], cv.validity, new_off)


def extract_first(rx: CompiledRegex, cv: CV, max_match: int):
    """(start int64[n], length int64[n], found bool[n]) of the leftmost
    (then greedy-longest) whole match per row."""
    n, off = _rows(cv)
    B = cv.data.shape[0]
    dev = cv.validity.device
    first = torch.full((n,), B, dtype=torch.int64, device=dev)
    length = torch.zeros(max(B, 1), dtype=torch.int64, device=dev)
    if B and n:
        ok, length = match_spans(rx, cv, max_match)
        pos, row, in_row = _byte_rows(cv)
        first.scatter_reduce_(0, row, torch.where(ok & in_row, pos, B),
                              "amin", include_self=True)
    found = first < B
    safe = first.clamp(0, max(B - 1, 0))
    ln = torch.where(found, length[safe], 0)
    start = torch.where(found, safe, off[:-1])
    if rx.start_mask & rx.accept_mask and not rx.anchored_end:
        # a zero-length match always exists (e.g. `x*`): empty rows match
        found = torch.ones(n, dtype=torch.bool, device=dev)
    return start, ln, found & cv.validity
