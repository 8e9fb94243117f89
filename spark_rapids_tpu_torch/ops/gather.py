"""Gather and compaction of columns: fixed-width, string, list, struct.

The port's copy of the JAX package's `ops/gather.py`. A string gather
rebuilds the offsets with a cumsum and moves the bytes with a byte ->
row map (scatter of row starts plus a running max): O(bytes), no per-row
loop. A list gather does the same over its elements and gathers the
element child recursively; a struct gathers each field. The output's
byte (element) buffer is the source's length unless the caller sizes it
(`gather_cols` sizes it exactly, at the cost of one host read for every
variable-width level of every column: a gather may repeat rows, so the
source's length is no bound); units past the last row are zero (null).
`take_measures` and `repeat_measures` give those sizes, depth first, in
the order `take(..., caps=...)` consumes them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import transfer
from .kernel_utils import CV

__all__ = ["take_fixed", "take_strings", "take", "compact",
           "compaction_perm", "gather_cols", "gather_groups", "row_of_unit",
           "gather_bytes", "take_measures", "repeat_measures", "elem_map",
           "null_like"]


def take_fixed(cv: CV, idx: torch.Tensor,
               in_bounds: Optional[torch.Tensor] = None) -> CV:
    """Gather rows of a fixed-width column (decimal128 [n, 2] included).
    idx must lie in [0, capacity); rows where in_bounds is False become
    null."""
    valid = cv.validity[idx]
    if in_bounds is not None:
        valid = valid & in_bounds
    return CV(cv.data[idx], valid)


def row_of_unit(new_off: torch.Tensor, n_out: int,
                out_cap: int) -> torch.Tensor:
    """For a var-width layout: the row that owns each of `out_cap` output
    bytes (scatter of each row's start, then a running max; a byte past
    the last row maps to the last row)."""
    starts = new_off[:n_out].to(torch.int64).clamp(max=out_cap)
    rob = torch.zeros(out_cap + 1, dtype=torch.int64, device=new_off.device)
    rob.scatter_reduce_(0, starts, torch.arange(n_out, device=rob.device),
                        "amax", include_self=True)
    return torch.cummax(rob, 0).values[:out_cap]


def gather_bytes(data: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, out_cap: int):
    """A string layout whose row i is data[starts[i]:starts[i] + lens[i]]:
    (int32 offsets [n + 1], uint8 bytes [out_cap]); out_cap must hold the
    sum of lens, and bytes past it are zero."""
    n = lens.shape[0]
    dev = data.device
    new_off = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    if n:
        torch.cumsum(lens, 0, dtype=torch.int32, out=new_off[1:])
    if n == 0 or out_cap == 0 or data.shape[0] == 0:
        return new_off, torch.zeros(out_cap, dtype=torch.uint8, device=dev)
    pos = torch.arange(out_cap, dtype=torch.int64, device=dev)
    row = row_of_unit(new_off, n, out_cap)
    src = starts.to(torch.int64)[row] + (pos - new_off[row])
    src = src.clamp(0, data.shape[0] - 1)
    out = torch.where(pos < new_off[n], data[src],
                      torch.zeros((), dtype=torch.uint8, device=dev))
    return new_off, out


def take_strings(cv: CV, idx: torch.Tensor,
                 in_bounds: Optional[torch.Tensor] = None,
                 out_data_capacity: Optional[int] = None) -> CV:
    """Gather rows of a string column, rebuilding offsets and bytes. A
    null or out-of-bounds row becomes an empty null row."""
    safe = idx.to(torch.int64).clamp(0, cv.offsets.shape[0] - 2)
    starts = cv.offsets[safe]
    lens = cv.offsets[safe + 1] - starts
    valid = cv.validity[safe]
    if in_bounds is not None:
        valid = valid & in_bounds
    lens = torch.where(valid, lens, 0)
    cap = (cv.data.shape[0] if out_data_capacity is None
           else out_data_capacity)
    off, data = gather_bytes(cv.data, starts, lens, cap)
    return CV(data, valid, off)


def elem_map(new_off: torch.Tensor, starts: torch.Tensor, n: int,
             out_cap: int):
    """For a list layout whose row i takes lens[i] units from
    starts[i] (new_off their cumsum): each of `out_cap` output units'
    source position and whether it is in use."""
    dev = new_off.device
    pos = torch.arange(out_cap, dtype=torch.int64, device=dev)
    if n == 0:
        return torch.zeros_like(pos), torch.zeros(out_cap, dtype=torch.bool,
                                                  device=dev)
    row = row_of_unit(new_off, n, out_cap)
    src = starts.to(torch.int64)[row] + (pos - new_off[row])
    return src, pos < new_off[n]


def take_array(cv: CV, idx: torch.Tensor, in_bounds=None,
               out_elem_capacity: Optional[int] = None, caps=None) -> CV:
    """Gather rows of a list column: offsets from the gathered rows'
    lengths (a null or out-of-bounds row is empty), then the referenced
    element ranges of the child, recursively."""
    off = cv.offsets
    safe = idx.to(torch.int64).clamp(0, max(off.shape[0] - 2, 0))
    valid = cv.validity[safe] if cv.capacity else torch.zeros(
        idx.shape[0], dtype=torch.bool, device=off.device)
    if in_bounds is not None:
        valid = valid & in_bounds
    starts = off[safe] if cv.capacity else torch.zeros_like(safe)
    lens = torch.where(valid, (off[safe + 1] - off[safe]) if cv.capacity
                       else torch.zeros_like(safe), 0)
    n = idx.shape[0]
    new_off = torch.zeros(n + 1, dtype=torch.int32, device=off.device)
    if n:
        torch.cumsum(lens, 0, dtype=torch.int32, out=new_off[1:])
    ecap = (cv.child.capacity if out_elem_capacity is None
            else out_elem_capacity)
    src, ok = elem_map(new_off, starts, n, ecap)
    ch = cv.child
    src = src.clamp(0, max(ch.capacity - 1, 0))
    child = take(ch, src, ok, caps) if ch.capacity else null_like(ch, ecap)
    return CV(cv.data, valid, new_off, (child,))


def null_like(cv: CV, n: int) -> CV:
    """An all-null column of n rows with `cv`'s layout."""
    dev = cv.validity.device
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    if cv.is_struct:
        return CV(cv.data, none, None,
                  tuple(null_like(c, n) for c in cv.children))
    if cv.offsets is not None:
        off = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        if cv.children:
            return CV(cv.data, none, off, (null_like(cv.child, 0),))
        return CV(cv.data[:0], none, off)
    return CV(torch.zeros((n,) + tuple(cv.data.shape[1:]),
                          dtype=cv.data.dtype, device=dev), none)


def take_struct(cv: CV, idx: torch.Tensor, in_bounds=None,
                caps=None) -> CV:
    valid = cv.validity[idx]
    if in_bounds is not None:
        valid = valid & in_bounds
    return CV(cv.data, valid, None,
              tuple(take(ch, idx, in_bounds, caps) for ch in cv.children))


def take(cv: CV, idx: torch.Tensor,
         in_bounds: Optional[torch.Tensor] = None,
         out_data_capacity=None) -> CV:
    """Gather rows of any column (idx in [0, capacity)).
    `out_data_capacity` is a string's byte capacity, or for a nested
    column an iterator of the variable-width capacities of every level
    (`take_measures`' sizes), depth first; without one the source's
    lengths are reused (right when no row repeats)."""
    caps = out_data_capacity
    if cv.children:
        if cv.offsets is not None:
            return take_array(cv, idx, in_bounds,
                              next(caps) if caps is not None else None,
                              caps)
        return take_struct(cv, idx, in_bounds, caps)
    if cv.offsets is not None:
        if hasattr(caps, "__next__"):
            caps = next(caps)
        return take_strings(cv, idx, in_bounds, caps)
    return take_fixed(cv, idx, in_bounds)


def _span_measures(cv: CV, starts, ends, valid, weight, out: list):
    """Units below a list level spanning element ranges [starts, ends)
    of `cv` (weighted per range), depth first."""
    if cv.is_struct:
        for ch in cv.children:
            _span_measures(ch, starts, ends, valid, weight, out)
        return
    if cv.offsets is None:
        return
    hi = cv.offsets.shape[0] - 1
    s2 = cv.offsets[starts.clamp(0, hi)].to(torch.int64)
    e2 = cv.offsets[ends.clamp(0, hi)].to(torch.int64)
    units = torch.where(valid, e2 - s2, 0)
    out.append((weight * units).sum())
    if cv.children:
        _span_measures(cv.child, s2, e2, valid, weight, out)


def take_measures(cv: CV, idx, in_bounds=None) -> List[torch.Tensor]:
    """0-d tensors: the variable-width units (bytes, elements) that a
    gather of rows `idx` of `cv` needs at each level, depth first."""
    out: List[torch.Tensor] = []
    _measures(cv, idx, in_bounds, None, out)
    return out


def repeat_measures(cv: CV, eff) -> List[torch.Tensor]:
    """As `take_measures` when row i of `cv` repeats eff[i] times."""
    out: List[torch.Tensor] = []
    idx = torch.arange(cv.capacity, device=cv.validity.device)
    _measures(cv, idx, None, eff.to(torch.int64), out)
    return out


def _measures(cv: CV, idx, inb, weight, out: list):
    if cv.is_struct:
        for ch in cv.children:
            _measures(ch, idx, inb, weight, out)
        return
    if cv.offsets is None:
        return
    if weight is None:
        weight = torch.ones(idx.shape[0], dtype=torch.int64,
                            device=cv.validity.device)
    if cv.capacity == 0:
        out.append(torch.zeros((), dtype=torch.int64,
                               device=cv.validity.device))
        if cv.children:
            _measures(cv.child, idx[:0], None, weight[:0], out)
        return
    safe = idx.to(torch.int64).clamp(0, cv.offsets.shape[0] - 2)
    starts = cv.offsets[safe].to(torch.int64)
    ends = cv.offsets[safe + 1].to(torch.int64)
    valid = cv.validity[safe]
    if inb is not None:
        valid = valid & inb
    out.append((weight * torch.where(valid, ends - starts, 0)).sum())
    if cv.children:
        _span_measures(cv.child, starts, ends, valid, weight, out)


def compaction_perm(mask: torch.Tensor):
    """Stable permutation moving the live rows to the front: (perm,
    count as a 0-d tensor). perm[i] is the source row of output slot i.
    Two cumsums and a scatter, no sort."""
    n = mask.shape[0]
    m = mask.to(torch.int64)
    count = m.sum()
    live_pos = torch.cumsum(m, 0) - m
    dead_pos = count + torch.cumsum(1 - m, 0) - (1 - m)
    pos = torch.where(mask, live_pos, dead_pos)
    perm = torch.empty(n, dtype=torch.int64, device=mask.device)
    perm.scatter_(0, pos, torch.arange(n, device=mask.device))
    return perm, count


def compact(cvs: Sequence[CV], mask: torch.Tensor) -> Tuple[List[CV], int]:
    """Move the live rows to the front, in order, and drop the rest.
    Returns the dense columns and the live-row count (one host sync)."""
    idx = torch.nonzero(mask).squeeze(1)
    transfer.note_sync()
    return [take(cv, idx) for cv in cvs], int(idx.shape[0])


def gather_cols(cvs: Sequence[CV], idx: torch.Tensor,
                inb: Optional[torch.Tensor]) -> List[CV]:
    """Gather a table's columns by idx. String and nested columns get
    buffers of exactly the units gathered (a gather may repeat rows, so
    the source's length is no bound): one host read for all of them."""
    return gather_groups([(cvs, idx, inb)])[0]


def gather_groups(groups) -> List[List[CV]]:
    """`gather_cols` of several (cvs, idx, inb) groups (a join's two
    sides), with one host read for the string and nested columns of all
    of them."""
    var = [(g, i) for g, (cvs, _, _) in enumerate(groups)
           for i, cv in enumerate(cvs)
           if cv.offsets is not None or cv.children]
    ms = [take_measures(groups[g][0][i], groups[g][1], groups[g][2])
          for g, i in var]
    got = iter(transfer.fetch_ints([m for mm in ms for m in mm]))
    caps = {k: [next(got) for _ in mm] for k, mm in zip(var, ms)}
    return [[take(cv, idx, inb, iter(caps[(g, i)]) if (g, i) in caps
                  else None)
             for i, cv in enumerate(cvs)]
            for g, (cvs, idx, inb) in enumerate(groups)]
