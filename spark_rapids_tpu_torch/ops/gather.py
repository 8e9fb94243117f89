"""Gather and compaction of columns: fixed-width and string.

The port's copy of the JAX package's `ops/gather.py` for fixed-width and
string columns (list, struct and the repeat-measure forms wait for the
slices that need them). A string gather rebuilds the offsets with a
cumsum and moves the bytes with a byte -> row map (scatter of row starts
plus a running max): O(bytes), no per-row loop. The output's byte buffer
is the source's length unless the caller sizes it (`gather_cols` sizes
it exactly, at the cost of one host read); bytes past the last row are
zero.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import transfer
from .kernel_utils import CV

__all__ = ["take_fixed", "take_strings", "take", "compact",
           "compaction_perm", "gather_cols", "gather_groups", "row_of_unit",
           "gather_bytes"]


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


def take(cv: CV, idx: torch.Tensor,
         in_bounds: Optional[torch.Tensor] = None,
         out_data_capacity: Optional[int] = None) -> CV:
    """Gather rows of any ported column."""
    if cv.offsets is not None:
        return take_strings(cv, idx, in_bounds, out_data_capacity)
    return take_fixed(cv, idx, in_bounds)


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


def _bytes_taken(cv: CV, idx, inb) -> torch.Tensor:
    safe = idx.to(torch.int64).clamp(0, cv.offsets.shape[0] - 2)
    valid = cv.validity[safe]
    if inb is not None:
        valid = valid & inb
    lens = cv.offsets[safe + 1] - cv.offsets[safe]
    return torch.where(valid, lens, 0).to(torch.int64).sum()


def gather_cols(cvs: Sequence[CV], idx: torch.Tensor,
                inb: Optional[torch.Tensor]) -> List[CV]:
    """Gather a table's columns by idx. String columns get a byte buffer
    of exactly the bytes gathered (a gather may repeat rows, so the
    source's length is no bound): one host read for all of them."""
    return gather_groups([(cvs, idx, inb)])[0]


def gather_groups(groups) -> List[List[CV]]:
    """`gather_cols` of several (cvs, idx, inb) groups (a join's two
    sides), with one host read for the string columns of all of them."""
    var = [(g, i) for g, (cvs, _, _) in enumerate(groups)
           for i, cv in enumerate(cvs) if cv.offsets is not None]
    caps = dict(zip(var, transfer.fetch_ints(
        [_bytes_taken(groups[g][0][i], groups[g][1], groups[g][2])
         for g, i in var])))
    return [[take(cv, idx, inb, caps.get((g, i)))
             for i, cv in enumerate(cvs)]
            for g, (cvs, idx, inb) in enumerate(groups)]
