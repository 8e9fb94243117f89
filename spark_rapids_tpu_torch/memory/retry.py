"""Split-and-retry: out-of-core execution for inputs bigger than the card.

The port of the JAX package's `memory/retry.py` (reference:
RmmRapidsRetryIterator.scala:36-105 `withRetry(input, splitPolicy)(fn)`):
an idempotent fn over a batch runs again on OOM, with the input split in
half when retrying alone cannot help. OOM is either the analytic
`BudgetExceeded` or the CUDA caching allocator's `torch.OutOfMemoryError`
(which a kernel launch may also surface as a `RuntimeError` whose
message starts "CUDA error: out of memory"); both take the same path.
Before the retry: the thread's pressure hook (`on_pressure`: an
exchange's pooled map worker waits until its step runs alone),
`gc.collect()`, `torch.cuda.empty_cache()` (the allocator keeps freed
blocks), then the device manager's spill hooks.
The exception and its traceback, which hold the failed attempt's
tensors, are dropped first.

Only code inside `with_retry` / `retry_no_split` survives an OOM. The
process-wide counts of OOMs caught and splits taken (`retry_stats`) are
for tests and measurements.
"""
from __future__ import annotations

import gc
import threading
from contextlib import contextmanager
from typing import Callable, Iterator, List, Optional

import torch

from ..columnar.column import Column
from ..columnar.table import Table
from .device import BudgetExceeded, DeviceManager

__all__ = ["with_retry", "retry_no_split", "split_batch_in_half",
           "OutOfCoreError", "is_oom_error", "retry_stats",
           "reset_retry_stats", "on_pressure"]

MAX_SPLITS = 12
#: a split falls at a multiple of this many rows, so each half's view of
#: a fixed-width column starts as aligned as the whole (16 B for 32-bit
#: values, 4 B for the validity bytes) and the partition kernel's vector
#: variant takes it (`ops/partition_kernels.py` `variant`)
SPLIT_ALIGN_ROWS = 8


class OutOfCoreError(Exception):
    pass


#: how much of the exception's own message is ITS message: the status
#: line put first. Matching beyond it (or past the first line) would
#: match user data quoted in the message: a ValueError quoting a row that
#: says "out of memory" is not an OOM.
_OOM_HEAD_CHARS = 256

_STATS_LOCK = threading.Lock()
_STATS = {"ooms": 0, "splits": 0, "retries": 0}


def retry_stats() -> dict:
    """OOMs caught, batch splits taken and unsplit retries, since the
    last reset (process-wide)."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_retry_stats():
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str):
    with _STATS_LOCK:
        _STATS[key] += 1


def _message_head(e: BaseException) -> str:
    return str(e).split("\n", 1)[0][:_OOM_HEAD_CHARS]


def is_oom_error(e: BaseException) -> bool:
    if isinstance(e, (BudgetExceeded, torch.OutOfMemoryError)):
        return True
    head = _message_head(e)
    return ("RESOURCE_EXHAUSTED" in head or "Out of memory" in head
            or "out of memory" in head)


_PRESSURE = threading.local()


@contextmanager
def on_pressure(hook: Callable[[], None]):
    """Run `hook()` on this thread before every recovery between attempts
    inside the block: an exchange's map worker waits there until the
    other workers' device steps have ended, so its retry runs alone."""
    prev = getattr(_PRESSURE, "hook", None)
    _PRESSURE.hook = hook
    try:
        yield
    finally:
        _PRESSURE.hook = prev


def _recover(dm: Optional[DeviceManager]):
    """Between attempts: wait for this thread's pressure hook (if any),
    drop the failed attempt's garbage, hand the allocator's cached blocks
    back, and let the spill store demote."""
    hook = getattr(_PRESSURE, "hook", None)
    if hook is not None:
        hook()
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    if dm is not None:
        dm.trigger_spill()


def split_batch_in_half(batch):
    """Two halves of a batch by row position. No data moves: a fixed
    column's half is a view of its rows, a string column's half a view
    of its rows' byte range of the shared buffer, its offsets rebased
    (one host read of the ranges' ends for all string columns), so a
    gather over a half sizes its output by the half's bytes. A nested
    column's half is gathered (one more host read, for its sizes). The
    halves need not be of equal or power-of-two length: the split falls
    at the middle rounded down to a multiple of SPLIT_ALIGN_ROWS (at the
    middle below twice that many rows; ROADMAP C.45)."""
    from ..exec.batch import DeviceBatch
    from ..ops.gather import gather_cols
    from ..utils.transfer import fetch_ints
    cap = batch.capacity
    if cap < 2:
        raise OutOfCoreError("cannot split a batch of one row")
    half = cap // 2
    if half >= SPLIT_ALIGN_ROWS:
        half -= half % SPLIT_ALIGN_ROWS
    cols = batch.table.columns
    strs = [c for c in cols if c.offsets is not None and not c.children]
    ends = iter(fetch_ints([c.offsets[i] for c in strs
                            for i in (0, half, cap)]))
    bounds = {id(c): (next(ends), next(ends), next(ends)) for c in strs}
    outs = []
    for k, (lo, hi) in enumerate(((0, half), (half, cap))):
        halves = []
        for c in cols:
            n = max(0, min(c.length, hi) - lo)
            if c.children:
                idx = torch.arange(lo, hi, device=c.validity.device)
                halves.append(Column.from_cv(
                    c.dtype, n, gather_cols([c.cv()], idx, None)[0]))
                continue
            if c.offsets is None:
                halves.append(Column(c.dtype, n, c.data[lo:hi],
                                     c.validity[lo:hi]))
                continue
            b0, b1 = bounds[id(c)][k], bounds[id(c)][k + 1]
            halves.append(Column(c.dtype, n, c.data[b0:b1],
                                 c.validity[lo:hi],
                                 c.offsets[lo:hi + 1] - b0))
        outs.append(DeviceBatch(Table(batch.table.names, halves),
                                max(0, min(batch.num_rows, hi) - lo),
                                batch.row_mask[lo:hi]))
    return outs


def with_retry(batch, fn: Callable[[object], object],
               max_splits: int = MAX_SPLITS,
               dm: Optional[DeviceManager] = None) -> Iterator[object]:
    """Run `fn` (idempotent!) over `batch`, splitting in half and retrying
    on device OOM. Yields one result per final sub-batch, in row order."""
    from .diagnostics import retry_scope
    stack: List[tuple] = [(batch, 0)]
    while stack:
        b, depth = stack.pop(0)
        failed = False
        try:
            # compute inside the scope, yield outside it: a generator
            # suspended at yield would hold the scope open
            with retry_scope():
                res = fn(b)
        except Exception as e:  # noqa: BLE001 - filtered below
            if not is_oom_error(e):
                raise
            _bump("ooms")
            if depth >= max_splits:
                raise OutOfCoreError(
                    f"still OOM after {depth} splits") from e
            failed = True
        if not failed:
            yield res
            continue
        res = None
        _recover(dm)
        halves = split_batch_in_half(b)
        _bump("splits")
        stack = [(halves[0], depth + 1), (halves[1], depth + 1)] + stack


def retry_no_split(fn: Callable[[], object], retries: int = 2,
                   dm: Optional[DeviceManager] = None):
    """Run `fn` (idempotent), retrying after recovery on device OOM, for
    work whose input cannot be split (a concatenation, parking a batch):
    the GpuRetryOOM half of the reference's retry framework."""
    from .diagnostics import retry_scope
    attempt = 0
    while True:
        try:
            with retry_scope():
                return fn()
        except Exception as e:  # noqa: BLE001 - filtered below
            if not is_oom_error(e) or attempt >= retries:
                raise
            _bump("ooms")
        attempt += 1
        _bump("retries")
        _recover(dm)
