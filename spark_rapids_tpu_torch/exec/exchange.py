"""Shuffle exchange: hash (or round-robin) repartitioning in one process.

Map side, once per child batch, on the device: partition ids (for one
int32/date key the Hopper kernel of `ops/partition_kernels.py`, else the
murmur3 fold of `ops/hash.py`, string keys included), dead rows to an
overflow bucket n, a stable argsort by target, per-partition counts, and
one gather (a string column's bytes too); then ONE copy to pinned host
memory and host slicing into per-reduce pieces, in map-partition order.
Reduce side: a partition's pieces concatenate on the host (string
offsets rebased onto the joined bytes) and move to the device in ONE
copy, one batch per non-empty partition. This is the JAX package's data
path with its shuffle files replaced by pieces held in this process's
memory. A grouped aggregate's partial states (keys plus flat state
columns) take the same path.

The adaptive stage API (JAX `:292-319`): `stage_stats` materializes the
map stage and returns the bytes of each reduce partition, and
`read_slice` reads one byte-balanced slice of a reduce partition (whole
pieces, as the JAX package reads whole serialized blocks; the slices of
a partition cover it exactly once). The bytes are those of the host
pieces this process holds, uncompressed; the JAX package counts its
shuffle files' compressed serialized bytes (ROADMAP C.7), so a decision
taken on them can differ between the packages on the same data, never
the rows. The map phase runs once, under the exchange's lock, whichever
thread (a broadcast build's or a concurrent collect task's included)
asks first.

The map side (JAX `:196-270`) runs its partitions on a pool of
`sql.exec.exchange.mapThreads` workers (0 = min(4, cores); 1 = one
after another): each worker runs one map partition (the child's
batches, the device pass, the host slicing) into pieces of its own,
which merge in map-partition order, never in completion order. Device
admission goes through `exchange_pool.PermitRider`, so a caller that
holds the only permit cannot deadlock its workers; the seconds workers
waited are `mapPoolWaitMs`. A worker that catches an OOM in its device
step (the child's upload included: the scan copies under
`retry_no_split`) retries once the other workers' steps have ended, as
the serial map side would (`mapPoolAloneSteps` counts such steps).
`mapTime` and `sliceTime` add up over the workers, so on the pool they
exceed the map side's wall time.

Memory runtime (JAX `:153-213`, `:302`): each batch's map pass runs
under `with_retry`, so a device OOM splits the batch and its halves give
more pieces a partition, with the same rows; the reduce concatenation
and upload run under `retry_no_split`. `RangeShuffleExchangeExec` (JAX
`:321-378`) partitions on one numeric or date key by bounds sampled from
the first child batch (`searchsorted`, right side; nulls to partition
0): the out-of-core sort's exchange. `release()` drops the host pieces.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..columnar.column import Column, tree_from_flat, tree_to_flat
from ..columnar.table import Schema, Table
from ..expr.expressions import EmitCtx, Expression
from ..memory.retry import retry_no_split, with_retry
from ..ops.gather import take
from ..ops.hash import partition_ids
from ..ops.kernel_utils import cv_buffers
from ..ops.partition_kernels import partition_ids_i32
from ..profiler import tracing
from ..runtime import faults, lockdep
from ..service.query_manager import _query_scope, current_query_id
from .base import ExecContext, Once, TpuExec
from .batch import DeviceBatch, to_device, to_host
from .exchange_pool import PermitRider, resolve_map_threads

__all__ = ["ShuffleExchangeExec", "RangeShuffleExchangeExec"]


class ShuffleExchangeExec(TpuExec):
    def __init__(self, child: TpuExec, num_partitions: int,
                 bound_keys: Optional[Sequence[Expression]],
                 schema: Schema):
        super().__init__([child], schema)
        self.n = num_partitions
        self.keys = list(bound_keys) if bound_keys else None
        self._lock = lockdep.rlock("ShuffleExchangeExec._lock")
        # the map side's output, (pieces, pstats): per reduce partition
        # its host pieces [(cols, rows, bytes)] in map order, and its bytes
        self._map_out: Once[Tuple[List[list], List[int]]] = Once(self._lock)

    def describe(self):
        mode = "hash" if self.keys else "roundrobin"
        return f"ShuffleExchangeExec[{mode}, n={self.n}]"

    def num_partitions(self, ctx):
        return self.n

    def _partition_ids(self, cvs, mask):
        """int32 target partition per row."""
        if not self.keys:
            live = torch.cumsum(mask.to(torch.int32), 0) - 1
            return torch.remainder(live, self.n).to(torch.int32)
        ctx = EmitCtx(cvs, mask.shape[0], mask.device)
        key_cvs = [k.emit(ctx) for k in self.keys]
        if len(self.keys) == 1 and isinstance(
                self.keys[0].dtype, (dt.IntegerType, dt.DateType)):
            k = key_cvs[0]
            return partition_ids_i32(k.data.contiguous(),
                                     k.validity.contiguous(), self.n)
        return partition_ids(key_cvs, [k.dtype for k in self.keys], self.n)

    def _map_batch(self, batch: DeviceBatch):
        """Partition one batch on the device; return its host copy:
        per-column buffer trees (`columnar/column.py`) sorted by target,
        and the counts."""
        if faults.ACTIVE:
            # inside the with_retry wrapper: an injected
            # RESOURCE_EXHAUSTED takes the split-and-retry path
            faults.hit("exchange.map", query_id=current_query_id(),
                       op=type(self).__name__)
        cvs, mask = batch.cvs(), batch.row_mask
        pids = self._partition_ids(cvs, mask)
        eff = torch.where(mask, pids, self.n)
        order = torch.argsort(eff, stable=True)
        counts = torch.bincount(eff.to(torch.int64),
                                minlength=self.n + 1)[:self.n]
        out = [take(cv, order, mask[order]) for cv in cvs]
        host = iter(to_host([t for cv in out for t in cv_buffers(cv)]
                            + [counts]))
        cols = [tree_from_flat(f.dtype, host) for f in self.schema.fields]
        return cols, next(host)

    def _ensure_shuffled(self, ctx: ExecContext
                         ) -> Tuple[List[list], List[int]]:
        """The map side's (pieces, pstats), run once (`Once`)."""
        return self._map_out.get(lambda: self._run_map(ctx))

    @property
    def _pieces(self) -> Optional[List[list]]:
        """The map side's pieces if it has run (without running it)."""
        out = self._map_out.value
        return None if out is None else out[0]

    @property
    def _pstats(self) -> Optional[List[int]]:
        """The map side's bytes per reduce partition if it has run."""
        out = self._map_out.value
        return None if out is None else out[1]

    def _prepare_map(self, ctx: ExecContext):
        """What the map side needs first (the range exchange's bounds)."""

    def release(self):
        self._map_out.clear()
        super().release()

    def _map_partition(self, ctx: ExecContext, mpid: int, rider=None,
                       stop=None):
        """One map task: child partition `mpid`'s batches, each
        partitioned on the device (under the rider's admission on the
        pool) and sliced on the host into this task's own pieces, per
        reduce partition in batch order; None when `stop` is set.

        A step maps one batch and then fetches the next: at the
        partition's end that exhausts the child's generators, whose
        frames still hold the batch just mapped, so a worker that waits
        for its next step (behind one retrying alone, say) holds no
        device memory of a finished partition."""
        pieces: List[list] = [[] for _ in range(self.n)]
        dm = ctx.device_manager
        it = self.children[0].execute_partition(ctx, mpid)
        step = rider.step if rider is not None else contextlib.nullcontext
        fetched, batch = False, None
        try:
            while True:
                if stop is not None and stop.is_set():
                    return None     # a sibling worker failed
                with step():
                    if not fetched:
                        batch, fetched = next(it, None), True
                    if batch is None:
                        break
                    # ends in the D2H sync: absorbs the batch's device
                    # work; an OOM splits the batch, and its halves give
                    # more pieces a partition
                    with ctx.timer(self._op_id, "mapTime"):
                        hosts = list(with_retry(batch, self._map_batch,
                                                dm=dm))
                    batch = None    # not held while the child fetches
                    batch = next(it, None)
                ctx.add_metric(self._op_id, "mapBatches", 1)
                with ctx.timer(self._op_id, "sliceTime"):
                    for cols, counts in hosts:
                        starts = np.concatenate([[0], np.cumsum(counts)])
                        for rp in np.flatnonzero(counts):
                            lo, hi = int(starts[rp]), int(starts[rp + 1])
                            sl = [_slice(c, lo, hi) for c in cols]
                            pieces[rp].append((sl, hi - lo, _nbytes(sl)))
        finally:
            batch = None
            it.close()
        return pieces

    def _run_pool(self, ctx: ExecContext, nparts: int,
                  threads: int) -> List[list]:
        """The map tasks on a pool of `threads` workers, every worker on
        the caller's CUDA stream (device work stays in the order one
        thread would give it; the host halves overlap). A failing worker
        stops the others and its exception propagates; the results come
        back in map-partition order."""
        from .nodes import _session_semaphore
        rider = PermitRider(_session_semaphore(ctx))
        stop = threading.Event()
        stream = (torch.cuda.current_stream(ctx.device)
                  if ctx.device is not None and ctx.device.type == "cuda"
                  else None)
        # the span open on this thread (the stage driver's
        # materialization) parents the map tasks
        tc = tracing.current() or ctx.trace
        qid = current_query_id()

        def task(mpid):
            # the worker takes the query's trace context and query scope:
            # its admission wait parents under this map task's span, and
            # what it reserves is the query's
            with _query_scope(qid), tracing.use(tc), tracing.span(
                    "exchange.map", "pool_task", mpid=mpid):
                if stream is None:
                    return self._map_partition(ctx, mpid, rider, stop)
                with torch.cuda.stream(stream):
                    return self._map_partition(ctx, mpid, rider, stop)

        with cf.ThreadPoolExecutor(
                threads, thread_name_prefix="tpu-exch-map") as pool:
            futs = [pool.submit(task, mpid) for mpid in range(nparts)]
            try:
                for f in cf.as_completed(futs):
                    f.result()
            except BaseException:
                stop.set()
                for f in futs:
                    f.cancel()
                raise
        ctx.add_metric(self._op_id, "mapPoolWaitMs",
                       round(rider.waited_secs * 1e3, 3))
        ctx.add_metric(self._op_id, "mapPoolAloneSteps", rider.alone_steps)
        return [f.result() for f in futs]

    def _run_map(self, ctx: ExecContext) -> Tuple[List[list], List[int]]:
        """Every map task, on the pool when `sql.exec.exchange.mapThreads`
        resolves to more than one worker. Each task fills pieces for its
        own map partition, and they merge in map-partition order, so the
        pool's completion order never changes what a reduce partition
        reads: its pieces, and a double sum over them, are those of the
        serial map side."""
        self._prepare_map(ctx)
        child = self.children[0]
        nparts = child.num_partitions(ctx)
        threads = resolve_map_threads(ctx, nparts)
        if threads <= 1:
            per_task = [self._map_partition(ctx, mpid)
                        for mpid in range(nparts)]
        else:
            per_task = self._run_pool(ctx, nparts, threads)
        pieces = [[p for task in per_task for p in task[rp]]
                  for rp in range(self.n)]
        pstats = [sum(p[2] for p in subs) for subs in pieces]
        m = ctx.metrics_for(self._op_id)
        m.set("mapPartitionsExecuted", nparts)
        m.set("shuffleBytesWritten", sum(pstats))
        ordered = sorted(pstats)
        m.set("shufflePartitionBytesMin", ordered[0])
        m.set("shufflePartitionBytesMedian", ordered[len(ordered) // 2])
        m.set("shufflePartitionBytesMax", ordered[-1])
        return pieces, pstats

    # ---- adaptive stage API --------------------------------------------
    def stage_stats(self, ctx: ExecContext) -> List[int]:
        """Materialize the map stage; the bytes of each reduce partition
        (the MapOutputStatistics analog)."""
        return self._ensure_shuffled(ctx)[1]

    def read_slice(self, ctx: ExecContext, rpid: int, chunk: int = 0,
                   nchunks: int = 1) -> Optional[DeviceBatch]:
        """Slice `chunk` of `nchunks` of reduce partition `rpid` as one
        batch (None when it holds no rows): the pieces whose first byte
        falls in the slice's byte range, so the slices of a partition
        cover its pieces exactly once."""
        pieces, pstats = self._ensure_shuffled(ctx)
        subs = pieces[rpid]
        if nchunks > 1:
            total = pstats[rpid]
            lo = total * chunk // nchunks
            hi = total * (chunk + 1) // nchunks
            sel, acc = [], 0
            for p in subs:
                if lo <= acc < hi:
                    sel.append(p)
                acc += p[2]
            subs = sel
        ctx.add_metric(self._op_id, "shuffleBytesRead",
                       pstats[rpid] // max(nchunks, 1))
        total = sum(rows for _, rows, _ in subs)
        if total == 0:
            return None
        fields = self.schema.fields

        def reduce():
            host = [a for j, f in enumerate(fields)
                    for a in tree_to_flat(f.dtype, _concat(
                        [cols[j] for cols, _, _ in subs]))]
            return iter(to_device(host, ctx.device))

        with ctx.timer(self._op_id, "reduceTime"):
            dev = retry_no_split(reduce, dm=ctx.device_manager)
        cols = [Column.from_buffers(f.dtype, total, dev) for f in fields]
        return DeviceBatch(Table(self.schema.names, cols), total,
                           device=ctx.device)

    def execute_partition(self, ctx: ExecContext, pid: int):
        batch = self.read_slice(ctx, pid)
        if batch is not None:
            yield batch


class RangeShuffleExchangeExec(ShuffleExchangeExec):
    """Range partitioning on one numeric or date key (reference:
    GpuRangePartitioner.scala, sample-based bounds): n - 1 bounds at the
    quantiles of the first child batch's live, valid keys; a row goes to
    the first partition whose bound exceeds its key (`searchsorted`,
    right side), a null to partition 0. Keys compare as int64 (integers,
    dates, timestamps, decimal64, booleans) or as float64 with NaN at
    +inf (floating types), an order-preserving map, so the partitions
    are in the key's ascending order."""

    def __init__(self, child, num_partitions, bound_keys, schema):
        super().__init__(child, num_partitions, bound_keys, schema)
        if not bound_keys or len(bound_keys) != 1 \
                or not range_key_ok(bound_keys[0].dtype):
            raise ValueError("range partitioning takes one numeric or "
                             "date key")
        self._bounds: Optional[torch.Tensor] = None

    def describe(self):
        return f"RangeShuffleExchangeExec[n={self.n}]"

    def _key(self, cvs, mask):
        kcv = self.keys[0].emit(EmitCtx(cvs, mask.shape[0], mask.device))
        x = kcv.data
        if x.is_floating_point():
            x = torch.where(torch.isnan(x), torch.full_like(x, float("inf")),
                            x).to(torch.float64)
        else:
            x = x.to(torch.int64)
        return x.contiguous(), kcv.validity

    def _prepare_map(self, ctx: ExecContext):
        if self._bounds is not None:
            return
        first = next(iter(self.children[0].execute_partition(ctx, 0)),
                     None)
        if first is None or first.capacity == 0:
            self._bounds = torch.zeros(self.n - 1, dtype=torch.int64,
                                       device=ctx.device)
            return
        key, valid = self._key(first.cvs(), first.row_mask)
        live = first.row_mask & valid
        # the live keys first, in order (dead rows take the maximum)
        ordered = torch.sort(torch.where(live, key, key.max())).values
        nlive = live.sum().clamp(min=1)
        qs = (torch.arange(1, self.n, device=key.device) * nlive) // self.n
        self._bounds = ordered[qs.clamp(0, first.capacity - 1)].contiguous()

    def _partition_ids(self, cvs, mask):
        key, valid = self._key(cvs, mask)
        bounds = self._bounds.to(key.dtype)
        pids = torch.searchsorted(bounds, key, right=True).to(torch.int32)
        return torch.where(valid, pids, 0)


def range_key_ok(dtype) -> bool:
    """A key the range exchange partitions on: fixed width, one word."""
    return not (dtype.is_variable_width
                or isinstance(dtype, dt.NullType)
                or (isinstance(dtype, dt.DecimalType)
                    and dtype.is_decimal128))


def _nbytes(cols) -> int:
    return sum(_tree_nbytes(c) for c in cols)


def _tree_nbytes(col: dict) -> int:
    return sum(v.nbytes for k, v in col.items() if k != "children") \
        + sum(_tree_nbytes(c) for c in col.get("children", ()))


def _slice(col: dict, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of one column's host buffer tree (views). String
    and list offsets stay absolute; the bytes (elements) below are
    sliced to the rows' range, recursively."""
    out = {"data": col["data"], "validity": col["validity"][lo:hi]}
    kids = col.get("children")
    if "offsets" in col:
        off = col["offsets"][lo:hi + 1]
        out["offsets"] = off
        if kids:
            out["children"] = [_slice(kids[0], int(off[0]), int(off[-1]))]
        else:
            out["data"] = col["data"][off[0]:off[-1]]
    elif kids:
        out["children"] = [_slice(c, lo, hi) for c in kids]
    else:
        out["data"] = col["data"][lo:hi]
    return out


def _concat(parts) -> dict:
    """One column's pieces joined on the host into one buffer tree;
    string and list offsets rebased onto the joined bytes (elements)."""
    p0 = parts[0]
    out = {"data": p0["data"],
           "validity": np.concatenate([p["validity"] for p in parts])}
    kids = p0.get("children")
    if "offsets" in p0:
        offs, base = [np.zeros(1, np.int32)], 0
        for p in parts:
            off = p["offsets"]
            offs.append(off[1:] - off[0] + base)
            base += int(off[-1] - off[0])
        out["offsets"] = np.concatenate(offs).astype(np.int32)
    if kids:
        out["children"] = [_concat([p["children"][j] for p in parts])
                           for j in range(len(kids))]
    else:
        out["data"] = np.concatenate([p["data"] for p in parts])
    return out
