"""Core physical operators: scans, project, filter, limit, and collect.

Partitioning mirrors the JAX package exactly, since an exchange's output
order depends on it: an in-memory scan has one partition per
`batchSizeRows` slice; a Parquet scan one per file, or one per file group
under the COALESCING reader. The Parquet scan decodes eligible column
chunks on the device (one batch per row group) or decodes on the host
with Arrow and moves each batch to the device in one copy; a prefetch
thread decodes ahead of the consumer on the device path and under the
MULTITHREADED reader.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.column import Column, tree_from_flat
from ..columnar.table import Schema, Table
from ..config import (MULTITHREADED_READ_THREADS, PARQUET_COALESCING_TARGET,
                      PARQUET_DEVICE_DECODE, PARQUET_DEVICE_SNAPPY,
                      PARQUET_READER_TYPE)
from ..expr.expressions import EmitCtx, Expression
from ..io import parquet_device as pdev
from ..io.file_cache import cached_local_path
from ..io.snapshot import verify_snapshot
from ..memory.host import staging_pool
from ..ops.kernel_utils import CV
from ..runtime import faults
from ..service.query_manager import current_query_id
from ..utils import transfer
from . import degrade
from .base import ExecContext, TpuExec
from .batch import DeviceBatch, _torch_dtype, to_host

__all__ = ["InMemoryScanExec", "CachedScanExec", "ParquetScanExec",
           "ProjectExec", "FilterExec", "LimitExec", "UnionExec",
           "collect_to_arrow", "make_table", "prune_row_groups"]


def make_table(schema: Schema, cvs: Sequence[CV], num_rows: int) -> Table:
    return Table(schema.names, [Column.from_cv(f.dtype, num_rows, cv)
                                for f, cv in zip(schema.fields, cvs)])


def _upload(ctx: ExecContext, op_id: str, at) -> DeviceBatch:
    """Host Arrow decode, then one copy to the device ("scanTime": host
    seconds, the device copy only enqueued), under `retry_no_split`: an
    OOM in the copy (an exchange's pooled map workers upload at once)
    recovers and copies again, alone among the workers (ROADMAP C.12).
    The rows, known on the host, are `numOutputRows` (the calibration
    harvest reads it)."""
    from ..memory.retry import retry_no_split
    with ctx.timer(op_id, "scanTime"):
        batch = retry_no_split(
            lambda: DeviceBatch(Table.from_arrow(at, ctx.device),
                                num_rows=at.num_rows, device=ctx.device),
            dm=ctx.device_manager)
    ctx.add_metric(op_id, "numOutputRows", at.num_rows)
    return batch


# ----------------------------------------------------------------------
class InMemoryScanExec(TpuExec):
    """Streams host (arrow) slices to the device, one per partition."""

    def __init__(self, arrow_table, schema: Schema):
        super().__init__([], schema)
        self.arrow = arrow_table

    def num_partitions(self, ctx):
        per = max(1, ctx.conf.batch_size_rows)
        return max(1, -(-self.arrow.num_rows // per))

    def execute_partition(self, ctx, pid) -> Iterator[DeviceBatch]:
        per = max(1, ctx.conf.batch_size_rows)
        start = pid * per
        n = min(per, self.arrow.num_rows - start)
        if n <= 0 and pid > 0:
            return
        yield _upload(ctx, self._op_id, self.arrow.slice(start, max(n, 0)))


class CachedScanExec(TpuExec):
    """Serves device-resident batches (`DataFrame.cache`) as they are,
    one a partition (GpuInMemoryTableScan analog). Like the JAX class it
    holds plain device batches, outside the device budget (ROADMAP A.5
    records the choice). It shares the logical node's batch list, so
    `DataFrame.uncache` frees them from every plan at once."""

    def __init__(self, batches, schema: Schema):
        super().__init__([], schema)
        self.batches = batches

    def num_partitions(self, ctx):
        return max(1, len(self.batches))

    def execute_partition(self, ctx, pid):
        if pid < len(self.batches):
            yield self.batches[pid]


def _rg_survives(stats, op: str, value) -> bool:
    """Can a row group with these column stats contain a matching row?"""
    try:
        if stats is None or not stats.has_min_max:
            return True
        # pyarrow cannot extract stats of some logical types: keep the
        # group rather than fail
        lo, hi = stats.min, stats.max
    except Exception:
        return True
    try:
        if op == ">=":
            return hi >= value
        if op == ">":
            return hi > value
        if op == "<=":
            return lo <= value
        if op == "<":
            return lo < value
        if op == "=":
            return lo <= value <= hi
    except TypeError:
        return True  # incomparable stat/literal types: keep the group
    return True


def prune_row_groups(pf, filters) -> List[int]:
    """Row groups whose footer stats might satisfy every conjunct."""
    md = pf.metadata
    name_to_idx = {md.schema.column(i).name: i
                   for i in range(md.num_columns)}
    kept = []
    for rg in range(md.num_row_groups):
        g = md.row_group(rg)
        ok = True
        for (name, op, value) in filters:
            ci = name_to_idx.get(name)
            if ci is None:
                continue
            if not _rg_survives(g.column(ci).statistics, op, value):
                ok = False
                break
        if ok:
            kept.append(rg)
    return kept


class ParquetScanExec(TpuExec):
    """Parquet reader: footer-stats row-group pruning from pushed-down
    conjuncts, the AUTO / COALESCING / MULTITHREADED / PERFILE reader
    partitioning, and two decode paths.

    - Device decode (`sql.format.parquet.deviceDecode.enabled`, on by
      default on CUDA; on a CPU session only when the conf is set
      explicitly): per row group, eligible column chunks decode on the
      device from one raw byte upload (`io/parquet_device.py`); the
      other columns decode on the host and join them in one
      DeviceBatch. The whole per-file loop runs on a prefetch thread.
    - Host decode: Arrow decodes `batchSizeRows` slices, each moved to
      the device in one copy; under the MULTITHREADED reader a prefetch
      thread decodes ahead of the consumer.

    The COALESCING reader always decodes on the host, as the JAX
    package's does.

    A file with a Delta deletion vector (`dv`: {path: (table root,
    descriptor)}) decodes on the host, never row-group pruned (pruning
    would shift the file's row positions), and each batch drops its dead
    rows. The bind-time snapshot (`snapshot`: (path, mtime_ns, size) per
    file) is checked as each partition starts: a file changed under the
    running query raises SnapshotMismatch (`scanSnapshotViolations`)."""

    def __init__(self, paths: Sequence[str], schema: Schema,
                 columns: Optional[Sequence[str]] = None, filters=None,
                 dv=None, snapshot=None, delta_version=None):
        super().__init__([], schema)
        self.paths = list(paths)
        self.columns = list(columns) if columns else None
        self.filters = list(filters) if filters else None
        # dead-row positions are loaded once a file at execution, never
        # at plan construction
        self.dv = dict(dv) if dv else None
        self.snapshot = tuple(snapshot) if snapshot else None
        self.delta_version = delta_version
        self._dv_cache = {}
        self._rt_cache = None
        self._groups_cache = None

    def describe(self):
        f = f", filters={self.filters}" if self.filters else ""
        return f"ParquetScanExec[{len(self.paths)} files{f}]"

    def _dead_positions(self, path):
        """The sorted dead row positions (int64) of a file with a
        deletion vector, or None; loaded once a file and shared by the
        scan's concurrent workers."""
        if self.dv is None or path not in self.dv:
            return None
        got = self._dv_cache.get(path)
        if got is None:
            import numpy as np

            from ..io.dv import load_dv_positions
            root, desc = self.dv[path]
            got = self._dv_cache.setdefault(path, np.unique(np.asarray(
                load_dv_positions(root, desc), np.int64)))
        return got

    def _cols(self):
        return (self.columns if self.columns is not None
                else [f.name for f in self.schema.fields])

    def _reader_type(self, ctx) -> str:
        # decided once: a flip mid-query would reinterpret partition
        # indices (group vs file)
        if self._rt_cache is None:
            rt = str(ctx.conf.get(PARQUET_READER_TYPE)).upper()
            if rt == "AUTO":
                rt = "MULTITHREADED"
                if len(self.paths) >= 4:
                    target = ctx.conf.get(PARQUET_COALESCING_TARGET)
                    try:
                        if all(os.path.getsize(p) < target // 4
                               for p in self.paths):
                            rt = "COALESCING"
                    except OSError:
                        pass
            self._rt_cache = rt
        return self._rt_cache

    def _groups(self, ctx):
        """COALESCING reader: bin-pack files (in order) into groups of
        ~targetBytes on-disk size; one output partition per group."""
        if self._groups_cache is None:
            target = max(1, ctx.conf.get(PARQUET_COALESCING_TARGET))
            groups, cur, size = [], [], 0
            for p in self.paths:
                try:
                    fsz = os.path.getsize(p)
                except OSError:
                    fsz = target
                if cur and size + fsz > target:
                    groups.append(cur)
                    cur, size = [], 0
                cur.append(p)
                size += fsz
            if cur:
                groups.append(cur)
            self._groups_cache = groups
        return self._groups_cache

    def num_partitions(self, ctx):
        if self._reader_type(ctx) == "COALESCING":
            return len(self._groups(ctx))
        return len(self.paths)

    @staticmethod
    def _open(path, ctx):
        """(local path, ParquetFile), through the local file cache."""
        import pyarrow.parquet as pq
        lp = cached_local_path(path, ctx.conf)
        try:
            return lp, pq.ParquetFile(lp)
        except FileNotFoundError:
            # LRU eviction can unlink the cached copy between
            # local_path() and open; the source path is always valid
            return path, pq.ParquetFile(path)

    def _device_decode_on(self, ctx) -> bool:
        """On a CUDA session, the conf's value; on a CPU session only
        when the conf is set explicitly (tests, parity runs): there
        pyarrow's native decoder shares the silicon with the 'device'
        ops and wins."""
        if not ctx.conf.get(PARQUET_DEVICE_DECODE):
            return False
        if ctx.device.type == "cpu":
            return ctx.conf.is_set(PARQUET_DEVICE_DECODE)
        return True

    def _device_decoded_batches(self, ctx, path, m):
        """Device-decode path (GpuParquetScan.scala:3364 analog): one
        DeviceBatch per row group, eligible column chunks decoded ON
        DEVICE from one raw byte upload (staged through the pinned pool;
        snappy pages decompress in parallel on the prefetch pool), the
        other columns decoded on the host and merged into the same
        batch. Returns None when the file's first row group has no
        eligible chunk, or a kept row group is over 4 x batchSizeRows
        (the caller uses the host path)."""
        import pyarrow as pa
        lp, pf = self._open(path, ctx)
        cols = self._cols()
        if pf.metadata.num_row_groups == 0:
            return None
        if not pdev.eligible_chunks(pf, 0, cols):
            for _name, (cat, _detail) in pdev.fallback_reasons(
                    pf, 0, cols).items():
                m.add(f"deviceDecodeFallback.{cat}", 1)
            return None
        kept = (prune_row_groups(pf, self.filters) if self.filters
                else list(range(pf.metadata.num_row_groups)))
        # the decode unit is a whole row group: bound the device-memory
        # spike against the host path's batchSizeRows slices. Checked
        # BEFORE any metric: the host path records skippedRowGroups.
        per = max(1, ctx.conf.batch_size_rows)
        if any(pf.metadata.row_group(rg).num_rows > 4 * per
               for rg in kept):
            return None
        m.add("skippedRowGroups", pf.metadata.num_row_groups - len(kept))
        field_by_name = {f.name: f for f in self.schema.fields}
        dev = ctx.device
        pool = staging_pool(ctx.conf, pinned=dev.type == "cuda")
        decomp = _decompress_pool(ctx)
        dev_snappy = ctx.conf.get(PARQUET_DEVICE_SNAPPY)

        def device_column(fld, rg, ci, nrows, chunks):
            """The chunk decoded on the device as a Column, or None with
            its fallback counted."""
            if fld.dtype.np_dtype is None or (
                    isinstance(fld.dtype, dt.DecimalType)
                    and fld.dtype.is_decimal128):
                # decimal128 needs the two-limb buffer the fixed-width
                # decode does not produce
                m.add("deviceDecodeFallback.type", 1)
                return None
            af = pf.schema_arrow.field(fld.name)
            if pa.types.is_timestamp(af.type) and af.type.unit != "us":
                m.add("deviceDecodeFallback.type", 1)  # host converts
                return None
            c = pdev.chunk_device_plan(pf, lp, rg, ci, fld.name,
                                       af.nullable, pool=pool,
                                       decomp_pool=decomp,
                                       device_snappy=dev_snappy, metrics=m)
            got = None
            if c is not None:
                try:
                    got = pdev.decode_chunk_device(c, nrows, dev,
                                                   metrics=m)
                except BaseException:
                    c.close()            # leases must not leak
                    raise
            if got is None:
                if c is not None:
                    c.close(sync=True)
                m.add("deviceDecodeFallback.pages", 1)
                return None
            chunks.append(c)
            m.add("deviceDecodeBytes", pf.metadata.row_group(rg)
                  .column(ci).total_compressed_size)
            if fld.dtype.is_variable_width:
                data, valid, offsets = got
                return Column(fld.dtype, nrows, data, valid, offsets)
            vals, valid = got
            want = _torch_dtype(fld.dtype.np_dtype)
            if vals.dtype != want:
                vals = vals.to(want)
            return Column(fld.dtype, nrows, vals, valid)

        def gen():
            pool0 = dict(pool.metrics)
            for rg in kept:
                nrows = pf.metadata.row_group(rg).num_rows
                if nrows == 0:
                    continue
                elig = pdev.eligible_chunks(pf, rg, cols)
                for _name, (cat, _detail) in pdev.fallback_reasons(
                        pf, rg, cols).items():
                    m.add(f"deviceDecodeFallback.{cat}", 1)
                dev_cols, chunks = {}, []
                try:
                    with m.timer("scanTime"):
                        for name, ci in elig.items():
                            got = device_column(field_by_name[name], rg,
                                                ci, nrows, chunks)
                            if got is not None:
                                dev_cols[name] = got
                    rest = [n for n in cols if n not in dev_cols]
                    host_by_name = {}
                    if rest:
                        with m.timer("decodeTime"):
                            at = pf.read_row_group(rg, columns=rest)
                        with m.timer("scanTime"):
                            host_by_name = dict(zip(
                                at.schema.names,
                                Table.from_arrow(at, dev).columns))
                    tbl = Table(list(cols), [
                        dev_cols[n] if n in dev_cols else host_by_name[n]
                        for n in cols])
                except BaseException:
                    for c in chunks:
                        c.close()        # leases must not leak
                    raise
                # staging buffers go back to the pool only after their
                # copies to the device end (this thread waits, never the
                # compute thread)
                for c in chunks:
                    c.close(sync=True)
                m.add("numOutputRows", nrows)
                m.add("numOutputBatches", 1)
                m.add("deviceDecodedChunks", len(dev_cols))
                yield DeviceBatch(tbl, num_rows=nrows, device=dev)
            for k, v in pool.metrics.items():
                delta = v - pool0.get(k, 0)
                if k.endswith("HeldBytes"):
                    m.set(k, v)
                elif delta:
                    m.add(k, delta)
        return gen()

    def _decoded_batches(self, ctx, path):
        import pyarrow as pa
        per = max(1, ctx.conf.batch_size_rows)
        _, pf = self._open(path, ctx)
        cols = self._cols()
        dead = self._dead_positions(path)
        # row-group pruning would shift the file's row positions under a
        # deletion vector
        if self.filters and dead is None:
            kept = prune_row_groups(pf, self.filters)
            ctx.add_metric(self._op_id, "skippedRowGroups",
                           pf.metadata.num_row_groups - len(kept))
            if not kept:
                return
            it = pf.iter_batches(batch_size=per, columns=cols,
                                 row_groups=kept)
        else:
            it = pf.iter_batches(batch_size=per, columns=cols)
        off = 0
        while True:
            with ctx.timer(self._op_id, "decodeTime"):
                rb = next(it, None)
            if rb is None:
                return
            at = pa.table(rb)
            if dead is not None:
                n0 = at.num_rows
                at = _drop_dead(at, dead, off)
                off += n0
                if at.num_rows == 0:
                    continue
            yield at

    def execute_partition(self, ctx, pid) -> Iterator[DeviceBatch]:
        verify_snapshot(self, ctx, "parquet")
        reader_type = self._reader_type(ctx)
        if reader_type == "COALESCING":
            yield from self._execute_coalescing(ctx, pid)
            return
        m = ctx.metrics_for(self._op_id)
        path = self.paths[pid]
        depth = min(max(1, ctx.conf.get(MULTITHREADED_READ_THREADS)), 4)
        if self._device_decode_on(ctx) and not (self.dv
                                                and path in self.dv):
            dev_iter = self._device_decoded_batches(ctx, path, m)
            if dev_iter is not None:
                # read + decompress + plan + decode dispatch run on a
                # worker thread: the consumer only waits on the queue
                # (prefetchWaitSecs)
                yield from _prefetched(dev_iter, depth, ctx.device,
                                       (m, "prefetchWaitSecs"))
                return
        host_iter = self._decoded_batches(ctx, path)
        if reader_type == "MULTITHREADED":
            host_iter = _prefetched(host_iter, depth, ctx.device,
                                    (m, "prefetchWaitSecs"))
        for at in host_iter:
            yield _upload(ctx, self._op_id, at)

    def _execute_coalescing(self, ctx, pid):
        """The group's files decode, concatenate on the host, and move to
        the device in `batchSizeRows` slices."""
        import pyarrow as pa
        group = self._groups(ctx)[pid]
        cols = self._cols()
        if not cols:
            # count-style scan: a zero-column read drops the row count,
            # per-file batches keep it
            for p in group:
                for at in self._decoded_batches(ctx, p):
                    yield _upload(ctx, self._op_id, at)
            return
        tables = []
        with ctx.timer(self._op_id, "decodeTime"):
            for p in group:
                _, pf = self._open(p, ctx)
                dead = self._dead_positions(p)
                if self.filters and dead is None:
                    kept = prune_row_groups(pf, self.filters)
                    ctx.add_metric(self._op_id, "skippedRowGroups",
                                   pf.metadata.num_row_groups - len(kept))
                    at = (pf.read_row_groups(kept, columns=cols)
                          if kept else None)
                else:
                    at = pf.read(columns=cols)
                    if dead is not None:
                        at = _drop_dead(at, dead, 0)
                if at is not None and at.num_rows:
                    tables.append(at)
        if not tables:
            return
        combined = (pa.concat_tables(tables) if len(tables) > 1
                    else tables[0])
        per = max(1, ctx.conf.batch_size_rows)
        for start in range(0, combined.num_rows, per):
            yield _upload(ctx, self._op_id, combined.slice(
                start, min(per, combined.num_rows - start)))


def _drop_dead(at, dead, off: int):
    """`at` (the file's rows from position `off` on) without the rows
    whose positions are in `dead` (sorted int64): one numpy mask, the
    rows the JAX package's per-row set test keeps."""
    import numpy as np
    import pyarrow as pa
    n = at.num_rows
    lo, hi = np.searchsorted(dead, [off, off + n])
    if lo == hi:
        return at
    mask = np.ones(n, bool)
    mask[dead[lo:hi] - off] = False
    return at.filter(pa.array(mask))


_DECOMP_POOL = None
_DECOMP_LOCK = threading.Lock()


def _decompress_pool(ctx):
    """The process-wide thread pool for per-page snappy decompression
    in the device scan (the MULTITHREADED pool, sized by the first
    caller's `multiThreadedRead.numThreads`): pages of one chunk
    decompress in parallel, called from the prefetch worker, never the
    compute thread."""
    global _DECOMP_POOL
    n = max(1, ctx.conf.get(MULTITHREADED_READ_THREADS))
    with _DECOMP_LOCK:
        if _DECOMP_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _DECOMP_POOL = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="srtpu-decomp")
        return _DECOMP_POOL


def _prefetched(it: Iterator, depth: int, device: torch.device,
                wait_metrics=None):
    """Run `it` on a worker thread with a bounded queue, so host decode
    (and the device decode's dispatch) overlap the consumer's device
    work. The worker enqueues on the consumer's current device and CUDA
    stream, so the consumer's kernels queue behind the batch's own on
    one stream and need no other wait. An abandoned consumer (e.g.
    under a LIMIT) signals the worker through a stop event, drains the
    queue so a blocked put returns, and joins the worker.
    `wait_metrics=(OpMetrics, name)` adds the consumer's seconds blocked
    on the queue."""
    import queue
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    err: List[BaseException] = []
    stream = (torch.cuda.current_stream(device)
              if device.type == "cuda" else None)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            if stream is not None:
                torch.cuda.set_device(stream.device)
                torch.cuda.set_stream(stream)
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            put(done)

    t = threading.Thread(target=work, daemon=True, name="srtpu-prefetch")
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if wait_metrics is not None:
                wait_metrics[0].add(wait_metrics[1],
                                    time.perf_counter() - t0)
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        # the worker ends after the item it is making: wait for it, so
        # no thread outlives its scan (one still inside torch or Arrow
        # when the interpreter exits aborts the process)
        t.join()


# ----------------------------------------------------------------------
class ProjectExec(TpuExec):
    def __init__(self, child: TpuExec, bound_exprs: List[Expression],
                 schema: Schema):
        super().__init__([child], schema)
        self.bound = bound_exprs

    def describe(self):
        return f"ProjectExec[{', '.join(map(repr, self.bound))}]"

    def fusable_stage(self):
        def fn(cvs, mask):
            ctx = EmitCtx(cvs, mask.shape[0], mask.device)
            return [e.emit(ctx) for e in self.bound], mask
        return fn

    def execute_partition(self, ctx, pid):
        stage = self.fusable_stage()
        m = ctx.metrics_for(self._op_id)
        for batch in self.children[0].execute_partition(ctx, pid):
            if self._op_id not in ctx.degraded:
                try:
                    if faults.ACTIVE:
                        faults.hit("device.dispatch",
                                   query_id=current_query_id(),
                                   op="ProjectExec")
                    cvs, _ = stage(batch.cvs(), batch.row_mask)
                except Exception as e:  # noqa: BLE001 - classified below
                    if not degrade.should_degrade(ctx, self, e):
                        raise
                else:
                    yield DeviceBatch(make_table(self.schema, cvs,
                                                 batch.num_rows),
                                      batch.num_rows, batch.row_mask)
                    continue
            # degraded, or this batch's device evaluation just failed: the
            # host interpreter evaluates the same bound expressions
            with m.timer("hostEvalTime"):
                hb = degrade.host_project_batch(self, batch, ctx.device)
            m.add("degradedToHost", 1)
            yield hb


class FilterExec(TpuExec):
    def __init__(self, child: TpuExec, bound_cond: Expression):
        super().__init__([child], child.schema)
        self.bound = bound_cond

    def describe(self):
        return f"FilterExec[{self.bound!r}]"

    def preserves_ordinals(self):
        return True

    def fusable_stage(self):
        def fn(cvs, mask):
            ctx = EmitCtx(cvs, mask.shape[0], mask.device)
            cv = self.bound.emit(ctx)
            return cvs, mask & cv.validity & cv.data.bool()
        return fn

    def execute_partition(self, ctx, pid):
        stage = self.fusable_stage()
        m = ctx.metrics_for(self._op_id)
        for batch in self.children[0].execute_partition(ctx, pid):
            if self._op_id not in ctx.degraded:
                try:
                    if faults.ACTIVE:
                        faults.hit("device.dispatch",
                                   query_id=current_query_id(),
                                   op="FilterExec")
                    _, mask = stage(batch.cvs(), batch.row_mask)
                except Exception as e:  # noqa: BLE001 - classified below
                    if not degrade.should_degrade(ctx, self, e):
                        raise
                else:
                    yield DeviceBatch(batch.table, batch.num_rows, mask)
                    continue
            # degraded, or this batch's device evaluation just failed:
            # the host evaluates the predicate over the same batch
            with m.timer("hostEvalTime"):
                hb = degrade.host_filter_batch(self, batch, ctx.device)
            m.add("degradedToHost", 1)
            if hb is not None:
                yield hb


class LimitExec(TpuExec):
    """Global limit: one output partition; the count still to take lives
    on the host. Each batch keeps its first `remaining` live rows (a
    cumsum of the mask, then one counted host read of how many it kept);
    a batch longer than twice the limit is compacted to exactly those
    rows, so the collect copies O(n) rows, not the whole batch."""

    def __init__(self, child: TpuExec, n: int):
        super().__init__([child], child.schema)
        self.n = n

    def describe(self):
        return f"LimitExec[{self.n}]"

    def num_partitions(self, ctx):
        return 1

    def execute_partition(self, ctx, pid):
        from ..ops.gather import compaction_perm, gather_cols
        remaining = self.n
        child = self.children[0]
        for cpid in range(child.num_partitions(ctx)):
            if remaining <= 0:
                return
            for batch in child.execute_partition(ctx, cpid):
                if remaining <= 0:
                    return
                with ctx.timer(self._op_id, "limitTime"):
                    mask = batch.row_mask
                    ranks = torch.cumsum(mask.to(torch.int64), 0)
                    mask = mask & (ranks <= remaining)
                    took = transfer.fetch_int(mask.sum())
                    if took and batch.capacity > 2 * self.n:
                        perm, _ = compaction_perm(mask)
                        out = gather_cols(batch.cvs(), perm[:took], None)
                        batch = DeviceBatch(make_table(self.schema, out,
                                                       took), took,
                                            device=ctx.device)
                    else:
                        batch = DeviceBatch(batch.table, batch.num_rows,
                                            mask)
                if took == 0:
                    continue
                remaining -= took
                yield batch


class UnionExec(TpuExec):
    """UNION ALL: the children's partitions, one after another; a child
    batch's columns take the union's names by position."""

    def num_partitions(self, ctx):
        return sum(c.num_partitions(ctx) for c in self.children)

    def execute_partition(self, ctx, pid):
        for c in self.children:
            n = c.num_partitions(ctx)
            if pid < n:
                for b in c.execute_partition(ctx, pid):
                    yield DeviceBatch(Table(self.schema.names,
                                            b.table.columns),
                                      b.num_rows, b.row_mask)
                return
            pid -= n


# ----------------------------------------------------------------------
def _batch_to_arrow(batch: DeviceBatch):
    import pyarrow as pa
    cols = batch.table.columns
    host = to_host([t for c in cols for t in c.buffers()]
                   + [batch.row_mask])
    mask = host[-1][:batch.num_rows]
    it = iter(host)
    arrs = [Column.arrow_from_host(c.dtype, c.length,
                                   tree_from_flat(c.dtype, it))
            for c in cols]
    at = (pa.Table.from_arrays(arrs, names=list(batch.table.names))
          if arrs else pa.table({}))
    if at.num_rows == 0 and batch.num_rows > 0:
        return pa.table({})  # zero-column batch
    if not mask.all():
        at = at.filter(pa.array(mask))
    return at


def collect_to_arrow(root: TpuExec, ctx: ExecContext):
    """Run the plan and materialize a host pyarrow Table (the analog of
    GpuColumnarToRowExec + collect). Partitions run as concurrent tasks
    on a `tpu-collect` pool of min(partitions, max(2, 2 x
    concurrentTpuTasks)) threads, bounded by the session's TpuSemaphore
    (the GpuSemaphore admission model, reference GpuSemaphore.scala:183):
    a task holds a permit while it advances its partition's iterator
    (the device work, enqueued on the caller's CUDA stream) and releases
    it around the D2H copy and the Arrow conversion. The pieces
    concatenate in partition order; the seconds tasks waited for a
    permit are `semaphoreWaitMs` on the root, the most permits held at
    once `semaphorePeakHeld`. One partition runs on the calling
    thread."""
    import concurrent.futures as cf

    import pyarrow as pa
    nparts = root.num_partitions(ctx)

    def to_arrow(b):
        # the D2H inside waits for the device work queued for this batch
        with ctx.timer(root._op_id, "collectTime"):
            return _batch_to_arrow(b)

    if nparts <= 1:
        pieces = [to_arrow(b) for b in root.execute_all(ctx)]
    else:
        sem = _session_semaphore(ctx)
        sem.reset_peak()
        waits = []
        # the tasks enqueue on the caller's stream, after the work the
        # stage driver queued there
        stream = (torch.cuda.current_stream(ctx.device)
                  if ctx.device is not None and ctx.device.type == "cuda"
                  else None)

        def run_part(pid):
            if stream is None:
                return run_task(pid)
            with torch.cuda.stream(stream):
                return run_task(pid)

        def run_task(pid):
            out, waited = [], 0.0
            it = root.execute_partition(ctx, pid)
            try:
                while True:
                    waited += sem.acquire()
                    try:
                        b = next(it, None)
                    finally:
                        sem.release()
                    if b is None:
                        break
                    out.append(to_arrow(b))
            finally:
                waits.append(waited)
                it.close()
            return out

        workers = min(nparts, max(2, 2 * ctx.conf.concurrent_tasks))
        with cf.ThreadPoolExecutor(
                workers, thread_name_prefix="tpu-collect") as pool:
            results = list(pool.map(run_part, range(nparts)))
        pieces = [at for r in results for at in r]
        ctx.add_metric(root._op_id, "semaphoreWaitMs",
                       round(sum(waits) * 1e3, 3))
        ctx.set_metric(root._op_id, "semaphorePeakHeld",
                       sem.metrics["peakHeld"])
    if not pieces:
        return root.schema.to_arrow().empty_table()
    return pa.concat_tables(pieces)


def _session_semaphore(ctx: ExecContext):
    """The session's semaphore, or one of its own for a context that has
    no session."""
    if ctx.session is not None:
        return ctx.session.semaphore
    from ..memory.semaphore import TpuSemaphore
    return TpuSemaphore(ctx.conf.concurrent_tasks)
