"""Core physical operators: scans, project, filter, limit, and collect.

Partitioning mirrors the JAX package exactly, since an exchange's output
order depends on it: an in-memory scan has one partition per
`batchSizeRows` slice; a Parquet scan one per file, or one per file group
under the COALESCING reader. The Parquet scan decodes on the host with
Arrow and moves each batch to the device in one copy. The MULTITHREADED
reader's decode-ahead thread is not ported: its batches are decoded in
order on the calling thread, which yields the same batches.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import torch

from ..columnar.column import Column, buffer_names
from ..columnar.table import Schema, Table
from ..config import PARQUET_COALESCING_TARGET, PARQUET_READER_TYPE
from ..expr.expressions import EmitCtx, Expression
from ..ops.kernel_utils import CV
from ..utils import transfer
from .base import ExecContext, TpuExec
from .batch import DeviceBatch, to_host

__all__ = ["InMemoryScanExec", "ParquetScanExec", "ProjectExec",
           "FilterExec", "LimitExec", "collect_to_arrow", "make_table",
           "prune_row_groups"]


def make_table(schema: Schema, cvs: Sequence[CV], num_rows: int) -> Table:
    return Table(schema.names, [Column(f.dtype, num_rows, cv.data,
                                       cv.validity, cv.offsets)
                                for f, cv in zip(schema.fields, cvs)])


def _upload(ctx: ExecContext, op_id: str, at) -> DeviceBatch:
    """Host Arrow decode, then one copy to the device ("scanTime": host
    seconds, the device copy only enqueued)."""
    with ctx.timer(op_id, "scanTime"):
        return DeviceBatch(Table.from_arrow(at, ctx.device),
                           num_rows=at.num_rows, device=ctx.device)


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
    """Parquet reader on its host-decode path, with footer-stats
    row-group pruning from pushed-down conjuncts and the AUTO /
    COALESCING / MULTITHREADED / PERFILE reader partitioning."""

    def __init__(self, paths: Sequence[str], schema: Schema,
                 columns: Optional[Sequence[str]] = None, filters=None):
        super().__init__([], schema)
        self.paths = list(paths)
        self.columns = list(columns) if columns else None
        self.filters = list(filters) if filters else None
        self._rt_cache = None
        self._groups_cache = None

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

    def _decoded_batches(self, ctx, path):
        import pyarrow as pa
        import pyarrow.parquet as pq
        per = max(1, ctx.conf.batch_size_rows)
        pf = pq.ParquetFile(path)
        cols = self._cols()
        if self.filters:
            kept = prune_row_groups(pf, self.filters)
            ctx.add_metric(self._op_id, "skippedRowGroups",
                           pf.metadata.num_row_groups - len(kept))
            if not kept:
                return
            it = pf.iter_batches(batch_size=per, columns=cols,
                                 row_groups=kept)
        else:
            it = pf.iter_batches(batch_size=per, columns=cols)
        for rb in it:
            yield pa.table(rb)

    def execute_partition(self, ctx, pid) -> Iterator[DeviceBatch]:
        if self._reader_type(ctx) == "COALESCING":
            yield from self._execute_coalescing(ctx, pid)
            return
        it = self._decoded_batches(ctx, self.paths[pid])
        while True:
            with ctx.timer(self._op_id, "decodeTime"):
                at = next(it, None)
            if at is None:
                return
            yield _upload(ctx, self._op_id, at)

    def _execute_coalescing(self, ctx, pid):
        """The group's files decode, concatenate on the host, and move to
        the device in `batchSizeRows` slices."""
        import pyarrow as pa
        import pyarrow.parquet as pq
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
                pf = pq.ParquetFile(p)
                if self.filters:
                    kept = prune_row_groups(pf, self.filters)
                    ctx.add_metric(self._op_id, "skippedRowGroups",
                                   pf.metadata.num_row_groups - len(kept))
                    at = (pf.read_row_groups(kept, columns=cols)
                          if kept else None)
                else:
                    at = pf.read(columns=cols)
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


# ----------------------------------------------------------------------
class ProjectExec(TpuExec):
    def __init__(self, child: TpuExec, bound_exprs: List[Expression],
                 schema: Schema):
        super().__init__([child], schema)
        self.bound = bound_exprs

    def fusable_stage(self):
        def fn(cvs, mask):
            ctx = EmitCtx(cvs, mask.shape[0], mask.device)
            return [e.emit(ctx) for e in self.bound], mask
        return fn

    def execute_partition(self, ctx, pid):
        stage = self.fusable_stage()
        for batch in self.children[0].execute_partition(ctx, pid):
            cvs, _ = stage(batch.cvs(), batch.row_mask)
            yield DeviceBatch(make_table(self.schema, cvs, batch.num_rows),
                              batch.num_rows, batch.row_mask)


class FilterExec(TpuExec):
    def __init__(self, child: TpuExec, bound_cond: Expression):
        super().__init__([child], child.schema)
        self.bound = bound_cond

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
        for batch in self.children[0].execute_partition(ctx, pid):
            _, mask = stage(batch.cvs(), batch.row_mask)
            yield DeviceBatch(batch.table, batch.num_rows, mask)


class LimitExec(TpuExec):
    """Global limit: one output partition; the count still to take lives
    on the host. Each batch keeps its first `remaining` live rows (a
    cumsum of the mask, then one counted host read of how many it kept);
    a batch longer than twice the limit is compacted to exactly those
    rows, so the collect copies O(n) rows, not the whole batch."""

    def __init__(self, child: TpuExec, n: int):
        super().__init__([child], child.schema)
        self.n = n

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


# ----------------------------------------------------------------------
def _batch_to_arrow(batch: DeviceBatch):
    import pyarrow as pa
    cols = batch.table.columns
    host = to_host([t for c in cols for t in c.buffers()]
                   + [batch.row_mask])
    mask = host[-1][:batch.num_rows]
    it = iter(host)
    arrs = [Column.arrow_from_host(
        c.dtype, c.length, {k: next(it) for k in buffer_names(c.dtype)})
        for c in cols]
    at = (pa.Table.from_arrays(arrs, names=list(batch.table.names))
          if arrs else pa.table({}))
    if at.num_rows == 0 and batch.num_rows > 0:
        return pa.table({})  # zero-column batch
    if not mask.all():
        at = at.filter(pa.array(mask))
    return at


def collect_to_arrow(root: TpuExec, ctx: ExecContext):
    """Run the plan and materialize a host pyarrow Table, partitions in
    order (the JAX package runs them concurrently and concatenates in
    the same order)."""
    import pyarrow as pa
    pieces = []
    for b in root.execute_all(ctx):
        # the D2H inside waits for the device work queued for this batch
        with ctx.timer(root._op_id, "collectTime"):
            pieces.append(_batch_to_arrow(b))
    if not pieces:
        return root.schema.to_arrow().empty_table()
    return pa.concat_tables(pieces)
