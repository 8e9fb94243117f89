"""File-format writer framework: Parquet / ORC / CSV / JSON / Hive-text
outputs with Spark's layout (part files, a `_SUCCESS` marker) and
dynamic partitioning; the JAX package's `io/writer.py`, ported.

Reference: GpuFileFormatWriter and GpuDynamicPartitionDataSingleWriter
(ColumnarOutputWriter.scala, GpuFileFormatDataWriter.scala). The device
computes the result; each physical partition's rows come to the host as
one Arrow table on the thread that runs the plan
(`DataFrame._iter_partition_tables`), and the encode and the disk write
run there or, under `sql.asyncWrite.enabled`, on the writer pool
(`io/async_io.py`). One output file a (physical partition, partition
directory).

One departure of form from the JAX writer: `partitionBy` splits a table
column-wise (`_split_by_keys`: Arrow dictionary codes of the key
columns, then one stable sort of the group ids) where the JAX writer
loops over rows in Python. Each directory gets the same rows in the same
order, and the directories are numbered in the order their key tuple
first appears, as there.
"""
from __future__ import annotations

import os
import shutil
import uuid
from typing import Dict, List, Sequence

__all__ = ["DataFrameWriter", "WriteStats"]


class WriteStats:
    """numFiles / numOutputRows / numOutputBytes (the reference's
    BasicColumnarWriteJobStatsTracker metrics) and the partition
    directories written, in first-appearance order."""

    def __init__(self):
        self.num_files = 0
        self.num_rows = 0
        self.num_bytes = 0
        self.partitions: List[str] = []

    def __repr__(self):
        return (f"WriteStats(files={self.num_files}, rows={self.num_rows},"
                f" bytes={self.num_bytes},"
                f" partitions={len(self.partitions)})")


def _partition_dir(names: Sequence[str], values) -> str:
    import urllib.parse
    parts = []
    for n, v in zip(names, values):
        sv = "__HIVE_DEFAULT_PARTITION__" if v is None else \
            urllib.parse.quote(str(v), safe="")
        parts.append(f"{n}={sv}")
    return "/".join(parts)


def _split_by_keys(at, pcols: Sequence[str]):
    """[(key tuple, row indices)] of `at` grouped by the values of
    `pcols`: the groups in the order their tuple first appears, each
    group's rows in table order (the JAX writer's dict of row lists).
    Column-wise: each key column's Arrow dictionary codes (a null its
    own code), the codes combined into one id, the ids numbered by first
    appearance, and one stable sort of them."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    n = at.num_rows
    gid = np.zeros(n, np.int64)
    radix = 1
    for c in pcols:
        enc = pc.dictionary_encode(at.column(c).combine_chunks())
        codes = enc.indices.fill_null(-1).to_numpy(
            zero_copy_only=False).astype(np.int64) + 1
        card = len(enc.dictionary) + 1
        if radix > (1 << 62) // card:
            # too many combinations for one int64: renumber the ids so
            # far densely (fewer than n of them)
            dense = pc.dictionary_encode(pa.array(gid))
            gid = np.asarray(dense.indices, np.int64)
            radix = len(dense.dictionary)
        gid = gid * card + codes
        radix *= card
    # number the groups by first appearance
    enc = pc.dictionary_encode(pa.array(gid))
    group = np.asarray(enc.indices, np.int64)
    ngroups = len(enc.dictionary)
    if ngroups <= 1:
        keys = at.select(list(pcols)).slice(0, 1).to_pylist()
        return [(tuple(keys[0][c] for c in pcols), np.arange(n))]
    # a stable sort keeps each group's rows in table order (radix sort
    # for 16-bit ids)
    small = group.astype(np.uint16) if ngroups <= 1 << 16 else group
    perm = np.argsort(small, kind="stable")
    counts = np.bincount(group, minlength=ngroups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    firsts = perm[starts]
    keys = at.select(list(pcols)).take(pa.array(firsts)).to_pylist()
    return [(tuple(keys[g][c] for c in pcols),
             perm[starts[g]:starts[g] + counts[g]])
            for g in range(ngroups)]


class DataFrameWriter:
    """`df.write` (pyspark's DataFrameWriter surface)."""

    def __init__(self, df):
        self._df = df
        self._mode = "errorifexists"
        self._partition_by: List[str] = []
        self._options: Dict[str, str] = {}

    def mode(self, m: str) -> "DataFrameWriter":
        assert m in ("overwrite", "append", "errorifexists", "ignore")
        self._mode = m
        return self

    def partitionBy(self, *cols: str) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def option(self, k: str, v) -> "DataFrameWriter":
        self._options[k] = v
        return self

    # ---- formats -----------------------------------------------------
    def parquet(self, path: str, compression: str = "snappy"):
        import pyarrow.parquet as pq

        def wfn(at, fname):
            pq.write_table(at, fname, compression=compression)

        return self._write(path, wfn, "parquet")

    def orc(self, path: str, compression: str = "zstd"):
        import pyarrow.orc as orc

        def wfn(at, fname):
            orc.write_table(at, fname, compression=compression)

        return self._write(path, wfn, "orc")

    def csv(self, path: str, header: bool = True, delimiter: str = ","):
        import pyarrow.csv as pc

        def wfn(at, fname):
            pc.write_csv(at, fname, write_options=pc.WriteOptions(
                include_header=header, delimiter=delimiter))

        return self._write(path, wfn, "csv")

    def json(self, path: str):
        import json as _json

        def wfn(at, fname):
            with open(fname, "w") as f:
                for row in at.to_pylist():
                    f.write(_json.dumps(row, default=str) + "\n")

        return self._write(path, wfn, "json")

    def hive_text(self, path: str, field_delim: str = "\x01",
                  null_marker: str = "\\N"):
        """Hive LazySimpleSerDe text layout (reference: the hive text
        write of GpuHiveTextFileFormat)."""

        def wfn(at, fname):
            cols = [at.column(i).to_pylist()
                    for i in range(at.num_columns)]
            with open(fname, "w") as f:
                for row in zip(*cols) if cols else []:
                    f.write(field_delim.join(
                        null_marker if v is None else str(v)
                        for v in row) + "\n")

        return self._write(path, wfn, "txt")

    def iceberg(self, path: str):
        from .iceberg_write import write_iceberg
        if self._partition_by:
            raise NotImplementedError(
                "partitionBy is not supported for iceberg writes yet")
        return write_iceberg(self._df, path, mode=self._mode)

    def delta(self, path: str):
        from .delta import write_delta
        exists = os.path.exists(os.path.join(path, "_delta_log"))
        if exists and self._mode == "errorifexists":
            raise FileExistsError(path)
        if exists and self._mode == "ignore":
            return 0
        mode = "append" if self._mode == "append" else "overwrite"
        return write_delta(self._df, path, mode=mode)

    # ---- core --------------------------------------------------------
    def _write(self, path: str, write_fn, ext: str) -> WriteStats:
        import pyarrow as pa
        if os.path.exists(path) and os.listdir(path):
            if self._mode == "errorifexists":
                raise FileExistsError(path)
            if self._mode == "ignore":
                return WriteStats()
            if self._mode == "overwrite":
                shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path, exist_ok=True)

        stats = WriteStats()
        job = uuid.uuid4().hex[:8]    # append-safe: unique per write job
        pcols = self._partition_by
        names = self._df.schema.names
        out_names = [n for n in names if n not in pcols]
        missing = [c for c in pcols if c not in names]
        if missing:
            raise KeyError(f"partition columns not in schema: {missing}")

        # the async path: encode and disk I/O on the writer pool,
        # throttled by the conf's TrafficController, while this thread
        # keeps running the plan (reference: io/async AsyncOutputStream)
        from ..config import ASYNC_WRITE_ENABLED, ASYNC_WRITE_THREADS
        conf = self._df._session.conf
        queue = None
        if conf.get(ASYNC_WRITE_ENABLED):
            from .async_io import AsyncWriteQueue, controller_for
            queue = AsyncWriteQueue(controller_for(conf),
                                    conf.get(ASYNC_WRITE_THREADS))

        def emit(tbl, fname):
            def task(t=tbl, f=fname):
                write_fn(t, f)
                return t.num_rows, os.path.getsize(f)
            if queue is None:
                nrows, nbytes = task()
                stats.num_rows += nrows
                stats.num_bytes += nbytes
                stats.num_files += 1
            else:
                # counted from drain()'s results: a part whose write
                # fails later is not counted
                queue.submit(tbl.nbytes, task)

        try:
            seq = 0
            for at in self._df._iter_partition_tables():
                if at.num_rows == 0:
                    continue
                if not pcols:
                    emit(at, os.path.join(path,
                                          f"part-{seq:05d}-{job}.{ext}"))
                    seq += 1
                    continue
                # dynamic partitioning: one directory a distinct key
                # tuple (GpuDynamicPartitionDataSingleWriter)
                body = at.select(out_names)
                for tup, idxs in _split_by_keys(at, pcols):
                    # a table of one key tuple goes whole, uncopied
                    sub = body if len(idxs) == at.num_rows else body.take(
                        pa.array(idxs, type=pa.int64()))
                    pdir = _partition_dir(pcols, tup)
                    full = os.path.join(path, pdir)
                    os.makedirs(full, exist_ok=True)
                    if pdir not in stats.partitions:
                        stats.partitions.append(pdir)
                    emit(sub, os.path.join(
                        full, f"part-{seq:05d}-{job}.{ext}"))
                    seq += 1
            if queue is not None:
                for nrows, nbytes in queue.drain():
                    stats.num_rows += nrows
                    stats.num_bytes += nbytes
                    stats.num_files += 1
        except BaseException:
            # close() re-raises a deferred write error through drain();
            # an exception already unwinding here is not replaced by it
            if queue is not None:
                try:
                    queue.close()
                except Exception:
                    pass
            raise
        else:
            if queue is not None:
                queue.close()
        if stats.num_files == 0:
            # an empty result still records the schema
            schema = self._df.schema.to_arrow()
            empty = (schema.empty_table() if not pcols else
                     pa.schema([(n, schema.field(n).type)
                                for n in out_names]).empty_table())
            write_fn(empty, os.path.join(path, f"part-00000-{job}.{ext}"))
            stats.num_files = 1
        open(os.path.join(path, "_SUCCESS"), "w").close()
        return stats
