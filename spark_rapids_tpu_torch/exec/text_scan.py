"""Lazy columnar CSV / JSON-lines / ORC / Avro scans (the JAX package's
`exec/text_scan.py`, ported).

Reference: GpuCSVScan.scala:57, GpuJsonScan.scala, GpuOrcScan.scala:78,
GpuAvroScan. The reference decodes these formats on the GPU through
cudf; here, as in the JAX package, the host Arrow decoders (and the
pure-Python Avro container reader, `io/avro.py`) stream batches (CSV
blocks, newline-split JSON blocks, ORC stripes, Avro container blocks)
through a prefetch thread (`exec/nodes.py` `_prefetched`), and each
batch moves to the device in one copy (`Table.from_arrow(at, device)`),
so the scans are lazy, batched and column-pruned. One partition a file;
the bind-time snapshot is checked as each partition starts.
"""
from __future__ import annotations

import io
from typing import Iterator, Optional, Sequence

from ..columnar.table import Schema
from ..config import MULTITHREADED_READ_THREADS, TEXT_BLOCK_SIZE
from ..io.snapshot import verify_snapshot
from .base import ExecContext, TpuExec
from .batch import DeviceBatch
from .nodes import _prefetched, _upload

__all__ = ["CsvScanExec", "JsonScanExec", "OrcScanExec", "AvroScanExec",
           "CsvOptions", "infer_text_schema"]


class CsvOptions:
    """The Spark option subset the JAX package supports (reference:
    GpuCSVScan tagging of supported CSVOptions)."""

    def __init__(self, header: bool = True, delimiter: str = ",",
                 quote: str = '"', escape: str = "\\",
                 comment: Optional[str] = None,
                 null_value: str = ""):
        if comment is not None:
            raise ValueError(
                "csv comment option is not supported (arrow csv has no "
                "comment handling); pre-filter the file instead")
        self.header = header
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.comment = comment
        self.null_value = null_value

    def read_options(self, block_size: int):
        import pyarrow.csv as pc
        return pc.ReadOptions(autogenerate_column_names=not self.header,
                              block_size=block_size)

    def parse_options(self):
        import pyarrow.csv as pc
        return pc.ParseOptions(delimiter=self.delimiter,
                               quote_char=self.quote or False,
                               escape_char=self.escape or False)

    def convert_options(self, arrow_schema=None, columns=None):
        import pyarrow.csv as pc
        kw = {"null_values": [self.null_value], "strings_can_be_null": True}
        if arrow_schema is not None:
            kw["column_types"] = {f.name: f.type for f in arrow_schema}
        if columns is not None:
            kw["include_columns"] = list(columns)
        return pc.ConvertOptions(**kw)


def infer_text_schema(path: str, fmt: str, options=None,
                      user_schema=None) -> Schema:
    """The schema from the file's metadata (ORC, Avro) or a first-block
    sample (CSV, JSON): never a full read."""
    if user_schema is not None:
        return user_schema
    if fmt == "orc":
        import pyarrow.orc as orc
        return Schema.from_arrow(orc.ORCFile(path).schema)
    if fmt == "csv":
        import pyarrow.csv as pc
        opts = options or CsvOptions()
        with pc.open_csv(path, read_options=opts.read_options(1 << 20),
                         parse_options=opts.parse_options(),
                         convert_options=opts.convert_options()) as r:
            return Schema.from_arrow(r.schema)
    if fmt == "avro":
        from ..io.avro import AvroReader, avro_arrow_schema
        return Schema.from_arrow(avro_arrow_schema(AvroReader(path).schema))
    if fmt == "json":
        import pyarrow.json as pj
        with open(path, "rb") as f:
            head = f.read(1 << 20)
        cut = head.rfind(b"\n")
        sample = head if cut < 0 else head[:cut + 1]
        return Schema.from_arrow(pj.read_json(io.BytesIO(sample)).schema)
    raise ValueError(f"unknown text format {fmt!r}")


class _TextScanBase(TpuExec):
    fmt = "?"

    def __init__(self, paths: Sequence[str], schema: Schema,
                 columns: Optional[Sequence[str]] = None, options=None,
                 snapshot=None):
        out_schema = schema
        if columns is not None:
            out_schema = Schema([f for f in schema.fields
                                 if f.name in set(columns)])
        super().__init__([], out_schema)
        self.paths = list(paths)
        self.full_schema = schema
        self.columns = list(columns) if columns else None
        self.options = options
        self.snapshot = tuple(snapshot) if snapshot else None

    def num_partitions(self, ctx):
        return len(self.paths)

    def describe(self):
        cols = f", columns={self.columns}" if self.columns else ""
        return f"{type(self).__name__}[{len(self.paths)} files{cols}]"

    def _host_batches(self, ctx, path) -> Iterator:
        raise NotImplementedError

    def execute_partition(self, ctx: ExecContext, pid: int):
        verify_snapshot(self, ctx, self.fmt)
        m = ctx.metrics_for(self._op_id)
        depth = min(max(1, ctx.conf.get(MULTITHREADED_READ_THREADS)), 4)
        for at in _prefetched(self._host_batches(ctx, self.paths[pid]),
                              depth, ctx.device, (m, "prefetchWaitSecs")):
            batch = _upload(ctx, self._op_id, at)
            m.add("numOutputBatches", 1)
            yield batch


class CsvScanExec(_TextScanBase):
    fmt = "csv"

    def _host_batches(self, ctx, path):
        import pyarrow as pa
        import pyarrow.csv as pc
        opts = self.options or CsvOptions()
        block = ctx.conf.get(TEXT_BLOCK_SIZE)
        with pc.open_csv(
                path, read_options=opts.read_options(block),
                parse_options=opts.parse_options(),
                convert_options=opts.convert_options(
                    self.full_schema.to_arrow(), self.columns)) as reader:
            for rb in reader:
                if rb.num_rows:
                    yield pa.table(rb)


class JsonScanExec(_TextScanBase):
    """JSON lines, read in `sql.text.blockSize` blocks: the bytes after a
    block's last newline carry into the next block, so no line splits."""

    fmt = "json"

    def _host_batches(self, ctx, path):
        import pyarrow.json as pj
        block = ctx.conf.get(TEXT_BLOCK_SIZE)
        popts = pj.ParseOptions(explicit_schema=self.full_schema.to_arrow())
        with open(path, "rb") as f:
            carry = b""
            while True:
                chunk = f.read(block)
                if not chunk:
                    if carry.strip():
                        yield self._parse(carry, popts)
                    return
                buf = carry + chunk
                cut = buf.rfind(b"\n")
                if cut < 0:
                    carry = buf
                    continue
                carry = buf[cut + 1:]
                part = buf[:cut + 1]
                if part.strip():
                    yield self._parse(part, popts)

    def _parse(self, raw: bytes, popts):
        import pyarrow.json as pj
        t = pj.read_json(io.BytesIO(raw), parse_options=popts)
        if self.columns is not None:
            t = t.select([c for c in t.schema.names
                          if c in set(self.columns)])
        return t


class OrcScanExec(_TextScanBase):
    """One partition a file; its stripes stream through the prefetch
    queue (the stripe-granular read of GpuOrcScan's PERFILE reader)."""

    fmt = "orc"

    def _host_batches(self, ctx, path):
        import pyarrow as pa
        import pyarrow.orc as orc
        of = orc.ORCFile(path)
        for i in range(of.nstripes):
            yield pa.table(of.read_stripe(i, columns=self.columns))


class AvroScanExec(_TextScanBase):
    """Avro container scan, one Arrow table a container block
    (`io/avro.py`)."""

    fmt = "avro"

    def _host_batches(self, ctx, path):
        from ..io.avro import iter_avro_blocks
        yield from iter_avro_blocks(path, self.columns)
