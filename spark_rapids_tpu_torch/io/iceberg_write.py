"""Iceberg write path: append/overwrite commits with Avro manifests; the
JAX package's `io/iceberg_write.py`, ported (the JAX result-cache
invalidation after a commit waits for the port's result cache, ROADMAP
A.15).

Reference: the plugin's iceberg module write support (GpuIcebergWrite /
SparkWrite shimming). Commit flow follows the SHAPE of the Iceberg v1
layout: data parquet files under data/, a manifest Avro listing the
added files, a manifest-list Avro naming every live manifest, a new
vN.metadata.json appending the snapshot, and version-hint.text
pointing at it. Appends reuse the previous snapshot's manifests and
add one more; overwrite starts a fresh manifest list.

COMPATIBILITY: the manifest records carry a SUBSET of the v1 required
fields (no added_snapshot_id, partition data, or sequence numbers) and
embed absolute local file paths, so these commits are self-readable
(by this engine's Iceberg reader) but are NOT guaranteed to load in
standard Iceberg readers. See docs/compatibility.md."""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List

from .avro import AvroReader, AvroWriter

__all__ = ["write_iceberg"]


def _iceberg_type(d) -> object:
    from ..columnar import dtypes as dt
    if isinstance(d, dt.BooleanType):
        return "boolean"
    if isinstance(d, (dt.ByteType, dt.ShortType, dt.IntegerType)):
        return "int"
    if isinstance(d, dt.LongType):
        return "long"
    if isinstance(d, dt.FloatType):
        return "float"
    if isinstance(d, dt.DoubleType):
        return "double"
    if isinstance(d, dt.DateType):
        return "date"
    if isinstance(d, dt.TimestampType):
        return "timestamptz"
    if isinstance(d, dt.StringType):
        return "string"
    if isinstance(d, dt.BinaryType):
        return "binary"
    if isinstance(d, dt.DecimalType):
        return f"decimal({d.precision}, {d.scale})"
    raise ValueError(f"iceberg write: unsupported type {d}")


def _schema_json(schema) -> Dict:
    return {"type": "struct",
            "schema-id": 0,
            "fields": [{"id": i + 1, "name": f.name,
                        "required": False,
                        "type": _iceberg_type(f.dtype)}
                       for i, f in enumerate(schema.fields)]}


# faithful subset of the v1 manifest-entry Avro schema: the fields the
# read path (and this writer's own round-trip) consumes
_DATA_FILE = {
    "type": "record", "name": "data_file", "fields": [
        {"name": "content", "type": "int", "default": 0},
        {"name": "file_path", "type": "string"},
        {"name": "file_format", "type": "string"},
        {"name": "record_count", "type": "long"},
        {"name": "file_size_in_bytes", "type": "long"},
    ]}
_MANIFEST_ENTRY = {
    "type": "record", "name": "manifest_entry", "fields": [
        {"name": "status", "type": "int"},
        {"name": "snapshot_id", "type": ["null", "long"],
         "default": None},
        {"name": "data_file", "type": _DATA_FILE},
    ]}
_MANIFEST_FILE = {
    "type": "record", "name": "manifest_file", "fields": [
        {"name": "manifest_path", "type": "string"},
        {"name": "manifest_length", "type": "long"},
        {"name": "partition_spec_id", "type": "int", "default": 0},
        {"name": "content", "type": "int", "default": 0},
        {"name": "added_files_count", "type": ["null", "int"],
         "default": None},
    ]}


def write_iceberg(df, path: str, mode: str = "append") -> int:
    """Commit df as an Iceberg snapshot; returns rows written."""
    import pyarrow.parquet as pq

    mdir = os.path.join(path, "metadata")
    ddir = os.path.join(path, "data")
    os.makedirs(mdir, exist_ok=True)
    os.makedirs(ddir, exist_ok=True)

    # current state (if any)
    from .iceberg import IcebergTable
    exists = bool(
        [n for n in os.listdir(mdir) if n.endswith(".metadata.json")])
    if exists and mode == "errorifexists":
        raise FileExistsError(path)
    if exists and mode == "ignore":
        return 0
    prev = IcebergTable(path) if exists else None
    version = 0
    if exists:
        import re as _re
        vnums = [int(m.group(1)) for n in os.listdir(mdir)
                 if (m := _re.search(r"v(\d+)\.metadata", n))]
        # tables written by standard Iceberg writers name metadata
        # 00001-<uuid>.metadata.json: continue from the file count
        version = max(vnums) if vnums else len(
            [n for n in os.listdir(mdir)
             if n.endswith(".metadata.json")])

    snap_id = int(uuid.uuid4().int % (1 << 62))
    commit = uuid.uuid4().hex[:8]
    now_ms = int(time.time() * 1000)

    # 1) data files
    total_rows = 0
    entries: List[Dict] = []
    seq = 0
    for at in df._iter_partition_tables():
        if at.num_rows == 0:
            continue
        fname = os.path.join(
            ddir, f"part-{seq:05d}-{commit}.parquet")
        pq.write_table(at, fname)
        entries.append({
            "status": 1,                       # ADDED
            "snapshot_id": snap_id,
            "data_file": {
                "content": 0,
                "file_path": fname,
                "file_format": "PARQUET",
                "record_count": at.num_rows,
                "file_size_in_bytes": os.path.getsize(fname),
            }})
        total_rows += at.num_rows
        seq += 1

    # 2) manifest avro
    man_path = os.path.join(mdir, f"manifest-{commit}.avro")
    with AvroWriter(man_path, _MANIFEST_ENTRY) as w:
        w.write_block(entries)

    # 3) manifest list: previous manifests (append) + the new one
    manifests: List[Dict] = []
    if prev is not None and mode == "append":
        snap = prev.snapshot()
        if snap is not None:
            mlist = prev._resolve(snap["manifest-list"])
            for m in AvroReader(mlist).records():
                manifests.append({
                    "manifest_path": prev._resolve(m["manifest_path"]),
                    "manifest_length": m.get("manifest_length", 0) or 0,
                    "partition_spec_id":
                        m.get("partition_spec_id", 0) or 0,
                    "content": m.get("content", 0) or 0,
                    "added_files_count": m.get("added_files_count"),
                })
    manifests.append({
        "manifest_path": man_path,
        "manifest_length": os.path.getsize(man_path),
        "partition_spec_id": 0,
        "content": 0,
        "added_files_count": len(entries),
    })
    mlist_path = os.path.join(
        mdir, f"snap-{snap_id}-manifest-list.avro")
    with AvroWriter(mlist_path, _MANIFEST_FILE) as w:
        w.write_block(manifests)

    # 4) metadata json vN+1
    snapshot = {
        "snapshot-id": snap_id,
        "timestamp-ms": now_ms,
        "manifest-list": mlist_path,
        "summary": {"operation":
                    "append" if mode == "append" else "overwrite"},
    }
    if prev is not None:
        # history stays reachable after overwrite too (time travel);
        # only the new manifest LIST decides what is live
        meta = dict(prev.meta)
        meta["snapshots"] = list(meta.get("snapshots", [])) + [snapshot]
        if mode != "append":
            # an overwrite may change the schema: the table metadata
            # must describe what the live files actually contain
            meta["schema"] = _schema_json(df.schema)
            meta.pop("schemas", None)
            meta.pop("current-schema-id", None)
            meta["last-column-id"] = len(df.schema.fields)
    else:
        meta = {
            "format-version": 1,
            "table-uuid": str(uuid.uuid4()),
            "location": path,
            "last-updated-ms": now_ms,
            "last-column-id": len(df.schema.fields),
            "schema": _schema_json(df.schema),
            "partition-spec": [],
            "properties": {},
            "snapshots": [snapshot],
        }
    meta["current-snapshot-id"] = snap_id
    meta["last-updated-ms"] = now_ms
    version += 1
    mpath = os.path.join(mdir, f"v{version}.metadata.json")
    with open(mpath, "w") as f:
        json.dump(meta, f)
    with open(os.path.join(mdir, "version-hint.text"), "w") as f:
        f.write(str(version))
    return total_rows
