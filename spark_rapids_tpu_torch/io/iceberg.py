"""Apache Iceberg table format: metadata reader + snapshot-scoped scans;
the JAX package's `io/iceberg.py`, ported.

Reference: the plugin's iceberg module (iceberg/, ~10k LoC:
GpuIcebergParquetScan, SparkBatchQueryScan shimming) — table metadata
JSON, Avro manifest lists + manifests (io/avro.py, no external deps),
snapshot time travel, and v2 position deletes.

Read path: metadata/v<N>.metadata.json (via version-hint.text or latest)
-> snapshot -> manifest-list.avro -> manifest.avro entries -> live data
files. Without delete files the scan stays lazy (ParquetScan over the
file list); position deletes force a host-side row filter per file (the
reference gathers on the GPU). A departure of form: the deleted positions
drop through one numpy mask a file where the JAX package tests each row
against a set; the rows kept are the same.
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from .avro import AvroReader

__all__ = ["IcebergTable", "read_iceberg"]


def _field_type(t) -> "object":
    from ..columnar import dtypes as dt
    if isinstance(t, dict):
        k = t.get("type")
        if k == "struct":
            return dt.StructType(tuple(
                dt.StructField(f["name"], _field_type(f["type"]),
                               not f.get("required", False))
                for f in t["fields"]))
        if k == "list":
            return dt.ArrayType(_field_type(t["element"]))
        if k == "map":
            return dt.MapType(_field_type(t["key"]),
                              _field_type(t["value"]))
        raise ValueError(f"unknown iceberg type {t!r}")
    m = {"boolean": dt.BOOL, "int": dt.INT32, "long": dt.INT64,
         "float": dt.FLOAT32, "double": dt.FLOAT64, "date": dt.DATE,
         "timestamp": dt.TIMESTAMP, "timestamptz": dt.TIMESTAMP,
         "string": dt.STRING, "binary": dt.BINARY, "uuid": dt.STRING}
    if t in m:
        return m[t]
    dm = re.match(r"decimal\((\d+),\s*(\d+)\)", t)
    if dm:
        return dt.DecimalType(int(dm.group(1)), int(dm.group(2)))
    raise ValueError(f"unknown iceberg type {t!r}")


class IcebergTable:
    def __init__(self, path: str):
        self.path = path
        self.meta = self._load_metadata()

    # -- metadata ------------------------------------------------------
    def _load_metadata(self) -> Dict:
        mdir = os.path.join(self.path, "metadata")
        hint = os.path.join(mdir, "version-hint.text")
        if os.path.exists(hint):
            v = open(hint).read().strip()
            p = os.path.join(mdir, f"v{v}.metadata.json")
        else:
            cands = sorted(
                glob.glob(os.path.join(mdir, "v*.metadata.json")),
                key=lambda s: int(
                    re.search(r"v(\d+)\.metadata", s).group(1)))
            if not cands:
                cands = sorted(glob.glob(
                    os.path.join(mdir, "*.metadata.json")))
            if not cands:
                raise FileNotFoundError(
                    f"no iceberg metadata under {mdir}")
            p = cands[-1]
        with open(p) as f:
            return json.load(f)

    def schema(self):
        from ..columnar.table import Field, Schema
        ms = self.meta.get("schemas")
        if ms:
            cur = self.meta.get("current-schema-id", 0)
            sch = next(s for s in ms if s.get("schema-id") == cur)
        else:
            sch = self.meta["schema"]
        return Schema([Field(f["name"], _field_type(f["type"]),
                             not f.get("required", False))
                       for f in sch["fields"]])

    def snapshots(self) -> List[Dict]:
        return self.meta.get("snapshots", [])

    def snapshot(self, snapshot_id=None,
                 as_of_timestamp=None) -> Optional[Dict]:
        snaps = self.snapshots()
        if not snaps:
            return None
        if snapshot_id is not None:
            for s in snaps:
                if s["snapshot-id"] == snapshot_id:
                    return s
            raise KeyError(f"snapshot {snapshot_id} not found")
        if as_of_timestamp is not None:
            ok = [s for s in snaps
                  if s["timestamp-ms"] <= as_of_timestamp]
            if not ok:
                raise KeyError(
                    f"no snapshot at or before {as_of_timestamp}")
            return max(ok, key=lambda s: s["timestamp-ms"])
        cur = self.meta.get("current-snapshot-id")
        for s in snaps:
            if s["snapshot-id"] == cur:
                return s
        return snaps[-1]

    def _resolve(self, p: str) -> str:
        """Manifest paths may carry the original table location prefix."""
        if os.path.exists(p):
            return p
        loc = self.meta.get("location", "")
        if loc and p.startswith(loc):
            return os.path.join(self.path, p[len(loc):].lstrip("/"))
        # fall back: strip scheme and rebase on the local table dir
        tail = re.sub(r"^[a-z0-9+.-]+://[^/]*", "", p)
        for marker in ("/data/", "/metadata/"):
            i = tail.find(marker)
            if i >= 0:
                return os.path.join(self.path, tail[i + 1:])
        return p

    # -- files ---------------------------------------------------------
    def live_files(self, snapshot_id=None, as_of_timestamp=None
                   ) -> Tuple[List[str], List[str]]:
        """(data parquet paths, position-delete parquet paths) reachable
        from the chosen snapshot. Manifest entry status 2 = DELETED rows
        drop out; manifest content 1 = delete manifests."""
        snap = self.snapshot(snapshot_id, as_of_timestamp)
        if snap is None:
            return [], []
        mlist = self._resolve(snap["manifest-list"])
        data_files: List[str] = []
        delete_files: List[str] = []
        for man in AvroReader(mlist).records():
            mpath = self._resolve(man["manifest_path"])
            content = man.get("content", 0) or 0
            for entry in AvroReader(mpath).records():
                if entry.get("status") == 2:     # DELETED entry
                    continue
                df = entry["data_file"]
                fpath = self._resolve(df["file_path"])
                fmt = str(df.get("file_format", "PARQUET")).upper()
                if fmt != "PARQUET":
                    raise ValueError(
                        f"iceberg {fmt} data files not supported")
                fcontent = df.get("content", 0) or 0
                if fcontent == 2:
                    raise ValueError(
                        "iceberg equality deletes not supported")
                if content == 1 or fcontent == 1:
                    delete_files.append(fpath)
                else:
                    data_files.append(fpath)
        return data_files, delete_files


def read_iceberg(session, path: str, snapshot_id=None,
                 as_of_timestamp=None):
    from ..plan import logical as L
    from ..session import DataFrame
    tbl = IcebergTable(path)
    schema = tbl.schema()
    data, deletes = tbl.live_files(snapshot_id, as_of_timestamp)
    if not data:
        import pyarrow as pa
        return DataFrame(session,
                         L.InMemoryScan(schema.to_arrow().empty_table()))
    if not deletes:
        return DataFrame(session, L.ParquetScan(data, schema))
    # v2 position deletes: (file_path, pos) rows; host-filter each data
    # file (the reference gathers surviving rows on-GPU)
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    dropped: Dict[str, list] = {}
    for dpath in deletes:
        dt_ = pq.read_table(dpath, columns=["file_path", "pos"])
        for fp, pos in zip(dt_.column(0).to_pylist(),
                           dt_.column(1).to_pylist()):
            dropped.setdefault(os.path.basename(fp), []).append(pos)
    tables = []
    for fpath in data:
        t = pq.read_table(fpath)
        gone = dropped.get(os.path.basename(fpath))
        if gone:
            pos = np.asarray(gone, np.int64)
            mask = np.ones(t.num_rows, bool)
            mask[pos[(pos >= 0) & (pos < t.num_rows)]] = False
            t = t.filter(pa.array(mask))
        tables.append(t)
    return DataFrame(session, L.InMemoryScan(pa.concat_tables(tables)))
