"""Delta Lake table support: transaction log, versioned reads, DML; the
JAX package's `io/delta.py`, ported.

The reference carries 60k LoC of Delta support (delta-lake/
GpuDeltaLog, GpuOptimisticTransaction, GpuMergeIntoCommand,
GpuDeleteCommand, GpuUpdateCommand); this module implements the storage
core (the `_delta_log` JSON-action commit protocol, snapshot
reconstruction and time travel, transactional append / overwrite),
copy-on-write DML (DELETE / UPDATE / MERGE INTO: per-file rewrites whose
filters and joins run on the port's engine, untouched files skipped),
deletion vectors (`io/dv.py`), OPTIMIZE with z-order, auto-compaction,
and periodic checkpoints (`NNN.checkpoint.parquet` + `_last_checkpoint`,
the JAX package's layout). The log the port writes is the JAX
package's, action for action, so each package reads the other's tables.

Departures of form: a deletion vector's dead rows drop through one
numpy mask (`_live_rows`) where the JAX package tests each row against
a set; the rows kept are the same. The JAX package's result-cache
invalidation after a commit waits for the port's result cache (ROADMAP
A.15).
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

__all__ = ["DeltaTable", "write_delta", "read_delta", "delete_delta",
           "update_delta", "merge_delta", "optimize_delta",
           "maybe_auto_compact", "CHECKPOINT_INTERVAL"]

CHECKPOINT_INTERVAL = 10


class DeltaTable:
    def __init__(self, path: str):
        self.path = path
        self.log_dir = os.path.join(path, "_delta_log")

    # ---- log protocol -------------------------------------------------
    def _commit_file(self, version: int) -> str:
        return os.path.join(self.log_dir, f"{version:020d}.json")

    def latest_version(self) -> int:
        if not os.path.isdir(self.log_dir):
            return -1
        versions = [int(f.split(".")[0]) for f in os.listdir(self.log_dir)
                    if f.endswith(".json")]
        return max(versions, default=-1)

    # ---- checkpoints ---------------------------------------------------
    def _checkpoint_file(self, version: int) -> str:
        return os.path.join(self.log_dir,
                            f"{version:020d}.checkpoint.parquet")

    def _last_checkpoint_version(self) -> int:
        lc = os.path.join(self.log_dir, "_last_checkpoint")
        if not os.path.exists(lc):
            return -1
        try:
            with open(lc) as f:
                return int(json.load(f)["version"])
        except (ValueError, KeyError, OSError):
            return -1

    def write_checkpoint(self, version: int):
        """Consolidate the snapshot at `version` into one parquet
        (engine-internal layout: one JSON action per row; the reference's
        binary checkpoint schema interop is follow-on work)."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        actions = self._replay_actions(version)
        # keep protocol/metaData + LIVE adds only
        live: Dict[str, dict] = {}
        keep: List[dict] = []
        for a in actions:
            if "add" in a:
                live[a["add"]["path"]] = a
            elif "remove" in a:
                live.pop(a["remove"]["path"], None)
            elif "protocol" in a or "metaData" in a:
                keep.append(a)
        rows = keep + list(live.values())
        pq.write_table(
            pa.table({"action": pa.array([json.dumps(a) for a in rows])}),
            self._checkpoint_file(version))
        with open(os.path.join(self.log_dir, "_last_checkpoint"),
                  "w") as f:
            json.dump({"version": version, "size": len(rows)}, f)

    def _replay_actions(self, version: int) -> List[dict]:
        """All actions up to `version`, starting from the newest usable
        checkpoint."""
        import pyarrow.parquet as pq
        out: List[dict] = []
        start = 0
        cp = self._last_checkpoint_version()
        if 0 <= cp <= version and os.path.exists(self._checkpoint_file(cp)):
            at = pq.read_table(self._checkpoint_file(cp))
            out.extend(json.loads(s) for s in at.column(0).to_pylist())
            start = cp + 1
        for v in range(start, version + 1):
            with open(self._commit_file(v)) as f:
                for line in f:
                    if line.strip():
                        out.append(json.loads(line))
        return out

    def _actions(self, version: int) -> List[dict]:
        return self._replay_actions(version)

    def snapshot_adds(self, version: Optional[int] = None) -> List[dict]:
        """Live add actions at a version (add minus remove; a re-add of
        the same path — e.g. attaching a deletion vector — replaces the
        earlier entry)."""
        latest = self.latest_version()
        if latest < 0:
            raise FileNotFoundError(f"not a delta table: {self.path}")
        v = latest if version is None else version
        if v > latest:
            raise ValueError(f"version {v} > latest {latest}")
        live: Dict[str, dict] = {}
        for a in self._actions(v):
            if "add" in a:
                live[a["add"]["path"]] = a["add"]
            elif "remove" in a:
                live.pop(a["remove"]["path"], None)
        return list(live.values())

    def snapshot_files(self, version: Optional[int] = None) -> List[str]:
        """Live data file paths at a version."""
        return [os.path.join(self.path, a["path"])
                for a in self.snapshot_adds(version)]

    def try_commit(self, actions: List[dict], version: int) -> bool:
        """Optimistic commit of a SPECIFIC version: atomically create the
        version file (O_EXCL, the delta-log concurrency primitive).
        Returns False if another writer won the version — the caller must
        recompute its actions against the new snapshot and retry."""
        os.makedirs(self.log_dir, exist_ok=True)
        path = self._commit_file(version)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            for a in actions:
                f.write(json.dumps(a) + "\n")
        return True

    def maybe_checkpoint(self, version: int):
        if version > 0 and version % CHECKPOINT_INTERVAL == 0:
            self.write_checkpoint(version)

    def history(self) -> List[dict]:
        out = []
        for v in range(self.latest_version() + 1):
            with open(self._commit_file(v)) as f:
                for line in f:
                    a = json.loads(line)
                    if "commitInfo" in a:
                        out.append({"version": v, **a["commitInfo"]})
        return out


def _live_rows(t, table_root: str, descriptor: dict):
    """The rows of `t` (one data file) that its deletion vector leaves
    live: one numpy mask over the dead positions."""
    import numpy as np
    import pyarrow as pa
    from .dv import load_dv_positions
    dead = np.asarray(load_dv_positions(table_root, descriptor), np.int64)
    mask = np.ones(t.num_rows, bool)
    mask[dead[dead < t.num_rows]] = False
    return t.filter(pa.array(mask))


def write_delta(df, path: str, mode: str = "append"):
    """Transactional write: data files first, then one commit. On a lost
    commit race the actions are RECOMPUTED against the new snapshot (the
    overwrite remove-list and the protocol/metaData bootstrap both depend
    on it)."""
    import pyarrow.parquet as pq
    table = DeltaTable(path)
    os.makedirs(path, exist_ok=True)
    at = df.to_arrow()
    fname = f"part-{uuid.uuid4().hex[:12]}.parquet"
    pq.write_table(at, os.path.join(path, fname))
    while True:
        latest = table.latest_version()
        first = latest < 0
        actions = []
        if first:
            actions.append({"protocol": {"minReaderVersion": 1,
                                         "minWriterVersion": 2}})
            actions.append({"metaData": {
                "id": uuid.uuid4().hex,
                "format": {"provider": "parquet"},
                "schemaString": df.schema.to_arrow().to_string(),
                "partitionColumns": [],
            }})
        op = "WRITE" if mode == "append" or first else "OVERWRITE"
        if mode == "overwrite" and not first:
            for f in table.snapshot_files():
                actions.append({"remove": {
                    "path": os.path.basename(f),
                    "deletionTimestamp": int(time.time() * 1000)}})
        actions.append({"add": {
            "path": fname,
            "size": os.path.getsize(os.path.join(path, fname)),
            "modificationTime": int(time.time() * 1000),
            "dataChange": True}})
        actions.append({"commitInfo": {
            "operation": op, "timestamp": int(time.time() * 1000)}})
        if table.try_commit(actions, latest + 1):
            table.maybe_checkpoint(latest + 1)
            if mode == "append":
                maybe_auto_compact(df._session, path, df._session.conf)
            return latest + 1


def read_delta(session, path: str, version: Optional[int] = None):
    """Read a delta table snapshot (optionally time travel). Files
    carrying deletion vectors host-filter their dead positions (the
    reference applies DVs as row filters in
    GpuDeltaParquetFileFormat)."""
    from ..plan.logical import InMemoryScan, ParquetScan, Union
    from ..session import DataFrame
    table = DeltaTable(path)
    adds = table.snapshot_adds(version)
    if not adds:
        raise ValueError(f"delta table {path} has no live files")
    # pin the table version in the scan: it rides the structural plan
    # fingerprint, so a commit (append/OPTIMIZE/DML) changes every
    # dependent result-cache key even when file mtimes are unhelpful
    dv_ver = table.latest_version() if version is None else version
    plain = [os.path.join(path, a["path"]) for a in adds
             if not a.get("deletionVector")]
    with_dv = [a for a in adds if a.get("deletionVector")]
    if not with_dv:
        return DataFrame(session, ParquetScan(plain, delta_version=dv_ver))
    import pyarrow as pa
    import pyarrow.parquet as pq
    tables = [_live_rows(pq.read_table(os.path.join(path, a["path"])),
                         path, a["deletionVector"]) for a in with_dv]
    dv_tbl = pa.concat_tables(tables)
    if not plain:
        return DataFrame(session, InMemoryScan(dv_tbl))
    return DataFrame(session, Union([
        ParquetScan(plain, delta_version=dv_ver), InMemoryScan(dv_tbl)]))


# ----------------------------------------------------------------------
# Copy-on-write DML (reference: delta-33x GpuDeleteCommand,
# GpuUpdateCommand, GpuMergeIntoCommand — per-file rewrite through the
# engine; files with no matching rows are left untouched)
# ----------------------------------------------------------------------
def _write_rows(session, at, path: str) -> Optional[dict]:
    """Write an arrow table as one new data file; None when empty."""
    import pyarrow.parquet as pq
    if at.num_rows == 0:
        return None
    fname = f"part-{uuid.uuid4().hex[:12]}.parquet"
    pq.write_table(at, os.path.join(path, fname))
    return {"add": {"path": fname,
                    "size": os.path.getsize(os.path.join(path, fname)),
                    "modificationTime": int(time.time() * 1000),
                    "dataChange": True}}


def _file_df(session, table: "DeltaTable", add: dict):
    """DataFrame over ONE live file with its deletion vector (if any)
    applied — DML rewrites must not resurrect DV-dead rows."""
    fpath = os.path.join(table.path, add["path"])
    dv = add.get("deletionVector")
    if not dv:
        return session.read.parquet(fpath)
    import pyarrow.parquet as pq
    return session.create_dataframe(
        _live_rows(pq.read_table(fpath), table.path, dv))


def _remove_action(f: str) -> dict:
    return {"remove": {"path": os.path.basename(f),
                       "deletionTimestamp": int(time.time() * 1000)}}


def _commit_dml(table: DeltaTable, build_actions, op: str) -> int:
    """Optimistic-commit loop: recompute file actions against the latest
    snapshot on every race loss (GpuOptimisticTransaction analog)."""
    while True:
        latest = table.latest_version()
        if latest < 0:
            raise FileNotFoundError(f"not a delta table: {table.path}")
        actions = build_actions()
        actions.append({"commitInfo": {
            "operation": op, "timestamp": int(time.time() * 1000)}})
        if table.try_commit(actions, latest + 1):
            table.maybe_checkpoint(latest + 1)
            return latest + 1


def delete_delta(session, path: str, condition) -> int:
    """DELETE FROM <path> WHERE condition. Returns the new version.
    With delta.deletionVectors.enabled, matching files get a roaring-
    bitmap DV marking dead rows instead of a rewrite (the descriptor's
    pathOrInlineDv is absolute, with storageType 'p')."""
    table = DeltaTable(path)

    from ..config import DELTA_DV_ENABLED
    from ..expr.expressions import IsNull, Not, Or
    use_dv = session.conf.get(DELTA_DV_ENABLED)

    def build():
        actions: List[dict] = []
        keep_cond = Or(Not(condition), IsNull(condition))  # NULL -> keep
        for a in table.snapshot_adds():
            f = os.path.join(path, a["path"])
            if use_dv:
                # ONE read + ONE predicate evaluation per file: the hit
                # positions drive both the skip decision and the DV
                actions.extend(_dv_delete_actions(session, table, a, f,
                                                  condition))
                continue
            df = _file_df(session, table, a)
            if df.filter(condition).count() == 0:
                continue        # untouched file, no rewrite
            kept = df.filter(keep_cond)
            actions.append(_remove_action(f))
            add = _write_rows(session, kept.to_arrow(), path)
            if add:
                actions.append(add)
        return actions

    return _commit_dml(table, build, "DELETE")


def _dv_delete_actions(session, table, add, fpath, condition):
    """Re-add `add` with a deletion vector covering old + new dead
    rows; no new hits -> no actions; a fully-dead file becomes a plain
    remove."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from .dv import load_dv_positions, write_dv_file
    t = pq.read_table(fpath)
    old_dead = set()
    dv0 = add.get("deletionVector")
    if dv0:
        old_dead = set(load_dv_positions(table.path, dv0))
    import numpy as np
    t2 = t.append_column("__pos", pa.array(np.arange(t.num_rows,
                                                     dtype=np.int64)))
    hits = session.create_dataframe(t2).filter(condition) \
        .to_arrow().column("__pos").to_pylist()
    if not set(hits) - old_dead:
        return []                          # nothing newly dead
    dead = old_dead | set(hits)
    if len(dead) >= t.num_rows:
        return [_remove_action(fpath)]
    dv_name = f"deletion_vector_{uuid.uuid4().hex[:12]}.bin"
    dv_abs = os.path.abspath(os.path.join(table.path, dv_name))
    desc = write_dv_file(dv_abs, dead)
    new_add = dict(add)
    # storageType 'p' means an ABSOLUTE path per the Delta protocol
    # (the reference resolves descriptor.absolutePath); table-relative
    # names here would break spec-conformant external readers
    new_add["deletionVector"] = {
        "storageType": "p", "pathOrInlineDv": dv_abs,
        "offset": desc["offset"], "sizeInBytes": desc["sizeInBytes"],
        "cardinality": desc["cardinality"]}
    new_add["dataChange"] = True
    return [_remove_action(fpath), {"add": new_add}]


def update_delta(session, path: str, condition,
                 assignments: Dict[str, object]) -> int:
    """UPDATE <path> SET col=expr WHERE condition. Expressions reference
    the table's columns; returns the new version."""
    from ..expr.expressions import (Cast, Expression, If, Literal,
                                    col as col_)
    table = DeltaTable(path)

    def build():
        actions: List[dict] = []
        for a in table.snapshot_adds():
            f = os.path.join(path, a["path"])
            df = _file_df(session, table, a)
            if df.filter(condition).count() == 0:
                continue
            exprs = []
            for fld in df.schema.fields:
                if fld.name in assignments:
                    v = assignments[fld.name]
                    ve = v if isinstance(v, Expression) else Literal(v)
                    # Spark casts the assignment to the COLUMN's type;
                    # an int literal must not narrow int64 -> int32
                    ve = Cast(ve, fld.dtype)
                    exprs.append(If(condition, ve,
                                    col_(fld.name)).alias(fld.name))
                else:
                    exprs.append(col_(fld.name))
            actions.append(_remove_action(f))
            add = _write_rows(session, df.select(*exprs).to_arrow(), path)
            if add:
                actions.append(add)
        return actions

    return _commit_dml(table, build, "UPDATE")


def merge_delta(session, path: str, source_df, on: List[str],
                when_matched: Optional[str] = "update",
                matched_assignments: Optional[Dict[str, object]] = None,
                when_not_matched: Optional[str] = "insert") -> int:
    """MERGE INTO <path> USING source ON target.k == source.k.

    when_matched: "update" (set matched_assignments, or replace the whole
    row with the source's columns when None), "delete", or None (leave
    matched rows); when_not_matched: "insert" or None. Copy-on-write:
    only files containing matches rewrite; inserts append one new file.
    (reference: delta-33x GpuMergeIntoCommand low-shuffle merge.)"""
    from ..expr.expressions import Expression, If, Literal, col as col_
    table = DeltaTable(path)
    src = source_df.to_arrow()      # materialize once; sources are small

    def build():
        import pyarrow as pa
        actions: List[dict] = []
        src_df = session.create_dataframe(src)
        if when_matched is not None:
            # Delta MERGE semantics: a target row matched by MULTIPLE
            # source rows is an error, not a cardinality change
            from ..functions import count as f_count
            dup = src_df.group_by(*on).agg(f_count("*").alias("__c"))
            dup_keys = dup.filter(col_("__c") > 1)
            if dup_keys.count() > 0:
                tgt = read_delta(session, path)
                hits = tgt.join(dup_keys, on=on, how="left_semi")
                if hits.count() > 0:
                    raise ValueError(
                        "MERGE: multiple source rows matched the same "
                        "target row")
        # rename non-key source columns so post-join references are
        # unambiguous ("update all" must read the SOURCE's value)
        src_ren = src_df.select(*(
            [col_(k) for k in on]
            + [col_(c).alias(f"__src_{c}") for c in src_df.columns
               if c not in on]))
        for a_ in table.snapshot_adds():
            f = os.path.join(path, a_["path"])
            tdf = _file_df(session, table, a_)
            if tdf.join(src_df, on=on, how="left_semi").count() == 0:
                continue
            if when_matched == "delete":
                out_at = tdf.join(src_df, on=on,
                                  how="left_anti").to_arrow()
            elif when_matched == "update":
                anti = tdf.join(src_df, on=on, how="left_anti")
                hit = tdf.join(src_ren, on=on, how="inner")
                exprs = []
                for fld in tdf.schema.fields:
                    if matched_assignments and \
                            fld.name in matched_assignments:
                        from ..expr.expressions import Cast as _Cast
                        v = matched_assignments[fld.name]
                        ve = (v if isinstance(v, Expression)
                              else Literal(v))
                        exprs.append(_Cast(ve, fld.dtype)
                                     .alias(fld.name))
                    elif matched_assignments is None \
                            and fld.name not in on \
                            and f"__src_{fld.name}" in hit.columns:
                        exprs.append(
                            col_(f"__src_{fld.name}").alias(fld.name))
                    else:
                        exprs.append(col_(fld.name))
                out_at = pa.concat_tables([
                    anti.to_arrow().select(list(tdf.columns)),
                    hit.select(*exprs).to_arrow()])
            else:
                continue
            actions.append(_remove_action(f))
            add = _write_rows(session, out_at, path)
            if add:
                actions.append(add)
        if when_not_matched == "insert":
            target = read_delta(session, path)
            tcols = [fld.name for fld in target.schema.fields]
            missing = [c for c in tcols if c not in src_df.columns]
            if missing:
                raise ValueError(f"merge insert: source lacks {missing}")
            inserts = src_df.join(target.select(*[col_(k) for k in on]),
                                  on=on, how="left_anti")
            add = _write_rows(session,
                              inserts.to_arrow().select(tcols), path)
            if add:
                actions.append(add)
        return actions

    return _commit_dml(table, build, "MERGE")


# ---- OPTIMIZE / auto-compaction / z-order -----------------------------
def _zorder_indices(at, zorder_by: List[str]):
    """Row order by interleaved-bit (Morton) z-value over the given
    numeric columns: each column min-max normalizes to 16 bits, bits
    interleave MSB-first (reference: sql-plugin zorder/ZOrderRules.scala
    + JNI ZOrder interleave_bits)."""
    import numpy as np
    # bits per column capped so the interleaved key fits uint64 (>4
    # z-order columns would otherwise shift the leading columns' high
    # bits out and scramble the curve)
    bits = min(16, 64 // max(1, len(zorder_by)))
    top = float((1 << bits) - 1)
    cols = []
    for name in zorder_by:
        v = at.column(name).to_numpy(zero_copy_only=False).astype(
            np.float64)
        v = np.where(np.isnan(v), 0.0, v)
        lo, hi = float(v.min()), float(v.max())
        span = (hi - lo) or 1.0
        cols.append(((v - lo) / span * top).astype(np.uint64))
    z = np.zeros(at.num_rows, np.uint64)
    for bit in range(bits - 1, -1, -1):
        for c in cols:
            z = (z << np.uint64(1)) | ((c >> np.uint64(bit))
                                       & np.uint64(1))
    return np.argsort(z, kind="stable")


def optimize_delta(session, path: str, zorder_by: Optional[List[str]]
                   = None, target_file_bytes: int = 128 << 20,
                   min_files: int = 2) -> dict:
    """OPTIMIZE: bin-pack small live files into ~target-sized files
    (deletion vectors applied — survivors carry forward, DV files
    retire), optionally z-order clustering rows by interleaved bits.
    One commit, operation OPTIMIZE, dataChange=False (the rewrite
    changes layout, not content — downstream streaming readers skip
    it). Returns {filesRemoved, filesAdded, version} (reference:
    delta-lake GpuOptimizeWriteExchangeExec + zorder/ZOrderRules).

    Auto-compaction (write_delta with
    spark.rapids.tpu.delta.autoCompact.minFiles) calls this after
    appends once the small-file count crosses the threshold."""
    import pyarrow as pa

    table = DeltaTable(path)
    latest = table.latest_version()
    if latest < 0:
        raise FileNotFoundError(f"not a delta table: {path}")

    def plan_groups():
        """Snapshot + grouping — recomputed INSIDE every commit
        attempt: a race-loss retry must not replay remove/rewrite
        actions against a stale snapshot (a concurrent DELETE's
        rewrite would be resurrected)."""
        adds = table.snapshot_adds()
        # z-order rewrites everything; plain compaction only groups of
        # small files (or DV-carrying files, which fold their DVs in)
        if zorder_by:
            return [adds] if adds else []
        small = [a for a in adds
                 if a.get("size", 0) < target_file_bytes // 2
                 or a.get("deletionVector")]
        return [small] if len(small) >= min_files else []

    if not plan_groups():
        return {"filesRemoved": 0, "filesAdded": 0,
                "version": latest}

    def build_actions():
        actions: List[dict] = []
        removed = 0
        added = 0
        for group in plan_groups():
            tabs = []
            for add in group:
                t = _file_df(session, table, add).to_arrow()
                if t.num_rows:
                    tabs.append(t)
                actions.append(_remove_action(add["path"]))
                removed += 1
            if not tabs:
                continue
            at = pa.concat_tables(tabs)
            if zorder_by:
                import pyarrow as _pa
                idx = _zorder_indices(at, zorder_by)
                at = at.take(_pa.array(idx, type=_pa.int64()))
            # slice into ~target-byte output files
            bpr = max(1, at.nbytes // max(at.num_rows, 1))
            rows_per_file = max(1, target_file_bytes // bpr)
            off = 0
            while off < at.num_rows:
                part = at.slice(off, rows_per_file)
                a = _write_rows(session, part, path)
                if a:
                    a["add"]["dataChange"] = False
                    actions.append(a)
                    added += 1
                off += rows_per_file
        build_actions.stats = (removed, added)
        return actions

    v = _commit_dml(table, build_actions, "OPTIMIZE")
    removed, added = build_actions.stats
    return {"filesRemoved": removed, "filesAdded": added, "version": v}


def maybe_auto_compact(session, path: str, conf) -> Optional[dict]:
    """Post-append auto-compaction: when the table has >= minFiles live
    files smaller than half the target, compact them (reference:
    delta auto-compaction / GpuOptimizeWriteExchangeExec)."""
    from ..config import (DELTA_AUTOCOMPACT_MIN_FILES,
                          DELTA_AUTOCOMPACT_TARGET_BYTES)
    min_files = conf.get(DELTA_AUTOCOMPACT_MIN_FILES)
    if min_files <= 0:
        return None
    target = conf.get(DELTA_AUTOCOMPACT_TARGET_BYTES)
    table = DeltaTable(path)
    adds = table.snapshot_adds()
    small = [a for a in adds if a.get("size", 0) < target // 2]
    if len(small) < min_files:
        return None
    return optimize_delta(session, path, target_file_bytes=target,
                          min_files=min_files)
