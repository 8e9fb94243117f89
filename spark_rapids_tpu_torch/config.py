"""Typed configuration registry: the subset of `spark.rapids.tpu.*` keys
the port reads.

The keys and defaults are the JAX package's own, so one conf dict
configures both sessions. Keys this registry does not know are kept and
ignored, as they are by the JAX package's `TpuConf`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

__all__ = ["TpuConf", "ConfEntry", "REGISTRY", "BATCH_SIZE_ROWS",
           "PARQUET_READER_TYPE", "PARQUET_COALESCING_TARGET",
           "MESH_DEVICES", "SHUFFLE_PARTITIONS", "AGG_STRING_HASH_KEYS",
           "AGG_MAX_MERGE_ROWS", "BROADCAST_THRESHOLD", "JOIN_BUILD_BUDGET"]

REGISTRY: Dict[str, "ConfEntry"] = {}


class ConfEntry:
    def __init__(self, key: str, default: Any, doc: str, typ: Callable):
        self.key = key
        self.default = default
        self.doc = doc
        self.typ = typ
        REGISTRY[key] = self

    def get(self, conf: "TpuConf"):
        raw = conf._settings.get(self.key, self.default)
        if raw is None:
            return None
        if self.typ is bool and isinstance(raw, str):
            return raw.lower() in ("true", "1", "yes")
        return self.typ(raw)


def _conf(key, default, doc, typ):
    return ConfEntry(f"spark.rapids.tpu.{key}", default, doc, typ)


BATCH_SIZE_ROWS = _conf(
    "sql.batchSizeRows", 1 << 20,
    "Target rows per columnar batch moved to the device.", int)
PARQUET_READER_TYPE = _conf(
    "sql.format.parquet.reader.type", "AUTO",
    "AUTO|PERFILE|COALESCING|MULTITHREADED. AUTO picks COALESCING when "
    "the scan has at least four files each below a quarter of the "
    "coalescing target, else MULTITHREADED.", str)
PARQUET_COALESCING_TARGET = _conf(
    "sql.format.parquet.coalescing.targetBytes", 128 << 20,
    "COALESCING reader: files group until their on-disk size reaches "
    "this target; one output partition per group.", int)
MESH_DEVICES = _conf(
    "mesh.devices", 0,
    "Devices in the SPMD mesh. The port has no mesh exchange: a plan "
    "that would use one raises NotPorted.", int)

SHUFFLE_PARTITIONS = _conf(
    "sql.shuffle.partitions", 8,
    "Default partition count for exchanges (spark.sql.shuffle.partitions).",
    int)
AGG_STRING_HASH_KEYS = _conf(
    "sql.agg.stringHashKeys.enabled", True,
    "Hash-once 64-bit keying of string group-by columns: the "
    "aggregation hash pass derives its bucket hashes from the same "
    "packed order-key chunk words the exact verify step compares "
    "(xxhash64-style fold), so string keys are read once per batch "
    "instead of twice (murmur3 walk + chunk build).", bool)
AGG_MAX_MERGE_ROWS = _conf(
    "sql.agg.maxMergeRows", 1 << 21,
    "Upper bound on buffered partial-aggregate rows merged in one "
    "concat pass. Above it, every partial splits into hash buckets of "
    "disjoint keys and each bucket merges and finalizes on its own. The "
    "port keeps the partials on the device (no spill store yet).", int)
JOIN_BUILD_BUDGET = _conf(
    "sql.join.buildSideBudgetBytes", 2 << 30,
    "When a join partition's build side exceeds this many bytes, the JAX "
    "package rehashes both sides into disjoint-key sub-partitions joined "
    "one at a time. The port has no such out-of-core join: it raises "
    "NotPorted instead. 0 disables the check.", int)
BROADCAST_THRESHOLD = _conf(
    "sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Build sides estimated at or below this many bytes use a broadcast "
    "hash join (build collected once, no exchange); larger builds "
    "shuffle both sides on the join keys and join per partition. -1 "
    "disables broadcast.", int)


class TpuConf:
    """Snapshot of settings, resolved against the registry."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def get(self, entry: ConfEntry):
        return entry.get(self)

    @property
    def batch_size_rows(self) -> int:
        return self.get(BATCH_SIZE_ROWS)
