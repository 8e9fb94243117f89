"""Typed configuration registry: the subset of `spark.rapids.tpu.*` keys
the port reads.

The keys and defaults are the JAX package's own, so one conf dict
configures both sessions. Keys this registry does not know are kept and
ignored, as they are by the JAX package's `TpuConf`.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional

__all__ = ["TpuConf", "ConfEntry", "REGISTRY", "BATCH_SIZE_ROWS",
           "PARQUET_READER_TYPE", "PARQUET_COALESCING_TARGET",
           "MESH_DEVICES", "SHUFFLE_PARTITIONS", "AGG_STRING_HASH_KEYS",
           "AGG_MAX_MERGE_ROWS", "BROADCAST_THRESHOLD", "JOIN_BUILD_BUDGET",
           "DISTINCT_AGG_REWRITE", "MULTITHREADED_READ_THREADS",
           "PARQUET_DEVICE_DECODE", "PARQUET_DEVICE_SNAPPY",
           "HOST_STAGING_POOL_BYTES", "HOST_MEMORY_LIMIT",
           "FILECACHE_ENABLED", "FILECACHE_DIR", "FILECACHE_MAX_BYTES",
           "JOIN_REORDER_ENABLED", "JOIN_REORDER_DP_RELATIONS",
           "ADAPTIVE_ENABLED", "ADAPTIVE_TARGET_BYTES",
           "ADAPTIVE_SKEW_ENABLED", "ADAPTIVE_SKEW_FACTOR",
           "ADAPTIVE_SKEW_MIN_BYTES", "ADAPTIVE_COALESCE_ENABLED",
           "ADAPTIVE_DEMOTE_ENABLED", "ADAPTIVE_CALIBRATION",
           "EXCHANGE_REUSE", "EXCHANGE_MAP_THREADS",
           "EXCHANGE_ASYNC_BROADCAST",
           "EXCHANGE_BROADCAST_TIMEOUT", "CONCURRENT_TASKS",
           "HBM_POOL_FRACTION", "HBM_POOL_BYTES", "HOST_SPILL_LIMIT",
           "SPILL_DIR", "OOM_MAX_RETRIES", "SORT_OOC_ENABLED",
           "SORT_OOC_THRESHOLD", "WINDOW_CHUNK_ROWS", "ALLOW_CPU_FALLBACK",
           "EXPLAIN", "AUDIT_STRICT", "CBO_ENABLED", "CBO_SMALL_INPUT_ROWS",
           "DEGRADE_TO_HOST", "JOIN_BLOOM_ENABLED",
           "JOIN_BLOOM_MAX_BUILD_ROWS", "TEXT_BLOCK_SIZE",
           "ASYNC_WRITE_ENABLED", "ASYNC_WRITE_MAX_IN_FLIGHT",
           "ASYNC_WRITE_THREADS", "DELTA_DV_ENABLED",
           "DELTA_AUTOCOMPACT_MIN_FILES", "DELTA_AUTOCOMPACT_TARGET_BYTES",
           "PYTHON_CONCURRENT_WORKERS", "PYTHON_GROUPED_CHUNK_BYTES",
           "METRICS_LEVEL", "METRICS_SYNC", "EVENT_LOG_ENABLED",
           "EVENT_LOG_DIR", "TRACE_ENABLED", "TRACE_SAMPLE_RATE",
           "TELEMETRY_ENABLED", "LORE_DUMP_IDS", "LORE_DUMP_PATH",
           "FAULTS_PLAN", "RETRY_COVERAGE_ENABLED", "LOCKDEP_ENABLED",
           "LOCKDEP_RAISE", "LEDGER_ENABLED", "LEDGER_RAISE",
           "LEDGER_POISON", "RACEDEP_ENABLED", "RACEDEP_RAISE"]

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
CONCURRENT_TASKS = _conf(
    "sql.concurrentTpuTasks", 2,
    "Max tasks concurrently admitted to the device (TpuSemaphore "
    "permits; analog of spark.rapids.sql.concurrentGpuTasks). The "
    "collect runs a query's partitions on min(partitions, max(2, 2 x "
    "this)) threads, each holding a permit while it advances its "
    "partition.", int)
HBM_POOL_FRACTION = _conf(
    "memory.tpu.allocFraction", 0.85,
    "Fraction of device memory the memory manager may budget for "
    "columnar data (on CUDA, of torch.cuda.mem_get_info's total).",
    float)
HBM_POOL_BYTES = _conf(
    "memory.tpu.poolBytes", None,
    "Explicit device budget in bytes; overrides allocFraction when set.",
    int)
HOST_SPILL_LIMIT = _conf(
    "memory.host.spillStorageSize", 32 * 1024 * 1024 * 1024,
    "Bytes of host DRAM usable for spilled device buffers before "
    "cascading to disk.", int)
SPILL_DIR = _conf(
    "memory.spill.dir", os.path.join(tempfile.gettempdir(), "srtpu-spill"),
    "Directory for disk-tier spill files (default: srtpu-spill under "
    "the process's temporary directory).", str)
OOM_MAX_RETRIES = _conf(
    "memory.oom.maxRetries", 8,
    "Bounded retries after device OOM before giving up (analog of "
    "DeviceMemoryEventHandler maxFailedOOMRetries). Registered as in "
    "the JAX package, which reads it nowhere either: the retry loops "
    "bound themselves (12 splits, 2 unsplit retries).", int)
SORT_OOC_ENABLED = _conf(
    "sql.sort.outOfCore.enabled", True,
    "Enable out-of-core sort (range exchange over spill handles + "
    "per-partition sorts) for big inputs.", bool)
SORT_OOC_THRESHOLD = _conf(
    "sql.sort.outOfCore.thresholdBytes", 2 << 30,
    "Device bytes of sort input above which the out-of-core path "
    "activates.", int)
WINDOW_CHUNK_ROWS = _conf(
    "sql.window.chunkRows", 1 << 22,
    "Row count above which chunkable window specs (running frames and "
    "ranking over fixed-width keys) stream chunk by chunk through the "
    "out-of-core sort with carried per-partition state, so a window "
    "partition need not fit device memory (reference: "
    "GpuRunningWindowExec batched running windows). 0 disables.", int)
PARQUET_READER_TYPE = _conf(
    "sql.format.parquet.reader.type", "AUTO",
    "AUTO|PERFILE|COALESCING|MULTITHREADED. AUTO picks COALESCING when "
    "the scan has at least four files each below a quarter of the "
    "coalescing target, else MULTITHREADED.", str)
PARQUET_COALESCING_TARGET = _conf(
    "sql.format.parquet.coalescing.targetBytes", 128 << 20,
    "COALESCING reader: files group until their on-disk size reaches "
    "this target; one output partition per group.", int)
MULTITHREADED_READ_THREADS = _conf(
    "sql.format.parquet.multiThreadedRead.numThreads", 4,
    "Thread pool for the multithreaded Parquet reader (analog of "
    "spark.rapids.sql.multiThreadedRead.numThreads): the decode-ahead "
    "queue holds up to min(n, 4) batches, and snappy pages of the "
    "device decode decompress on n threads.", int)
PARQUET_DEVICE_DECODE = _conf(
    "sql.format.parquet.deviceDecode.enabled", True,
    "Decode eligible Parquet column chunks ON DEVICE (flat "
    "INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY chunks; UNCOMPRESSED or "
    "SNAPPY; PLAIN or dictionary encoded; v1 and v2 data pages): raw "
    "bytes upload once, PLAIN lane assembly + RLE run expansion + "
    "string offset extraction + def-level masking run as torch ops on "
    "the device (GpuParquetScan.scala:3364 Table.readParquet analog). "
    "Snappy pages decompress per-page on the multithreaded prefetch "
    "pool, off the compute thread. Ineligible columns fall back to host "
    "pyarrow per column (deviceDecodeFallback.* counters). On a CPU "
    "session the path only fires when this conf is set explicitly: "
    "host pyarrow decode and the 'device' ops share the same silicon "
    "there, and pyarrow's native decoder wins.", bool)
PARQUET_DEVICE_SNAPPY = _conf(
    "sql.parquet.deviceSnappy", False,
    "Decompress qualifying snappy pages ON DEVICE (the parsed "
    "literal/copy element table: run-ownership map + log-depth pointer "
    "doubling resolves every output byte to a literal source). Applies "
    "to v1 PLAIN pages of non-nullable chunks; the host walks only the "
    "tag bytes. Other pages keep the host prefetch-pool decompress.",
    bool)
HOST_STAGING_POOL_BYTES = _conf(
    "memory.host.stagingPoolBytes", 256 * 1024 * 1024,
    "Byte cap on the pinned staging pool: reusable pow2-bucketed host "
    "buffers for raw-chunk reads, snappy decompression targets, and "
    "H2D upload staging in the device Parquet scan (HostAlloc pinned "
    "pool analog). Cached buffers draw from memory.host.limitBytes; "
    "leases past the cap are transient (freed on release).", int)
HOST_MEMORY_LIMIT = _conf(
    "memory.host.limitBytes", 0,
    "Global host-DRAM byte budget (HostAlloc.scala:36 analog) shared by "
    "the spill store's host tier and the staging pool's cached buffers. "
    "A spill reservation over budget fires the host->disk pressure "
    "cascade; a staging lease over budget stays transient. 0 = "
    "unlimited.", int)
FILECACHE_ENABLED = _conf(
    "filecache.enabled", False,
    "Cache scan input files on local disk, keyed by (path, mtime, "
    "size) with LRU eviction; repeated scans of network-mounted inputs "
    "skip the fetch (reference: spark.rapids.filecache.enabled, "
    "GpuFileCache). Off by default: pure overhead for local inputs.",
    bool)
FILECACHE_DIR = _conf(
    "filecache.dir", "/tmp/srtpu-filecache",
    "Local directory for cached input files.", str)
FILECACHE_MAX_BYTES = _conf(
    "filecache.maxBytes", 16 << 30,
    "Upper bound on cached bytes; least-recently-used entries evict "
    "past it.", int)
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
    "concat pass. Buffered partials live in the spill store; when the "
    "total group state exceeds this, the aggregation repartitions every "
    "partial into hash buckets of disjoint keys and merges/finalizes "
    "each bucket separately, the out-of-core fallback "
    "(GpuAggregateExec.scala:863-894 repartition algorithm analog).", int)
JOIN_BUILD_BUDGET = _conf(
    "sql.join.buildSideBudgetBytes", 2 << 30,
    "When a join partition's build side exceeds this many bytes, both "
    "sides are rehashed into disjoint-key sub-partitions (spillable "
    "piles) joined one at a time, so builds bigger than device memory "
    "complete instead of dying (GpuSubPartitionHashJoin.scala:617 "
    "analog). 0 disables.", int)
BROADCAST_THRESHOLD = _conf(
    "sql.autoBroadcastJoinThreshold", 10 * 1024 * 1024,
    "Build sides estimated at or below this many bytes use a broadcast "
    "hash join (build collected once, no exchange); larger builds "
    "shuffle both sides on the join keys and join per partition. -1 "
    "disables broadcast.", int)
JOIN_BLOOM_ENABLED = _conf(
    "sql.join.bloomFilter.enabled", False,
    "Runtime bloom-filter join pruning: shuffled inner/left_semi/right "
    "equi-joins with a small scan-shaped build side run the build once "
    "into a device bloom filter and mask the stream side BEFORE its "
    "exchange (reference: GpuBloomFilterAggregate + "
    "GpuBloomFilterMightContain via InSubqueryExec runtime filters). "
    "Off by default pending broader production soak.", bool)
JOIN_BLOOM_MAX_BUILD_ROWS = _conf(
    "sql.join.bloomFilter.maxBuildRows", 4_000_000,
    "Upper bound on the ESTIMATED build-side rows for runtime "
    "bloom-filter creation (filter memory is ~1 byte/bit at 8 "
    "bits/row).", int)
DISTINCT_AGG_REWRITE = _conf(
    "sql.optimizer.distinctAggRewrite.enabled", True,
    "Rewrite count(DISTINCT x) into a two-level hash aggregation (the "
    "single-distinct-child case of Catalyst's "
    "RewriteDistinctAggregates): an inner DISTINCT group-by over "
    "(keys..., x) then an outer Count. Both levels run the bucketed "
    "hash-aggregate pass (incl. hash-once string keying) instead of "
    "CollectAggExec's full multi-chunk lexsort.", bool)

JOIN_REORDER_ENABLED = _conf(
    "sql.optimizer.joinReorder.enabled", True,
    "Cost-based join reordering (analog of Catalyst's "
    "CostBasedJoinReorder): maximal chains of INNER equi-joins are "
    "reordered into the left-deep order minimizing estimated "
    "intermediate cardinalities, from bottom-up row/NDV estimates "
    "(sampled scan statistics, Chao1 extrapolation). Outer, semi, "
    "anti and cross joins and non-equi conditions are never reordered "
    "across. The smaller estimated side of every join lands on the "
    "build side.", bool)
JOIN_REORDER_DP_RELATIONS = _conf(
    "sql.optimizer.joinReorder.maxDpRelations", 8,
    "Join chains with at most this many relations are ordered by exact "
    "dynamic programming over left-deep orders (Selinger); larger "
    "chains use a greedy min-intermediate-cardinality extension.", int)
ADAPTIVE_ENABLED = _conf(
    "sql.adaptive.enabled", True,
    "Adaptive execution: every shuffle stage materializes before its "
    "consumer runs, then its reduce partitions are re-planned "
    "(coalesced, skew-split, or the join demoted to broadcast), and "
    "observed cardinalities calibrate later plans.", bool)
ADAPTIVE_TARGET_BYTES = _conf(
    "sql.adaptive.advisoryPartitionSizeInBytes", 64 * 1024 * 1024,
    "Advisory post-shuffle partition size: adjacent reduce partitions "
    "smaller than this coalesce into one task.", int)
ADAPTIVE_SKEW_FACTOR = _conf(
    "sql.adaptive.skewJoin.skewedPartitionFactor", 5,
    "A join stream partition is skewed when its bytes exceed this "
    "factor times the median partition size (and the min threshold).",
    int)
ADAPTIVE_SKEW_MIN_BYTES = _conf(
    "sql.adaptive.skewJoin.skewedPartitionThresholdInBytes",
    256 * 1024 * 1024,
    "Minimum bytes before a stream partition is considered skewed.", int)
ADAPTIVE_COALESCE_ENABLED = _conf(
    "sql.adaptive.coalescePartitions.enabled", True,
    "Adaptive rule 1: merge small contiguous post-shuffle partitions "
    "toward advisoryPartitionSizeInBytes. Off: one task per reduce "
    "partition.", bool)
ADAPTIVE_SKEW_ENABLED = _conf(
    "sql.adaptive.skewJoin.enabled", True,
    "Adaptive rule 2: split join stream partitions exceeding "
    "skewedPartitionFactor x median (and the byte threshold) into "
    "byte-balanced slices, each probing the full matching build "
    "partition.", bool)
ADAPTIVE_DEMOTE_ENABLED = _conf(
    "sql.adaptive.joinDemotion.enabled", True,
    "Adaptive rule 3: when a shuffled hash join's build side "
    "materializes under autoBroadcastJoinThreshold, the join becomes a "
    "broadcast hash join over the shuffled build and the stream side's "
    "map phase never runs.", bool)
ADAPTIVE_CALIBRATION = _conf(
    "sql.adaptive.calibration.enabled", True,
    "Feed observed output cardinalities back into plan/stats.py as a "
    "process-wide calibration table keyed by structural plan "
    "fingerprints, correcting the join reorder's row estimates for "
    "later plans of the same subtrees.", bool)
EXCHANGE_REUSE = _conf(
    "sql.exec.exchange.reuse.enabled", True,
    "Plan-level exchange deduplication (Spark's ReuseExchange rule): "
    "structurally identical exchange subtrees become ReusedExchange "
    "nodes sharing the first occurrence's materialization; hits are "
    "exchangeReuseHits.", bool)
EXCHANGE_MAP_THREADS = _conf(
    "sql.exec.exchange.mapThreads", 0,
    "Worker threads executing an exchange's map-side child partitions "
    "concurrently (each worker runs a full map partition: child "
    "execute, device partition pass, host slicing, shuffle write). "
    "Device admission still goes through the TpuSemaphore, so chip "
    "concurrency stays bounded by sql.concurrentTpuTasks; this conf "
    "overlaps the HOST halves (decode, slicing, serialization, file "
    "I/O) across partitions (the RapidsShuffleThreadedWriter analog). "
    "0 = auto (min(4, cpu cores)); 1 = serial map side.", int)
EXCHANGE_ASYNC_BROADCAST = _conf(
    "sql.exec.exchange.asyncBroadcast.enabled", True,
    "Materialize a broadcast join's build side on a background thread "
    "started when the join begins executing, so the build overlaps the "
    "stream side's scan; the join waits for it, bounded by "
    "broadcastTimeoutSecs.", bool)
EXCHANGE_BROADCAST_TIMEOUT = _conf(
    "sql.exec.exchange.broadcastTimeoutSecs", 300.0,
    "Upper bound on the join's wait for an async broadcast build. On "
    "timeout the join joins or re-runs the build on its own thread "
    "(never two at once) and counts broadcastTimeoutFallbacks. 0 = "
    "wait forever.", float)

ALLOW_CPU_FALLBACK = _conf(
    "sql.allowCpuFallback", True,
    "Allow operators that cannot run on TPU to fall back to the host CPU "
    "path instead of failing. In the port: a Project or Filter whose "
    "expression the device cannot run evaluates on the host interpreter "
    "(exec/host_fallback.py).", bool)
EXPLAIN = _conf(
    "sql.explain", "NONE",
    "Explain TPU planning: NONE|NOT_ON_TPU|ALL|VALIDATE "
    "(analog of spark.rapids.sql.explain). NOT_ON_TPU/ALL print the "
    "tagged plan plus static-audit findings; VALIDATE prints the full "
    "plan-audit verdict tree (ok / will_fallback / will_not_work per "
    "node; the port never issues recompile_risk).", str)
AUDIT_STRICT = _conf(
    "sql.audit.strict", False,
    "Fail at PLAN time when the static plan auditor finds a "
    "will_not_work verdict (unregistered expression, dtype the device "
    "kernels cannot actually run): raises UnsupportedExpr carrying the "
    "node path of every blocked site. will_fallback verdicts never fail "
    "the plan.", bool)
CBO_ENABLED = _conf(
    "sql.optimizer.cbo.enabled", False,
    "Cost-based device-vs-host placement: tiny Project/Filter inputs "
    "the host interpreter covers run on the CPU bridge instead of "
    "paying a device dispatch (reference: CostBasedOptimizer.scala + "
    "GpuCostModel, also default-off). Decisions show in explain as "
    "'CBO: ...'.", bool)
CBO_SMALL_INPUT_ROWS = _conf(
    "sql.optimizer.cbo.smallInputRows", 64,
    "CBO small-input bound: estimated input rows at or below this run "
    "host-side when coverable.", int)
DEGRADE_TO_HOST = _conf(
    "sql.exec.degradeToHost.enabled", True,
    "Graceful device->host degradation: a ProjectExec or FilterExec "
    "whose device evaluation raises an error that is neither an OOM "
    "(split-and-retry's) nor a CUDA runtime error re-evaluates the batch "
    "on the host interpreter, and after two device failures on the "
    "same operator stops dispatching to the device for the rest of the "
    "query (counted as degradedToHost, recorded as a degrade_to_host "
    "event).", bool)

TEXT_BLOCK_SIZE = _conf(
    "sql.text.blockSize", 32 * 1024 * 1024,
    "Host decode block size (bytes) for streaming CSV/JSON scans.", int)
ASYNC_WRITE_ENABLED = _conf(
    "sql.asyncWrite.enabled", True,
    "Run file-part encode + disk I/O on a writer pool off the compute "
    "thread (reference: io/async AsyncOutputStream). The pool does host "
    "work only: every copy from the device stays on the thread that "
    "runs the plan.", bool)
ASYNC_WRITE_MAX_IN_FLIGHT = _conf(
    "sql.asyncWrite.maxInFlightHostMemoryBytes", 2 << 30,
    "Upper bound on host bytes held by scheduled-but-unfinished async "
    "writes; submissions block above it (always admitting one task), "
    "so a slow disk cannot pile the query's output into host memory "
    "(reference: TrafficController).", int)
ASYNC_WRITE_THREADS = _conf(
    "sql.asyncWrite.numThreads", 4,
    "Writer-pool threads for the async write path.", int)
DELTA_DV_ENABLED = _conf(
    "delta.deletionVectors.enabled", False,
    "DELETE writes a deletion-vector (roaring bitmap) file marking "
    "dead rows instead of rewriting the data file (reference: Delta "
    "DV support in GpuDeltaParquetFileFormat / GpuDeleteCommand). Reads "
    "apply DVs regardless of this flag.", bool)
DELTA_AUTOCOMPACT_MIN_FILES = _conf(
    "delta.autoCompact.minFiles", 0,
    "When > 0, a Delta append auto-compacts once the table holds at "
    "least this many live files smaller than half the target size "
    "(reference: delta auto-compaction). 0 disables.", int)
DELTA_AUTOCOMPACT_TARGET_BYTES = _conf(
    "delta.autoCompact.targetBytes", 128 << 20,
    "Target output file size for Delta OPTIMIZE / auto-compaction.",
    int)

PYTHON_CONCURRENT_WORKERS = _conf(
    "python.concurrentPythonWorkers", 4,
    "Worker-process slots for pandas transforms (mapInPandas); "
    "acquisition blocks above it (reference: "
    "spark.rapids.python.concurrentPythonWorkers, "
    "PythonWorkerSemaphore).", int)
PYTHON_GROUPED_CHUNK_BYTES = _conf(
    "python.groupedChunkBytes", 64 << 20,
    "applyInPandas/aggregate-in-pandas partitions larger than this "
    "many host bytes ship to the python worker in chunks cut at GROUP "
    "boundaries (OOM-safe: a group is never split).", int)
METRICS_LEVEL = _conf(
    "sql.metrics.level", "MODERATE",
    "Metric verbosity: ESSENTIAL|MODERATE|DEBUG.", str)
METRICS_SYNC = _conf(
    "sql.metrics.sync", False,
    "Synchronize the device at the end of every operator timer "
    "(torch.cuda.synchronize on the query's device; nothing on the "
    "CPU). OFF by default: CUDA launches are asynchronous, so default "
    "op-time metrics measure the time to ENQUEUE the work, and its "
    "execution is attributed to whichever later operator first waits "
    "(usually the D2H copy at the plan root). Turning this on yields "
    "per-operator execution times at the cost of pipelining.", bool)
EVENT_LOG_ENABLED = _conf(
    "sql.eventLog.enabled", False,
    "Write a structured per-query JSONL event log (the Spark event-log "
    "analog): plan with lore ids, per-operator metric snapshots, "
    "memory watermarks, kernel launch and host-sync counts, trace "
    "spans. Consumed by EXPLAIN ANALYZE post-processing and the JAX "
    "package's profiling tool, whose reader parses the same records.",
    bool)
EVENT_LOG_DIR = _conf(
    "sql.eventLog.dir", os.path.join(tempfile.gettempdir(),
                                     "srtpu-events"),
    "Directory for per-query event-log JSONL files (default under the "
    "process's temporary directory).", str)
TRACE_ENABLED = _conf(
    "sql.trace.enabled", True,
    "Open per-query spans (profiler/tracing.py) around planning, the "
    "adaptive stage decisions, pool map tasks and their admission "
    "waits, broadcast builds and their waits, and degrade-to-host "
    "recovery. Spans assemble into one trace per query, written to the "
    "event log as trace_span records (when sql.eventLog.enabled) and "
    "reduced to critical-path latency shares "
    "(profiler/critical_path.py) shown in EXPLAIN ANALYZE's root "
    "annotation.", bool)
TRACE_SAMPLE_RATE = _conf(
    "sql.trace.sampleRate", 1.0,
    "Fraction of queries traced (0.0-1.0). Sampling is deterministic "
    "on the query id (crc32 bucket), so every thread of a query agrees "
    "on the decision.", float)
TELEMETRY_ENABLED = _conf(
    "sql.telemetry.enabled", True,
    "Expose the process-global telemetry registry (profiler/"
    "telemetry.py: histograms, counters and memory-watermark gauges) "
    "as a snapshot and a Prometheus text dump. Recording itself is "
    "always-on and O(1) per observation; this gates the scrape "
    "surface.", bool)
LORE_DUMP_IDS = _conf(
    "sql.lore.idsToDump", None,
    "LORE ids whose input batches should be dumped for replay "
    "(analog of spark.rapids.sql.lore.idsToDumpPath).", str)
LORE_DUMP_PATH = _conf(
    "sql.lore.dumpPath", os.path.join(tempfile.gettempdir(),
                                      "srtpu-lore"),
    "Directory for LORE operator dumps (default under the process's "
    "temporary directory).", str)


FAULTS_PLAN = _conf(
    "sql.debug.faults.plan", None,
    "Deterministic fault-injection plan (runtime/faults.py): "
    "';'-separated rules `point[:selector]*[:action]` over the named "
    "fault points (block.fetch, rpc.send, executor.task, "
    "device.dispatch, exchange.map, spill.write, xla.compile, "
    "mesh.collective, peer.fetch; the port fires device.dispatch, "
    "exchange.map and spill.write, the others parse and stay inert "
    "until their modules come). Selectors: nth=N, prob=P, seed=S, "
    "times=K, query=SUB, op=NAME; actions: raise=NAME, delay=MS, "
    "kill. Same plan + seed injects the identical failure sequence. "
    "The SRTPU_FAULTS env var installs the same grammar process-wide. "
    "None disables with zero overhead.", str)
RETRY_COVERAGE_ENABLED = _conf(
    "memory.retryCoverage.enabled", False,
    "Track, per engine call-site, whether device reservations happen "
    "inside an OOM-retry scope (with_retry / retry_no_split); the "
    "reservations outside it are the ones that die instead of "
    "spilling (reference: AllocationRetryCoverageTracker.scala). "
    "Report via memory.diagnostics.coverage_report().", bool)
LOCKDEP_ENABLED = _conf(
    "sql.debug.lockdep.enabled", False,
    "Runtime lockdep witness (runtime/lockdep.py): wrap engine locks, "
    "the TpuSemaphore permit and the exchange ride slot, record the "
    "acquisition-order graph, and report lock-order cycles at edge "
    "formation time plus bounded-pool self-waits. Locks created "
    "before the session exists are only covered when env "
    "SRTPU_LOCKDEP=1 was set before import.", bool)
LOCKDEP_RAISE = _conf(
    "sql.debug.lockdep.raiseOnCycle", True,
    "With lockdep enabled: raise LockOrderViolation / PoolSelfWait at "
    "the acquisition that forms the cycle. False records findings for "
    "the concurrency_report event without raising.", bool)
LEDGER_ENABLED = _conf(
    "sql.debug.ledger.enabled", False,
    "Runtime resource ledger (runtime/ledger.py): count every "
    "acquire / release of device and host reservations, staging "
    "leases, spill handles, semaphore permits and ride slots, "
    "attribute them to the submitting query, and assert the "
    "owner-scoped kinds balance when the query ends. Budget "
    "exhaustion errors attach an outstanding-holders dump, and every "
    "logged query emits a resource_ledger event.", bool)
LEDGER_RAISE = _conf(
    "sql.debug.ledger.raiseOnImbalance", True,
    "With the ledger enabled: raise ResourceLeakError when a query "
    "finishes cleanly with owner-scoped resources outstanding. False "
    "records findings for the resource_ledger event without raising; "
    "error-path imbalances are recorded, never raised over the "
    "original error.", bool)
LEDGER_POISON = _conf(
    "sql.debug.ledger.poison", False,
    "With the ledger enabled: fill released cached staging buffers "
    "with 0xAB before they return to the pool's free list, so a "
    "use-after-release reads deterministic garbage.", bool)
RACEDEP_ENABLED = _conf(
    "sql.debug.racedep.enabled", False,
    "Runtime data-race witness (runtime/racedep.py): Eraser-style "
    "lockset tracking on the instrumented shared structures (the "
    "telemetry registry, the operator metric store), reporting when "
    "a shared slot's candidate lockset collapses to empty. Locks "
    "created before the session exists are only lockset-visible when "
    "env SRTPU_RACEDEP=1 was set before import.", bool)
RACEDEP_RAISE = _conf(
    "sql.debug.racedep.raiseOnRace", True,
    "With racedep enabled: raise DataRaceDetected at the access that "
    "collapses a shared slot's lockset. False records findings for "
    "the race_report event without raising.", bool)


class TpuConf:
    """Snapshot of settings, resolved against the registry."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def get(self, entry: ConfEntry):
        return entry.get(self)

    def is_set(self, entry: ConfEntry) -> bool:
        """Whether the caller supplied this key (vs the registry
        default), so a policy can defer to an explicit setting."""
        return entry.key in self._settings

    @property
    def batch_size_rows(self) -> int:
        return self.get(BATCH_SIZE_ROWS)

    @property
    def concurrent_tasks(self) -> int:
        return self.get(CONCURRENT_TASKS)

    @property
    def explain(self) -> str:
        return str(self.get(EXPLAIN)).upper()

    @property
    def allow_cpu_fallback(self) -> bool:
        return self.get(ALLOW_CPU_FALLBACK)

    def set(self, key: str, value) -> "TpuConf":
        """A copy with one setting changed."""
        s = dict(self._settings)
        s[key] = value
        return TpuConf(s)
