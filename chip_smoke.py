"""Smoke run of the PyTorch port on one NVIDIA GPU (python3 chip_smoke.py).

Drives the port's main path through the entry points a user calls, at
TPC-H SF10 (60,012,150 lineitem rows in 1,048,576-row batches):

  1. the card, its power limit, and the torch / CUDA versions;
  2. builds every CUDA kernel from the sources in this checkout (one nvcc
     per source, all started together), with ptxas's registers and
     spills, and counts each kernel's SASS instructions per row
     (`cuobjdump -sass`);
  3. holds each kernel (the partition kernel's vector and scalar
     variants) against its plain PyTorch version on the card, bit for
     bit, and times them
     with CUDA events, L2 flushed clean, beside the bound (the least time
     the card could take: bytes over the memory rate or instructions over
     the issue rate, whichever is larger);
  4. Q6 over `create_dataframe` (every batch tensor must lie on CUDA);
  5. Q6 over `read.parquet` of the same table written as 16 files;
  6. the repartition path: `select(...).repartition(200, "l_shipdate")`
     and Q6 on top, with the kernel launch counts set to 0 just before
     and read just after (every launch must be the vector variant), and
     the pinned-host allocator's counters around the map side;
  7. the same query under torch.profiler: device busy share, device time
     by kernel, and the partition kernel's share of the map side's device
     time; then, on a 1M-row sample, every row of reduce partition p must
     hash to p by the plain version on the CPU;
  8. TPC-H Q1 (`tpch.q1(df).sort("l_returnflag", "l_linestatus")`) over
     `create_dataframe`, twice, and over the 16 Parquet files: the
     grouped hash aggregate, partial -> exchange on the two string keys
     -> final, then the sort;
  9. `group_by("l_shipdate").agg(sum(l_quantity), count(*))`: the
     partial states go through the exchange on a date key, so the
     partition kernel runs under an aggregation (every launch must be
     the vector variant), with the pinned-host counters around the map
     side;
 10. Q1 under torch.profiler: device busy share, device time by group
     (sort, scatter/index_add, gathers, elementwise, H2D, D2H, partition
     kernel), kernel launches and host syncs per input batch;
 11. TPC-H Q3 (`tpch.q3(customer, orders, lineitem)`) over
     `create_dataframe` of customer (1.5M rows), orders (15M) and the
     lineitem table, twice, at the default conf: both joins shuffled (two
     `HashJoinExec` per partition, each over two `ShuffleExchangeExec`,
     no broadcast), with the layers, the build paths each join's stream
     batches took, and 0 partition-kernel launches (every exchange key is
     int64); then the same query without its limit, whose every row is
     checked;
 12. Q3 with `sql.autoBroadcastJoinThreshold` at 4 GiB: both joins
     broadcast (two `BroadcastExchangeExec`);
 13. Q3 under torch.profiler: device busy share, device time by group
     (searchsorted, scatter, sort, gather, elementwise, H2D, D2H),
     launches and host syncs per input batch;
 14. a grouped double sum (`seg_sum`) of one fixed 2M-row input over
     100,000 segments, five times: the results must be bit-equal (and
     `index_add_`, the atomic sum it replaces, beside it for contrast);
 15. the earlier tables freed, `tpch.gen_all(10)` (seed 7): rows and
     generation seconds per table, then the exact numpy reference of
     each of Q2, Q4, Q5, Q7-Q22 (Q18 at the spec's 300), timed (int64
     unscaled decimals with an overflow guard, the generators' 0..n-1
     keys as indexes, each layout asserted; the double results of Q8,
     Q9, Q11, Q14, Q15 and Q17 summed in float64 from the same unscaled
     integers; Q13 and Q16 with the JAX package's LIKE; the rows within
     1e-9 of a double threshold counted for Q11, Q17 and Q22, and Q15's
     second-best revenue beside its best);
 16-34. each of those queries (`workloads/tpch_queries.py`) over
     `create_dataframe` of the eight tables at the default conf, twice,
     each a fresh plan: the plan shape (broadcast and per-partition
     joins, exchanges, aggregate modes), wall time, layers, each join's
     build paths, host syncs, peak device memory, and the partition
     kernel's launches, which must be more than 0, all of the vector
     variant, where the plan exchanges on one int32 key (Q8's year can)
     and 0 elsewhere (int64, string and tuple keys); the two runs of
     each query with a double sum (Q8, Q9, Q11, Q14, Q15, Q17, Q22) must
     be bit-equal;
 35. Q5, the longest join chain, and Q13 (LIKE over o_comment, a left
     join, two aggregates) under torch.profiler;
 36. a conditional hash join, orders (15M rows) with customer on the key
     and `o_totalprice > c_acctbal * 10`, checked against numpy;
 37. a nested-loop join, customer (1.5M rows) with nation (25) on
     `condition=c_nationkey == n_nationkey` alone (37.5M pairs in
     chunks of about 2^20), whose rows must equal the equi-join's and
     numpy's.

Each Q6 revenue must equal `q6_numpy_baseline`; each Q1 result the exact
integer reference `q1_reference` (numpy int64 per group, HALF_UP
averages), row for row; the per-date sums and counts numpy's; each Q3
result `q3_reference` (numpy int64 revenue per order): the unlimited
result row for row but for the order of rows tied on (revenue,
o_orderdate), the top 10 on those keys with ties allowed at the 10th
row; each of the nineteen later queries its reference row for row (Q5,
sorted by revenue alone, as a set with revenue not increasing), keys,
decimals and counts exact, a double within a relative 1e-9; the
conditional and nested-loop joins numpy's rows exactly. The
partition kernel's launches are counted on every path that runs it,
each path with the counts set to 0 just before it and read just after.
Each phase prints one JSON line; any failure raises and exits non-zero.
The line before the last is the kernels table; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when
CUDA is not available.
"""
from __future__ import annotations

import collections
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SF = 10.0
BATCH_ROWS = 1 << 20
REPARTITION_N = 200
PARTITION_CASES = (1, 7, 16, 200, 2**31 - 1)
KERNEL_SOURCES = ("partition_ids",)
SWEEP_ROWS = (BATCH_ROWS, 1 << 22, 1 << 24, 60_000_000)
TILE_EDGE_LENGTHS = (2, 3, 4, 5, 15, 16, 17, 4095, 4096, 4097, 4099,
                     4096 + 17, 8191, 8192, 8195)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SM_SLOTS_PER_CLOCK = 4 * 32    # thread-instructions an SM issues a clock


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def cuda_ms(fn, iters=50, warmup=10, flush=None):
    """Median milliseconds of fn() by CUDA events, each call timed alone;
    `flush` (run before each call, outside the events) evicts L2."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(fn, iters=200):
    """Milliseconds per call of `iters` calls issued back to back between
    one pair of events: L2 stays warm, and the host's launch cost shows
    wherever it exceeds the device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def partition_keys(n, seed, validity="mixed"):
    import numpy as np
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2**31, 2**31 - 1, n, endpoint=True).astype(np.int32)
    edge = np.array([-2**31, 2**31 - 1, 0, -1, 1, 42], np.int32)
    vals[:min(n, len(edge))] = edge[:n]
    valid = {"none_null": np.ones(n, bool), "all_null": np.zeros(n, bool),
             "mixed": rng.integers(0, 2, n).astype(bool)}[validity]
    return vals, valid


def l2_flush(torch, dev, dirty=False):
    """A call that evicts the 50 MB L2 before a timed call, over a 256 MB
    buffer: by default it sums the buffer and leaves L2 holding clean
    lines; `dirty` writes it instead and leaves 50 MB of dirty lines,
    whose writeback the timed call's own misses then pay for
    (partition_kernel_ab.py times both)."""
    scratch = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    return scratch.zero_ if dirty else scratch.sum


_PTXAS_PROPS = re.compile(r"Function properties for (\S+)")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """Per function in an `nvcc -Xptxas -v` log: registers, stack frame
    and spill bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_PROPS.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _PTXAS_FRAME.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


_SASS_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def sass_counts(text: str) -> dict:
    """Per function of a `cuobjdump -sass` listing: its instructions (no
    NOPs, not the branch-to-self after EXIT) and those of its largest
    loop (the widest backward branch; 0 when it has none)."""
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            pending = []
            continue
        if cur is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                cur[1][label] = addr
            pending = []
            cur[0].append((addr, m.group(2).strip()))
    out = {}
    for name, (ins, labels) in funcs.items():
        kept, loops = [], []
        for addr, op in ins:
            words = op.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            mnemonic = words[0] if words else ""
            if mnemonic == "NOP":
                continue
            target = None
            if mnemonic == "BRA":
                t = _SASS_TARGET.search(op)
                if t:
                    target = labels.get(t.group(1)) if t.group(1) \
                        else int(t.group(2), 16)
            if target == addr:
                continue
            kept.append(addr)
            if target is not None and target < addr:
                loops.append((target, addr))
        loop = max((sum(1 for a in kept if lo <= a <= hi)
                    for lo, hi in loops), default=0)
        out[name] = {"instructions": len(kept), "loop_instructions": loop}
    return out


def kernel_of(symbol: str):
    """'vector' or 'scalar' for a partition kernel's mangled name, else
    None."""
    for kind in ("vector", "scalar"):
        if f"partition_ids_i32_{kind}_kernel" in symbol:
            return kind
    return None


# rows a thread handles per pass of its straight-line code or loop body
ROWS_PER_PASS = {"vector": 4, "scalar": 1}


def instr_per_row(counts: dict) -> dict:
    """SASS instructions per row of each partition kernel: its loop body
    (scalar) or its whole body (vector, which has no loop) over the
    rows a thread handles in one pass of it. A static count: for the
    vector kernel it includes the code of the last 1-3 rows, which one
    thread runs, so it is an upper estimate of what a row costs."""
    out = {}
    for symbol, c in counts.items():
        kind = kernel_of(symbol)
        if kind:
            body = c["loop_instructions"] or c["instructions"]
            out[kind] = body / ROWS_PER_PASS[kind]
    return out


def sm_max_clock_hz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def partition_bound(rows: int, per_row_instr: float, sms: int,
                    clock_hz: float) -> dict:
    """The least time for `rows` rows: 9 B a row over the memory rate,
    or the instructions over the issue rate (4 warp schedulers of 32
    lanes per SM, at the SM's maximum clock), whichever is larger."""
    bytes_ms = rows * (4 + 1 + 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * per_row_instr / (sms * SM_SLOTS_PER_CLOCK * clock_hz) \
        * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_bound_ms": bytes_ms,
            "instr_bound_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def offset_copy(torch, t, k):
    """t's values in a fresh buffer, as a view starting k elements in."""
    buf = torch.empty(t.shape[0] + k, dtype=t.dtype, device=t.device)
    buf[k:].copy_(t)
    return buf[k:]


def check_partition_kernel(torch, pk, last_batch_rows):
    """Both partition kernels against the plain version on the card, bit
    for bit, through the wrapper, whose per-variant counts must move as
    the alignment rule says: the vector kernel on fresh tensors, the
    scalar kernel on views one row in; the lengths and key patterns below
    and the tile edges."""
    dev = torch.device("cuda")
    cases = dict.fromkeys(("vector", "scalar"), 0)
    max_err = dict.fromkeys(cases, 0)

    def hold(kind, got, ref, what):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
        max_err[kind] = max(max_err[kind], err)
        cases[kind] += 1
        if err:
            raise AssertionError(f"{kind} partition kernel differs from its "
                                 f"plain version: {what}")

    def through_wrapper(kind, vals, valid, parts):
        before = (pk.vector_launches, pk.scalar_launches)
        got = pk.partition_ids_i32(vals, valid, parts)
        moved = (pk.vector_launches - before[0],
                 pk.scalar_launches - before[1])
        if moved != ((1, 0) if kind == "vector" else (0, 1)):
            raise AssertionError(f"expected the {kind} kernel, counts "
                                 f"moved {moved}")
        return got

    lengths = (1, 1000, BATCH_ROWS, BATCH_ROWS + 3, last_batch_rows,
               60_000_000)
    for n in lengths:
        for validity in ("none_null", "all_null", "mixed"):
            vals, valid = partition_keys(n, seed=n % 1009,
                                         validity=validity)
            kv = torch.from_numpy(vals).to(dev)
            vv = torch.from_numpy(valid).to(dev)
            ko, vo = offset_copy(torch, kv, 1), offset_copy(torch, vv, 1)
            for parts in PARTITION_CASES:
                what = f"n={n} validity={validity} parts={parts}"
                ref = pk.partition_ids_i32_ref(kv, vv, parts)
                hold("vector", through_wrapper("vector", kv, vv, parts),
                     ref, what)
                hold("scalar", through_wrapper("scalar", ko, vo, parts),
                     ref, what)
            del kv, vv, ko, vo
    for n in TILE_EDGE_LENGTHS:
        vals, valid = partition_keys(n, seed=n)
        kv = torch.from_numpy(vals).to(dev)
        vv = torch.from_numpy(valid).to(dev)
        for parts in (REPARTITION_N, 2**31 - 1):
            ref = pk.partition_ids_i32_ref(kv, vv, parts)
            for k in (0, 1, 2, 3, 4):
                kind = "vector" if k in (0, 4) else "scalar"
                got = through_wrapper(kind, offset_copy(torch, kv, k),
                                      offset_copy(torch, vv, k), parts)
                hold(kind, got, ref, f"n={n} offset={k} parts={parts}")

    return {"cases": cases, "lengths": list(lengths),
            "tile_edge_lengths": list(TILE_EDGE_LENGTHS),
            "num_partitions": list(PARTITION_CASES), "max_abs_err": max_err}


def kernel_device_us(torch, fn, flush, name_part, iters=20):
    """Mean device duration in µs of the kernels whose name holds
    `name_part`, over `iters` calls each after a flush, as torch.profiler
    (CUPTI) records them: the kernel alone, without the cost of the
    events and the launch around it that `cuda_ms` includes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name_part in e.key]
    count = sum(e.count for e in hits)
    return sum(device_us(e) for e in hits) / count if count else None


def host_us_per_call(torch, fn, iters=500):
    """The host's own cost of a call: host clock over calls issued back
    to back without a synchronize (the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / iters * 1e6


def time_partition_kernels(torch, pk):
    """Each partition kernel at the main path's batch shape, L2 flushed
    clean before each call, in turns (so drift shows as a difference
    between a kind's two readings): CUDA-event ms, the kernel's own
    device time (CUPTI), back to back, and the host's cost per call;
    then the floor (the vector kernel on 4 rows: what any launch costs,
    by events and on the device) and the time at larger sizes, where the
    fixed cost no longer hides the memory rate."""
    dev = torch.device("cuda")
    flush = l2_flush(torch, dev)
    data = {}
    for rows in SWEEP_ROWS:
        vals, valid = partition_keys(rows, seed=5)
        kv = torch.from_numpy(vals).to(dev)
        vv = torch.from_numpy(valid).to(dev)
        data[rows] = (kv, vv, offset_copy(torch, kv, 1),
                      offset_copy(torch, vv, 1))

    def calls(rows):
        kv, vv, ko, vo = data[rows]
        return {
            "vector": lambda: pk.partition_ids_i32(kv, vv, REPARTITION_N),
            "scalar": lambda: pk.partition_ids_i32(ko, vo, REPARTITION_N)}
    batch = calls(BATCH_ROWS)
    timed = {kind: {"ms": [], "back_to_back_ms": []} for kind in batch}
    for kind in ("vector", "scalar", "scalar", "vector"):
        timed[kind]["ms"].append(cuda_ms(batch[kind], flush=flush))
        timed[kind]["back_to_back_ms"].append(back_to_back_ms(batch[kind]))
    for kind, fn in batch.items():
        timed[kind]["device_us"] = kernel_device_us(
            torch, fn, flush, f"partition_ids_i32_{kind}_kernel")
        timed[kind]["host_us_per_call"] = host_us_per_call(torch, fn)
        timed[kind]["ms_by_rows"] = {}
    for rows in SWEEP_ROWS:
        for kind, fn in calls(rows).items():
            timed[kind]["ms_by_rows"][str(rows)] = cuda_ms(
                fn, iters=20, flush=flush)
    kv, vv = data[BATCH_ROWS][:2]
    floor = (kv[:4].clone(), vv[:4].clone())

    def tiny():
        return pk.partition_ids_i32(*floor, REPARTITION_N)
    return {"timed": timed, "rows": BATCH_ROWS,
            "sweep_rows": list(SWEEP_ROWS),
            "floor_ms": cuda_ms(tiny, flush=flush),
            "floor_device_us": kernel_device_us(
                torch, tiny, flush, "partition_ids_i32_vector_kernel"),
            "plain_ms": cuda_ms(
                lambda: pk.partition_ids_i32_ref(kv, vv, REPARTITION_N),
                iters=20, flush=flush)}


def unscaled(at, name):
    from spark_rapids_tpu_torch.columnar.column import Column
    return Column.host_from_arrow(at.column(name))[2]["data"]


def revenue_unscaled(at_result) -> int:
    """Q6's decimal(27,4) revenue as its unscaled integer."""
    rev = at_result.column("revenue")[0].as_py()
    if rev is None:
        raise AssertionError("Q6 revenue is null")
    unscaled_rev = rev.scaleb(4)
    if unscaled_rev != unscaled_rev.to_integral_value():
        raise AssertionError(f"Q6 revenue {rev} is not at scale 4")
    return int(unscaled_rev)


class BatchDevices:
    """Counts the devices of every tensor of every DeviceBatch built."""

    def __init__(self, batch_cls):
        self.cls = batch_cls
        self.orig = batch_cls.__init__
        self.seen = collections.Counter()

    def __enter__(self):
        orig, seen = self.orig, self.seen

        def spy(batch, *a, **k):
            orig(batch, *a, **k)
            seen[batch.row_mask.device.type] += 1
            for c in batch.table.columns:
                seen[c.data.device.type] += 1
                seen[c.validity.device.type] += 1
        self.cls.__init__ = spy
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.orig


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def metric_totals(df) -> dict:
    """The last action's per-layer host seconds and counts, each summed
    over operators (DataFrame.last_metrics)."""
    out = {}
    for m in df.last_metrics().values():
        for k, v in m.items():
            out[k] = out.get(k, 0) + v
    return out


def timed_q6(df, tpch, device):
    """(result, wall seconds, layer metrics) of Q6 over `df`: planned
    afresh and run through `to_arrow`, ending in a device sync."""
    t0 = time.perf_counter()
    q = tpch.q6(df)
    out = q.to_arrow()
    sync(device)
    return out, time.perf_counter() - t0, metric_totals(q)


MAP_RANGE = "exchange.map_batch"
PINNED_KEYS = ("num_host_alloc", "num_host_free", "allocations.current",
               "allocated_bytes.current", "active_requests.allocated",
               "active_bytes.allocated", "host_alloc_time.total")
KERNEL_GROUPS = (("partition_kernel", r"partition_ids"),
                 ("argsort", r"[Ss]ort|[Rr]adix"),
                 ("bincount", r"[Hh]istogram|bincount"),
                 ("gather", r"[Ii]ndex|[Gg]ather"),
                 ("d2h", r"DtoH"), ("h2d", r"HtoD"))


class MapSideProbe:
    """Around ShuffleExchangeExec's map side: the pinned-host allocator's
    counters (torch.cuda.host_memory_stats) are read before and after the
    whole map side, and `host` gets their differences, one dict per
    exchange; with `ranged`, for a profiled run, each map batch also runs
    under a profiler range named MAP_RANGE."""

    def __init__(self, exchange_cls, ranged=False):
        self.cls = exchange_cls
        self.orig = (exchange_cls._map_batch, exchange_cls._ensure_shuffled)
        self.ranged = ranged
        self.host = []

    @staticmethod
    def _pinned():
        import torch
        if not torch.cuda.is_initialized():    # a rehearsal on the CPU
            return {}
        return torch.cuda.host_memory_stats()

    def __enter__(self):
        from torch.profiler import record_function
        map_batch, ensure = self.orig
        probe = self

        def ranged(exch, batch):
            with record_function(MAP_RANGE):
                return map_batch(exch, batch)

        def counted(exch, ctx):
            if exch._pieces is not None:
                return ensure(exch, ctx)
            before = probe._pinned()
            ensure(exch, ctx)
            after = probe._pinned()
            probe.host.append({k: after[k] - before[k] for k in PINNED_KEYS
                               if k in before and k in after})
        self.cls._ensure_shuffled = counted
        if self.ranged:
            self.cls._map_batch = ranged
        return self

    def __exit__(self, *exc):
        self.cls._map_batch, self.cls._ensure_shuffled = self.orig


def device_us(e):
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def kernels_under(evt):
    """The device kernels and copies launched inside a profiled CPU
    event, its children's included (not the range's own annotation)."""
    out = [k for k in evt.kernels if k.name != evt.name]
    for ch in evt.cpu_children:
        out += kernels_under(ch)
    return out


def group_of(name: str) -> str:
    for group, pattern in KERNEL_GROUPS:
        if re.search(pattern, name):
            return group
    return "other"


def profiled_q6(df, tpch, device):
    """Q6 over `df` under torch.profiler: the device's busy time (the
    device-side entries only, kernels and copies: a host op that launched
    them carries the same time again) and its share of the wall time,
    device time by kernel name and by group; where the plan has an
    exchange, the map side's device time (every kernel and copy launched
    inside a map batch) by group, and the partition kernel's share of
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with MapSideProbe(ShuffleExchangeExec, ranged=True) as probe, \
            profile(activities=acts) as prof:
        out, wall, layers = timed_q6(df, tpch, device)
    ka = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and device_us(e) > 0
          and e.key != MAP_RANGE]
    busy_us = sum(device_us(e) for e in ka)
    by_group = collections.Counter()
    for e in ka:
        by_group[group_of(e.key)] += device_us(e)
    ranges = [e for e in prof.events()
              if e.name == MAP_RANGE and e.device_type == DeviceType.CPU]
    map_group = collections.Counter()
    for r in ranges:
        for k in kernels_under(r):
            map_group[group_of(k.name)] += k.duration
    # the profiler links a kernel to the torch op that launched it, and a
    # ctypes launch is no torch op, so the partition kernel is not found
    # under the ranges; it runs on the map side only, so its whole time is
    map_group["partition_kernel"] = by_group["partition_kernel"]
    map_us = sum(map_group.values())
    top = sorted(ka, key=device_us, reverse=True)[:12]
    return out, {
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_entries": len(ka), "layers_s": layers,
        "device_us_by_group": dict(by_group),
        "top_device_us": {e.key[:80]: device_us(e) for e in top},
        "map_batches_profiled": len(ranges),
        "map_side_device_us": map_us,
        "map_side_device_us_by_group": dict(map_group),
        "partition_kernel_share_of_map_side":
            map_group["partition_kernel"] / map_us if map_us else None,
        "pinned_host_over_map_side": probe.host}


def check_revenue(out, expect, what):
    if revenue_unscaled(out) != expect:
        raise AssertionError(f"Q6 over {what}: revenue differs from "
                             f"q6_numpy_baseline")


def check_devices(devs, device):
    if set(devs.seen) != {device.type}:
        raise AssertionError(f"batch tensors off {device}: {devs.seen}")


def q6_runs(make_df, tpch, device, expect, what, runs=2):
    """Q6 `runs` times over fresh DataFrames from make_df: every revenue
    checked, every batch tensor on `device`."""
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    with BatchDevices(DeviceBatch) as devs:
        results = [timed_q6(make_df(), tpch, device) for _ in range(runs)]
    check_devices(devs, device)
    for out, _, _ in results:
        check_revenue(out, expect, what)
    return {"wall_s": [w for _, w, _ in results],
            "layers_s": [m for _, _, m in results],
            "batch_tensors_by_device": dict(devs.seen)}

# ----------------------------------------------------------------------
# Q1 and the grouped path
# ----------------------------------------------------------------------
Q1_KEYS = ("l_returnflag", "l_linestatus")
#: Q1's result columns and the scale of each one's unscaled integer
Q1_SCALES = {"sum_qty": 2, "sum_base_price": 2, "sum_disc_price": 4,
             "sum_charge": 6, "avg_qty": 6, "avg_price": 6, "avg_disc": 6,
             "count_order": 0}
Q1_GROUPS = (("sort", r"[Ss]ort|[Rr]adix"),
             ("partition_kernel", r"partition_ids"),
             ("scatter_index_add", r"[Ss]catter|indexFunc|index_add"),
             ("gather", r"[Ii]ndex|[Gg]ather"),
             ("scan", r"[Ss]can|cumsum|cummax"),
             ("reduce", r"[Rr]educe"),
             ("d2h", r"DtoH"), ("h2d", r"HtoD"),
             ("elementwise", r"[Ee]lementwise"))


def q1_group_of(name: str, groups=Q1_GROUPS) -> str:
    """The group (of Q1_GROUPS, or `groups`) of a device kernel or copy,
    by its name."""
    for group, pattern in groups:
        if re.search(pattern, name):
            return group
    return "other"


def _codes(arr):
    """(int32 code per row, the distinct values) of a string column."""
    import pyarrow as pa
    enc = arr.combine_chunks().dictionary_encode() \
        if isinstance(arr, pa.ChunkedArray) else arr.dictionary_encode()
    return enc.indices.to_numpy(), enc.dictionary.to_pylist()


def _half_up_div(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return q if num >= 0 else -q


def q1_reference(lineitem) -> dict:
    """Q1's exact result: {(returnflag, linestatus): {column: unscaled
    int}}. Sums and counts in numpy int64 per group (each group's bound
    is checked so a sum cannot wrap); the averages are the decimal(18, 6)
    HALF_UP quotients, in Python ints."""
    import numpy as np
    ship = lineitem.column("l_shipdate").to_numpy()
    m = ship <= 10471
    qty, price, disc, tax = (unscaled(lineitem, c)[m] for c in
                             ("l_quantity", "l_extendedprice",
                              "l_discount", "l_tax"))
    rf, rf_vals = _codes(lineitem.column("l_returnflag"))
    ls, ls_vals = _codes(lineitem.column("l_linestatus"))
    g = rf[m].astype(np.int64) * len(ls_vals) + ls[m]
    out = {}
    for gi in np.flatnonzero(np.bincount(g)):
        sel = g == gi
        n = int(sel.sum())
        q, p, d, t = qty[sel], price[sel], disc[sel], tax[sel]
        disc_price = p * (100 - d)                       # scale 4
        charge = disc_price * (100 + t)                  # scale 6
        if int(np.abs(charge).max()) * n >= 2**63:
            raise AssertionError("Q1 reference would overflow int64")
        sums = [int(x.sum()) for x in (q, p, disc_price, charge)]
        out[(rf_vals[gi // len(ls_vals)], ls_vals[gi % len(ls_vals)])] = {
            "sum_qty": sums[0], "sum_base_price": sums[1],
            "sum_disc_price": sums[2], "sum_charge": sums[3],
            "avg_qty": _half_up_div(sums[0] * 10**4, n),
            "avg_price": _half_up_div(sums[1] * 10**4, n),
            "avg_disc": _half_up_div(int(d.sum()) * 10**4, n),
            "count_order": n}
    return out


def q1_rows(at) -> list:
    """Q1's Arrow result as [((returnflag, linestatus), {column: unscaled
    int})], in its row order."""
    rows = []
    for r in at.to_pylist():
        vals = {}
        for c, scale in Q1_SCALES.items():
            v = r[c]
            if v is None:
                raise AssertionError(f"Q1 {c} is null")
            vals[c] = int(v.scaleb(scale)) if scale else int(v)
        rows.append(((r[Q1_KEYS[0]], r[Q1_KEYS[1]]), vals))
    return rows


def check_q1(at, expect: dict, what: str):
    """Row for row: the groups in key order, each equal to the exact
    reference."""
    rows = q1_rows(at)
    keys = [k for k, _ in rows]
    if keys != sorted(expect):
        raise AssertionError(f"Q1 over {what}: groups {keys}, expected "
                             f"{sorted(expect)}")
    for k, vals in rows:
        if vals != expect[k]:
            raise AssertionError(f"Q1 over {what}: group {k} is {vals}, "
                                 f"expected {expect[k]}")


def shipdate_reference(lineitem):
    """(dates, sum of l_quantity unscaled, count) per date, numpy."""
    import numpy as np
    ship = lineitem.column("l_shipdate").to_numpy().astype(np.int64)
    qty = unscaled(lineitem, "l_quantity")
    lo = int(ship.min())
    counts = np.bincount(ship - lo)
    if int(qty.max()) * int(counts.max()) >= 2**53:
        raise AssertionError("per-date sums would leave float64's exact "
                             "integers")
    sums = np.bincount(ship - lo, weights=qty).astype(np.int64)
    dates = np.flatnonzero(counts)
    return dates + lo, sums[dates], counts[dates]


def check_shipdate(at, expect, what: str):
    import numpy as np
    dates, sums, counts = expect
    order = np.argsort(at.column("l_shipdate").cast("int32").to_numpy())
    got_dates = at.column("l_shipdate").cast("int32").to_numpy()[order]
    words = unscaled(at, "q")
    got_sums = (words[:, 0] if words.ndim == 2 else words)[order]
    got_counts = at.column("c").to_numpy()[order]
    if not (np.array_equal(got_dates, dates)
            and np.array_equal(got_sums, sums)
            and np.array_equal(got_counts, counts)):
        raise AssertionError(f"group_by(l_shipdate) over {what} differs "
                             f"from numpy's per-date sums")


def grouped_shipdate(df):
    import spark_rapids_tpu_torch.functions as F
    return df.group_by("l_shipdate").agg(F.sum("l_quantity").alias("q"),
                                         F.count("*").alias("c"))


def sorted_q1(tpch, df):
    return tpch.q1(df).sort(*Q1_KEYS)


def timed_query(q, device):
    """(result, wall seconds, layer metrics, host syncs) of a fresh
    DataFrame through `to_arrow`, ending in a device sync."""
    from spark_rapids_tpu_torch.utils import transfer
    transfer.syncs = 0
    t0 = time.perf_counter()
    out = q.to_arrow()
    sync(device)
    return out, time.perf_counter() - t0, metric_totals(q), transfer.syncs


def plan_chain(q) -> list:
    """The physical plan of a DataFrame, root first, down the first
    children: each node's class (and an aggregate's mode)."""
    node, _ = q.physical_plan()
    out = []
    while node is not None:
        mode = getattr(node, "mode", None)
        out.append(type(node).__name__ + (f"[{mode}]" if mode else ""))
        node = node.children[0] if node.children else None
    return out


def profiled_query(q, device, batches: int, groups=Q1_GROUPS):
    """A query under torch.profiler: device busy time (kernels and copies
    only) and share of the wall time, device time by group (`groups`,
    Q1_GROUPS by default), device launches and host syncs per input
    batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out, wall, layers, syncs = timed_query(q, device)
    ka = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in ka)
    by_group, launches = collections.Counter(), collections.Counter()
    for e in ka:
        grp = q1_group_of(e.key, groups)
        by_group[grp] += device_us(e)
        launches[grp] += e.count
    top = sorted(ka, key=device_us, reverse=True)[:15]
    n = max(batches, 1)
    return out, {
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall, "layers_s": layers,
        "device_us_by_group": dict(by_group),
        "device_launches_by_group": dict(launches),
        "device_launches": sum(launches.values()),
        "input_batches": batches,
        "device_launches_per_batch": sum(launches.values()) / n,
        "host_syncs": syncs, "host_syncs_per_batch": syncs / n,
        "top_device_us": {e.key[:80]: device_us(e) for e in top}}


def q1_phases(session, lineitem, parquet_dir, q1_expect,
              shipdate_expect) -> dict:
    """Phases 8-10 on the session's device; returns the partition
    kernel's launches per grouped path."""
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.ops import partition_kernels as pk
    from spark_rapids_tpu_torch.workloads import tpch

    dev = session.device
    rows = lineitem.num_rows
    launches = {}

    def counted(make_q, check, what):
        with BatchDevices(DeviceBatch) as devs, \
                MapSideProbe(ShuffleExchangeExec) as probe:
            q = make_q()
            pk.launches = pk.vector_launches = pk.scalar_launches = 0
            out, wall, layers, syncs = timed_query(q, dev)
            got = {"all": pk.launches, "vector": pk.vector_launches,
                   "scalar": pk.scalar_launches}
        check(out, what)
        check_devices(devs, dev)
        batches = int(layers.get("inputBatches", 0))
        return {"wall_s": wall, "rows_per_s": rows / wall,
                "layers_s": layers, "input_batches": batches,
                "host_syncs": syncs,
                "host_syncs_per_batch": syncs / max(batches, 1),
                "partition_kernel_launches": got,
                "pinned_host_over_map_side": probe.host,
                "batch_tensors_by_device": dict(devs.seen)}, got

    def q1_check(out, what):
        check_q1(out, q1_expect, what)

    # ---- Q1 over create_dataframe, twice ------------------------------
    runs = []
    for _ in range(2):
        res, got = counted(
            lambda: sorted_q1(tpch, session.create_dataframe(lineitem)),
            q1_check, "create_dataframe")
        runs.append(res)
    launches["q1_create_dataframe"] = got
    emit({"phase": "q1_create_dataframe", "rows": rows,
          "plan": plan_chain(sorted_q1(tpch,
                                       session.create_dataframe(lineitem))),
          "runs": runs})

    # ---- Q1 over the 16 Parquet files --------------------------------
    res, got = counted(lambda: sorted_q1(tpch,
                                         session.read.parquet(parquet_dir)),
                       q1_check, "read.parquet")
    launches["q1_read_parquet"] = got
    emit({"phase": "q1_read_parquet", "rows": rows, "files": 16,
          "plan": plan_chain(sorted_q1(tpch,
                                       session.read.parquet(parquet_dir))),
          **res})

    # ---- group_by(l_shipdate): the kernel under an aggregation -------
    res, got = counted(
        lambda: grouped_shipdate(session.create_dataframe(lineitem)),
        lambda out, what: check_shipdate(out, shipdate_expect, what),
        "create_dataframe")
    map_batches = int(res["layers_s"].get("mapBatches", 0))
    want = map_batches if dev.type == "cuda" else 0
    if map_batches == 0 or got != {"all": want, "vector": want,
                                   "scalar": 0}:
        raise AssertionError(f"grouped path: partition kernel launches "
                             f"{got}, map batches {map_batches}: every "
                             f"launch must be the vector kernel")
    launches["groupby_shipdate"] = got
    emit({"phase": "groupby_shipdate", "rows": rows,
          "groups": len(shipdate_expect[0]), "map_batches": map_batches,
          "plan": plan_chain(grouped_shipdate(
              session.create_dataframe(lineitem))), **res})

    # ---- Q1 profiled --------------------------------------------------
    q = sorted_q1(tpch, session.create_dataframe(lineitem))
    batches = -(-rows // session.conf.batch_size_rows)
    out, prof = profiled_query(q, dev, batches)
    check_q1(out, q1_expect, "create_dataframe (profiled)")
    emit({"phase": "q1_profiled", **prof})
    return launches


def path_phases(session, lineitem, expect, q1_expect=None,
                shipdate_expect=None) -> dict:
    """Phases 4-10 on the session's device (8-10 when the Q1 and per-date
    references are given); returns the partition kernel's launches per
    path, in all and per variant. On a CPU session (a rehearsal without a
    card) the plain version runs and the kernel never launches."""
    import shutil

    d = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _path_phases(session, lineitem, expect, q1_expect,
                            shipdate_expect, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _path_phases(session, lineitem, expect, q1_expect, shipdate_expect,
                 d) -> dict:
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.ops import partition_kernels as pk
    from spark_rapids_tpu_torch.workloads import tpch

    dev = session.device
    rows = lineitem.num_rows
    # warm-up at a small size: CUDA context, allocator, pinned pool
    tpch.q6(session.create_dataframe(lineitem.slice(0, 100_000))).to_arrow()

    # ---- Q6 over create_dataframe ------------------------------------
    res = q6_runs(lambda: session.create_dataframe(lineitem), tpch, dev,
                  expect, "create_dataframe")
    emit({"phase": "q6_create_dataframe", "rows": rows, **res,
          "rows_per_s": [rows / w for w in res["wall_s"]]})
    out, prof = profiled_q6(session.create_dataframe(lineitem), tpch, dev)
    check_revenue(out, expect, "create_dataframe (profiled)")
    emit({"phase": "q6_create_dataframe_profiled", **prof})

    # ---- Q6 over read.parquet (16 files) -----------------------------
    t0 = time.perf_counter()
    per = -(-rows // 16)
    for i in range(16):
        pq.write_table(lineitem.slice(i * per, per),
                       os.path.join(d, f"part-{i:02d}.parquet"))
    write_s = time.perf_counter() - t0
    root, ctx = tpch.q6(session.read.parquet(d)).physical_plan()
    scan = root
    while scan.children:
        scan = scan.children[0]
    res = q6_runs(lambda: session.read.parquet(d), tpch, dev,
                  expect, "read.parquet")
    emit({"phase": "q6_read_parquet", "rows": rows, "files": 16,
          "reader": scan._reader_type(ctx), "write_s": write_s, **res,
          "rows_per_s": [rows / w for w in res["wall_s"]]})

    # ---- the repartition path: the kernel's main path ----------------
    cols = list(tpch.Q6_COLUMNS) + ["l_orderkey"]

    def repartitioned():
        return session.create_dataframe(lineitem).select(*cols) \
            .repartition(REPARTITION_N, "l_shipdate")
    with BatchDevices(DeviceBatch) as devs, \
            MapSideProbe(ShuffleExchangeExec) as probe:
        pk.launches = pk.vector_launches = pk.scalar_launches = 0
        out, wall, layers = timed_q6(repartitioned(), tpch, dev)
        launches = {"all": pk.launches, "vector": pk.vector_launches,
                    "scalar": pk.scalar_launches}
    check_revenue(out, expect, "repartition")
    check_devices(devs, dev)
    map_batches = int(layers.get("mapBatches", 0))
    want = map_batches if dev.type == "cuda" else 0
    if map_batches == 0 or launches != {"all": want, "vector": want,
                                        "scalar": 0}:
        raise AssertionError(f"partition kernel launches {launches}, "
                             f"map batches {map_batches}: every launch "
                             f"of the path must be the vector kernel")
    emit({"phase": "q6_over_repartition", "rows": rows,
          "num_partitions": REPARTITION_N, "wall_s": wall,
          "rows_per_s": rows / wall, "layers_s": layers,
          "map_batches": map_batches, "partition_kernel_launches": launches,
          "pinned_host_over_map_side": probe.host,
          "batch_tensors_by_device": dict(devs.seen)})

    out, prof = profiled_q6(repartitioned(), tpch, dev)
    check_revenue(out, expect, "repartition (profiled)")
    emit({"phase": "q6_over_repartition_profiled", **prof})

    # every row of reduce partition p hashes to p (plain version, CPU)
    sample = session.create_dataframe(lineitem.slice(0, BATCH_ROWS)) \
        .select("l_shipdate").repartition(REPARTITION_N, "l_shipdate")
    sroot, sctx = sample.physical_plan()
    seen = 0
    for p in range(sroot.num_partitions(sctx)):
        for b in sroot.execute_partition(sctx, p):
            c = b.table.columns[0]
            ids = pk.partition_ids_i32_ref(c.data.cpu(), c.validity.cpu(),
                                           REPARTITION_N)
            if not bool((ids == p).all()):
                raise AssertionError(f"reduce partition {p} holds rows of "
                                     f"another partition")
            seen += b.num_rows
    if seen != min(BATCH_ROWS, rows):
        raise AssertionError(f"sample lost rows: {seen}")
    emit({"phase": "repartition_placement", "rows": seen,
          "num_partitions": REPARTITION_N, "ok": True})
    by_path = {"q6_over_repartition": launches}
    if q1_expect is not None:
        by_path.update(q1_phases(session, lineitem, d, q1_expect,
                                 shipdate_expect))
    return by_path


# ----------------------------------------------------------------------
# Q3: the joins
# ----------------------------------------------------------------------
Q3_COLUMNS = ("l_orderkey", "o_orderdate", "o_shippriority", "revenue")
Q3_LIMIT = 10
Q3_BROADCAST_THRESHOLD = 4 << 30
Q3_GROUPS = (("searchsorted", r"searchsorted"),) + Q1_GROUPS
Q3_LAYERS = ("scanTime", "mapTime", "sliceTime", "reduceTime", "buildTime",
             "probeTime", "expandTime", "hashPassTime", "sortPassTime",
             "mergeTime", "sortTime", "limitTime", "collectTime")
JOIN_PATHS = ("streamBatches", "directProbeBatches", "promotedToSorted",
              "sortedProbeBatches", "countProbeBatches", "fkOutputBatches",
              "expandOutputBatches", "numOutputRows")


def q3_tables(sf, lineitem=None):
    """(customer, orders, lineitem) at `sf`, each from its generator's
    default seed (lineitem: seed 0, the table of the earlier phases)."""
    from spark_rapids_tpu_torch.workloads import tpch
    if lineitem is None:
        lineitem = tpch.gen_lineitem(sf, seed=0)
    return tpch.gen_customer(sf), tpch.gen_orders(sf), lineitem


def q3_reference(customer, orders, lineitem):
    """Q3's whole result before its limit, exactly: int64 arrays
    (l_orderkey, o_orderdate, o_shippriority, revenue unscaled at scale
    4), sorted by revenue descending, o_orderdate, then l_orderkey."""
    import numpy as np
    import pyarrow.compute as pc
    seg = pc.equal(customer.column("c_mktsegment"), "BUILDING")
    cust = customer.column("c_custkey").to_numpy()[
        seg.to_numpy(zero_copy_only=False)]
    okey = orders.column("o_orderkey").to_numpy()
    odate = orders.column("o_orderdate").to_numpy().astype(np.int64)
    oprio = orders.column("o_shippriority").to_numpy().astype(np.int64)
    om = (odate < 9204) & np.isin(orders.column("o_custkey").to_numpy(),
                                  cust, kind="table")
    o_sorted = np.argsort(okey[om], kind="stable")
    okey, odate, oprio = okey[om][o_sorted], odate[om][o_sorted], \
        oprio[om][o_sorted]
    lkey = lineitem.column("l_orderkey").to_numpy()
    lm = (lineitem.column("l_shipdate").to_numpy() > 9204) & \
        np.isin(lkey, okey, kind="table")
    rev = unscaled(lineitem, "l_extendedprice")[lm] * \
        (100 - unscaled(lineitem, "l_discount")[lm])
    lk = lkey[lm]
    order = np.argsort(lk, kind="stable")
    lk, rev = lk[order], rev[order]
    if int(np.abs(rev).max(initial=0)) * len(rev) >= 2**63:
        raise AssertionError("Q3 reference would overflow int64")
    starts = np.flatnonzero(np.r_[True, lk[1:] != lk[:-1]]) if len(lk) \
        else np.zeros(0, np.int64)
    keys = lk[starts]
    sums = np.add.reduceat(rev, starts) if len(lk) else rev
    # each order key is once in orders: its date and priority
    at = np.searchsorted(okey, keys)
    date, prio = odate[at], oprio[at]
    order = np.lexsort((keys, date, -sums))
    return keys[order], date[order], prio[order], sums[order]


def q3_rows(at) -> list:
    """Q3's Arrow result as [(l_orderkey, o_orderdate, o_shippriority,
    revenue unscaled)], in its row order."""
    rows = []
    for r in at.to_pylist():
        if any(r[c] is None for c in Q3_COLUMNS):
            raise AssertionError(f"Q3 row with a null: {r}")
        rows.append((r["l_orderkey"], r["o_orderdate"], r["o_shippriority"],
                     int(r["revenue"].scaleb(4))))
    return rows


def _ref_rows(expect) -> list:
    return [tuple(int(x) for x in t) for t in zip(*expect)]


def _ordered(rows, what):
    """The rows must run by revenue descending, then o_orderdate."""
    keys = [(-r[3], r[1]) for r in rows]
    if keys != sorted(keys):
        raise AssertionError(f"Q3 over {what}: rows out of (revenue DESC, "
                             f"o_orderdate) order")


def check_q3_full(at, expect, what: str):
    """The unlimited result: every row of the reference once, in the
    query's order (rows tied on both sort keys in any order)."""
    rows = q3_rows(at)
    _ordered(rows, what)
    ref = _ref_rows(expect)
    got = sorted(rows, key=lambda r: (-r[3], r[1], r[0]))
    if got != ref:
        raise AssertionError(f"Q3 over {what}: {len(rows)} rows differ from "
                             f"the reference's {len(ref)}")


def check_q3_top(at, expect, what: str, n: int = Q3_LIMIT):
    """The limited result: the reference's first n sort keys, each row a
    reference row (a tie at the n-th row may pick any of the tied)."""
    rows = q3_rows(at)
    ref = _ref_rows(expect)
    _ordered(rows, what)
    if [(r[3], r[1]) for r in rows] != [(r[3], r[1]) for r in ref[:n]]:
        raise AssertionError(f"Q3 over {what}: top {n} keys differ from the "
                             f"reference's")
    if len(set(rows)) != len(rows) or not set(rows) <= set(ref):
        raise AssertionError(f"Q3 over {what}: rows not in the reference")


def plan_nodes(root) -> list:
    """Every node of a physical plan, depth first."""
    out, stack = [], [root]
    while stack:
        node = stack.pop()
        out.append(node)
        stack.extend(reversed(node.children))
    return out


def q3_plan_shape(root) -> dict:
    """The join topology of a Q3 plan: each HashJoinExec's mode and its
    children's classes, and the count of broadcast exchanges."""
    joins = [{"per_partition": j.per_partition,
              "children": [type(c).__name__ for c in j.children]}
             for j in plan_nodes(root) if type(j).__name__ == "HashJoinExec"]
    n_bcast = sum(type(x).__name__ == "BroadcastExchangeExec"
                  for x in plan_nodes(root))
    return {"joins": joins, "broadcast_exchanges": n_bcast}


def check_q3_plan(root, shuffled: bool):
    shape = q3_plan_shape(root)
    if shuffled:
        want = {"joins": [{"per_partition": True,
                           "children": ["ShuffleExchangeExec"] * 2}] * 2,
                "broadcast_exchanges": 0}
    else:
        want = {"joins": [{"per_partition": False,
                           "children": [None, "BroadcastExchangeExec"]}] * 2,
                "broadcast_exchanges": 2}
        for j in shape["joins"]:
            j["children"][0] = None
    if shape != want:
        raise AssertionError(f"Q3 plan {q3_plan_shape(root)}, expected "
                             f"{'shuffled' if shuffled else 'broadcast'} "
                             f"joins")
    return q3_plan_shape(root)


def per_node_metrics(q) -> dict:
    """The last action's metrics per plan node, named by class and its
    place in a depth-first walk (joins and exchanges apart)."""
    mets = q.last_metrics()
    out, seen = {}, collections.Counter()
    for node in plan_nodes(q.last_plan()):
        name = type(node).__name__
        seen[name] += 1
        m = mets.get(node._op_id)
        if m:
            out[f"{name}#{seen[name]}"] = m
    return out


def q3_query(tpch, session, tables, limit=True):
    c, o, li = (session.create_dataframe(t) for t in tables)
    q = tpch.q3(c, o, li)
    if not limit:
        from spark_rapids_tpu_torch.session import DataFrame
        q = DataFrame(q._session, q._plan.child)
    return q


def q3_phases(session, tables, expect, profile=True) -> dict:
    """Phases 11-13 on the session's device: Q3 at the session's conf
    (whose joins must be shuffled: at SF10 the defaults, in a rehearsal a
    threshold of -1), then with the broadcast threshold at 4 GiB, then
    profiled. Returns the partition kernel's launches per path."""
    from spark_rapids_tpu_torch import TpuSession
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.ops import partition_kernels as pk
    from spark_rapids_tpu_torch.workloads import tpch

    dev = session.device
    per = session.conf.batch_size_rows
    batches = sum(-(-t.num_rows // per) for t in tables)
    launches = {}

    def counted(sess, check, what, shuffled, limit=True):
        with BatchDevices(DeviceBatch) as devs, \
                MapSideProbe(ShuffleExchangeExec) as probe:
            q = q3_query(tpch, sess, tables, limit)
            pk.launches = pk.vector_launches = pk.scalar_launches = 0
            out, wall, layers, syncs = timed_query(q, dev)
            got = {"all": pk.launches, "vector": pk.vector_launches,
                   "scalar": pk.scalar_launches}
        check(out, expect, what)
        check_devices(devs, dev)
        shape = check_q3_plan(q.last_plan(), shuffled)
        if got["all"]:
            raise AssertionError(f"Q3 over {what}: partition kernel "
                                 f"launched {got}; every key is int64")
        nodes = per_node_metrics(q)
        return {"wall_s": wall, "rows": out.num_rows,
                "layers_s": {k: layers[k] for k in Q3_LAYERS if k in layers},
                "by_node": nodes,
                "join_paths": {k: {p: v.get(p, 0) for p in JOIN_PATHS}
                               for k, v in nodes.items()
                               if k.startswith("HashJoinExec")},
                "input_batches": batches, "host_syncs": syncs,
                "host_syncs_per_batch": syncs / max(batches, 1),
                "partition_kernel_launches": got, "plan": shape,
                "pinned_host_over_map_side": probe.host,
                "batch_tensors_by_device": dict(devs.seen)}, got

    runs = []
    for _ in range(2):
        res, got = counted(session, check_q3_top, "default conf", True)
        runs.append(res)
    launches["q3_shuffled"] = got
    full, got = counted(session, check_q3_full, "default conf, no limit",
                        True, limit=False)
    launches["q3_shuffled_no_limit"] = got
    emit({"phase": "q3_shuffled", "rows": [t.num_rows for t in tables],
          "runs": runs, "no_limit": full})

    bsess = TpuSession(dict(session.conf._settings, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
            Q3_BROADCAST_THRESHOLD}), device=dev)
    res, got = counted(bsess, check_q3_top, "broadcast threshold 4 GiB",
                       False)
    launches["q3_broadcast"] = got
    emit({"phase": "q3_broadcast", **res})

    if profile:
        out, prof = profiled_query(q3_query(tpch, session, tables), dev,
                                   batches, Q3_GROUPS)
        check_q3_top(out, expect, "default conf (profiled)")
        emit({"phase": "q3_profiled", **prof})
    return launches


# ----------------------------------------------------------------------
# The TPC-H queries of workloads/tpch_queries.py over gen_all's tables
# ----------------------------------------------------------------------
TPCH_QUERIES = (2, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
                19, 20, 21, 22)
#: Q18's quantity threshold (the spec's)
TPCH_Q18_QTY = 300
TPCH_SEED = 7     # gen_all's default seed
#: each query's result columns
TPCH_COLUMNS = {
    4: ("o_orderpriority", "order_count"),
    5: ("n_name", "revenue"),
    7: ("supp_nation", "cust_nation", "l_year", "revenue"),
    10: ("c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
         "c_address", "revenue"),
    12: ("l_shipmode", "high_line_count", "low_line_count"),
    18: ("c_name", "c_custkey", "o_orderkey", "o_orderdate",
         "o_totalprice", "sum_qty"),
    19: ("revenue",),
    2: ("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
        "s_address", "s_phone", "s_comment"),
    8: ("o_year", "mkt_share"),
    9: ("n_name", "o_year", "sum_profit"),
    13: ("c_count", "custdist"),
    14: ("promo_revenue",),
    17: ("avg_yearly",),
    20: ("s_name", "s_address"),
    11: ("ps_partkey", "part_value"),
    15: ("s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"),
    16: ("p_brand", "p_type", "p_size", "supplier_cnt"),
    21: ("s_name", "numwait"),
    22: ("cntrycode", "numcust", "totacctbal")}
#: the double columns of each query; the reference sums the same doubles
#: (each from the same unscaled integers) in another order, so these
#: agree within TPCH_RTOL; every other column is exact
TPCH_FLOAT_COLUMNS = {8: ("mkt_share",), 9: ("sum_profit",),
                      11: ("part_value",), 14: ("promo_revenue",),
                      15: ("total_revenue",), 17: ("avg_yearly",)}
#: the queries whose result holds or depends on a double sum: their two
#: runs on the card must be bit-equal
TPCH_DOUBLE_QUERIES = (8, 9, 11, 14, 15, 17, 22)
TPCH_RTOL = 1e-9


def _col(at, name):
    return at.column(name).to_numpy()


def _arange_keys(at, name) -> int:
    """The generators' key layout: `name` is 0..n-1 in row order, so a
    join on it is an index. Returns n."""
    import numpy as np
    keys = _col(at, name)
    if not np.array_equal(keys, np.arange(len(keys))):
        raise AssertionError(f"{name} is not 0..n-1: a reference that "
                             f"indexes by it would be wrong")
    return len(keys)


def _in_range(keys, n, what):
    if len(keys) and (int(keys.min()) < 0 or int(keys.max()) >= n):
        raise AssertionError(f"{what} out of 0..{n - 1}")


def _isin(at, name, values):
    import pyarrow as pa
    import pyarrow.compute as pc
    return pc.is_in(at.column(name), value_set=pa.array(values)).to_numpy(
        zero_copy_only=False)


def _strs(at, name, idx) -> list:
    import pyarrow as pa
    return at.column(name).take(pa.array(idx, pa.int64())).to_pylist()


def _group_sum(codes, vals, n):
    """Exact int64 sums of vals per code in 0..n-1 (np.add.at), refused
    where an int64 could overflow."""
    import numpy as np
    if len(vals) and int(np.abs(vals).max()) * len(vals) >= 2**63:
        raise AssertionError("reference sum would overflow int64")
    out = np.zeros(n, np.int64)
    np.add.at(out, codes, vals)
    return out


def _revenue(li, m):
    """l_extendedprice * (1 - l_discount) of the rows m, unscaled at
    scale 4."""
    return unscaled(li, "l_extendedprice")[m] * \
        (100 - unscaled(li, "l_discount")[m])


def _cust_nation_of_orders(t):
    """c_nationkey of each order's customer (o_orderkey and c_custkey are
    0..n-1; every o_custkey names a customer)."""
    o, c = t["orders"], t["customer"]
    nc = _arange_keys(c, "c_custkey")
    ock = _col(o, "o_custkey")
    _in_range(ock, nc, "o_custkey")
    return _col(c, "c_nationkey")[ock]


def _lineitem_orders(t):
    """(l_orderkey with 0 where it names no order, the rows whose key
    names one): the generator draws l_orderkey below lineitem rows / 4,
    a little above the orders' count, and an inner join drops the rest."""
    import numpy as np
    no = _arange_keys(t["orders"], "o_orderkey")
    lok = _col(t["lineitem"], "l_orderkey")
    ok = (lok >= 0) & (lok < no)
    return np.where(ok, lok, 0), ok


def q4_reference(t, d0="1993-07-01", d1="1993-10-01") -> list:
    import numpy as np
    from spark_rapids_tpu_torch.workloads.tpch import day
    o, li = t["orders"], t["lineitem"]
    lok, ok = _lineitem_orders(t)
    late = np.zeros(o.num_rows, bool)
    late[lok[ok & (_col(li, "l_commitdate")
                   < _col(li, "l_receiptdate"))]] = True
    d = _col(o, "o_orderdate")
    m = (d >= day(d0)) & (d < day(d1)) & late
    codes, vocab = _codes(o.column("o_orderpriority"))
    cnt = np.bincount(codes[m], minlength=len(vocab))
    return sorted((vocab[i], int(n)) for i, n in enumerate(cnt) if n)


def q5_reference(t, region="ASIA", d0="1994-01-01",
                 d1="1995-01-01") -> list:
    """Rows (n_name, revenue) by revenue descending (ties by name: the
    query leaves their order open)."""
    import numpy as np
    from spark_rapids_tpu_torch.workloads.tpch import day
    o, li, s, nat, reg = (t[k] for k in ("orders", "lineitem", "supplier",
                                          "nation", "region"))
    lok, ok = _lineitem_orders(t)
    ns = _arange_keys(s, "s_suppkey")
    nn = _arange_keys(nat, "n_nationkey")
    _arange_keys(reg, "r_regionkey")
    o_cnk = _cust_nation_of_orders(t)
    d = _col(o, "o_orderdate")
    om = (d >= day(d0)) & (d < day(d1))
    lsk = _col(li, "l_suppkey")
    _in_range(lsk, ns, "l_suppkey")
    cnk = o_cnk[lok]
    r_names = reg.column("r_name").to_pylist()
    in_region = np.array([r_names[r] == region
                          for r in _col(nat, "n_regionkey")])
    m = ok & om[lok] & (_col(s, "s_nationkey")[lsk] == cnk)
    _in_range(cnk[m], nn, "c_nationkey")
    m &= in_region[cnk]
    nk = cnk[m]
    sums = _group_sum(nk, _revenue(li, m), nn)
    names = nat.column("n_name").to_pylist()
    rows = [(names[k], int(sums[k])) for k in np.unique(nk)]
    return sorted(rows, key=lambda r: (-r[1], r[0]))


def q7_reference(t, n1="FRANCE", n2="GERMANY") -> list:
    import numpy as np
    from spark_rapids_tpu_torch.workloads.tpch import day
    li, s, nat = t["lineitem"], t["supplier"], t["nation"]
    lok, ok = _lineitem_orders(t)
    ns = _arange_keys(s, "s_suppkey")
    nn = _arange_keys(nat, "n_nationkey")
    names = nat.column("n_name").to_pylist()
    f, g = names.index(n1), names.index(n2)
    lsk = _col(li, "l_suppkey")
    _in_range(lsk, ns, "l_suppkey")
    snk = _col(s, "s_nationkey")[lsk]
    cnk = _cust_nation_of_orders(t)[lok]
    sd = _col(li, "l_shipdate")
    m = (ok & (sd >= day("1995-01-01")) & (sd <= day("1996-12-31"))
         & (((snk == f) & (cnk == g)) | ((snk == g) & (cnk == f))))
    year = np.where(sd[m] <= day("1995-12-31"), 1995, 1996)
    key = (snk[m] * nn + cnk[m]) * 2 + (year - 1995)
    sums = _group_sum(key, _revenue(li, m), nn * nn * 2)
    rows = [(names[k // 2 // nn], names[k // 2 % nn], 1995 + k % 2,
             int(sums[k])) for k in np.unique(key)]
    return sorted(rows)


def q10_reference(t, d0="1993-10-01", d1="1994-01-01") -> list:
    import numpy as np
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.workloads.tpch import day
    c, o, li, nat = t["customer"], t["orders"], t["lineitem"], t["nation"]
    lok, ok = _lineitem_orders(t)
    nc = _arange_keys(c, "c_custkey")
    nn = _arange_keys(nat, "n_nationkey")
    d = _col(o, "o_orderdate")
    om = (d >= day(d0)) & (d < day(d1))
    m = ok & om[lok] & pc.equal(li.column("l_returnflag"), "R").to_numpy(
        zero_copy_only=False)
    ock = _col(o, "o_custkey")
    _in_range(ock, nc, "o_custkey")
    ck = ock[lok[m]]
    sums = _group_sum(ck, _revenue(li, m), nc)
    keys = np.unique(ck)
    top = keys[np.lexsort((keys, -sums[keys]))][:20]
    cnk = _col(c, "c_nationkey")[top]
    _in_range(cnk, nn, "c_nationkey")
    cols = [top.tolist(), _strs(c, "c_name", top),
            unscaled(c, "c_acctbal")[top].tolist(),
            _strs(c, "c_phone", top), _strs(nat, "n_name", cnk),
            _strs(c, "c_address", top), sums[top].tolist()]
    return [tuple(r) for r in zip(*cols)]


def q12_reference(t, m1="MAIL", m2="SHIP", d0="1994-01-01",
                  d1="1995-01-01") -> list:
    import numpy as np
    from spark_rapids_tpu_torch.workloads.tpch import day
    o, li = t["orders"], t["lineitem"]
    lok, ok = _lineitem_orders(t)
    cd, rd = _col(li, "l_commitdate"), _col(li, "l_receiptdate")
    m = (ok & _isin(li, "l_shipmode", [m1, m2]) & (cd < rd)
         & (_col(li, "l_shipdate") < cd) & (rd >= day(d0)) & (rd < day(d1)))
    high = _isin(o, "o_orderpriority", ["1-URGENT", "2-HIGH"])[lok[m]]
    codes, vocab = _codes(li.column("l_shipmode"))
    codes = codes[m]
    hi = np.bincount(codes[high], minlength=len(vocab))
    lo = np.bincount(codes[~high], minlength=len(vocab))
    return sorted((vocab[i], int(hi[i]), int(lo[i]))
                  for i in range(len(vocab)) if hi[i] + lo[i])


def q18_reference(t, qty=TPCH_Q18_QTY, limit=100) -> list:
    """The orders whose lines sum past qty, by o_totalprice descending,
    o_orderdate, o_orderkey; the first `limit` (None: all)."""
    import numpy as np
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    lok, ok = _lineitem_orders(t)
    nc = _arange_keys(c, "c_custkey")
    # the sums over every l_orderkey; the semi join keeps the orders'
    sums = _group_sum(lok[ok], unscaled(li, "l_quantity")[ok], o.num_rows)
    big = np.flatnonzero(sums > qty * 100)
    ock = _col(o, "o_custkey")[big]
    _in_range(ock, nc, "o_custkey")
    price = unscaled(o, "o_totalprice")[big]
    date = _col(o, "o_orderdate")[big].astype(np.int64)
    top = np.lexsort((big, date, -price))[:limit]
    cols = [_strs(c, "c_name", ock[top]), ock[top].tolist(),
            big[top].tolist(), date[top].tolist(), price[top].tolist(),
            sums[big[top]].tolist()]
    return [tuple(r) for r in zip(*cols)]


Q19_BRANCHES = (("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
                 1, 11, 5),
                ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
                 10, 20, 10),
                ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
                 20, 30, 15))


def q19_reference(t) -> list:
    import numpy as np
    import pyarrow.compute as pc
    li, p = t["lineitem"], t["part"]
    npart = _arange_keys(p, "p_partkey")
    m = _isin(li, "l_shipmode", ["AIR", "REG AIR"]) & pc.equal(
        li.column("l_shipinstruct"), "DELIVER IN PERSON").to_numpy(
            zero_copy_only=False)
    pk = _col(li, "l_partkey")[m]
    _in_range(pk, npart, "l_partkey")
    q = unscaled(li, "l_quantity")[m]
    size = _col(p, "p_size")[pk]
    hit = np.zeros(len(pk), bool)
    for brand, containers, qlo, qhi, szhi in Q19_BRANCHES:
        part_ok = pc.equal(p.column("p_brand"), brand).to_numpy(
            zero_copy_only=False) & _isin(p, "p_container", list(containers))
        hit |= (part_ok[pk] & (q >= qlo * 100) & (q <= qhi * 100)
                & (size >= 1) & (size <= szhi))
    rows = np.flatnonzero(m)[hit]
    rev = _revenue(li, rows)
    if len(rev) and int(np.abs(rev).max()) * len(rev) >= 2**63:
        raise AssertionError("Q19 reference would overflow int64")
    return [(int(rev.sum()) if len(rev) else None,)]


def _bools(chunked):
    return chunked.to_numpy(zero_copy_only=False).astype(bool)


def _order_years(dates):
    """`tpch_queries._order_year`'s CASE WHEN over int32 days."""
    import numpy as np
    from spark_rapids_tpu_torch.workloads.tpch import day
    bins = [day(f"{y}-12-31") for y in range(1992, 1998)]
    return np.searchsorted(bins, dates, side="left") + 1992


def _as_double(unscaled_vals, scale):
    """A decimal's cast to double: the unscaled int64 over 10^scale, the
    engine's bits for a value that is not negative (the queries' are
    not)."""
    import numpy as np
    return unscaled_vals.astype(np.float64) / (10.0 ** scale)


def _partsupp_rows(t, pk, sk):
    """(partsupp row of each (pk, sk) pair, whether one exists): partsupp
    holds four rows a part in part order, so the candidates are rows
    4 pk .. 4 pk + 3; a pair found twice is refused."""
    import numpy as np
    ps = t["partsupp"]
    npart = _arange_keys(t["part"], "p_partkey")
    if not np.array_equal(_col(ps, "ps_partkey"),
                          np.repeat(np.arange(npart), 4)):
        raise AssertionError("partsupp is not four rows a part in order")
    psk = _col(ps, "ps_suppkey")
    row = np.zeros(len(pk), np.int64)
    hits = np.zeros(len(pk), np.int64)
    for i in range(4):
        cand = pk * 4 + i
        m = psk[cand] == sk
        row = np.where(m, cand, row)
        hits += m
    if len(hits) and int(hits.max()) > 1:
        raise AssertionError("a (ps_partkey, ps_suppkey) pair repeats")
    return row, hits == 1


def _nations_in_region(t, region):
    import numpy as np
    nat, reg = t["nation"], t["region"]
    _arange_keys(nat, "n_nationkey")
    _arange_keys(reg, "r_regionkey")
    names = reg.column("r_name").to_pylist()
    return np.array([names[r] == region for r in _col(nat, "n_regionkey")])


def q2_reference(t, size=15, type_suffix="BRASS", region="EUROPE",
                 limit=100) -> list:
    """The suppliers of each qualifying part whose supply cost is the
    part's least among the region's suppliers; by s_acctbal descending,
    n_name, s_name, p_partkey."""
    import numpy as np
    import pyarrow.compute as pc
    p, s, ps, nat = t["part"], t["supplier"], t["partsupp"], t["nation"]
    npart = _arange_keys(p, "p_partkey")
    ns = _arange_keys(s, "s_suppkey")
    in_region = _nations_in_region(t, region)
    snk = _col(s, "s_nationkey")
    _in_range(snk, len(in_region), "s_nationkey")
    psk, pspk = _col(ps, "ps_suppkey"), _col(ps, "ps_partkey")
    _in_range(psk, ns, "ps_suppkey")
    _in_range(pspk, npart, "ps_partkey")
    eu = in_region[snk][psk]
    cost = unscaled(ps, "ps_supplycost")
    least = np.full(npart, np.iinfo(np.int64).max)
    np.minimum.at(least, pspk[eu], cost[eu])
    part_ok = (_col(p, "p_size") == size) & _bools(
        pc.ends_with(p.column("p_type"), type_suffix))
    rows = np.flatnonzero(eu & part_ok[pspk] & (cost == least[pspk]))
    sk, pk = psk[rows], pspk[rows]
    names = nat.column("n_name").to_pylist()
    cols = [unscaled(s, "s_acctbal")[sk].tolist(), _strs(s, "s_name", sk),
            [names[k] for k in snk[sk]], pk.tolist(),
            _strs(p, "p_mfgr", pk), _strs(s, "s_address", sk),
            _strs(s, "s_phone", sk), _strs(s, "s_comment", sk)]
    out = sorted(zip(*cols), key=lambda r: (-r[0], r[2], r[1], r[3]))
    return out[:limit]


def q8_reference(t, nation="BRAZIL", region="AMERICA",
                 ptype="ECONOMY ANODIZED STEEL") -> list:
    """(o_year, the nation's share of the region's volume), each volume
    the double of the unscaled revenue."""
    import numpy as np
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.workloads.tpch import day
    li, o, p, s, nat = (t[k] for k in ("lineitem", "orders", "part",
                                        "supplier", "nation"))
    lok, ok = _lineitem_orders(t)
    npart = _arange_keys(p, "p_partkey")
    ns = _arange_keys(s, "s_suppkey")
    lpk, lsk = _col(li, "l_partkey"), _col(li, "l_suppkey")
    _in_range(lpk, npart, "l_partkey")
    _in_range(lsk, ns, "l_suppkey")
    d = _col(o, "o_orderdate")[lok]
    cnk = _cust_nation_of_orders(t)[lok]
    m = (ok & _bools(pc.equal(p.column("p_type"), ptype))[lpk]
         & (d >= day("1995-01-01")) & (d <= day("1996-12-31"))
         & _nations_in_region(t, region)[cnk])
    year = np.where(d[m] <= day("1995-12-31"), 1995, 1996)
    vol = _as_double(_revenue(li, m), 4)
    target = nat.column("n_name").to_pylist().index(nation)
    nat_vol = np.where(_col(s, "s_nationkey")[lsk[m]] == target, vol, 0.0)
    rows = []
    for y in (1995, 1996):
        sel = year == y
        if sel.any():
            rows.append((y, float(nat_vol[sel].sum() / vol[sel].sum())))
    return rows


def q9_reference(t, word="green") -> list:
    """(n_name, o_year, the sum of revenue less supply cost x quantity),
    by n_name, o_year descending; each term the double of its unscaled
    integer."""
    import numpy as np
    import pyarrow.compute as pc
    li, o, p, s, ps, nat = (t[k] for k in ("lineitem", "orders", "part",
                                            "supplier", "partsupp",
                                            "nation"))
    lok, ok = _lineitem_orders(t)
    npart = _arange_keys(p, "p_partkey")
    ns = _arange_keys(s, "s_suppkey")
    nn = _arange_keys(nat, "n_nationkey")
    lpk, lsk = _col(li, "l_partkey"), _col(li, "l_suppkey")
    _in_range(lpk, npart, "l_partkey")
    _in_range(lsk, ns, "l_suppkey")
    m = np.flatnonzero(ok & _bools(pc.match_substring(p.column("p_name"),
                                                      word))[lpk])
    row, hit = _partsupp_rows(t, lpk[m], lsk[m])
    idx, row = m[hit], row[hit]
    cost = unscaled(ps, "ps_supplycost")[row]
    qty = unscaled(li, "l_quantity")[idx]
    if len(cost) and int(cost.max()) * int(qty.max()) >= 2**63:
        raise AssertionError("Q9 reference product would overflow int64")
    amount = _as_double(_revenue(li, idx), 4) - _as_double(cost * qty, 4)
    year = _order_years(_col(o, "o_orderdate")[lok[idx]])
    key = _col(s, "s_nationkey")[lsk[idx]] * 7 + (year - 1992)
    _in_range(key, nn * 7, "Q9 group")
    sums = np.bincount(key, weights=amount, minlength=nn * 7)
    names = nat.column("n_name").to_pylist()
    rows = [(names[k // 7], 1992 + k % 7, float(sums[k]))
            for k in np.unique(key)]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def q13_reference(t, w1="special", w2="requests") -> list:
    """(c_count, custdist) by custdist, c_count descending. The orders
    dropped are those `o_comment LIKE '%w1%w2%'` matches as the JAX
    package's LIKE does: each middle run contained anywhere, in either
    order."""
    import numpy as np
    o, c = t["orders"], t["customer"]
    nc = _arange_keys(c, "c_custkey")
    like = _like_two_runs(o.column("o_comment"), w1, w2)
    ock = _col(o, "o_custkey")
    _in_range(ock, nc, "o_custkey")
    dist = np.bincount(np.bincount(ock[~like], minlength=nc))
    rows = [(int(k), int(dist[k])) for k in np.flatnonzero(dist)]
    return sorted(rows, key=lambda r: (-r[1], -r[0]))


def q14_reference(t, d0="1995-09-01", d1="1995-10-01") -> list:
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.workloads.tpch import day
    li, p = t["lineitem"], t["part"]
    npart = _arange_keys(p, "p_partkey")
    sd = _col(li, "l_shipdate")
    m = (sd >= day(d0)) & (sd < day(d1))
    pk = _col(li, "l_partkey")[m]
    _in_range(pk, npart, "l_partkey")
    rev = _as_double(_revenue(li, m), 4)
    promo = _bools(pc.starts_with(p.column("p_type"), "PROMO"))[pk]
    return [(float(100.0 * rev[promo].sum() / rev.sum()),)]


def q17_reference(t, brand="Brand#23", container="MED BOX",
                  notes=None) -> list:
    """The yearly average of the prices of the part's lines under a fifth
    of the part's average quantity. Quantities are whole numbers, so
    their double sums are exact and the thresholds (one division, one
    product) are the engine's to the bit; `notes`, where given, gets the
    part's line count and how many lie within 1e-9 of their threshold."""
    import numpy as np
    import pyarrow.compute as pc
    li, p = t["lineitem"], t["part"]
    npart = _arange_keys(p, "p_partkey")
    lpk = _col(li, "l_partkey")
    _in_range(lpk, npart, "l_partkey")
    qu = unscaled(li, "l_quantity")
    if len(qu) and (np.any(qu % 100) or int(qu.max()) * len(qu) >= 2**53):
        raise AssertionError("Q17 quantities are not small whole numbers")
    qty = _as_double(qu, 2)
    cnt = np.bincount(lpk, minlength=npart)
    thr = np.bincount(lpk, weights=qty, minlength=npart) \
        / np.maximum(cnt, 1) * 0.2
    part_ok = (_bools(pc.equal(p.column("p_brand"), brand))
               & _bools(pc.equal(p.column("p_container"), container)))
    m = part_ok[lpk]
    t_row = thr[lpk]
    if notes is not None:
        notes["q17_lines"] = int(m.sum())
        notes["q17_near_ties"] = int(
            (m & (np.abs(qty - t_row) <= 1e-9 * np.abs(t_row))).sum())
    sel = m & (qty < t_row)
    total = _as_double(unscaled(li, "l_extendedprice")[sel], 2).sum()
    return [(float(total / 7.0),)]


def q20_reference(t, word="forest", nation="CANADA", d0="1994-01-01",
                  d1="1995-01-01") -> list:
    """(s_name, s_address) of the nation's suppliers with a part whose
    name starts with `word` and whose available quantity exceeds half
    the quantity shipped in the year (whole numbers: exact)."""
    import numpy as np
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch.workloads.tpch import day
    li, p, s, ps, nat = (t[k] for k in ("lineitem", "part", "supplier",
                                        "partsupp", "nation"))
    npart = _arange_keys(p, "p_partkey")
    ns = _arange_keys(s, "s_suppkey")
    lpk, lsk = _col(li, "l_partkey"), _col(li, "l_suppkey")
    _in_range(lpk, npart, "l_partkey")
    _in_range(lsk, ns, "l_suppkey")
    sd = _col(li, "l_shipdate")
    m = np.flatnonzero((sd >= day(d0)) & (sd < day(d1)))
    row, hit = _partsupp_rows(t, lpk[m], lsk[m])
    shipped = _group_sum(row[hit], unscaled(li, "l_quantity")[m[hit]],
                         ps.num_rows)
    has = np.bincount(row[hit], minlength=ps.num_rows) > 0
    psk = _col(ps, "ps_suppkey")
    qual = (has & _bools(pc.starts_with(p.column("p_name"), word))[
        _col(ps, "ps_partkey")]
        & (2 * 100 * _col(ps, "ps_availqty").astype(np.int64) > shipped))
    supp_ok = np.zeros(ns, bool)
    supp_ok[psk[qual]] = True
    target = nat.column("n_name").to_pylist().index(nation)
    sel = np.flatnonzero(supp_ok & (_col(s, "s_nationkey") == target))
    return sorted(zip(_strs(s, "s_name", sel), _strs(s, "s_address", sel)))


def _near(x, thr):
    """Rows within a relative 1e-9 of their threshold: where a reference
    that sums the same doubles in another order could decide
    otherwise."""
    import numpy as np
    return int((np.abs(x - thr) <= 1e-9 * np.abs(thr)).sum())


def _like_two_runs(chunked, w1, w2):
    """`LIKE '%w1%w2%'` as the JAX package's LIKE answers it: each middle
    run contained anywhere, in either order, in a string long enough for
    both (docs/compatibility.md)."""
    import pyarrow.compute as pc
    return (_bools(pc.greater_equal(pc.binary_length(chunked),
                                    len(w1) + len(w2)))
            & _bools(pc.match_substring(chunked, w1))
            & _bools(pc.match_substring(chunked, w2)))


def q11_reference(t, nation="GERMANY", fraction=0.0001,
                  notes=None) -> list:
    """(ps_partkey, part_value) of the nation's parts whose stock value
    exceeds `fraction` of the nation's total, by part_value descending,
    ps_partkey; each value the double of its unscaled integer (whole
    cents times a quantity: exact). `notes` gets the parts within 1e-9
    of the threshold."""
    import numpy as np
    ps, s, nat = t["partsupp"], t["supplier"], t["nation"]
    ns = _arange_keys(s, "s_suppkey")
    psk, pspk = _col(ps, "ps_suppkey"), _col(ps, "ps_partkey")
    _in_range(psk, ns, "ps_suppkey")
    target = nat.column("n_name").to_pylist().index(nation)
    m = _col(s, "s_nationkey")[psk] == target
    unsc = unscaled(ps, "ps_supplycost")[m] * \
        _col(ps, "ps_availqty")[m].astype(np.int64)
    if len(unsc) and int(unsc.max()) >= 2**53:
        raise AssertionError("Q11 values are not exact doubles")
    value = _as_double(unsc, 2)
    parts, inv = np.unique(pspk[m], return_inverse=True)
    part_value = np.bincount(inv, weights=value, minlength=len(parts))
    thr = value.sum() * fraction
    if notes is not None:
        notes["q11_parts"] = len(parts)
        notes["q11_near_ties"] = _near(part_value, thr)
    sel = part_value > thr
    rows = list(zip(parts[sel].tolist(), part_value[sel].tolist()))
    return sorted(rows, key=lambda r: (-r[1], r[0]))


def q15_reference(t, d0="1996-01-01", d1="1996-04-01", notes=None) -> list:
    """The supplier(s) of the largest revenue in the quarter: (s_suppkey,
    s_name, s_address, s_phone, total_revenue), each line's revenue the
    double of its unscaled integer. `notes` gets the best and the
    second-best revenue, so a near tie shows."""
    import numpy as np
    from spark_rapids_tpu_torch.workloads.tpch import day
    li, s = t["lineitem"], t["supplier"]
    ns = _arange_keys(s, "s_suppkey")
    lsk = _col(li, "l_suppkey")
    _in_range(lsk, ns, "l_suppkey")
    sd = _col(li, "l_shipdate")
    m = (sd >= day(d0)) & (sd < day(d1))
    rev = np.bincount(lsk[m], weights=_as_double(_revenue(li, m), 4),
                      minlength=ns)
    has = np.bincount(lsk[m], minlength=ns) > 0
    live = np.where(has, rev, -np.inf)
    best = live.max()
    if notes is not None:
        top2 = np.sort(live)[-2:]
        notes["q15_best"] = float(top2[-1])
        notes["q15_second"] = float(top2[0])
        notes["q15_rel_gap"] = float((top2[-1] - top2[0]) / top2[-1])
    sk = np.flatnonzero(has & (rev == best))
    return list(zip(sk.tolist(), _strs(s, "s_name", sk),
                    _strs(s, "s_address", sk), _strs(s, "s_phone", sk),
                    rev[sk].tolist()))


def q16_reference(t, brand="Brand#45", tprefix="MEDIUM POLISHED",
                  sizes=(49, 14, 23, 45, 19, 3, 36, 9)) -> list:
    """(p_brand, p_type, p_size, the distinct suppliers) of the parts
    that pass, over the suppliers without complaints; by supplier_cnt
    descending, then brand, type and size."""
    import numpy as np
    import pyarrow.compute as pc
    p, s, ps = t["part"], t["supplier"], t["partsupp"]
    npart = _arange_keys(p, "p_partkey")
    ns = _arange_keys(s, "s_suppkey")
    psk, pspk = _col(ps, "ps_suppkey"), _col(ps, "ps_partkey")
    _in_range(psk, ns, "ps_suppkey")
    _in_range(pspk, npart, "ps_partkey")
    bad = _like_two_runs(s.column("s_comment"), "Customer", "Complaints")
    size = _col(p, "p_size")
    part_ok = (~_bools(pc.equal(p.column("p_brand"), brand))
               & ~_bools(pc.starts_with(p.column("p_type"), tprefix))
               & np.isin(size, sizes))
    m = part_ok[pspk] & ~bad[psk]
    codes = []
    for name in ("p_brand", "p_type"):
        enc = p.column(name).combine_chunks().dictionary_encode()
        codes.append((enc.indices.to_numpy().astype(np.int64),
                      enc.dictionary.to_pylist()))
    nb, nt = len(codes[0][1]), len(codes[1][1])
    smax = int(size.max()) + 1
    group = (codes[0][0] * nt + codes[1][0]) * smax + size.astype(np.int64)
    pairs = np.unique(group[pspk[m]] * ns + psk[m])
    g, cnt = np.unique(pairs // ns, return_counts=True)
    if len(g) and int(g.max()) >= nb * nt * smax:
        raise AssertionError("Q16 group codes overflow")
    rows = [(codes[0][1][k // smax // nt], codes[1][1][k // smax % nt],
             int(k % smax), int(c)) for k, c in zip(g.tolist(), cnt)]
    return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))


def _distinct_per_order(ok, sk, ns, n_orders):
    """The distinct suppliers of each order key in 0..n_orders-1: one
    sort of the (order, supplier) pairs."""
    import numpy as np
    pairs = np.sort(ok * ns + sk)
    first = np.ones(len(pairs), bool)
    first[1:] = pairs[1:] != pairs[:-1]
    return np.bincount(pairs[first] // ns, minlength=n_orders)


def q21_reference(t, nation="SAUDI ARABIA", limit=100) -> list:
    """(s_name, numwait): the nation's suppliers' late lines on orders
    with status F, another supplier on the order and no other late
    supplier; by numwait descending, s_name."""
    import numpy as np
    import pyarrow.compute as pc
    li, o, s, nat = t["lineitem"], t["orders"], t["supplier"], t["nation"]
    ns = _arange_keys(s, "s_suppkey")
    lok, ok = _lineitem_orders(t)
    no = o.num_rows
    lsk = _col(li, "l_suppkey")
    _in_range(lsk, ns, "l_suppkey")
    late = _col(li, "l_receiptdate") > _col(li, "l_commitdate")
    n_supp = _distinct_per_order(lok[ok], lsk[ok], ns, no)
    n_late = _distinct_per_order(lok[ok & late], lsk[ok & late], ns, no)
    target = nat.column("n_name").to_pylist().index(nation)
    f = _bools(pc.equal(o.column("o_orderstatus"), "F"))
    m = (ok & late & f[lok] & (n_supp[lok] > 1) & (n_late[lok] == 1)
         & (_col(s, "s_nationkey")[lsk] == target))
    sk, cnt = np.unique(lsk[m], return_counts=True)
    rows = list(zip(_strs(s, "s_name", sk), cnt.tolist()))
    return sorted(rows, key=lambda r: (-r[1], r[0]))[:limit]


def q22_reference(t, codes=("13", "31", "23", "29", "30", "18", "17"),
                  notes=None) -> list:
    """(cntrycode, numcust, totacctbal unscaled) of the customers with a
    listed phone code, no order and a balance above the average positive
    balance of such codes (a double, the reference's sum in another
    order: `notes` gets the customers within 1e-9 of it)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    c, o = t["customer"], t["orders"]
    nc = _arange_keys(c, "c_custkey")
    cc = pc.utf8_slice_codeunits(c.column("c_phone"), 0, 2)
    m = _bools(pc.is_in(cc, value_set=pa.array(codes)))
    bal = unscaled(c, "c_acctbal")
    dbal = _as_double(bal, 2)
    pos = m & (bal > 0)
    avg = dbal[pos].sum() / pos.sum()
    ock = _col(o, "o_custkey")
    _in_range(ock, nc, "o_custkey")
    has_order = np.bincount(ock, minlength=nc) > 0
    sel = m & ~has_order
    if notes is not None:
        notes["q22_near_ties"] = _near(dbal[sel], avg)
    sel &= dbal > avg
    code = np.array(cc.to_pylist(), dtype=object)
    rows = []
    for k in sorted(set(code[sel].tolist())):
        g = sel & (code == k)
        rows.append((k, int(g.sum()), int(_group_sum(
            np.zeros(int(g.sum()), np.int64), bal[g], 1)[0])))
    return rows


TPCH_REFERENCES = {2: q2_reference, 4: q4_reference, 5: q5_reference,
                   7: q7_reference, 8: q8_reference, 9: q9_reference,
                   10: q10_reference, 12: q12_reference,
                   13: q13_reference, 14: q14_reference,
                   17: q17_reference, 18: q18_reference,
                   19: q19_reference, 20: q20_reference,
                   11: q11_reference, 15: q15_reference,
                   16: q16_reference, 21: q21_reference,
                   22: q22_reference}


def tpch_kw(n, tables, qty=TPCH_Q18_QTY) -> dict:
    """Query n's parameters where the spec scales them: Q18's quantity
    (`qty`) and Q11's fraction, 0.0001 / SF (the scale factor from the
    part rows). `q11`'s own default, 0.0001, is the spec's at SF1: at
    SF10 no part passes it."""
    from spark_rapids_tpu_torch.workloads.tpch import PART_ROWS_PER_SF
    if n == 18:
        return {"qty": qty}
    if n == 11:
        return {"fraction": 0.0001 * PART_ROWS_PER_SF
                / tables["part"].num_rows}
    return {}


def tpch_reference(n, tables, qty=TPCH_Q18_QTY, notes=None) -> list:
    """Query n's exact result rows at `tpch_kw`'s parameters, each
    decimal as its unscaled int; `notes`, where given, gets what the
    reference notes (near ties)."""
    kw = tpch_kw(n, tables, qty)
    if notes is not None and n in (11, 15, 17, 22):
        kw["notes"] = notes
    return TPCH_REFERENCES[n](tables, **kw)


def tpch_rows(at) -> list:
    """An Arrow result as row tuples, each decimal as its unscaled int at
    its column's scale."""
    import pyarrow as pa
    scales = {f.name: f.type.scale for f in at.schema
              if pa.types.is_decimal(f.type)}
    rows = []
    for r in at.to_pylist():
        row = []
        for k, v in r.items():
            if k in scales and v is not None:
                u = v.scaleb(scales[k])
                if u != u.to_integral_value():
                    raise AssertionError(f"{k} = {v} not at its scale")
                v = int(u)
            row.append(v)
        rows.append(tuple(row))
    return rows


def _rows_agree(rows, expect, floats) -> bool:
    """Row for row: the columns at `floats` within TPCH_RTOL of the
    reference's, every other column equal."""
    import math
    if len(rows) != len(expect):
        return False
    for r, e in zip(rows, expect):
        if len(r) != len(e):
            return False
        for i, (a, b) in enumerate(zip(r, e)):
            if i in floats and a is not None and b is not None:
                if not math.isclose(a, b, rel_tol=TPCH_RTOL, abs_tol=0.0):
                    return False
            elif a != b:
                return False
    return True


def check_tpch(n, at, expect, what: str):
    """Q5 (sorted by revenue alone) as a set with revenue not increasing
    down the rows; every other query row for row, in order; a double
    column within TPCH_RTOL."""
    if tuple(at.column_names) != TPCH_COLUMNS[n]:
        raise AssertionError(f"Q{n} over {what}: columns {at.column_names}")
    rows = tpch_rows(at)
    if n == 5:
        revs = [r[1] for r in rows]
        if revs != sorted(revs, reverse=True):
            raise AssertionError(f"Q5 over {what}: revenue increases")
        rows = sorted(rows, key=lambda r: (-r[1], r[0]))
    floats = {TPCH_COLUMNS[n].index(c)
              for c in TPCH_FLOAT_COLUMNS.get(n, ())}
    if not _rows_agree(rows, expect, floats):
        raise AssertionError(f"Q{n} over {what}: {len(rows)} rows differ "
                             f"from the reference's {len(expect)}")


def tpch_query(n, session, tables, qty=TPCH_Q18_QTY):
    """Query n at `tpch_kw`'s parameters, built afresh over
    create_dataframe of the tables."""
    from spark_rapids_tpu_torch.workloads import tpch_queries as Q
    dfs = {k: session.create_dataframe(v) for k, v in tables.items()}
    return getattr(Q, f"q{n}")(dfs, **tpch_kw(n, tables, qty))


def tpch_plan_shape(root) -> dict:
    """Joins by topology and kind, exchanges and aggregate modes."""
    nodes = plan_nodes(root)
    kinds = collections.Counter(type(x).__name__ for x in nodes)
    joins = [j for j in nodes if type(j).__name__ == "HashJoinExec"]
    return {"broadcast_joins": sum(not j.per_partition for j in joins),
            "per_partition_joins": sum(j.per_partition for j in joins),
            "join_kinds": [j.how for j in joins],
            "shuffle_exchanges": kinds["ShuffleExchangeExec"],
            "broadcast_exchanges": kinds["BroadcastExchangeExec"],
            "aggregates": [getattr(x, "mode", "ungrouped") for x in nodes
                           if type(x).__name__.endswith("AggExec")
                           or type(x).__name__ == "HashAggregateExec"]}


def int32_exchanges(root) -> int:
    """The shuffle exchanges of a plan on one int32 or date key: the ones
    that run the partition kernel."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    return sum(1 for x in plan_nodes(root)
               if type(x).__name__ == "ShuffleExchangeExec" and x.keys
               and len(x.keys) == 1
               and isinstance(x.keys[0].dtype, (dt.IntegerType,
                                                dt.DateType)))


def check_partition_launches(n, root, got, device):
    """On the card, the partition kernel ran where the plan has an
    exchange on one int32/date key, every launch the vector variant; it
    ran nowhere else (and never off the card, where the exchange takes
    its plain version)."""
    what = f"Q{n}" if isinstance(n, int) else n
    if int32_exchanges(root) and device.type == "cuda":
        if not got["all"] or got["vector"] != got["all"]:
            raise AssertionError(f"{what}: an exchange on an int32 key, "
                                 f"partition kernel launches {got}")
    elif got["all"]:
        raise AssertionError(f"{what}: partition kernel launched {got}; "
                             f"no exchange key is int32")


#: Q13's device groups: the profile names torch's cummax (row_of_unit)
#: and the byte gathers (1-byte elements) apart from the rest
Q13_GROUPS = (("cummax", r"cummax|with_indices"),
              ("byte_gather", r"[Ii]ndex.*OpaqueType<1>"),) + Q3_GROUPS


def same_bits(a, b) -> bool:
    """Two Arrow results equal column for column, a double column bit
    for bit (its nulls in the same rows)."""
    import numpy as np
    import pyarrow as pa
    if a.schema != b.schema or a.num_rows != b.num_rows:
        return False
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        if pa.types.is_floating(x.type):
            if not (x.is_null().equals(y.is_null()) and np.array_equal(
                    x.to_numpy(zero_copy_only=False).view(np.int64),
                    y.to_numpy(zero_copy_only=False).view(np.int64))):
                return False
        elif not x.equals(y):
            return False
    return True


def run_counted(q, device, what):
    """(result, the run's numbers) of a fresh DataFrame through
    `to_arrow`: every batch tensor on the session's device, the
    partition kernel's launches counted from 0 and held to the plan
    (`what` names the path), the layers, host syncs, peak device memory
    and the per-operator metrics."""
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    from spark_rapids_tpu_torch.ops import partition_kernels as pk
    with BatchDevices(DeviceBatch) as devs:
        torch_peak_reset(device)
        pk.launches = pk.vector_launches = pk.scalar_launches = 0
        out, wall, layers, syncs = timed_query(q, device)
        got = {"all": pk.launches, "vector": pk.vector_launches,
               "scalar": pk.scalar_launches}
    check_devices(devs, device)
    check_partition_launches(what, q.last_plan(), got, device)
    return out, {
        "wall_s": wall, "rows": out.num_rows, "layers_s": layers,
        "host_syncs": syncs, "partition_kernel_launches": got,
        "peak_device_bytes": torch_peak(device),
        "batch_tensors_by_device": dict(devs.seen),
        "nodes": per_node_metrics(q)}


def tpch_phases(session, tables, expects, runs=2,
                queries=TPCH_QUERIES) -> dict:
    """One phase per query (each run a fresh plan; the partition kernel's
    launches counted from 0 and held to the plan's int32 exchanges; the
    runs of a query with a double sum bit-equal), then Q5 and Q13 under
    torch.profiler. Returns the partition kernel's launches per path."""
    dev = session.device
    per = session.conf.batch_size_rows
    batches = sum(-(-t.num_rows // per) for t in tables.values())
    launches = {}
    for n in queries:
        out_runs, outs = [], []
        for _ in range(runs):
            q = tpch_query(n, session, tables)
            out, info = run_counted(q, dev, n)
            check_tpch(n, out, expects[n], "default conf")
            outs.append(out)
            layers, nodes = info["layers_s"], info.pop("nodes")
            info["layers_s"] = {k: layers[k] for k in Q3_LAYERS
                                if k in layers}
            info["join_paths"] = {k: {p: v.get(p, 0) for p in JOIN_PATHS}
                                  for k, v in nodes.items()
                                  if k.startswith("HashJoinExec")}
            out_runs.append(info)
        launches[f"q{n}"] = info["partition_kernel_launches"]
        bit_equal = None
        if n in TPCH_DOUBLE_QUERIES and runs > 1:
            bit_equal = all(same_bits(outs[0], o) for o in outs[1:])
            if not bit_equal:
                raise AssertionError(f"Q{n}: the runs' doubles differ")
        emit({"phase": f"tpch_q{n}", "plan": tpch_plan_shape(q.last_plan()),
              "int32_exchanges": int32_exchanges(q.last_plan()),
              "input_batches": batches, "runs_bit_equal": bit_equal,
              "runs": out_runs})
    for n, groups in ((5, Q3_GROUPS), (13, Q13_GROUPS)):
        if n not in queries:
            continue
        torch_peak_reset(dev)
        out, prof = profiled_query(tpch_query(n, session, tables), dev,
                                   batches, groups)
        check_tpch(n, out, expects[n], "default conf (profiled)")
        emit({"phase": f"tpch_q{n}_profiled",
              "peak_device_bytes": torch_peak(dev), **prof})
    return launches


def _join_run(q, device, what):
    """`run_counted`, with the joins' metrics and the plan's nodes."""
    out, info = run_counted(q, device, what)
    info["joins"] = {k: v for k, v in info.pop("nodes").items()
                     if "JoinExec" in k}
    info["plan"] = [type(x).__name__ for x in plan_nodes(q.last_plan())]
    return out, info


def _sorted_by(at, *names):
    return at.sort_by([(n, "ascending") for n in names])


def join_condition_phases(session, tables) -> dict:
    """Two joins with a condition over gen_all's tables, each checked
    against numpy: orders (15M rows at SF10) with customer on the key
    and `o_totalprice > c_acctbal * 10` (a conditional hash join), and
    customer (1.5M) with nation (25) on `condition=c_nationkey ==
    n_nationkey` alone (the nested-loop join, whose rows must equal the
    equi-join's). Returns the partition kernel's launches per path."""
    import numpy as np
    from spark_rapids_tpu_torch.expr.expressions import col, lit
    dev = session.device
    o, c, nat = tables["orders"], tables["customer"], tables["nation"]
    nc = _arange_keys(c, "c_custkey")
    no = _arange_keys(o, "o_orderkey")
    nn = _arange_keys(nat, "n_nationkey")
    ock = _col(o, "o_custkey")
    _in_range(ock, nc, "o_custkey")
    acct, price = unscaled(c, "c_acctbal"), unscaled(o, "o_totalprice")
    launches = {}

    orders = session.create_dataframe(
        o.select(["o_orderkey", "o_custkey", "o_totalprice"]))
    cust = session.create_dataframe(c.select(["c_custkey", "c_acctbal"]))
    q = orders.join(cust, on=(col("o_custkey") == col("c_custkey"))
                    & (col("o_totalprice") > col("c_acctbal") * lit(10)))
    out, info = _join_run(q, dev, "the conditional hash join")
    want = np.flatnonzero(price > acct[ock] * 10)
    got = _sorted_by(out, "o_orderkey")
    gk = _col(got, "o_orderkey")
    if not (np.array_equal(gk, want)
            and np.array_equal(_col(got, "c_custkey"), ock[want])
            and np.array_equal(unscaled(got, "c_acctbal"), acct[ock[want]])
            and np.array_equal(unscaled(got, "o_totalprice"),
                               price[want])):
        raise AssertionError(f"the conditional hash join: {len(gk)} rows "
                             f"differ from numpy's {len(want)}")
    joins = [x for x in plan_nodes(q.last_plan())
             if type(x).__name__ == "HashJoinExec"]
    if len(joins) != 1 or joins[0].condition is None:
        raise AssertionError("the conditional hash join's plan")
    launches["join_condition"] = info["partition_kernel_launches"]
    emit({"phase": "join_condition", "stream_rows": no, "build_rows": nc,
          "per_partition": joins[0].per_partition, **info})

    csel = session.create_dataframe(
        c.select(["c_custkey", "c_nationkey", "c_acctbal"]))
    nsel = session.create_dataframe(nat.select(["n_nationkey", "n_name"]))
    q = csel.join(nsel, condition=col("c_nationkey") == col("n_nationkey"))
    out, info = _join_run(q, dev, "the nested-loop join")
    nlj = [x for x in plan_nodes(q.last_plan())
           if type(x).__name__ == "NestedLoopJoinExec"]
    if len(nlj) != 1:
        raise AssertionError("the nested-loop join's plan")
    chunks = q.last_metrics()[nlj[0]._op_id]["nestedLoopChunks"]
    eq, eq_info = _join_run(
        csel.join(nsel, on=col("c_nationkey") == col("n_nationkey")), dev,
        "the equi-join")
    got = _sorted_by(out, "c_custkey")
    cnk = _col(c, "c_nationkey")
    _in_range(cnk, nn, "c_nationkey")
    names = np.array(nat.column("n_name").to_pylist(), object)
    if not (got.equals(_sorted_by(eq, "c_custkey"))
            and np.array_equal(_col(got, "c_custkey"), np.arange(nc))
            and np.array_equal(_col(got, "n_nationkey"), cnk)
            and got.column("n_name").to_pylist() == names[cnk].tolist()):
        raise AssertionError("the nested-loop join differs from the "
                             "equi-join or numpy")
    launches["nested_loop"] = info["partition_kernel_launches"]
    emit({"phase": "nested_loop_join", "stream_rows": nc,
          "build_rows": nn, "pairs": nc * nn, "chunks": chunks, **info,
          "equi_join_wall_s": eq_info["wall_s"]})
    return launches


def double_sum_repeat(device, rows=2_000_000, segments=100_000, repeats=5,
                      seed=17) -> dict:
    """A grouped double sum (`seg_sum`, the aggregates' accumulator) of
    one fixed input, `repeats` times: every result must be bit-equal.
    `index_add_`, the atomic sum it replaces on the card, runs beside it
    for contrast (its distinct results counted), and the CPU's row-order
    sum gives the largest relative difference."""
    import numpy as np
    import torch
    from spark_rapids_tpu_torch.expr.aggregates import seg_sum
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal(rows) * 1e6
    ih = rng.integers(0, segments, rows)
    x = torch.from_numpy(xh).to(device)
    ids = torch.from_numpy(ih).to(device)

    def atomic():
        return torch.zeros(segments, dtype=torch.float64,
                           device=device).index_add_(0, ids, x)
    outs = [seg_sum(x, ids, segments) for _ in range(repeats)]
    atomics = [atomic() for _ in range(repeats)]
    bits = {o.view(torch.int64).cpu().numpy().tobytes() for o in outs}
    if len(bits) != 1:
        raise AssertionError(f"a double group sum gave {len(bits)} "
                             f"different results in {repeats} runs")
    cpu = seg_sum(x.cpu(), ids.cpu(), segments).numpy()
    got = outs[0].cpu().numpy()
    info = {
        "phase": "double_group_sum_repeat", "rows": rows,
        "segments": segments, "repeats": repeats, "bit_equal": True,
        "index_add_distinct_results": len(
            {o.view(torch.int64).cpu().numpy().tobytes() for o in atomics}),
        "max_rel_diff_vs_cpu": float(np.max(
            np.abs(got - cpu) / np.maximum(np.abs(cpu), 1e-300))),
        "bit_equal_to_cpu": bool(np.array_equal(got.view(np.int64),
                                                cpu.view(np.int64)))}
    if device.type == "cuda":
        info["ms"] = cuda_ms(lambda: seg_sum(x, ids, segments))
        info["index_add_ms"] = cuda_ms(atomic)
    emit(info)
    return info


def torch_peak_reset(device):
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)


def torch_peak(device):
    """Peak device bytes since the last reset (None off the card)."""
    if device.type != "cuda":
        return None
    import torch
    return torch.cuda.max_memory_allocated(device)


def tpch_data(sf, seed=TPCH_SEED, qty=TPCH_Q18_QTY):
    """(gen_all's tables, reference rows per query), printing each table's
    rows and generation seconds and each reference's seconds. The tables
    are gen_all's, made one generator call at a time to time each."""
    from spark_rapids_tpu_torch.workloads import tpch
    makers = {
        "lineitem": lambda: tpch.gen_lineitem(sf, seed, full=True),
        "orders": lambda: tpch.gen_orders(sf, seed, full=True),
        "customer": lambda: tpch.gen_customer(sf, seed, full=True),
        "part": lambda: tpch.gen_part(sf),
        "supplier": lambda: tpch.gen_supplier(sf),
        "partsupp": lambda: tpch.gen_partsupp(sf),
        "nation": tpch.gen_nation,
        "region": tpch.gen_region,
    }
    tables, gen_s = {}, {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        tables[name] = make()
        gen_s[name] = time.perf_counter() - t0
    ref_s, expects, notes = {}, {}, {}
    for n in TPCH_QUERIES:
        t0 = time.perf_counter()
        if n == 18:     # every order over the threshold, then the limit
            q18_all = q18_reference(tables, qty, limit=None)
            expects[n] = q18_all[:100]
        else:
            expects[n] = tpch_reference(n, tables, qty, notes)
        ref_s[f"q{n}"] = time.perf_counter() - t0
    emit({"phase": "tpch_data", "sf": sf, "seed": seed,
          "rows": {k: v.num_rows for k, v in tables.items()},
          "gen_s": gen_s, "reference_s": ref_s,
          "result_rows": {f"q{n}": len(e) for n, e in expects.items()},
          "q18_qty": qty, "q18_orders_over_qty": len(q18_all),
          "q11_fraction": tpch_kw(11, tables)["fraction"], **notes})
    return tables, expects


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.ops import partition_kernels as pk
    from spark_rapids_tpu_torch.workloads import tpch

    torch.cuda.set_device(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "numpy": __import__("numpy").__version__})

    t0 = time.perf_counter()
    built = cuda_build.build(KERNEL_SOURCES)
    ptxas = {}
    for v in built.values():
        for symbol, props in ptxas_report(v["log"]).items():
            ptxas[kernel_of(symbol) or symbol] = props
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "flags": list(cuda_build.NVCC_FLAGS),
          "kernels": {k: {"seconds": v["seconds"], "path": v["path"]}
                      for k, v in built.items()},
          "ptxas": ptxas})
    counts = {}
    for name in KERNEL_SOURCES:
        counts.update(sass_counts(cuda_build.sass(name)))
    sass = {"functions": counts, "instr_per_row": instr_per_row(counts)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = sm_max_clock_hz()
    emit({"phase": "sass", "sms": sms, "sm_max_clock_hz": clock_hz, **sass})

    rows = int(tpch.LINEITEM_ROWS_PER_SF * SF)
    last_batch = rows - (rows - 1) // BATCH_ROWS * BATCH_ROWS
    kcheck = check_partition_kernel(torch, pk, last_batch)
    ktime = time_partition_kernels(torch, pk)
    ipr = sass["instr_per_row"]
    per_kind = {}
    for kind, t in ktime["timed"].items():
        per_kind[kind] = {
            "ms": t["ms"][0], "ms_again": t["ms"][1],
            "back_to_back_ms": t["back_to_back_ms"][0],
            "back_to_back_ms_again": t["back_to_back_ms"][1],
            "device_us": t["device_us"],
            "host_us_per_call": t["host_us_per_call"],
            "ms_by_rows": t["ms_by_rows"],
            "max_abs_err": kcheck["max_abs_err"][kind],
            "cases": kcheck["cases"][kind],
            "instr_per_row": ipr.get(kind),
            **partition_bound(BATCH_ROWS, ipr.get(kind, 0.0), sms, clock_hz),
            **ptxas.get(kind, {})}
    emit({"phase": "kernel_vs_plain", "kernel": "partition_ids_i32",
          "lengths": kcheck["lengths"],
          "tile_edge_lengths": kcheck["tile_edge_lengths"],
          "num_partitions": kcheck["num_partitions"],
          "rows": BATCH_ROWS, "plain_ms": ktime["plain_ms"],
          "floor_ms": ktime["floor_ms"],
          "floor_device_us": ktime["floor_device_us"],
          "variants": per_kind})

    t0 = time.perf_counter()
    lineitem = tpch.gen_lineitem(SF, seed=0)
    expect = tpch.q6_numpy_baseline(
        lineitem.column("l_shipdate").to_numpy(),
        unscaled(lineitem, "l_discount"), unscaled(lineitem, "l_quantity"),
        unscaled(lineitem, "l_extendedprice"))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q1_expect = q1_reference(lineitem)
    shipdate_expect = shipdate_reference(lineitem)
    emit({"phase": "data", "sf": SF, "rows": lineitem.num_rows,
          "gen_and_baseline_s": gen_s,
          "q1_and_shipdate_reference_s": time.perf_counter() - t0,
          "q6_expected_unscaled": expect,
          "q1_expected_unscaled": {"|".join(k): v
                                   for k, v in sorted(q1_expect.items())},
          "shipdate_groups": len(shipdate_expect[0])})

    session = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows":
                             BATCH_ROWS})
    by_path = path_phases(session, lineitem, expect, q1_expect,
                          shipdate_expect)

    t0 = time.perf_counter()
    tables = q3_tables(SF, lineitem)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q3_expect = q3_reference(*tables)
    emit({"phase": "q3_data", "sf": SF,
          "rows": {n: t.num_rows for n, t in zip(
              ("customer", "orders", "lineitem"), tables)},
          "gen_s": gen_s, "reference_s": time.perf_counter() - t0,
          "result_rows": len(q3_expect[0]),
          "top": [[int(x) for x in t] for t in zip(*(
              a[:Q3_LIMIT] for a in q3_expect))]})
    by_path.update(q3_phases(session, tables, q3_expect))
    # the earlier phases' tables go before the eight of gen_all
    del lineitem, tables
    gc.collect()
    double_sum_repeat(session.device)
    tpch_tables, tpch_expects = tpch_data(SF)
    by_path.update(tpch_phases(session, tpch_tables, tpch_expects))
    by_path.update(join_condition_phases(session, tpch_tables))
    launches = {k: sum(p[k] for p in by_path.values())
                for k in ("all", "vector", "scalar")}

    variants = {k: dict(v, launches=launches[k])
                for k, v in per_kind.items()}
    vec = variants["vector"]
    emit({"kernels": [{
        "name": "partition_ids_i32", "route": "cuda",
        "source": pk.SOURCE,
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:64",
        "tpu_kernel": "ops/pallas_kernels.py:pallas_partition_ids_i32",
        "launches": launches["all"],
        "launches_by_path": {k: v["all"] for k, v in by_path.items()},
        "checked_against_plain": True,
        "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
        "ms": vec["ms"], "back_to_back_ms": vec["back_to_back_ms"],
        "plain_ms": ktime["plain_ms"], "bound_ms": vec["bound_ms"],
        "bound_by": vec["bound_by"], "instr_per_row": vec["instr_per_row"],
        "library_ms": None, "variants": variants}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
