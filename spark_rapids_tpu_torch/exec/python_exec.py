"""Arrow-IPC python worker execs: pandas transforms in SEPARATE worker
processes, batches crossing as Arrow IPC stream bytes; the port of the
JAX package's `exec/python_exec.py`.

The analog of the reference's execution/python package
(`GpuMapInPandasExec`, `GpuArrowEvalPythonExec`): a device batch leaves
for the host through `exec/nodes.py` `_batch_to_arrow` (one D2H copy),
ships to a pooled python worker over a pipe, the user's pandas function
runs there (its own GIL, its own memory), and the result returns through
one upload (`Table.from_arrow`) onto the query's device. A worker-slot
bound caps the workers alive in the process, like the reference's
PythonWorkerSemaphore (`PythonWorkerSemaphore.scala:44`), so a wide
query cannot fork an unbounded python fleet.

The user function must be picklable (a module-level def or a
functools.partial): workers start with the `spawn` method, so they
inherit nothing of the parent. The worker's side (its loop and the
picklable group wrappers `_GroupApply`, `_AggApply`, `_CoGroupApply`,
re-exported here) lives in `exec/python_worker.py`, which imports
neither torch nor the rest of the port: a worker starts without
loading torch (seconds saved a spawn) and can never touch CUDA; it sees
Arrow bytes and pandas frames only.

Pools: one pool per exec, as in the JAX package, reused across the
batches and partitions of its action. The JAX package keeps a pool for
the life of its cached physical plan; the port plans every action
afresh, so the session closes the plan's pools when the action ends
(`close_plan_pools`), as `release()` does. The workers spawned in the
process are `pool_stats()["spawned"]`.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import threading
from typing import Callable, Dict, Iterator, List, Optional

from ..columnar.table import Schema, Table
from ..config import PYTHON_CONCURRENT_WORKERS, PYTHON_GROUPED_CHUNK_BYTES
from .base import ExecContext, TpuExec
from .batch import DeviceBatch
from .python_worker import (_AggApply, _CoGroupApply,  # noqa: F401
                            _GroupApply, _worker_main)

__all__ = ["ArrowEvalPythonExec", "GroupedMapPythonExec",
           "CoGroupPythonExec", "PythonWorkerPool", "close_plan_pools",
           "pool_stats"]


class _Worker:
    def __init__(self, fn_blob: bytes):
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main, args=(child,),
                                daemon=True)
        self.proc.start()
        child.close()
        with _STATS_LOCK:
            _STATS["spawned"] += 1
        try:
            self.conn.send(("fn", fn_blob))
            kind, payload = self.conn.recv()
        except BaseException:
            self.stop()
            raise
        if kind != "ok":
            self.stop()
            raise RuntimeError(f"python worker init failed: {payload}")

    def run(self, ipc_bytes: bytes) -> bytes:
        self.conn.send(("batch", ipc_bytes))
        kind, payload = self.conn.recv()
        if kind != "ok":
            raise RuntimeError(f"python worker failed: {payload}")
        return payload

    def stop(self):
        try:
            self.conn.send(("stop",))
        except Exception:
            pass
        self.proc.join(timeout=2)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=2)
        self.conn.close()


# process-GLOBAL worker-slot accounting: the bound caps the live python
# workers across ALL pools and queries in this process, matching the
# reference's one PythonWorkerSemaphore per executor (sized from the
# first conf observed; later differing values keep the first bound)
_slots_cv = threading.Condition()
_slots_bound: List[int] = []            # [bound] once initialized
_slots_used = [0]

_STATS_LOCK = threading.Lock()
_STATS = {"spawned": 0, "pools": 0}


def _global_acquire(bound_hint: int, block: bool = True) -> bool:
    """Take one worker slot, waiting for one (`block`) or returning
    False when every slot is taken."""
    with _slots_cv:
        if not _slots_bound:
            _slots_bound.append(max(1, bound_hint))
        while _slots_used[0] >= _slots_bound[0]:
            if not block:
                return False
            _slots_cv.wait(timeout=0.5)
        _slots_used[0] += 1
        return True


def _global_release():
    with _slots_cv:
        _slots_used[0] = max(0, _slots_used[0] - 1)
        _slots_cv.notify()


class PythonWorkerPool:
    """Pool of persistent python workers for ONE function, drawing
    spawn slots from the process-global bound (PythonWorkerSemaphore
    analog); run() blocks while every slot is busy, and workers are
    reused across batches."""

    def __init__(self, fn: Callable, max_workers: int):
        self._fn_blob = pickle.dumps(fn)
        self.max_workers = max(1, max_workers)
        self._idle: List[_Worker] = []
        self._spawned = 0
        self._cv = threading.Condition()
        self._closed = False
        with _STATS_LOCK:
            _STATS["pools"] += 1

    def run(self, ipc_bytes: bytes) -> bytes:
        w = self._acquire()
        try:
            out = w.run(ipc_bytes)
        except BaseException:
            # failed worker is not returned to the pool
            self._drop(w)
            raise
        self._release(w)
        return out

    def _drop(self, w: Optional[_Worker]):
        with self._cv:
            self._spawned -= 1
            self._cv.notify()
        _global_release()
        if w is not None:
            w.stop()

    def _acquire(self) -> _Worker:
        while True:
            with self._cv:
                if self._idle:
                    return self._idle.pop()
                if self._spawned >= self.max_workers:
                    self._cv.wait(timeout=0.5)
                    continue
                self._spawned += 1
                alone = self._spawned == 1
            # a pool with a worker of its own waits for it rather than
            # for a slot its own workers may hold
            try:
                got = _global_acquire(self.max_workers, block=alone)
            except BaseException:
                with self._cv:
                    self._spawned -= 1
                    self._cv.notify()
                raise
            if got:
                break
            with self._cv:
                self._spawned -= 1
                self._cv.wait(timeout=0.5)
        try:
            return _Worker(self._fn_blob)
        except BaseException:
            # failed spawn MUST return its slot or the pool deadlocks
            with self._cv:
                self._spawned -= 1
                self._cv.notify()
            _global_release()
            raise

    def _release(self, w: _Worker):
        with self._cv:
            if self._closed:
                # checked out across close(): return its slot here
                self._spawned -= 1
            else:
                self._idle.append(w)
                self._cv.notify()
                return
        w.stop()
        _global_release()

    def close(self):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            idle, self._idle = self._idle, []
            n = len(idle)
            self._spawned -= n
        for w in idle:
            w.stop()
        for _ in range(n):
            _global_release()
        with _STATS_LOCK:
            _STATS["pools"] -= 1


def close_plan_pools(root: TpuExec) -> None:
    """Close the pools of every python exec in a physical plan: the end
    of its action (a later action plans afresh)."""
    stack = [root]
    while stack:
        node = stack.pop()
        if isinstance(node, ArrowEvalPythonExec):
            node.close_pool()
        stack.extend(node.children)


def pool_stats() -> Dict[str, int]:
    """Workers spawned in this process, the pools open and the slots in
    use."""
    with _STATS_LOCK:
        out = dict(_STATS)
    with _slots_cv:
        out["slotsUsed"] = _slots_used[0]
        out["slotsBound"] = _slots_bound[0] if _slots_bound else 0
    return out


class ArrowEvalPythonExec(TpuExec):
    """mapInPandas: each input batch crosses to a python worker as an
    Arrow IPC stream and the pandas result uploads to the query's
    device (reference: GpuMapInPandasExec / GpuArrowEvalPythonExec
    batch flow)."""

    def __init__(self, child: TpuExec, fn: Callable, schema: Schema):
        super().__init__([child], schema)
        self.fn = fn
        self._pool: Optional[PythonWorkerPool] = None
        self._pool_lock = threading.Lock()

    def describe(self):
        name = getattr(self.fn, "__name__", "fn")
        return f"ArrowEvalPythonExec[{name}]"

    def _ensure_pool(self, ctx) -> PythonWorkerPool:
        with self._pool_lock:
            if self._pool is None:
                self._pool = PythonWorkerPool(
                    self.fn, ctx.conf.get(PYTHON_CONCURRENT_WORKERS))
            return self._pool

    def close_pool(self):
        """Stop this exec's workers (a later batch spawns anew)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()

    def release(self):
        self.close_pool()
        super().release()

    def _ship(self, ctx, pool, at, m, out_arrow):
        import pyarrow as pa
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, at.schema) as w:
            w.write_table(at)
        res_bytes = pool.run(sink.getvalue().to_pybytes())
        with pa.ipc.open_stream(res_bytes) as rd:
            res = rd.read_all()
        if res.num_rows == 0:
            return None
        res = res.cast(out_arrow)
        tbl = Table.from_arrow(res, ctx.device)
        m.add("numOutputRows", res.num_rows)
        m.add("numOutputBatches", 1)
        return DeviceBatch(tbl, num_rows=res.num_rows, device=ctx.device)

    def execute_partition(self, ctx: ExecContext,
                          pid: int) -> Iterator[DeviceBatch]:
        from .nodes import _batch_to_arrow
        m = ctx.metrics_for(self._op_id)
        pool = self._ensure_pool(ctx)
        out_arrow = self.schema.to_arrow()
        for batch in self.children[0].execute_partition(ctx, pid):
            with m.timer("pythonEvalTime"):
                out = self._ship(ctx, pool, _batch_to_arrow(batch), m,
                                 out_arrow)
            if out is not None:
                yield out


class GroupedMapPythonExec(ArrowEvalPythonExec):
    """applyInPandas / aggregate-in-pandas: the child is repartitioned
    by the grouping keys so every group is whole within one partition;
    the partition ships to a python worker as ONE frame (the wrapper
    does the per-group apply). Oversized partitions chunk at GROUP
    boundaries — OOM-safe without splitting a group (reference:
    GpuFlatMapGroupsInPandasExec / GpuAggregateInPandasExec)."""

    def __init__(self, child: TpuExec, fn: Callable, schema: Schema,
                 key_names):
        super().__init__(child, fn, schema)
        self.key_names = list(key_names)

    def describe(self):
        name = getattr(getattr(self.fn, "fn", self.fn), "__name__", "fn")
        return f"GroupedMapPythonExec[{name}, keys={self.key_names}]"

    def execute_partition(self, ctx: ExecContext,
                          pid: int) -> Iterator[DeviceBatch]:
        import numpy as np
        import pyarrow as pa
        import pyarrow.compute as pc

        from .nodes import _batch_to_arrow
        m = ctx.metrics_for(self._op_id)
        pool = self._ensure_pool(ctx)
        out_arrow = self.schema.to_arrow()
        parts = [_batch_to_arrow(b) for b in
                 self.children[0].execute_partition(ctx, pid)]
        parts = [p for p in parts if p.num_rows]
        if not parts:
            return
        at = pa.concat_tables(parts)
        limit = ctx.conf.get(PYTHON_GROUPED_CHUNK_BYTES)
        with m.timer("pythonEvalTime"):
            if at.nbytes <= limit:
                chunks = [at]
            else:
                # chunk at group boundaries: sort host rows by key so
                # each group is contiguous, then greedy-pack whole
                # groups under the byte limit
                keys = [at.column(k) for k in self.key_names]
                order = pc.sort_indices(
                    pa.table({f"k{i}": c for i, c in enumerate(keys)}),
                    sort_keys=[(f"k{i}", "ascending")
                               for i in range(len(keys))])
                at = at.take(order)
                kdf = at.select(self.key_names).to_pandas()
                prev = kdf.shift()
                # NaN != NaN would split the null-key group (dropna=False
                # groups) at every row — treat both-null as equal
                diff = (kdf != prev) & ~(kdf.isna() & prev.isna())
                new_grp = np.array(diff.any(axis=1).to_numpy())
                new_grp[0] = True
                starts = np.flatnonzero(new_grp)
                bpr = max(1, at.nbytes // max(at.num_rows, 1))
                rows_per_chunk = max(1, limit // bpr)
                chunks = []
                lo = 0
                while lo < at.num_rows:
                    target = lo + rows_per_chunk
                    nxt = starts[starts > lo]
                    cut = (at.num_rows if target >= at.num_rows
                           else int(nxt[nxt >= target][0])
                           if (nxt >= target).any() else at.num_rows)
                    chunks.append(at.slice(lo, cut - lo))
                    lo = cut
        m.add("numGroupChunks", len(chunks))
        for c in chunks:
            with m.timer("pythonEvalTime"):
                out = self._ship(ctx, pool, c, m, out_arrow)
            if out is not None:
                yield out


class CoGroupPythonExec(ArrowEvalPythonExec):
    """FlatMapCoGroupsInPandas: both (key-repartitioned) sides of a
    cogroup ship together with a __side marker; the worker wrapper
    matches groups by key equality and applies fn(left_df, right_df)
    (reference: GpuFlatMapCoGroupsInPandasExec)."""

    def __init__(self, left: TpuExec, right: TpuExec, fn: Callable,
                 schema: Schema):
        TpuExec.__init__(self, [left, right], schema)
        self.fn = fn
        self._pool = None
        self._pool_lock = threading.Lock()

    def describe(self):
        name = getattr(getattr(self.fn, "fn", self.fn), "__name__", "fn")
        return f"CoGroupPythonExec[{name}]"

    def num_partitions(self, ctx):
        return self.children[0].num_partitions(ctx)

    def execute_partition(self, ctx: ExecContext,
                          pid: int) -> Iterator[DeviceBatch]:
        import pyarrow as pa

        from .nodes import _batch_to_arrow
        m = ctx.metrics_for(self._op_id)
        pool = self._ensure_pool(ctx)
        out_arrow = self.schema.to_arrow()

        def side_table(child, side):
            parts = [_batch_to_arrow(b)
                     for b in child.execute_partition(ctx, pid)]
            parts = [p for p in parts if p.num_rows]
            if not parts:
                return None
            t = pa.concat_tables(parts)
            return t.append_column(
                "__side", pa.array([side] * t.num_rows, pa.int8()))

        with m.timer("pythonEvalTime"):
            lt = side_table(self.children[0], 0)
            rt = side_table(self.children[1], 1)
            tabs = [t for t in (lt, rt) if t is not None]
            if not tabs:
                return
            at = pa.concat_tables(tabs, promote_options="default")
            out = self._ship(ctx, pool, at, m, out_arrow)
        if out is not None:
            yield out
