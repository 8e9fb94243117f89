"""Runtime bloom-filter join pruning.

The port of the JAX package's `exec/runtime_filter.py` (reference: the
plugin's runtime filter path, GpuBloomFilterAggregate feeding
GpuBloomFilterMightContain through InSubqueryExec, so the fact side of a
join drops non-matching rows BEFORE the shuffle). The planner wraps the
STREAM side of a shuffled equi-join in RuntimeBloomFilterExec, which
folds the build keys into a device bloom-filter bit vector and then
masks every stream batch by k-hash membership: rows that cannot match
never reach the exchange.

Only sound for join types where a stream row WITHOUT a build match
contributes nothing (inner, left_semi, right). The build subtree is
wrapped in SharedBuildExec, so the filter and the join's build exchange
consume ONE materialization: any build shape with a row-count estimate
is eligible (no re-execution, no scan-shape restriction). The build
positions and the probe's are `ops/hash.py` `bloom_positions`, the ones
`bloom_filter_agg` and `might_contain` use.

The filter is built lazily, under a lock, by whichever thread first asks
a stream partition for a batch: on the map pool that is a worker inside
a `PermitRider` step (`exec/exchange_pool.py`). Workers that wait on the
lock hold their steps meanwhile, and the build runs inside the building
thread's step; an exchange inside the build subtree runs its own pool
with its own rider, whose ride slot is always free to one of its
workers, so the build never waits for a permit that a waiting worker
holds.
"""
from __future__ import annotations

import threading
from typing import Iterator

import torch

from ..expr.aggregates import BloomFilterAggregate
from ..expr.expressions import EmitCtx
from ..memory.retry import retry_no_split
from ..ops.hash import bloom_positions
from .base import ExecContext, TpuExec
from .batch import DeviceBatch

__all__ = ["RuntimeBloomFilterExec", "SharedBuildExec"]


class SharedBuildExec(TpuExec):
    """Materializes its child ONCE per execution context (spill-backed)
    and replays the batches for every consumer: the join's build-side
    exchange and the runtime bloom filter read the SAME single scan,
    instead of re-executing the subtree per consumer. The handles live
    in `ctx.shared_handles` and close with the context."""

    def __init__(self, child: TpuExec):
        super().__init__([child], child.schema)
        self._locks = {}
        self._lock = threading.Lock()

    def describe(self):
        return "SharedBuildExec"

    def num_partitions(self, ctx):
        return self.children[0].num_partitions(ctx)

    def _pid_lock(self, pid):
        with self._lock:
            return self._locks.setdefault(pid, threading.Lock())

    def execute_partition(self, ctx: ExecContext, pid: int):
        cache = ctx.shared_handles.setdefault(id(self), {})
        with self._pid_lock(pid):
            if pid not in cache:
                store, dm = ctx.spill_store, ctx.device_manager
                handles = []
                try:
                    for b in self.children[0].execute_partition(ctx, pid):
                        handles.append(retry_no_split(
                            lambda bb=b: store.add_batch(bb), dm=dm))
                except BaseException:
                    for h in handles:
                        h.close()
                    raise
                cache[pid] = handles
        for h in cache[pid]:
            yield h.materialize()


class RuntimeBloomFilterExec(TpuExec):
    """The stream side of a shuffled equi-join, masked by a bloom filter
    of the build side's keys (`bloomBuildTime`, `bloomProbeTime`)."""

    def __init__(self, stream: TpuExec, build: TpuExec, stream_key,
                 build_key, estimated_items: int):
        super().__init__([stream], stream.schema)
        self.build = build
        self.stream_key = stream_key
        self.build_key = build_key
        self._agg = BloomFilterAggregate(build_key,
                                         estimated_items=estimated_items)
        self._agg._resolve_type()
        self._bits = None
        self._lock = threading.Lock()

    def describe(self):
        return (f"RuntimeBloomFilterExec[{self.stream_key!r} IN "
                f"bloom({self.build_key!r}), "
                f"bits={self._agg.num_bits}]")

    @property
    def num_bits(self) -> int:
        return self._agg.num_bits

    def release(self):
        self._bits = None
        self.build.release()
        super().release()

    # -- build ---------------------------------------------------------
    def _ensure_filter(self, ctx: ExecContext):
        if self._bits is not None:
            return self._bits
        with self._lock:
            if self._bits is not None:
                return self._bits
            a = self._agg
            state = None
            with ctx.timer(self._op_id, "bloomBuildTime"):
                for b in self.build.execute_all(ctx):
                    mask = b.row_mask
                    ectx = EmitCtx(b.cvs(), mask.shape[0], mask.device)
                    st = a.update(a.child.emit(ectx), mask)
                    state = st if state is None else a.merge(state, st)
                if state is None:          # empty build: nothing matches
                    state = (torch.zeros(a.num_bits, dtype=torch.bool,
                                         device=ctx.device),)
            self._bits = state[0]
        return self._bits

    def _probe(self, bits, batch: DeviceBatch):
        mask = batch.row_mask
        cv = self.stream_key.emit(EmitCtx(batch.cvs(), mask.shape[0],
                                          mask.device))
        nb = self._agg.num_bits
        hit = cv.validity
        for pos in bloom_positions(cv, self.stream_key.dtype, self._agg.k,
                                   nb):
            hit = hit & bits[pos.clamp(0, nb - 1)]
        return mask & hit

    def execute_partition(self, ctx: ExecContext,
                          pid: int) -> Iterator[DeviceBatch]:
        bits = self._ensure_filter(ctx)
        for batch in self.children[0].execute_partition(ctx, pid):
            with ctx.timer(self._op_id, "bloomProbeTime"):
                new_mask = self._probe(bits, batch)
            ctx.add_metric(self._op_id, "numOutputBatches", 1)
            yield DeviceBatch(batch.table, batch.num_rows, new_mask)
