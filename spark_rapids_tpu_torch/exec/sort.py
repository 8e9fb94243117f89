"""Sort execution, in core or out of core.

The port of the JAX package's `exec/sort.py` `SortExec` (`:118-231`):
every batch of every child partition is parked in the spill store (so
the device budget bounds the input while its exact size is measured).
In core, the batches concatenate on the device, then one stable sort of
the normalized order keys (Spark's null ordering, NaN greatest,
descending by complement, dead rows last) and one gather of every
column: one batch with the live rows first, in order. Above
`sql.sort.outOfCore.thresholdBytes` of input, when the leading order is
ascending, nulls first, on a one-word fixed-width key, the sort goes
out of core: a `RangeShuffleExchangeExec` over the handles cuts the
input into max(2, 2 x total // threshold + 1) key ranges
(`oocRangePartitions`), the handles close once it has mapped them, and
each range sorts alone and is emitted in range order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar.table import Schema
from ..config import SORT_OOC_ENABLED, SORT_OOC_THRESHOLD
from ..expr.expressions import EmitCtx
from ..memory.retry import retry_no_split
from ..ops import sortkeys as sk
from ..ops.concat import concat_cvs, concat_masks
from ..ops.gather import take
from ..ops.kernel_utils import CV
from .base import ExecContext, TpuExec, collapse_fusable
from .batch import DeviceBatch
from .exchange import RangeShuffleExchangeExec, range_key_ok
from .nodes import make_table

__all__ = ["SortExec", "sort_batch_cvs"]


def _order_key_arrays(key_cvs, orders, nchunks):
    """(key tensors, their widths) of the sort orders: per order, the
    null key then the order keys."""
    arrays, widths = [], []
    for kcv, o, nc in zip(key_cvs, orders, nchunks):
        vkey = kcv.validity.to(torch.uint8)
        arrays.append(vkey if o.nulls_first else ~vkey)
        arrays += sk.order_keys(kcv, o.expr.dtype, nc,
                                descending=not o.ascending)
        widths += [None] + sk.key_widths(o.expr.dtype, nc)
    return arrays, widths


def sort_batch_cvs(cvs: Sequence[CV], mask: torch.Tensor, orders,
                   nchunks) -> Tuple[List[CV], torch.Tensor]:
    """(sorted cvs, out mask): the live rows first, in the requested
    order."""
    ctx = EmitCtx(list(cvs), mask.shape[0], mask.device)
    key_cvs = [o.expr.emit(ctx) for o in orders]
    arrays, widths = _order_key_arrays(key_cvs, orders, nchunks)
    perm = sk.lexsort([(~mask).to(torch.uint8)] + arrays, [None] + widths)
    live_sorted = mask[perm]
    return [take(cv, perm, in_bounds=live_sorted) for cv in cvs], \
        live_sorted


class SortExec(TpuExec):
    def __init__(self, child: TpuExec, bound_orders, schema: Schema):
        super().__init__([child], schema)
        self.orders = list(bound_orders)
        self._base = None
        self._stages = None

    def describe(self):
        return f"SortExec[{self.orders}]"

    def num_partitions(self, ctx):
        return 1

    def _nchunks(self, cvs, mask) -> Tuple[int, ...]:
        """String-chunk counts of the order keys: one host read."""
        ctx = EmitCtx(list(cvs), mask.shape[0], mask.device)
        dtypes = [o.expr.dtype for o in self.orders]
        return sk.key_nchunks([o.expr.emit(ctx) if t.is_variable_width
                               else None
                               for o, t in zip(self.orders, dtypes)],
                              dtypes, mask)

    def _ooc_eligible(self, ctx: ExecContext) -> bool:
        """Range bounds follow the key's ascending order with nulls in
        partition 0; other leading orders sort in core."""
        if not ctx.conf.get(SORT_OOC_ENABLED):
            return False
        o0 = self.orders[0]
        return o0.ascending and o0.nulls_first \
            and range_key_ok(o0.expr.dtype)

    def _sort_one(self, ctx: ExecContext, cvs, mask) -> DeviceBatch:
        with ctx.timer(self._op_id, "sortTime"):
            out, out_mask = sort_batch_cvs(cvs, mask, self.orders,
                                           self._nchunks(cvs, mask))
            cap = out_mask.shape[0]
        return DeviceBatch(make_table(self.schema, out, cap), cap, out_mask)

    def execute_partition(self, ctx: ExecContext, pid: int):
        if self._base is None:
            self._base, self._stages, _ = collapse_fusable(
                self.children[0])
        store, dm = ctx.spill_store, ctx.device_manager
        handles, total = [], 0
        try:
            for cpid in range(self._base.num_partitions(ctx)):
                for b in self._base.execute_partition(ctx, cpid):
                    cvs, mask = self._stages(b.cvs(), b.row_mask)
                    batch = DeviceBatch(make_table(self.schema, cvs,
                                                   mask.shape[0]),
                                        b.num_rows, mask)
                    handles.append(ctx.track(retry_no_split(
                        lambda b=batch: store.add_batch(b), dm=dm)))
                    total += batch.nbytes
            if not handles:
                return
            thr = ctx.conf.get(SORT_OOC_THRESHOLD)
            if total > thr and self._ooc_eligible(ctx):
                nparts = max(2, int(2 * total // max(thr, 1)) + 1)
                ctx.add_metric(self._op_id, "oocRangePartitions", nparts)
                yield from self._execute_out_of_core(ctx, handles, nparts)
                return
            batches = [h.materialize() for h in handles]
            with ctx.timer(self._op_id, "sortTime"):
                if len(batches) == 1:
                    cvs, mask = batches[0].cvs(), batches[0].row_mask
                else:
                    cvs = [concat_cvs([b.cvs()[i] for b in batches],
                                      f.dtype)
                           for i, f in enumerate(self.schema.fields)]
                    mask = concat_masks([b.row_mask for b in batches])
            del batches
            yield self._sort_one(ctx, cvs, mask)
        finally:
            for h in handles:
                h.close()

    def _execute_out_of_core(self, ctx: ExecContext, handles, nparts):
        ex = RangeShuffleExchangeExec(
            _HandleScanExec(handles, self.schema), nparts,
            [self.orders[0].expr], self.schema)
        try:
            ex.stage_stats(ctx)             # the map: the input is on host
            for h in handles:
                h.close()
            for rp in range(nparts):        # partitions are range-ordered
                for batch in ex.execute_partition(ctx, rp):
                    yield self._sort_one(ctx, batch.cvs(), batch.row_mask)
        finally:
            ex.release()


class _HandleScanExec(TpuExec):
    """Serves spill-store handles as batches, one child partition per
    handle (the out-of-core sort's range exchange reads it)."""

    def __init__(self, handles, schema: Schema):
        super().__init__([], schema)
        self.handles = list(handles)

    def num_partitions(self, ctx):
        return max(1, len(self.handles))

    def execute_partition(self, ctx, pid):
        if pid < len(self.handles):
            yield self.handles[pid].materialize()
