"""Sort execution, in core.

The port of the JAX package's `exec/sort.py` `SortExec` without its
out-of-core path (which waits for the memory runtime): every batch of
every child partition concatenates on the device, then one stable sort
of the normalized order keys (Spark's null ordering, NaN greatest,
descending by complement, dead rows last) and one gather of every
column. The output is one batch with the live rows first, in order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..columnar.table import Schema
from ..expr.expressions import EmitCtx
from ..ops import sortkeys as sk
from ..ops.concat import concat_cvs, concat_masks
from ..ops.gather import take
from ..ops.kernel_utils import CV
from .base import ExecContext, TpuExec, collapse_fusable
from .batch import DeviceBatch
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

    def execute_partition(self, ctx: ExecContext, pid: int):
        if self._base is None:
            self._base, self._stages, _ = collapse_fusable(
                self.children[0])
        batches = []
        for cpid in range(self._base.num_partitions(ctx)):
            for b in self._base.execute_partition(ctx, cpid):
                cvs, mask = self._stages(b.cvs(), b.row_mask)
                batches.append((cvs, mask))
        if not batches:
            return
        with ctx.timer(self._op_id, "sortTime"):
            if len(batches) == 1:
                cvs, mask = batches[0]
            else:
                cvs = [concat_cvs([b[0][i] for b in batches], f.dtype)
                       for i, f in enumerate(self.schema.fields)]
                mask = concat_masks([b[1] for b in batches])
            out, out_mask = sort_batch_cvs(cvs, mask, self.orders,
                                           self._nchunks(cvs, mask))
            cap = out_mask.shape[0]
        yield DeviceBatch(make_table(self.schema, out, cap), cap, out_mask)
