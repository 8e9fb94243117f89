"""Batch coalescing: small batches concatenate on the device toward a
target row count; a batch already at half the target passes through
untouched. Row masks are compacted away during the concatenation."""
from __future__ import annotations

from typing import List

import torch

from ..ops.concat import concat_cvs
from ..ops.gather import compact
from .base import ExecContext, TpuExec
from .batch import DeviceBatch
from .nodes import make_table

__all__ = ["CoalesceBatchesExec", "concat_batches"]


def concat_batches(batches: List[DeviceBatch], schema) -> DeviceBatch:
    """One batch of the live rows of `batches`, in order."""
    if len(batches) == 1:
        return batches[0]
    cvs = [concat_cvs([b.cvs()[i] for b in batches], f.dtype)
           for i, f in enumerate(schema.fields)]
    mask = torch.cat([b.row_mask for b in batches])
    out_cvs, n = compact(cvs, mask)
    return DeviceBatch(make_table(schema, out_cvs, n), n, device=mask.device)


class CoalesceBatchesExec(TpuExec):
    def __init__(self, child: TpuExec, target_rows: int, fan_in: int = 1):
        """fan_in: how many child partitions each output partition drains
        (merging across small files needs cross-partition coalescing)."""
        super().__init__([child], child.schema)
        self.target = target_rows
        self.fan_in = max(1, fan_in)

    def describe(self):
        return (f"CoalesceBatchesExec[target={self.target}, "
                f"fanIn={self.fan_in}]")

    def num_partitions(self, ctx):
        n = self.children[0].num_partitions(ctx)
        return max(1, -(-n // self.fan_in))

    def _child_batches(self, ctx, pid):
        child = self.children[0]
        n = child.num_partitions(ctx)
        for cpid in range(pid * self.fan_in,
                          min((pid + 1) * self.fan_in, n)):
            yield from child.execute_partition(ctx, cpid)

    def execute_partition(self, ctx: ExecContext, pid: int):
        pending: List[DeviceBatch] = []
        pending_rows = 0
        for batch in self._child_batches(ctx, pid):
            if batch.num_rows >= self.target // 2 and not pending:
                yield batch
                continue
            pending.append(batch)
            pending_rows += batch.num_rows
            if pending_rows >= self.target:
                yield concat_batches(pending, self.schema)
                pending, pending_rows = [], 0
        if pending:
            yield concat_batches(pending, self.schema)
