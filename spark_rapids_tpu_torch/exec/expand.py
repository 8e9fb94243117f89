"""ExpandExec: the row expansion of GROUPING SETS, ROLLUP and CUBE
(reference: GpuExpandExec.scala; the port of the JAX package's
`exec/expand.py`).

Each input batch comes out once per grouping set, the copies one after
another: the child's columns repeated, then each grouping key (a key
the set excludes is an all-null column with zeroed buffers, since the
grouping compares data under the validity and stale data would split a
subtotal's group), then the set's grouping id, with bit nk - 1 - i set
where key i is excluded (Spark's grouping_id). The aggregate above
groups by the keys and the id, so a subtotal row never merges with a
detail row whose key is a real null.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.table import Schema
from ..expr.expressions import EmitCtx, Expression
from ..ops.concat import concat_cvs, concat_masks
from ..ops.gather import null_like
from ..ops.kernel_utils import CV
from .base import ExecContext, TpuExec
from .batch import DeviceBatch
from .nodes import make_table

__all__ = ["ExpandExec"]


class ExpandExec(TpuExec):
    def __init__(self, child: TpuExec, bound_keys: Sequence[Expression],
                 include_masks: Sequence[Sequence[bool]], schema: Schema):
        super().__init__([child], schema)
        self.bound_keys = list(bound_keys)
        self.include_masks = [tuple(m) for m in include_masks]
        nk = len(self.bound_keys)
        self.gids = [sum((0 if inc else 1) << (nk - 1 - i)
                         for i, inc in enumerate(m))
                     for m in self.include_masks]

    def describe(self):
        return (f"ExpandExec[{len(self.include_masks)} sets, "
                f"keys={[k.name for k in self.bound_keys]}]")

    def num_partitions(self, ctx):
        return self.children[0].num_partitions(ctx)

    def _expand(self, cvs, mask):
        cap, dev = mask.shape[0], mask.device
        n_sets = len(self.include_masks)
        ctx = EmitCtx(list(cvs), cap, dev)
        kcvs = [k.emit(ctx) for k in self.bound_keys]
        fields = self.schema.fields
        out = [concat_cvs([cv] * n_sets, f.dtype)
               for cv, f in zip(cvs, fields)]
        for i, kcv in enumerate(kcvs):
            none = null_like(kcv, cap)
            out.append(concat_cvs([kcv if m[i] else none
                                   for m in self.include_masks],
                                  fields[len(cvs) + i].dtype))
        gid = torch.cat([torch.full((cap,), g, dtype=torch.int64,
                                    device=dev) for g in self.gids])
        out.append(CV(gid, torch.ones(cap * n_sets, dtype=torch.bool,
                                      device=dev)))
        return out, concat_masks([mask] * n_sets)

    def execute_partition(self, ctx: ExecContext, pid: int):
        n_sets = len(self.include_masks)
        for batch in self.children[0].execute_partition(ctx, pid):
            with ctx.timer(self._op_id, "opTime"):
                out, out_mask = self._expand(batch.cvs(), batch.row_mask)
            n = batch.capacity * n_sets
            ctx.add_metric(self._op_id, "numOutputBatches", 1)
            ctx.add_metric(self._op_id, "numOutputRows",
                           batch.num_rows * n_sets)
            yield DeviceBatch(make_table(self.schema, out, n), n, out_mask)
