"""GenerateExec: explode and posexplode (and their _outer forms) over
list and map columns (reference: GpuGenerateExec.scala; the port of the
JAX package's `exec/generate.py`).

Per batch: the generator's array and each live row's fan-out (its
element count; at least one row under _outer), their cumsum as the
output offsets, then one host read of the output's row count and of
the variable-width sizes of the parent columns repeated that many times.
Each output row maps to its parent row (`row_of_unit` over the output
offsets) and to its element; the parent columns are gathered by parent
row, the element (or a map entry's key and value) by element position.
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar import dtypes as dt
from ..columnar.table import Schema
from ..expr.collection_exprs import _take_elems, arr_lens
from ..expr.expressions import EmitCtx
from ..ops import gather as ops_gather
from ..ops.kernel_utils import CV
from ..utils import transfer
from .base import TpuExec
from .batch import DeviceBatch
from .nodes import make_table

__all__ = ["GenerateExec"]


class GenerateExec(TpuExec):
    def __init__(self, child: TpuExec, bound_gen, schema: Schema):
        super().__init__([child], schema)
        self.gen = bound_gen                  # bound Explode / PosExplode
        self.outer = bound_gen.outer
        self.with_pos = bound_gen.with_position
        self.is_map = isinstance(bound_gen.child.dtype, dt.MapType)

    def describe(self):
        mode = "posexplode" if self.with_pos else "explode"
        if self.outer:
            mode += "_outer"
        return f"GenerateExec[{mode}({self.gen.child!r})]"

    def _generate(self, cvs: List[CV], mask: torch.Tensor):
        cap, dev = mask.shape[0], mask.device
        arr = self.gen.child.emit(EmitCtx(cvs, cap, dev))
        lens = torch.where(mask, arr_lens(arr), 0).to(torch.int64)
        # an empty or null array of a live row still gives one (null)
        # row under _outer
        eff = torch.where(mask, lens.clamp(min=1), 0) if self.outer \
            else lens
        out_off = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        torch.cumsum(eff, 0, out=out_off[1:])
        measures = [ops_gather.repeat_measures(cv, eff) for cv in cvs]
        got = iter(transfer.fetch_ints(
            [out_off[cap]] + [m for ms in measures for m in ms]))
        total = next(got)
        caps = [[next(got) for _ in ms] for ms in measures]
        j = torch.arange(total, dtype=torch.int64, device=dev)
        parent = (ops_gather.row_of_unit(out_off, cap, total) if cap
                  else torch.zeros(0, dtype=torch.int64, device=dev))
        rel = j - out_off[parent]
        elem_ok = (rel < lens[parent]) & arr.validity[parent]
        epos = arr.offsets[:-1].to(torch.int64)[parent] \
            + torch.where(elem_ok, rel, 0)
        outs = [ops_gather.take(cv, parent, None,
                                iter(ck) if ck else None)
                for cv, ck in zip(cvs, caps)]
        if self.with_pos:
            outs.append(CV(rel.to(torch.int32), elem_ok))
        if self.is_map:
            outs += [_take_elems(c, epos, elem_ok)
                     for c in arr.child.children]
        else:
            outs.append(_take_elems(arr.child, epos, elem_ok))
        return outs, total

    def execute_partition(self, ctx, pid):
        for batch in self.children[0].execute_partition(ctx, pid):
            with ctx.timer(self._op_id, "opTime"):
                outs, total = self._generate(batch.cvs(), batch.row_mask)
            ctx.add_metric(self._op_id, "numOutputRows", total)
            ctx.add_metric(self._op_id, "numOutputBatches", 1)
            yield DeviceBatch(make_table(self.schema, outs, total), total,
                              device=ctx.device)
