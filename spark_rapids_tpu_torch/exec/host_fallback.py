"""Host-fallback execution nodes (the GpuCpuBridge analog).

The port's copy of the JAX package's `exec/host_fallback.py`
(reference: GpuCpuBridgeExpression.scala: unsupported expressions copy
to host rows, evaluate on the CPU and return to the device). A batch
goes to Arrow in one device-to-host copy (`nodes._batch_to_arrow`),
becomes row dicts, runs through the host interpreter
(`expr/host_eval.py`), and the result goes back to the session's device
in one copy: on CUDA the output batch is a CUDA batch. Slow and proud
of it: the alternative is a failed query.
"""
from __future__ import annotations

from typing import List, Optional

import pyarrow as pa

from ..columnar import dtypes as dt
from ..columnar.table import Schema, Table
from ..expr.host_eval import host_eval_rows
from .base import ExecContext, TpuExec
from .batch import DeviceBatch

__all__ = ["HostFilterExec", "HostProjectExec", "host_filter",
           "host_project"]


def _batch_rows(batch: DeviceBatch):
    """(Arrow table of the batch's live rows, one dict a row)."""
    import numpy as np
    import pyarrow.types as pt
    from .nodes import _batch_to_arrow
    at = _batch_to_arrow(batch)
    names = at.schema.names
    cols = []
    for i in range(at.num_columns):
        vals = at.column(i).to_pylist()
        # integers ride as WIDTH-TYPED numpy scalars so interpreter
        # arithmetic wraps like Java and the device (int32 * int32 wraps
        # at 32 bits); plain Python ints would widen without bound
        t = at.schema.types[i]
        if pt.is_integer(t):
            np_t = np.dtype(t.to_pandas_dtype()).type
            vals = [None if v is None else np_t(v) for v in vals]
        cols.append(vals)
    rows = [dict(zip(names, vals)) for vals in zip(*cols)] \
        if at.num_rows else []
    return at, rows


def _upload(at, device) -> DeviceBatch:
    return DeviceBatch(Table.from_arrow(at, device), at.num_rows,
                       device=device)


def host_filter(condition, batch: DeviceBatch,
                device) -> Optional[DeviceBatch]:
    """One batch filtered by `condition` (bound or unbound) on host rows,
    back on `device`; None when no row survives."""
    at, rows = _batch_rows(batch)
    if not rows:
        return None
    keep = host_eval_rows(condition, rows)
    mask = pa.array([bool(k) if k is not None else False for k in keep])
    filtered = at.filter(mask)
    if filtered.num_rows == 0:
        return None
    return _upload(filtered, device)


def host_project(exprs, schema: Schema, batch: DeviceBatch,
                 device) -> DeviceBatch:
    """One batch projected through `exprs` (bound or unbound) on host
    rows, as `schema`, back on `device`."""
    at, rows = _batch_rows(batch)
    arrays = [pa.array(host_eval_rows(e, rows), dt.to_arrow(f.dtype))
              for e, f in zip(exprs, schema.fields)]
    out = (pa.Table.from_arrays(arrays, names=list(schema.names))
           if arrays else pa.table({}))
    return _upload(out, device)


class HostFilterExec(TpuExec):
    """Filter whose predicate runs on host rows."""

    def __init__(self, child: TpuExec, condition, reason: str):
        super().__init__([child], child.schema)
        self.condition = condition
        self.reason = reason

    def describe(self):
        return f"HostFilterExec[{self.condition!r}]  (CPU: {self.reason})"

    def execute_partition(self, ctx: ExecContext, pid: int):
        m = ctx.metrics_for(self._op_id)
        for batch in self.children[0].execute_partition(ctx, pid):
            with m.timer("hostEvalTime"):
                out = host_filter(self.condition, batch, ctx.device)
            if out is None:
                continue
            m.add("numOutputBatches", 1)
            m.add("numOutputRows", out.num_rows)
            yield out


class HostProjectExec(TpuExec):
    """Project where SOME output expressions run on host rows; the
    supported ones evaluate there too (whole-node fallback, as in the
    JAX package; the reference bridges per expression)."""

    def __init__(self, child: TpuExec, exprs, schema: Schema, reason: str):
        super().__init__([child], schema)
        self.exprs: List = list(exprs)
        self.reason = reason

    def describe(self):
        return (f"HostProjectExec[{len(self.exprs)} exprs]  "
                f"(CPU: {self.reason})")

    def execute_partition(self, ctx: ExecContext, pid: int):
        m = ctx.metrics_for(self._op_id)
        for batch in self.children[0].execute_partition(ctx, pid):
            with m.timer("hostEvalTime"):
                out = host_project(self.exprs, self.schema, batch,
                                   ctx.device)
            m.add("numOutputBatches", 1)
            m.add("numOutputRows", out.num_rows)
            yield out
