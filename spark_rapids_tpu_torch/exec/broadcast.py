"""Broadcast exchange: the build side of a broadcast hash join, collected
once.

The port of the JAX package's `exec/broadcast.py` `BroadcastExchangeExec`
(`:58`) on its synchronous path: the first `execute_partition` runs every
partition of the child and keeps the batches on the device; every later
call hands out the same batches. The JAX package's async build, which
materializes on a background thread while the join's stream side scans
(`sql.exec.exchange.asyncBroadcast.enabled`, `:99-165`), is not ported:
here the join builds first, then probes.
"""
from __future__ import annotations

from typing import List, Optional

from .base import ExecContext, TpuExec

__all__ = ["BroadcastExchangeExec"]


class BroadcastExchangeExec(TpuExec):
    def __init__(self, child: TpuExec, schema):
        super().__init__([child], schema)
        self._batches: Optional[List] = None

    def num_partitions(self, ctx):
        return 1

    def _materialize(self, ctx: ExecContext) -> List:
        if self._batches is None:
            child = self.children[0]
            out = []
            with ctx.timer(self._op_id, "buildTime"):
                for bpid in range(child.num_partitions(ctx)):
                    out.extend(child.execute_partition(ctx, bpid))
            ctx.add_metric(self._op_id, "numOutputBatches", len(out))
            self._batches = out
        return self._batches

    def execute_partition(self, ctx: ExecContext, pid: int):
        yield from self._materialize(ctx)
