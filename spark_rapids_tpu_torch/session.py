"""Session and DataFrame: the entry points of the port.

The same surface as the JAX package's `TpuSession` for the ported slice:
`create_dataframe`, `read.parquet`, and `filter`, `select`, `agg`,
`group_by(...).agg`, `sort`, `repartition`, `to_arrow` and `collect` on
a DataFrame. A session runs on
one torch device: CUDA unless the caller asks for another. Every action
plans the logical tree afresh and executes it on that device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .columnar.table import Schema
from .config import TpuConf
from .exec.base import ExecContext
from .exec.nodes import collect_to_arrow
from .expr.aggregates import AggExpr
from .expr.expressions import Alias, Expression
from .functions import _to_expr
from .plan import logical as L
from .plan.planner import Planner

__all__ = ["TpuSession", "DataFrame", "GroupedData"]


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TpuSession runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


class TpuSession:
    def __init__(self, conf: Optional[Dict] = None, device=None):
        self.conf = TpuConf(conf)
        self.device = _resolve_device(device)
        self.read = DataFrameReader(self)

    def create_dataframe(self, data, schema=None) -> "DataFrame":
        import pyarrow as pa
        if isinstance(data, pa.Table):
            at = data
        elif isinstance(data, dict):
            if schema is not None:
                at = pa.table(data, schema=schema.to_arrow()
                              if isinstance(schema, Schema) else schema)
            else:
                at = pa.table(data)
        else:
            raise TypeError(
                "create_dataframe expects a pyarrow Table or dict")
        return DataFrame(self, L.InMemoryScan(at))


class DataFrameReader:
    def __init__(self, session: TpuSession):
        self._session = session

    def parquet(self, *paths: str, columns=None) -> "DataFrame":
        import glob as _glob
        import os
        expanded: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                expanded.extend(sorted(
                    _glob.glob(os.path.join(p, "*.parquet"))))
            elif any(ch in p for ch in "*?["):
                expanded.extend(sorted(_glob.glob(p)))
            else:
                expanded.append(p)
        return DataFrame(self._session,
                         L.ParquetScan(expanded, columns=columns))


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence[Expression]):
        self._df = df
        self._keys = list(keys)

    def agg(self, *aggs) -> "DataFrame":
        pairs = []
        for a in aggs:
            name, inner = a.name, a
            if isinstance(a, Alias):
                name, inner = a._name, a.child
            if not isinstance(inner, AggExpr):
                raise TypeError(f"not an aggregate: {a!r}")
            pairs.append((name, inner))
        return DataFrame(self._df._session,
                         L.Aggregate(self._df._plan, self._keys, pairs))


class DataFrame:
    def __init__(self, session: TpuSession, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    def select(self, *exprs) -> "DataFrame":
        return DataFrame(self._session,
                         L.Project(self._plan, [_to_expr(e) for e in exprs]))

    def filter(self, cond) -> "DataFrame":
        return DataFrame(self._session,
                         L.Filter(self._plan, _to_expr(cond)))

    def group_by(self, *keys) -> GroupedData:
        return GroupedData(self, [_to_expr(k) for k in keys])

    groupBy = group_by

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *orders, ascending=True) -> "DataFrame":
        sos = [o if isinstance(o, L.SortOrder)
               else L.SortOrder(_to_expr(o), ascending) for o in orders]
        return DataFrame(self._session, L.Sort(self._plan, sos))

    orderBy = sort

    def repartition(self, n: int, *keys) -> "DataFrame":
        ks = [_to_expr(k) for k in keys] or None
        return DataFrame(self._session, L.Repartition(self._plan, n, ks))

    def physical_plan(self):
        """(root exec, its ExecContext): a fresh plan of this DataFrame
        on the session's device."""
        s = self._session
        return Planner(s.conf).plan(self._plan), ExecContext(s.conf,
                                                             s.device)

    def to_arrow(self):
        root, ctx = self.physical_plan()
        out = collect_to_arrow(root, ctx)
        self._last_metrics = ctx.metrics
        return out

    def last_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-operator metrics of this DataFrame's most recent action:
        host seconds per layer (scanTime, decodeTime, hashPassTime,
        sortPassTime, mergeTime, mapTime, sliceTime, reduceTime, sortTime,
        collectTime) and counts (mapBatches, skippedRowGroups,
        inputBatches, hashPassBatches, sortPassBatches, mergePasses,
        numBucketRecursions)."""
        return getattr(self, "_last_metrics", {})

    def collect(self) -> List[tuple]:
        at = self.to_arrow()
        cols = [at.column(i).to_pylist() for i in range(at.num_columns)]
        return list(zip(*cols)) if cols else []
