"""Column functions (`import spark_rapids_tpu_torch.functions as F`): the
ported subset of pyspark.sql.functions."""
from __future__ import annotations

from .expr import aggregates as _agg
from .expr.expressions import Expression, col, lit

__all__ = ["col", "lit", "sum", "count", "avg", "mean"]


def sum(e):  # noqa: A001 - match pyspark naming
    return _agg.Sum(_to_expr(e))


def count(e):
    if isinstance(e, str) and e == "*":
        return _agg.CountStar()
    return _agg.Count(_to_expr(e))


def avg(e):
    return _agg.Avg(_to_expr(e))


mean = avg


def _to_expr(e) -> Expression:
    if isinstance(e, Expression):
        return e
    if isinstance(e, str):
        return col(e)
    return lit(e)
