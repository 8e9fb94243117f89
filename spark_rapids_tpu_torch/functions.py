"""Column functions (`import spark_rapids_tpu_torch.functions as F`): the
ported subset of pyspark.sql.functions."""
from __future__ import annotations

from .expr import aggregates as _agg
from .expr import string_exprs as _se
from .expr.expressions import CaseWhen, Expression, Literal, col, lit

__all__ = ["col", "lit", "sum", "count", "countDistinct",
           "count_distinct", "min", "max", "avg", "mean",
           "when", "substring", "contains", "startswith", "endswith",
           "like"]


def sum(e):  # noqa: A001 - match pyspark naming
    return _agg.Sum(_to_expr(e))


def count(e):
    if isinstance(e, str) and e == "*":
        return _agg.CountStar()
    return _agg.Count(_to_expr(e))


def countDistinct(e):
    return _agg.CountDistinct(_to_expr(e))


count_distinct = countDistinct


def min(e):  # noqa: A001
    return _agg.Min(_to_expr(e))


def max(e):  # noqa: A001
    return _agg.Max(_to_expr(e))


def avg(e):
    return _agg.Avg(_to_expr(e))


mean = avg


def _to_expr(e) -> Expression:
    if isinstance(e, Expression):
        return e
    if isinstance(e, str):
        return col(e)
    return lit(e)


class _WhenBuilder:
    """`when(c, v).when(...).otherwise(d)`; an unfinished chain serves as
    the CASE WHEN without ELSE (null)."""

    def __init__(self, branches):
        self._branches = branches

    def when(self, cond, value):
        return _WhenBuilder(self._branches + [(_to_expr(cond),
                                               _to_expr(value))])

    def otherwise(self, value):
        return CaseWhen(self._branches, _to_expr(value))

    def __getattr__(self, item):
        return getattr(CaseWhen(self._branches, None), item)


def when(cond, value):
    return _WhenBuilder([(_to_expr(cond), _to_expr(value))])


def substring(e, start, length=None):
    return _se.Substring(_to_expr(e), start, length)


def _to_pattern(p):
    # a pattern argument is a literal, not a column name
    return Literal(p) if isinstance(p, (str, bytes)) else _to_expr(p)


def contains(e, pattern):
    return _se.Contains(_to_expr(e), _to_pattern(pattern))


def startswith(e, pattern):
    return _se.StartsWith(_to_expr(e), _to_pattern(pattern))


def endswith(e, pattern):
    return _se.EndsWith(_to_expr(e), _to_pattern(pattern))


def like(e, pattern: str):
    return _se.Like(_to_expr(e), pattern)
