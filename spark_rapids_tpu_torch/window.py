"""Window function API: WindowSpec and window expressions.

The port's copy of the JAX package's `window.py`, pyspark.sql.Window
naming. Frames:

  - ROWS BETWEEN a AND b (bounded or unbounded, every aggregate,
    min/max too)
  - RANGE BETWEEN a AND b over one numeric, date or timestamp order key
  - Spark's default frame: RANGE UNBOUNDED PRECEDING .. CURRENT ROW when
    ordered (peer rows included), the whole partition when unordered
  - lag / lead, the ranking functions (row_number, rank, dense_rank,
    percent_rank, cume_dist, ntile), first_value / last_value / nth_value

    from spark_rapids_tpu_torch.window import Window, row_number
    w = Window.partition_by("k").order_by("ts")
    df.select(F.col("v"), row_number().over(w).alias("rn"))

`DataFrame.select` lifts the window expressions into a `WindowOp` node;
the planner runs one `WindowExec` (`exec/window.py`) per distinct
(partition, order) spec.
"""
from __future__ import annotations

from typing import Optional

from .columnar import dtypes as dt
from .expr.expressions import Expression, UnsupportedExpr, _wrap
from .plan.logical import SortOrder

__all__ = ["Window", "WindowSpec", "WindowExpr", "row_number", "rank",
           "dense_rank", "percent_rank", "cume_dist", "ntile", "lag",
           "lead", "first_value", "last_value", "nth_value", "win_sum",
           "win_count", "win_min", "win_max", "win_avg", "CURRENT_ROW",
           "UNBOUNDED"]

UNBOUNDED = object()
CURRENT_ROW = 0


class WindowSpec:
    """frame_mode: "rows", "range", or None (Spark's default, resolved at
    bind: the whole partition when unordered, RANGE UNBOUNDED .. CURRENT
    ROW, peers included, when ordered)."""

    def __init__(self, partition_keys=(), orders=(), frame=None,
                 frame_mode=None):
        self.partition_keys = list(partition_keys)
        self.orders = list(orders)
        self.frame = frame
        self.frame_mode = frame_mode

    def partition_by(self, *keys) -> "WindowSpec":
        from .functions import _to_expr
        return WindowSpec([_to_expr(k) for k in keys], self.orders,
                          self.frame, self.frame_mode)

    def order_by(self, *orders) -> "WindowSpec":
        from .functions import _to_expr
        sos = [o if isinstance(o, SortOrder) else SortOrder(_to_expr(o),
                                                           True)
               for o in orders]
        return WindowSpec(self.partition_keys, sos, self.frame,
                          self.frame_mode)

    def rows_between(self, start, end) -> "WindowSpec":
        return WindowSpec(self.partition_keys, self.orders, (start, end),
                          "rows")

    def range_between(self, start, end) -> "WindowSpec":
        return WindowSpec(self.partition_keys, self.orders, (start, end),
                          "range")


class _WindowBuilder:
    """`Window.partition_by(...)` / `Window.order_by(...)`, pyspark's
    class-method style."""

    @staticmethod
    def partition_by(*keys) -> WindowSpec:
        return WindowSpec().partition_by(*keys)

    @staticmethod
    def order_by(*orders) -> WindowSpec:
        return WindowSpec().order_by(*orders)

    unboundedPreceding = UNBOUNDED
    unboundedFollowing = UNBOUNDED
    currentRow = CURRENT_ROW


Window = _WindowBuilder


class WindowExpr(Expression):
    """fn OVER spec; bound by the WindowOp logical node."""

    FNS = ("row_number", "rank", "dense_rank", "percent_rank",
           "cume_dist", "ntile", "lag", "lead", "first_value",
           "last_value", "nth_value", "sum", "count", "min", "max", "avg")
    RANKING = ("row_number", "rank", "dense_rank", "percent_rank",
               "cume_dist", "ntile")
    AGGS = ("sum", "count", "min", "max", "avg")

    def __init__(self, fn: str, child: Optional[Expression],
                 spec: WindowSpec, offset: int = 1, default=None):
        assert fn in self.FNS
        self.fn = fn
        self.child = child
        self.spec = spec
        self.offset = offset
        self.default = default
        self.children = [c for c in [child] if c is not None]

    def bind(self, schema):
        frame, mode = self.spec.frame, self.spec.frame_mode
        if mode is None:
            if self.spec.orders:
                frame, mode = (UNBOUNDED, CURRENT_ROW), "range"
            else:
                frame, mode = (UNBOUNDED, UNBOUNDED), "rows"
        b = WindowExpr(self.fn,
                       self.child.bind(schema) if self.child else None,
                       WindowSpec(
                           [k.bind(schema) for k in self.spec.partition_keys],
                           [SortOrder(o.expr.bind(schema), o.ascending,
                                      o.nulls_first)
                            for o in self.spec.orders],
                           frame, mode),
                       self.offset, self.default)
        if b.child is not None and b.child.dtype.is_nested:
            # the JAX planner's type signature for a window input:
            # numeric, date, timestamp, string, boolean or null
            raise UnsupportedExpr(
                f"window {self.fn} over {b.child.dtype}")
        if self.fn in self.RANKING:
            if not b.spec.orders:
                raise UnsupportedExpr(f"{self.fn} requires ORDER BY")
            b.dtype = (dt.FLOAT64 if self.fn in ("percent_rank",
                                                 "cume_dist") else dt.INT32)
        elif self.fn in ("lag", "lead", "first_value", "last_value",
                         "nth_value"):
            b.dtype = b.child.dtype
        else:
            if b.child.dtype.is_variable_width:
                raise UnsupportedExpr(f"window {self.fn} over strings")
            if self.fn == "count":
                b.dtype = dt.INT64
            elif self.fn == "avg":
                b.dtype = dt.FLOAT64
            else:
                from .expr.aggregates import Max, Min, Sum
                proto = {"sum": Sum, "min": Min, "max": Max}[self.fn](
                    b.child)
                proto._resolve_type()
                b.dtype = proto.dtype
        return b

    @property
    def name(self):
        return f"{self.fn}()"

    def __repr__(self):
        return f"{self.fn}(...) OVER (...)"


class _PendingWindowFn:
    """A window function waiting for its `over(spec)`."""

    def __init__(self, fn, child=None, offset=1, default=None):
        self.fn = fn
        self.child = child
        self.offset = offset
        self.default = default

    def over(self, spec: WindowSpec) -> WindowExpr:
        return WindowExpr(self.fn, self.child, spec, self.offset,
                          self.default)


def row_number():
    return _PendingWindowFn("row_number")


def rank():
    return _PendingWindowFn("rank")


def dense_rank():
    return _PendingWindowFn("dense_rank")


def percent_rank():
    return _PendingWindowFn("percent_rank")


def cume_dist():
    return _PendingWindowFn("cume_dist")


def ntile(n: int):
    if n <= 0:
        raise ValueError("ntile bucket count must be positive")
    return _PendingWindowFn("ntile", offset=n)


def lag(e, offset: int = 1, default=None):
    return _PendingWindowFn("lag", _wrap(e), offset, default)


def lead(e, offset: int = 1, default=None):
    return _PendingWindowFn("lead", _wrap(e), offset, default)


def first_value(e):
    return _PendingWindowFn("first_value", _wrap(e))


def last_value(e):
    return _PendingWindowFn("last_value", _wrap(e))


def nth_value(e, n: int):
    if n <= 0:
        raise ValueError("nth_value n must be positive")
    return _PendingWindowFn("nth_value", _wrap(e), offset=n)


def win_sum(e):
    return _PendingWindowFn("sum", _wrap(e))


def win_count(e):
    return _PendingWindowFn("count", _wrap(e))


def win_min(e):
    return _PendingWindowFn("min", _wrap(e))


def win_max(e):
    return _PendingWindowFn("max", _wrap(e))


def win_avg(e):
    return _PendingWindowFn("avg", _wrap(e))
