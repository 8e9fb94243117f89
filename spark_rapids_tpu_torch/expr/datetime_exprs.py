"""Date and time expressions: the port's copy of the JAX package's
`expr/datetime_exprs.py`, with its binding rules.

The fields (year, month, dayofmonth, dayofweek, dayofyear, quarter) take
a date or a timestamp (its UTC day); hour, minute and second take a
timestamp. date_add / date_sub take a date and an integral count,
datediff two dates, last_day a date. to_date and to_timestamp take a
date, a timestamp or a string ('YYYY-MM-DD[ HH:MM:SS]', as the casts
parse it). from_utc_timestamp / to_utc_timestamp shift a timestamp by
the zone's offset at each row, from the TZif tables of `utils/tzdb.py`
on the batch's device: one searchsorted and one gather a batch. A zone
the database does not know raises UnsupportedExpr at bind, as in the
JAX package.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..ops import datetime as ops_dt
from ..ops.kernel_utils import CV
from .expressions import Expression, UnsupportedExpr, _BinaryOp, _UnaryOp

__all__ = ["Year", "Month", "DayOfMonth", "DayOfWeek", "DayOfYear",
           "FromUTCTimestamp", "ToUTCTimestamp",
           "Quarter", "Hour", "Minute", "Second", "DateAdd", "DateSub",
           "DateDiff", "LastDay", "ToDate", "ToTimestamp"]


class _DateField(_UnaryOp):
    kernel = None

    def _resolve_type(self):
        ct = self.child.dtype
        if not isinstance(ct, (dt.DateType, dt.TimestampType)):
            raise UnsupportedExpr(f"{type(self).__name__}({ct})")
        self.dtype = dt.INT32

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        days = (ops_dt.micros_to_days(cv.data)
                if isinstance(self.child.dtype, dt.TimestampType)
                else cv.data)
        return CV(type(self).kernel(days), cv.validity)

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.child})"


class Year(_DateField):
    kernel = staticmethod(ops_dt.year)


class Month(_DateField):
    kernel = staticmethod(ops_dt.month)


class DayOfMonth(_DateField):
    kernel = staticmethod(ops_dt.day)


class DayOfWeek(_DateField):
    kernel = staticmethod(ops_dt.day_of_week)


class DayOfYear(_DateField):
    kernel = staticmethod(ops_dt.day_of_year)


class Quarter(_DateField):
    kernel = staticmethod(ops_dt.quarter)


class _TimeField(_UnaryOp):
    kernel = None

    def _resolve_type(self):
        if not isinstance(self.child.dtype, dt.TimestampType):
            raise UnsupportedExpr(f"{type(self).__name__} needs timestamp")
        self.dtype = dt.INT32

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        return CV(type(self).kernel(cv.data), cv.validity)

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.child})"


class Hour(_TimeField):
    kernel = staticmethod(ops_dt.hour)


class Minute(_TimeField):
    kernel = staticmethod(ops_dt.minute)


class Second(_TimeField):
    kernel = staticmethod(ops_dt.second)


class _DateDelta(_BinaryOp):
    sign = 1

    def _resolve_type(self):
        if not isinstance(self.left.dtype, dt.DateType):
            raise UnsupportedExpr("date_add/sub needs a date")
        if not self.right.dtype.is_integral:
            raise UnsupportedExpr("date_add/sub delta must be integral")
        self.dtype = dt.DATE

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        out = l.data + self.sign * r.data.to(torch.int32)
        return CV(out.to(torch.int32), l.validity & r.validity)


class DateAdd(_DateDelta):
    sign = 1
    symbol = "date_add"


class DateSub(_DateDelta):
    sign = -1
    symbol = "date_sub"


class DateDiff(_BinaryOp):
    symbol = "datediff"

    def _resolve_type(self):
        if not (isinstance(self.left.dtype, dt.DateType)
                and isinstance(self.right.dtype, dt.DateType)):
            raise UnsupportedExpr("datediff needs dates")
        self.dtype = dt.INT32

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        return CV((l.data - r.data).to(torch.int32), l.validity & r.validity)


class LastDay(_UnaryOp):
    def _resolve_type(self):
        if not isinstance(self.child.dtype, dt.DateType):
            raise UnsupportedExpr("last_day needs a date")
        self.dtype = dt.DATE

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        return CV(ops_dt.last_day(cv.data), cv.validity)

    def __repr__(self):
        return f"last_day({self.child})"


class ToDate(_UnaryOp):
    def _resolve_type(self):
        ct = self.child.dtype
        if not isinstance(ct, (dt.DateType, dt.TimestampType,
                               dt.StringType)):
            raise UnsupportedExpr(f"to_date({ct})")
        self.dtype = dt.DATE

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        if isinstance(self.child.dtype, dt.TimestampType):
            return CV(ops_dt.micros_to_days(cv.data), cv.validity)
        if isinstance(self.child.dtype, dt.StringType):
            from ..ops.cast_strings import string_to_date
            return string_to_date(cv)
        return cv

    def __repr__(self):
        return f"to_date({self.child})"


class ToTimestamp(_UnaryOp):
    def _resolve_type(self):
        ct = self.child.dtype
        if not isinstance(ct, (dt.TimestampType, dt.DateType,
                               dt.StringType)):
            raise UnsupportedExpr(f"to_timestamp({ct})")
        self.dtype = dt.TIMESTAMP

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        ct = self.child.dtype
        if isinstance(ct, dt.TimestampType):
            return cv
        if isinstance(ct, dt.DateType):
            return CV(cv.data.to(torch.int64) * ops_dt.MICROS_PER_DAY,
                      cv.validity)
        from ..ops.cast_strings import string_to_timestamp
        return string_to_timestamp(cv)

    def __repr__(self):
        return f"to_timestamp({self.child})"


class _TzConvert(Expression):
    """from_utc_timestamp / to_utc_timestamp over the zone's transition
    tables (the module docstring)."""

    to_utc = False

    def __init__(self, child: Expression, tz: str):
        self.child = child
        self.tz = tz
        self.children = [child]

    def bind(self, schema):
        b = type(self)(self.child.bind(schema), self.tz)
        if not isinstance(b.child.dtype, dt.TimestampType):
            raise UnsupportedExpr(
                f"{type(self).__name__} on {b.child.dtype}")
        from ..utils.tzdb import load_transitions
        try:
            load_transitions(self.tz)
        except ValueError as e:
            raise UnsupportedExpr(str(e)) from e
        b.dtype = dt.TIMESTAMP
        return b

    def emit(self, ctx):
        from ..utils.tzdb import device_tables
        trans, offs = device_tables(self.tz, self.to_utc, ctx.device)
        cv = self.child.emit(ctx)
        idx = torch.searchsorted(trans, cv.data, right=True) - 1
        off = offs[idx.clamp(0, offs.shape[0] - 1)]
        out = cv.data - off if self.to_utc else cv.data + off
        return CV(out, cv.validity)

    def __repr__(self):
        fn = "to_utc_timestamp" if self.to_utc else "from_utc_timestamp"
        return f"{fn}({self.child}, {self.tz!r})"


class FromUTCTimestamp(_TzConvert):
    to_utc = False


class ToUTCTimestamp(_TzConvert):
    to_utc = True
