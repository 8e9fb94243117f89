"""Expression trees: binding, Spark type coercion, and evaluation on
tensors.

The port's copy of the JAX package's expression layer: column references
(string columns included), literals (timestamps and decimal128 too),
aliases, arithmetic (+, -, *, /, %, div and pmod; decimals above
precision 18 on the exact limb kernels of `ops/decimal128.py`, a decimal
`/` by `dec_div`), negation and abs, comparisons (strings too: a literal
`=`/`!=` by length and 4-byte chunks, any other by `ops/strings.py`
`compare`; decimal128 by `dec_cmp_scaled`; a NULL literal on either side
gives an all-null result, and `<=>` the other side's null flag),
null-safe equality, the null predicates and isnan, coalesce, IF, CASE
WHEN and IN, Kleene AND/OR/NOT, the unary math functions, HALF_UP round,
greatest and least, the bitwise operations and shifts, pow and atan2,
and CAST (a type name such as "bigint" or "decimal(10,2)" too) between
the numeric, boolean, date, timestamp and string types as the JAX `Cast`
allows them. The string, date and hash functions live in
`string_exprs.py`, `datetime_exprs.py` and `hash_expr.py`.
`bind(schema)` resolves names and types exactly as the JAX package does
and refuses what it refuses (`UnsupportedExpr`); `emit(ctx)` evaluates
the bound tree eagerly and returns a CV.
"""
from __future__ import annotations

import datetime
import decimal
import math
from typing import List, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.table import Schema
from ..ops import elementwise as ew
from ..ops.kernel_utils import CV

__all__ = [
    "Expression", "UnsupportedExpr", "EmitCtx", "ColumnRef", "BoundRef",
    "Literal", "Alias", "Add", "Subtract", "Multiply", "Divide",
    "IntDivide", "Remainder", "Pmod", "Negate", "Abs", "Eq", "Ne", "Lt",
    "Le", "Gt", "Ge", "EqNullSafe", "And", "Or", "Not", "IsNull",
    "IsNotNull", "IsNaN", "Cast", "Coalesce", "If", "CaseWhen", "In",
    "MathUnary", "Round", "Greatest", "Least", "lit", "col", "BitwiseAnd",
    "BitwiseOr", "BitwiseXor", "BitwiseNot", "ShiftLeft", "ShiftRight",
    "Pow", "Atan2",
]


class UnsupportedExpr(Exception):
    """Raised at bind time when an expression cannot be evaluated."""


class EmitCtx:
    """Evaluation context: the input CVs, the batch capacity, and the
    device that literals are built on."""

    def __init__(self, cvs: Sequence[CV], capacity: int,
                 device: torch.device):
        self.cvs = list(cvs)
        self.capacity = capacity
        self.device = device
        # the values of bound lambda variables (`collection_exprs.py`'s
        # higher-order functions): variable id -> element-domain CV
        self.lambda_vals = {}


class Expression:
    children: List["Expression"] = []
    dtype: Optional[dt.DataType] = None   # set after bind

    def bind(self, schema: Schema) -> "Expression":
        raise NotImplementedError

    def emit(self, ctx: EmitCtx) -> CV:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return str(self)

    # Fluent builder API (the DataFrame `Column` surface).
    def alias(self, name):
        return Alias(self, name)

    def cast(self, dtype):
        return Cast(self, dtype)

    def __add__(self, o):
        return Add(self, _wrap(o))

    def __radd__(self, o):
        return Add(_wrap(o), self)

    def __sub__(self, o):
        return Subtract(self, _wrap(o))

    def __rsub__(self, o):
        return Subtract(_wrap(o), self)

    def __mul__(self, o):
        return Multiply(self, _wrap(o))

    def __rmul__(self, o):
        return Multiply(_wrap(o), self)

    def __truediv__(self, o):
        return Divide(self, _wrap(o))

    def __rtruediv__(self, o):
        return Divide(_wrap(o), self)

    def __mod__(self, o):
        return Remainder(self, _wrap(o))

    def __neg__(self):
        return Negate(self)

    def __eq__(self, o):  # type: ignore[override]
        return Eq(self, _wrap(o))

    def __ne__(self, o):  # type: ignore[override]
        return Ne(self, _wrap(o))

    def __lt__(self, o):
        return Lt(self, _wrap(o))

    def __le__(self, o):
        return Le(self, _wrap(o))

    def __gt__(self, o):
        return Gt(self, _wrap(o))

    def __ge__(self, o):
        return Ge(self, _wrap(o))

    def __and__(self, o):
        return And(self, _wrap(o))

    def __or__(self, o):
        return Or(self, _wrap(o))

    def __invert__(self):
        return Not(self)

    def __hash__(self):
        return id(self)

    def isNull(self):
        return IsNull(self)

    def isNotNull(self):
        return IsNotNull(self)

    def isin(self, *values):
        return In(self, [_wrap(v) for v in values])

    def between(self, lo, hi):
        return And(Ge(self, _wrap(lo)), Le(self, _wrap(hi)))

    # the string surface (imported late: string_exprs imports this module)
    def contains(self, pattern):
        from .string_exprs import Contains
        return Contains(self, _wrap(pattern))

    def startswith(self, pattern):
        from .string_exprs import StartsWith
        return StartsWith(self, _wrap(pattern))

    def endswith(self, pattern):
        from .string_exprs import EndsWith
        return EndsWith(self, _wrap(pattern))

    def like(self, pattern: str):
        from .string_exprs import Like
        return Like(self, pattern)

    def rlike(self, pattern: str):
        from .regex_exprs import RLike
        return RLike(self, pattern)

    def substr(self, start, length=None):
        from .string_exprs import Substring
        return Substring(self, start, length)

    # the collection surface (collection_exprs imports this module)
    def getItem(self, key):
        from .collection_exprs import GetArrayItem
        return GetArrayItem(self, _wrap(key))

    def getField(self, name: str):
        from .collection_exprs import GetStructField
        return GetStructField(self, name)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.getField(key)
        return self.getItem(key)


def _wrap(v) -> Expression:
    return v if isinstance(v, Expression) else Literal(v)


def col(name: str) -> "ColumnRef":
    return ColumnRef(name)


def lit(v) -> "Literal":
    return Literal(v)


# ----------------------------------------------------------------------
class ColumnRef(Expression):
    def __init__(self, name: str):
        self._name = name
        self.children = []

    @property
    def name(self):
        return self._name

    def bind(self, schema: Schema):
        idx = schema.index_of(self._name)
        return BoundRef(idx, schema[idx].dtype, self._name)

    def __repr__(self):
        return self._name


class BoundRef(Expression):
    def __init__(self, ordinal: int, dtype: dt.DataType, name: str = ""):
        self.ordinal = ordinal
        self.dtype = dtype
        self._name = name or f"c{ordinal}"
        self.children = []

    @property
    def name(self):
        return self._name

    def bind(self, schema):
        return self

    def emit(self, ctx: EmitCtx) -> CV:
        return ctx.cvs[self.ordinal]

    def __repr__(self):
        return f"{self._name}#{self.ordinal}"


def _infer_literal_dtype(v) -> dt.DataType:
    if v is None:
        return dt.NULLTYPE
    if isinstance(v, bool):
        return dt.BOOL
    if isinstance(v, int):
        return dt.INT32 if -2**31 <= v < 2**31 else dt.INT64
    if isinstance(v, float):
        return dt.FLOAT64
    if isinstance(v, str):
        return dt.STRING
    if isinstance(v, bytes):
        return dt.BINARY
    if isinstance(v, decimal.Decimal):
        sign, digits, exp = v.as_tuple()
        scale = max(0, -exp)
        precision = max(len(digits), scale)
        return dt.DecimalType(precision, scale)
    if isinstance(v, datetime.datetime):
        return dt.TIMESTAMP
    if isinstance(v, datetime.date):
        return dt.DATE
    raise UnsupportedExpr(f"cannot infer literal type for {v!r}")


class Literal(Expression):
    def __init__(self, value, dtype: Optional[dt.DataType] = None):
        self.value = value
        self.dtype = dtype or _infer_literal_dtype(value)
        self.children = []

    def bind(self, schema):
        return self

    def device_value(self):
        v, d = self.value, self.dtype
        if v is None:
            return 0
        if isinstance(d, dt.DecimalType):
            return int(decimal.Decimal(v).scaleb(d.scale).to_integral_value(
                rounding=decimal.ROUND_HALF_UP))
        if isinstance(d, dt.DateType):
            return (v - datetime.date(1970, 1, 1)).days
        if isinstance(d, dt.TimestampType):
            # the JAX package's formula: a naive datetime is UTC
            ts = v if v.tzinfo else v.replace(tzinfo=datetime.timezone.utc)
            return int(ts.timestamp() * 1_000_000)
        return v

    def emit(self, ctx: EmitCtx) -> CV:
        cap, dev = ctx.capacity, ctx.device
        if isinstance(self.dtype, dt.DecimalType) \
                and self.dtype.is_decimal128 and self.value is not None:
            # the unscaled value as its two's-complement (lo, hi) words
            u = self.device_value() & ((1 << 128) - 1)
            words = [u & ((1 << 64) - 1), u >> 64]
            row = torch.tensor([w - (1 << 64) if w >= 1 << 63 else w
                                for w in words], dtype=torch.int64,
                               device=dev)
            return CV(row.expand(cap, 2).contiguous(),
                      torch.ones(cap, dtype=torch.bool, device=dev))
        if self.dtype.is_variable_width:
            # the bytes tiled once a row: offsets stay monotone
            raw = b"" if self.value is None else (
                self.value.encode() if isinstance(self.value, str)
                else self.value)
            nb = len(raw)
            valid = torch.full((cap,), self.value is not None,
                               dtype=torch.bool, device=dev)
            data = torch.frombuffer(bytearray(raw * cap), dtype=torch.uint8) \
                if nb and cap else torch.zeros(0, dtype=torch.uint8)
            off = torch.arange(cap + 1, dtype=torch.int32, device=dev) * nb
            return CV(data.to(dev), valid, off)
        if self.value is None:
            return CV(torch.zeros(dt.alloc_shape(self.dtype, cap),
                                  dtype=dt.torch_dtype(self.dtype),
                                  device=dev),
                      torch.zeros(cap, dtype=torch.bool, device=dev))
        return CV(torch.full((cap,), self.device_value(),
                             dtype=dt.torch_dtype(self.dtype),
                             device=ctx.device),
                  torch.ones(cap, dtype=torch.bool, device=ctx.device))

    def __repr__(self):
        return repr(self.value)


class Alias(Expression):
    def __init__(self, child: Expression, name: str):
        self.child = child
        self._name = name
        self.children = [child]

    @property
    def name(self):
        return self._name

    def bind(self, schema):
        b = Alias(self.child.bind(schema), self._name)
        b.dtype = b.child.dtype
        return b

    def emit(self, ctx):
        return self.child.emit(ctx)

    def __repr__(self):
        return f"{self.child} AS {self._name}"


# ----------------------------------------------------------------------
# Implicit cast insertion (Spark's binary-op type coercion)
# ----------------------------------------------------------------------
def _coerce_pair(l: Expression, r: Expression, for_division=False):
    lt_, rt = l.dtype, r.dtype
    if isinstance(lt_, dt.NullType):
        l = Cast.bound(l, rt)
        lt_ = rt
    if isinstance(rt, dt.NullType):
        r = Cast.bound(r, lt_)
        rt = lt_
    if isinstance(lt_, dt.DecimalType) or isinstance(rt, dt.DecimalType):
        return _coerce_decimal(l, r)
    if for_division:
        # Spark `/` over non-decimals divides doubles
        if not lt_.is_floating:
            l = Cast.bound(l, dt.FLOAT64)
        if not rt.is_floating:
            r = Cast.bound(r, dt.FLOAT64)
        lt_, rt = l.dtype, r.dtype
    if lt_ == rt:
        return l, r, lt_
    out = dt.promote(lt_, rt)
    if lt_ != out:
        l = Cast.bound(l, out)
    if rt != out:
        r = Cast.bound(r, out)
    return l, r, out


def _coerce_decimal(l, r):
    # decimal op decimal/integral: Spark's implicit coercion; the result
    # type is decided per operator
    def as_dec(e):
        if isinstance(e.dtype, dt.DecimalType):
            return e
        if e.dtype.is_integral:
            # Spark: Byte->dec(3,0) Short->dec(5,0) Int->dec(10,0)
            # Long->dec(20,0)
            p = {1: 3, 2: 5, 4: 10, 8: 20}[e.dtype.np_dtype.itemsize]
            return Cast.bound(e, dt.DecimalType(p, 0))
        raise UnsupportedExpr(f"decimal with {e.dtype}")
    if l.dtype.is_floating or r.dtype.is_floating:
        return (Cast.bound(l, dt.FLOAT64), Cast.bound(r, dt.FLOAT64),
                dt.FLOAT64)
    return as_dec(l), as_dec(r), None


def _refuse_d128(dtype, what: str):
    """The JAX package's gate for the operators that take no decimal128
    (`_reject_d128`): it raises UnsupportedExpr, and so does the port."""
    if isinstance(dtype, dt.DecimalType) and dtype.is_decimal128:
        raise UnsupportedExpr(
            f"{what} over decimal precision > 18 not yet implemented")


def _adjust_precision_scale(p: int, s: int):
    """Spark DecimalType.adjustPrecisionScale: clamp precision at 38,
    sacrificing scale down to a floor of min(s, 6)."""
    if p <= 38:
        return p, s
    int_digits = p - s
    min_scale = min(s, 6)
    return 38, max(38 - int_digits, min_scale)


def _as_dec128(cv: CV, dtype) -> CV:
    """Widen a decimal64 CV to the [n, 2] limb layout (no-op for 128)."""
    if dtype.is_decimal128:
        return cv
    from ..ops.decimal128 import dec_from_i64
    return CV(dec_from_i64(cv.data), cv.validity)


def _dec_scale_shift(cv: CV, shift: int) -> CV:
    if shift == 0:
        return cv
    return CV(cv.data * (10 ** shift), cv.validity)


class _BinaryOp(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = [left, right]

    def bind(self, schema):
        b = type(self)(self.left.bind(schema), self.right.bind(schema))
        b._resolve_type()
        return b

    def _resolve_type(self):
        raise NotImplementedError

    def __repr__(self):
        return f"({self.left} {self.symbol} {self.right})"


class _Arith(_BinaryOp):
    kernel = None
    dec128_fn = None    # decimal128.dec_add / dec_sub

    def _resolve_type(self):
        self.left, self.right, out = _coerce_pair(self.left, self.right)
        if out is None:  # decimal
            p1, s1 = self.left.dtype.precision, self.left.dtype.scale
            p2, s2 = self.right.dtype.precision, self.right.dtype.scale
            s = max(s1, s2)
            p = max(p1 - s1, p2 - s2) + s + 1
            self.dtype = dt.DecimalType(*_adjust_precision_scale(p, s))
        else:
            self.dtype = out

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if isinstance(self.dtype, dt.DecimalType):
            s = self.dtype.scale
            if self.dtype.is_decimal128:
                # exact 128-bit limb path: both sides rescaled to the
                # result scale, any overflow nulls the row
                from ..ops import decimal128 as d128
                la, o1 = d128.dec_rescale(
                    _as_dec128(l, self.left.dtype).data,
                    self.left.dtype.scale, s, 38)
                ra, o2 = d128.dec_rescale(
                    _as_dec128(r, self.right.dtype).data,
                    self.right.dtype.scale, s, 38)
                res, o3 = type(self).dec128_fn(la, ra)
                ok = d128.fits_precision(d128.to_limbs(res),
                                         self.dtype.precision)
                return CV(res, l.validity & r.validity & ~o1 & ~o2 & ~o3
                          & ok)
            l = _dec_scale_shift(l, s - self.left.dtype.scale)
            r = _dec_scale_shift(r, s - self.right.dtype.scale)
        return type(self).kernel(l, r)


class Add(_Arith):
    symbol = "+"
    kernel = staticmethod(ew.add)

    @staticmethod
    def dec128_fn(a, b):
        from ..ops.decimal128 import dec_add
        return dec_add(a, b)


class Subtract(_Arith):
    symbol = "-"
    kernel = staticmethod(ew.sub)

    @staticmethod
    def dec128_fn(a, b):
        from ..ops.decimal128 import dec_sub
        return dec_sub(a, b)


class Multiply(_BinaryOp):
    symbol = "*"

    def _resolve_type(self):
        self.left, self.right, out = _coerce_pair(self.left, self.right)
        if out is None:
            p1, s1 = self.left.dtype.precision, self.left.dtype.scale
            p2, s2 = self.right.dtype.precision, self.right.dtype.scale
            self._full_scale = s1 + s2
            self.dtype = dt.DecimalType(
                *_adjust_precision_scale(p1 + p2 + 1, s1 + s2))
        else:
            self.dtype = out

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if isinstance(self.dtype, dt.DecimalType) \
                and self.dtype.is_decimal128:
            from ..ops import decimal128 as d128
            res, ovf = d128.dec_mul_scaled(
                _as_dec128(l, self.left.dtype).data,
                _as_dec128(r, self.right.dtype).data,
                self._full_scale - self.dtype.scale, self.dtype.precision)
            return CV(res, l.validity & r.validity & ~ovf)
        return ew.mul(l, r)


class Divide(_BinaryOp):
    """Spark `/`: doubles for non-decimal sides; decimals by an exact
    128-bit long division with HALF_UP rounding at Spark's result type.
    A divisor of 0 (or -0.0) gives null."""
    symbol = "/"

    def _resolve_type(self):
        self.left, self.right, out = _coerce_pair(self.left, self.right,
                                                  for_division=True)
        if out is None:
            p1, s1 = self.left.dtype.precision, self.left.dtype.scale
            p2, s2 = self.right.dtype.precision, self.right.dtype.scale
            s = max(6, s1 + p2 + 1)
            self.dtype = dt.DecimalType(
                *_adjust_precision_scale(p1 - s1 + s2 + s, s))
        else:
            self.dtype = out

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if not isinstance(self.dtype, dt.DecimalType):
            return ew.divide(l, r)
        from ..ops import decimal128 as d128
        lt_, rt = self.left.dtype, self.right.dtype
        res, ovf, divzero = d128.dec_div(
            _as_dec128(l, lt_).data, _as_dec128(r, rt).data,
            self.dtype.scale - lt_.scale + rt.scale, self.dtype.precision,
            num_digits=lt_.precision)
        valid = l.validity & r.validity & ~ovf & ~divzero
        if self.dtype.is_decimal128:
            return CV(res, valid)
        v64, fits = d128.dec_to_i64(res)
        return CV(v64, valid & fits)


class Remainder(_BinaryOp):
    """Spark `%`: the sign follows the dividend (Java); a divisor of 0
    gives null. Decimals above precision 18 are refused, as in the JAX
    package."""
    symbol = "%"

    def _resolve_type(self):
        self.left, self.right, out = _coerce_pair(self.left, self.right)
        if out is None:
            lt_, rt = self.left.dtype, self.right.dtype
            if lt_.is_decimal128 or rt.is_decimal128:
                raise UnsupportedExpr("remainder over decimal precision "
                                      "> 18 not yet implemented")
            self.dtype = dt.DecimalType(min(18, max(lt_.precision,
                                                    rt.precision)),
                                        max(lt_.scale, rt.scale))
        else:
            self.dtype = out

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if isinstance(self.dtype, dt.DecimalType):
            s = self.dtype.scale
            l = _dec_scale_shift(l, s - self.left.dtype.scale)
            r = _dec_scale_shift(r, s - self.right.dtype.scale)
        return ew.remainder(l, r)


class IntDivide(_BinaryOp):
    """Spark `div`: an int64 quotient truncated toward zero; decimals are
    brought to one scale first. A divisor of 0 gives null."""
    symbol = "div"

    def _resolve_type(self):
        self.left, self.right, out = _coerce_pair(self.left, self.right)
        if out is None:
            _refuse_d128(self.left.dtype, "div")
            _refuse_d128(self.right.dtype, "div")
        elif not out.is_integral:
            raise UnsupportedExpr("div on non-integral")
        self.dtype = dt.INT64

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if isinstance(self.left.dtype, dt.DecimalType):
            s1, s2 = self.left.dtype.scale, self.right.dtype.scale
            l = _dec_scale_shift(l, max(s1, s2) - s1)
            r = _dec_scale_shift(r, max(s1, s2) - s2)
        out = ew.int_divide(l, r)
        return CV(out.data.to(torch.int64), out.validity)


class Pmod(Remainder):
    """Spark pmod, as the JAX package computes it (`ops/elementwise.py`
    `pmod`); the result type is `%`'s."""
    symbol = "pmod"

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if isinstance(self.dtype, dt.DecimalType):
            s = self.dtype.scale
            l = _dec_scale_shift(l, s - self.left.dtype.scale)
            r = _dec_scale_shift(r, s - self.right.dtype.scale)
        return ew.pmod(l, r)


class _UnaryOp(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = [child]

    def bind(self, schema):
        b = type(self)(self.child.bind(schema))
        b._resolve_type()
        return b

    def _resolve_type(self):
        self.dtype = self.child.dtype


class Negate(_UnaryOp):
    def _resolve_type(self):
        _refuse_d128(self.child.dtype, "negate")
        self.dtype = self.child.dtype

    def emit(self, ctx):
        return ew.negate(self.child.emit(ctx))

    def __repr__(self):
        return f"(- {self.child})"


class Abs(_UnaryOp):
    def _resolve_type(self):
        _refuse_d128(self.child.dtype, "abs")
        self.dtype = self.child.dtype

    def emit(self, ctx):
        return ew.abs_(self.child.emit(ctx))

    def __repr__(self):
        return f"abs({self.child})"


def _is_str(t) -> bool:
    return isinstance(t, (dt.StringType, dt.BinaryType))


class _Comparison(_BinaryOp):
    kernel = None
    cmp_op = None   # string compares: applied to compare()'s -1/0/1

    def _resolve_type(self):
        lt_, rt = self.left.dtype, self.right.dtype
        self.dtype = dt.BOOL
        if isinstance(lt_, dt.NullType) or isinstance(rt, dt.NullType):
            return      # answered by _null_side, whatever the other type
        if _is_str(lt_) != _is_str(rt):
            raise UnsupportedExpr("string/non-string compare")
        if not _is_str(lt_) and lt_ != rt:
            self.left, self.right, _ = _coerce_pair(self.left, self.right)

    def _null_side(self, ctx) -> Optional[CV]:
        """A comparison with a NULL literal: all null, and `<=>` true
        where the other side is null. None when neither side is NULL."""
        sides = (self.left, self.right)
        if not any(isinstance(c.dtype, dt.NullType) for c in sides):
            return None
        if type(self) is not EqNullSafe:
            none = torch.zeros(ctx.capacity, dtype=torch.bool,
                               device=ctx.device)
            return CV(none, none.clone())
        out = torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
        for c in sides:
            if not isinstance(c.dtype, dt.NullType):
                out = out & ~c.emit(ctx).validity
        return CV(out, torch.ones_like(out))

    def emit(self, ctx):
        from ..ops import strings as ops_str
        null = self._null_side(ctx)
        if null is not None:
            return null
        if _is_str(self.left.dtype) and type(self) in (Eq, Ne):
            # literal string equality: length + 4-byte chunks, not the
            # byte-domain walk of compare()
            lit = col = None
            if isinstance(self.right, Literal):
                lit, col = self.right, self.left
            elif isinstance(self.left, Literal):
                lit, col = self.left, self.right
            if lit is not None and isinstance(lit.value, (str, bytes)):
                cv = col.emit(ctx)
                raw = (lit.value.encode() if isinstance(lit.value, str)
                       else lit.value)
                eq = ops_str.equals_literal(cv, raw)
                return CV(~eq if type(self) is Ne else eq, cv.validity)
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if _is_str(self.left.dtype):
            c = ops_str.compare(l, r)
            return CV(type(self).cmp_op(c), l.validity & r.validity)
        if isinstance(self.left.dtype, dt.DecimalType):
            lt_, rt = self.left.dtype, self.right.dtype
            if lt_.is_decimal128 or rt.is_decimal128:
                from ..ops.decimal128 import dec_cmp_scaled
                c = dec_cmp_scaled(_as_dec128(l, lt_).data, lt_.scale,
                                   _as_dec128(r, rt).data, rt.scale)
                return CV(type(self).cmp_op(c), l.validity & r.validity)
            s = max(lt_.scale, rt.scale)
            l = _dec_scale_shift(l, s - lt_.scale)
            r = _dec_scale_shift(r, s - rt.scale)
        return type(self).kernel(l, r)


class Eq(_Comparison):
    symbol = "="
    kernel = staticmethod(ew.eq)
    cmp_op = staticmethod(lambda c: c == 0)


class Ne(_Comparison):
    symbol = "!="
    kernel = staticmethod(ew.ne)
    cmp_op = staticmethod(lambda c: c != 0)


class Lt(_Comparison):
    symbol = "<"
    kernel = staticmethod(ew.lt)
    cmp_op = staticmethod(lambda c: c < 0)


class Le(_Comparison):
    symbol = "<="
    kernel = staticmethod(ew.le)
    cmp_op = staticmethod(lambda c: c <= 0)


class Gt(_Comparison):
    symbol = ">"
    kernel = staticmethod(ew.gt)
    cmp_op = staticmethod(lambda c: c > 0)


class Ge(_Comparison):
    symbol = ">="
    kernel = staticmethod(ew.ge)
    cmp_op = staticmethod(lambda c: c >= 0)


class EqNullSafe(_Comparison):
    """<=>: null <=> null is true, null <=> a value false; never null.
    Strings compare by bytes, decimal128 by both words (at one scale)."""
    symbol = "<=>"
    kernel = staticmethod(ew.eq_null_safe)

    def emit(self, ctx):
        null = self._null_side(ctx)
        if null is not None:
            return null
        lt_, rt = self.left.dtype, self.right.dtype
        d128 = isinstance(lt_, dt.DecimalType) and (
            lt_.is_decimal128 or rt.is_decimal128)
        if not (_is_str(lt_) or d128):
            return super().emit(ctx)
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        if d128:
            from ..ops.decimal128 import dec_cmp_scaled
            c = dec_cmp_scaled(_as_dec128(l, lt_).data, lt_.scale,
                               _as_dec128(r, rt).data, rt.scale)
        else:
            from ..ops import strings as ops_str
            c = ops_str.compare(l, r)
        out = (~l.validity & ~r.validity) | (l.validity & r.validity
                                             & (c == 0))
        return CV(out, torch.ones_like(out))


class And(_BinaryOp):
    symbol = "AND"

    def _resolve_type(self):
        self.dtype = dt.BOOL

    def emit(self, ctx):
        return ew.logical_and(self.left.emit(ctx), self.right.emit(ctx))


class Or(_BinaryOp):
    symbol = "OR"

    def _resolve_type(self):
        self.dtype = dt.BOOL

    def emit(self, ctx):
        return ew.logical_or(self.left.emit(ctx), self.right.emit(ctx))


class Not(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = [child]

    def bind(self, schema):
        b = Not(self.child.bind(schema))
        b.dtype = dt.BOOL
        return b

    def emit(self, ctx):
        return ew.logical_not(self.child.emit(ctx))

    def __repr__(self):
        return f"NOT {self.child}"


class IsNull(_UnaryOp):
    def _resolve_type(self):
        self.dtype = dt.BOOL

    def emit(self, ctx):
        return ew.is_null(self.child.emit(ctx))

    def __repr__(self):
        return f"({self.child} IS NULL)"


class IsNotNull(_UnaryOp):
    def _resolve_type(self):
        self.dtype = dt.BOOL

    def emit(self, ctx):
        return ew.is_not_null(self.child.emit(ctx))

    def __repr__(self):
        return f"({self.child} IS NOT NULL)"


class IsNaN(_UnaryOp):
    def _resolve_type(self):
        # the JAX planner's type signature takes only float and double
        # here (`plan/typesig.py` "IsNaN")
        if not self.child.dtype.is_floating:
            raise UnsupportedExpr(f"isnan on {self.child.dtype}")
        self.dtype = dt.BOOL

    def emit(self, ctx):
        return ew.is_nan(self.child.emit(ctx))

    def __repr__(self):
        return f"isnan({self.child})"


class Cast(Expression):
    """Spark CAST (non-ANSI). The target may be a type name
    ("bigint", "decimal(10,2)"). The numeric, boolean and temporal casts
    are `ops/cast.py`'s, the casts from and to strings
    `ops/cast_strings.py`'s; `bind` accepts exactly the pairs the JAX
    `Cast` accepts and refuses the rest with UnsupportedExpr."""

    def __init__(self, child: Expression, to, ansi=False):
        self.child = child
        if isinstance(to, str):
            to = dt.from_name(to)   # pyspark-style .cast("bigint")
        self.to = to
        self.ansi = ansi
        self.children = [child]

    @staticmethod
    def bound(child: Expression, to: dt.DataType) -> "Cast":
        c = Cast(child, to)
        c.dtype = to
        return c

    def bind(self, schema):
        b = Cast(self.child.bind(schema), self.to, self.ansi)
        b.dtype = self.to
        from_t, to = b.child.dtype, self.to
        temporal = (dt.DateType, dt.TimestampType)
        str_src_ok = (isinstance(from_t, dt.StringType)
                      and (to.is_numeric
                           or isinstance(to, (dt.BooleanType,) + temporal)))
        str_dst_ok = (isinstance(to, dt.StringType)
                      and (from_t.is_integral
                           or isinstance(from_t, (dt.BooleanType,
                                                  dt.DecimalType)
                                         + temporal)))
        ok = (from_t == to
              or (from_t.is_numeric and to.is_numeric)
              or isinstance(from_t, dt.NullType)
              or (isinstance(from_t, dt.BooleanType) and to.is_numeric)
              or (from_t.is_numeric and isinstance(to, dt.BooleanType))
              or (isinstance(from_t, dt.TimestampType)
                  and (to.is_numeric or isinstance(to, dt.DateType)))
              or (isinstance(from_t, dt.DateType)
                  and isinstance(to, (dt.TimestampType, dt.IntegerType)))
              or (from_t.is_numeric and isinstance(to, dt.TimestampType))
              or str_src_ok or str_dst_ok)
        if not ok:
            raise UnsupportedExpr(f"cast {from_t} -> {to}")
        if str_dst_ok and isinstance(from_t, dt.DecimalType) \
                and from_t.is_decimal128:
            # the JAX device path reads the [n, 2] words as one array and
            # fails (its host fallback answers); the port refuses it
            # (ROADMAP C.17)
            _refuse_d128(from_t, "cast to string")
        return b

    def emit(self, ctx):
        from ..ops import cast as cast_ops
        from ..ops import cast_strings as cs
        cv = self.child.emit(ctx)
        from_t, to = self.child.dtype, self.to
        if isinstance(from_t, dt.StringType) \
                and not isinstance(to, dt.StringType):
            if to.is_integral:
                return cs.string_to_int(cv, to)
            if to.is_floating:
                out = cs.string_to_float(cv)
                return CV(out.data.to(dt.torch_dtype(to)), out.validity)
            if isinstance(to, dt.BooleanType):
                return cs.string_to_bool(cv)
            if isinstance(to, dt.DateType):
                return cs.string_to_date(cv)
            if isinstance(to, dt.TimestampType):
                return cs.string_to_timestamp(cv)
            return cs.string_to_decimal(cv, to)
        if isinstance(to, dt.StringType) \
                and not isinstance(from_t, dt.StringType):
            if isinstance(from_t, dt.NullType):
                return cast_ops.cast_cv(cv, from_t, to)
            if isinstance(from_t, dt.BooleanType):
                return cs.bool_to_string(cv)
            if isinstance(from_t, dt.DecimalType):
                return cs.decimal_to_string(cv, from_t.scale)
            if isinstance(from_t, dt.DateType):
                return cs.date_to_string(cv)
            if isinstance(from_t, dt.TimestampType):
                return cs.timestamp_to_string(cv)
            return cs.int_to_string(cv)
        return cast_ops.cast_cv(cv, from_t, to)

    def __repr__(self):
        return f"CAST({self.child} AS {self.to})"


def _select_cv(pick_a, a: CV, b: CV, out_valid) -> CV:
    """Row-wise select between two CVs; a string column gathers from the
    concatenation of both."""
    if a.offsets is not None or b.offsets is not None:
        from ..ops.concat import concat_cvs
        from ..ops.gather import take_strings
        cap = pick_a.shape[0]
        ar = torch.arange(cap, device=pick_a.device)
        out = take_strings(concat_cvs([a, b], dt.STRING),
                           torch.where(pick_a, ar, cap + ar))
        return CV(out.data, out_valid, out.offsets)
    return CV(torch.where(pick_a.reshape(-1, *([1] * (a.data.dim() - 1))),
                          a.data, b.data), out_valid)


class Coalesce(Expression):
    """The first non-null child (the full outer join's key projection)."""

    def __init__(self, *children: Expression):
        self.children = list(children)

    def bind(self, schema):
        bc = [c.bind(schema) for c in self.children]
        out = next((c.dtype for c in bc
                    if not isinstance(c.dtype, dt.NullType)), dt.NULLTYPE)
        bc = [c if c.dtype == out else Cast.bound(c, out) for c in bc]
        b = Coalesce(*bc)
        b.dtype = out
        return b

    def emit(self, ctx):
        cvs = [c.emit(ctx) for c in self.children]
        out = cvs[-1]
        for cv in reversed(cvs[:-1]):
            out = _select_cv(cv.validity, cv, out,
                             cv.validity | out.validity)
        return out

    def __repr__(self):
        return "coalesce(" + ", ".join(map(repr, self.children)) + ")"


class If(Expression):
    """IF(pred, t, f): a null predicate takes f. Both branches cast to the
    output type, the type of the branch that is not NULL."""

    def __init__(self, pred: Expression, t: Expression, f: Expression):
        self.pred, self.t, self.f = pred, t, f
        self.children = [pred, t, f]

    def bind(self, schema):
        p, t, f = (c.bind(schema) for c in self.children)
        out = t.dtype if not isinstance(t.dtype, dt.NullType) else f.dtype
        if t.dtype != out:
            t = Cast.bound(t, out)
        if f.dtype != out:
            f = Cast.bound(f, out)
        b = If(p, t, f)
        b.dtype = out
        return b

    def emit(self, ctx):
        p, t, f = (c.emit(ctx) for c in self.children)
        take_t = p.validity & p.data.to(torch.bool)
        return _select_cv(take_t, t, f,
                          torch.where(take_t, t.validity, f.validity))

    def __repr__(self):
        return f"if({self.pred}, {self.t}, {self.f})"


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... [ELSE d] END, built as nested If at bind;
    no ELSE gives null."""

    def __init__(self, branches, default: Optional[Expression] = None):
        self.branches = branches
        self.default = default
        self.children = ([e for p, v in branches for e in (p, v)]
                         + ([default] if default else []))

    def bind(self, schema):
        expr: Expression = self.default or Literal(None)
        for p, v in reversed(self.branches):
            expr = If(p, v, expr)
        return expr.bind(schema)

    def __repr__(self):
        return "CASE WHEN ..."


class In(Expression):
    """child IN (v1, ...), built as an OR of equalities at bind, so a
    string value takes the literal-equality path."""

    def __init__(self, child: Expression, values: List[Expression]):
        self.child = child
        self.values = values
        self.children = [child] + values

    def bind(self, schema):
        expr: Optional[Expression] = None
        for v in self.values:
            e = Eq(self.child, v)
            expr = e if expr is None else Or(expr, e)
        return (expr or Literal(False)).bind(schema)

    def __repr__(self):
        return f"{self.child} IN (...)"


# ----------------------------------------------------------------------
# Math, round, greatest / least, bitwise operations and shifts
# ----------------------------------------------------------------------
def _cbrt(x):
    """Cube root with x's sign: |x|^(1/3), then one Newton step (torch
    has no cbrt; the step brings pow's error on 1/3 back to an ulp or
    two of the correctly rounded root)."""
    y = torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)
    ok = torch.isfinite(y) & (y != 0)
    safe = torch.where(ok, y, torch.ones_like(y))
    step = safe - (safe * safe * safe - x) / (3.0 * safe * safe)
    return torch.where(ok, step, y)


_MATH_FNS = {
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "cbrt": _cbrt, "expm1": torch.expm1, "floor": torch.floor,
    "ceil": torch.ceil, "signum": lambda x: torch.where(
        (x == 0) | torch.isnan(x), x, torch.sign(x)),   # jnp.sign's NaN, -0.0
    "rint": torch.round,
    # jnp.degrees / radians: one product with the constant
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
}


class MathUnary(_UnaryOp):
    """A double-valued unary math function with Spark semantics: log,
    log10 and log2 of x <= 0, and log1p of x <= -1, are null; floor and
    ceil of an integral column stay int64."""

    def __init__(self, fn_name: str, child: Expression):
        super().__init__(child)
        self.fn_name = fn_name
        if fn_name not in _MATH_FNS:
            raise UnsupportedExpr(f"math fn {fn_name}")

    def bind(self, schema):
        b = MathUnary(self.fn_name, self.child.bind(schema))
        ct = b.child.dtype
        if not (ct.is_numeric or isinstance(ct, dt.NullType)):
            raise UnsupportedExpr(f"{self.fn_name} on {ct}")
        # the JAX MathUnary reads a decimal128's [n, 2] words as one
        # array and breaks; the port refuses it (ROADMAP C.17)
        _refuse_d128(ct, self.fn_name)
        if b.fn_name in ("floor", "ceil") and ct.is_integral:
            b.dtype = dt.INT64
        else:
            b.dtype = dt.FLOAT64
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        x = cv.data.to(torch.float64)
        if isinstance(self.child.dtype, dt.DecimalType):
            from ..ops.cast import _over_pow10
            x = _over_pow10(x, self.child.dtype.scale)
        valid = cv.validity
        if self.fn_name in ("log", "log10", "log2"):
            valid = valid & (x > 0)
            x = torch.where(x > 0, x, 1.0)
        if self.fn_name == "log1p":
            valid = valid & (x > -1)
            x = torch.where(x > -1, x, 0.0)
        out = _MATH_FNS[self.fn_name](x)
        if self.dtype == dt.INT64:
            from ..ops.cast import _f64_to_i64
            out = _f64_to_i64(out)
        return CV(out, valid)

    def __repr__(self):
        return f"{self.fn_name}({self.child})"


def _half_up_int(x, p: int):
    """Integer x / p rounded HALF_UP (away from zero), p > 0."""
    half = p // 2
    adj = torch.where(x >= 0, x + half, x - half)
    q = torch.div(adj, p, rounding_mode="floor")
    r = adj - q * p
    return torch.where((r != 0) & (adj < 0), q + 1, q)


class Round(Expression):
    """round(x, d), HALF_UP (Spark ROUND); d may be negative. A decimal
    keeps its precision at scale min(s, max(d, 0)); an integer keeps its
    type; anything else is a double."""

    def __init__(self, child: Expression, digits: int = 0):
        self.child = child
        self.digits = digits
        self.children = [child]

    def bind(self, schema):
        b = Round(self.child.bind(schema), self.digits)
        ct = b.child.dtype
        _refuse_d128(ct, "round")
        if isinstance(ct, dt.DecimalType):
            b.dtype = dt.DecimalType(ct.precision,
                                     min(ct.scale, max(self.digits, 0)))
        elif ct.is_integral:
            b.dtype = ct
        else:
            b.dtype = dt.FLOAT64
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        ct = self.child.dtype
        if isinstance(ct, dt.DecimalType):
            out = cv.data
            drop = ct.scale - max(self.digits, 0)
            if drop > 0:
                out = _half_up_int(out, 10 ** drop)
            if self.digits < 0:
                p = 10 ** (-self.digits)
                out = _half_up_int(out, p) * p
            return CV(out, cv.validity)
        if ct.is_integral and self.digits >= 0:
            return cv
        if ct.is_integral:  # negative digits: round at 10^-d
            p = 10 ** (-self.digits)
            q = _half_up_int(cv.data.to(torch.int64), p)
            return CV((q * p).to(cv.data.dtype), cv.validity)
        from ..ops.cast import _over_pow10
        x = cv.data.to(torch.float64)
        scaled = x * (10.0 ** self.digits)
        out = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                          torch.ceil(scaled - 0.5))
        return CV(_over_pow10(out, self.digits), cv.validity)

    def __repr__(self):
        return f"round({self.child}, {self.digits})"


class _MinMaxOf(Expression):
    """greatest / least: nulls skipped (null only when every input is),
    NaN above every value; all children promoted to one type."""
    is_greatest = True

    def __init__(self, *children: Expression):
        self.children = list(children)

    def bind(self, schema):
        bc = [c.bind(schema) for c in self.children]
        out = bc[0].dtype
        for c in bc[1:]:
            out = dt.promote(out, c.dtype) if c.dtype != out else out
        _refuse_d128(out, "greatest/least")
        bc = [c if c.dtype == out else Cast.bound(c, out) for c in bc]
        b = type(self)(*bc)
        b.dtype = out
        return b

    def emit(self, ctx):
        cvs = [c.emit(ctx) for c in self.children]
        out = cvs[0]
        for cv in cvs[1:]:
            better = (ew._nan_lt(out.data, cv.data) if self.is_greatest
                      else ew._nan_lt(cv.data, out.data))
            pick = cv.validity & (~out.validity | better)
            out = CV(torch.where(pick, cv.data, out.data),
                     out.validity | cv.validity)
        return out

    def __repr__(self):
        fn = "greatest" if self.is_greatest else "least"
        return f"{fn}(" + ", ".join(map(repr, self.children)) + ")"


class Greatest(_MinMaxOf):
    is_greatest = True


class Least(_MinMaxOf):
    is_greatest = False


class _Bitwise(_BinaryOp):
    op = None

    def _resolve_type(self):
        self.left, self.right, out = _coerce_pair(self.left, self.right)
        if out is None or not out.is_integral:
            raise UnsupportedExpr("bitwise op on non-integral")
        self.dtype = out

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        return CV(type(self).op(l.data, r.data), l.validity & r.validity)


class BitwiseAnd(_Bitwise):
    symbol = "&"
    op = staticmethod(torch.bitwise_and)


class BitwiseOr(_Bitwise):
    symbol = "|"
    op = staticmethod(torch.bitwise_or)


class BitwiseXor(_Bitwise):
    symbol = "^"
    op = staticmethod(torch.bitwise_xor)


class BitwiseNot(_UnaryOp):
    def _resolve_type(self):
        if not self.child.dtype.is_integral:
            raise UnsupportedExpr("~ on non-integral")
        self.dtype = self.child.dtype

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        return CV(torch.bitwise_not(cv.data), cv.validity)

    def __repr__(self):
        return f"~{self.child}"


class ShiftLeft(_BinaryOp):
    """shiftleft(a, n): Java's shift, n masked to the width (byte and
    short promote to int first, as Spark does)."""
    symbol = "<<"

    def _resolve_type(self):
        if not (self.left.dtype.is_integral
                and self.right.dtype.is_integral):
            raise UnsupportedExpr("shift on non-integral")
        if isinstance(self.left.dtype, (dt.ByteType, dt.ShortType)):
            self.left = Cast.bound(self.left, dt.INT32)
        self.dtype = self.left.dtype

    def _shift(self, x, n):
        return torch.bitwise_left_shift(x, n)

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        nbits = l.data.element_size() * 8
        sh = torch.remainder(r.data.to(torch.int32), nbits)
        return CV(self._shift(l.data, sh.to(l.data.dtype)),
                  l.validity & r.validity)


class ShiftRight(ShiftLeft):
    """shiftright(a, n): the arithmetic shift."""
    symbol = ">>"

    def _shift(self, x, n):
        return torch.bitwise_right_shift(x, n)


class Pow(_BinaryOp):
    symbol = "pow"

    def _resolve_type(self):
        # numeric only, as the JAX planner's type signature has it
        for e in (self.left, self.right):
            if not (e.dtype.is_numeric or isinstance(e.dtype, dt.NullType)):
                raise UnsupportedExpr(f"pow on {e.dtype}")
        self.left = (self.left if self.left.dtype.is_floating
                     else Cast.bound(self.left, dt.FLOAT64))
        self.right = (self.right if self.right.dtype.is_floating
                      else Cast.bound(self.right, dt.FLOAT64))
        self.dtype = dt.FLOAT64

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        return CV(torch.pow(l.data.to(torch.float64),
                            r.data.to(torch.float64)),
                  l.validity & r.validity)


class Atan2(_BinaryOp):
    symbol = "atan2"

    def _resolve_type(self):
        for side in ("left", "right"):
            e = getattr(self, side)
            if not (e.dtype.is_numeric or isinstance(e.dtype, dt.NullType)):
                raise UnsupportedExpr(f"atan2 on {e.dtype}")
            if not e.dtype.is_floating:
                setattr(self, side, Cast.bound(e, dt.FLOAT64))
        self.dtype = dt.FLOAT64

    def emit(self, ctx):
        l, r = self.left.emit(ctx), self.right.emit(ctx)
        return CV(torch.atan2(l.data.to(torch.float64),
                              r.data.to(torch.float64)),
                  l.validity & r.validity)
