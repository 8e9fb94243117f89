"""Expression trees: binding, Spark type coercion, and evaluation on
tensors.

The port's copy of the JAX package's expression layer, cut to the slice:
column references (string columns included), literals, aliases,
arithmetic (+, -, *, / and %; decimals above precision 18 on the exact
limb kernels of `ops/decimal128.py`, a decimal `/` by `dec_div`),
comparisons (strings too: a literal `=`/`!=` by length and 4-byte
chunks, any other by `ops/strings.py` `compare`; decimal128 by
`dec_cmp_scaled`; a NULL literal on either side gives an all-null
result, and `<=>` the other side's null flag), null-safe equality,
coalesce, IF, CASE WHEN and IN, Kleene AND/OR/NOT and the numeric casts
(decimal128 on either side included). The string functions live in
`string_exprs.py`. `bind(schema)` resolves names and types exactly as
the JAX package does; `emit(ctx)` evaluates the bound tree eagerly and
returns a CV. A cast named by a type string raises NotPorted.
"""
from __future__ import annotations

import datetime
import decimal
from typing import List, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.table import Schema
from ..errors import NotPorted
from ..ops import elementwise as ew
from ..ops.kernel_utils import CV

__all__ = [
    "Expression", "UnsupportedExpr", "EmitCtx", "ColumnRef", "BoundRef",
    "Literal", "Alias", "Add", "Subtract", "Multiply", "Divide",
    "Remainder", "Eq", "Ne", "Lt",
    "Le", "Gt", "Ge", "EqNullSafe", "And", "Or", "Not", "Cast",
    "Coalesce", "If", "CaseWhen", "In", "lit", "col",
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

    def substr(self, start, length=None):
        from .string_exprs import Substring
        return Substring(self, start, length)


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
        raise NotPorted("timestamp literals")
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
        return v

    def emit(self, ctx: EmitCtx) -> CV:
        cap, dev = ctx.capacity, ctx.device
        if isinstance(self.dtype, dt.DecimalType) \
                and self.dtype.is_decimal128:
            raise NotPorted("decimal128 literals")
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


def _reject_d128(*dtypes):
    for t in dtypes:
        if isinstance(t, dt.DecimalType) and t.is_decimal128:
            raise NotPorted(f"decimal arithmetic at precision > 18 ({t})")


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
    """<=>: null <=> null is true; never null."""
    symbol = "<=>"
    kernel = staticmethod(ew.eq_null_safe)

    def _resolve_type(self):
        super()._resolve_type()
        if not any(isinstance(c.dtype, dt.NullType)
                   for c in (self.left, self.right)):
            _reject_d128(self.left.dtype, self.right.dtype)

    def emit(self, ctx):
        null = self._null_side(ctx)
        if null is not None:
            return null
        if not _is_str(self.left.dtype):
            return super().emit(ctx)
        from ..ops import strings as ops_str
        l, r = self.left.emit(ctx), self.right.emit(ctx)
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


class Cast(Expression):
    """Spark CAST, the numeric subset (ops/cast.py): null to any type,
    boolean to numeric, and numeric to numeric, decimal128 on either
    side included."""

    def __init__(self, child: Expression, to: dt.DataType):
        if isinstance(to, str):
            raise NotPorted("casts named by a type string")
        self.child = child
        self.to = to
        self.children = [child]

    @staticmethod
    def bound(child: Expression, to: dt.DataType) -> "Cast":
        c = Cast(child, to)
        c.dtype = to
        return c

    def bind(self, schema):
        b = Cast.bound(self.child.bind(schema), self.to)
        from_t, to = b.child.dtype, self.to
        ok = (from_t == to or isinstance(from_t, dt.NullType)
              or (isinstance(from_t, dt.BooleanType) and to.is_numeric)
              or (from_t.is_numeric and to.is_numeric))
        if not ok:
            raise NotPorted(f"cast {from_t} -> {self.to}")
        return b

    def emit(self, ctx):
        from ..ops.cast import cast_cv
        return cast_cv(self.child.emit(ctx), self.child.dtype, self.to)

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
