"""Host (CPU) expression interpreter: the engine of the host fallback.

The port's copy of the JAX package's `expr/host_eval.py` (reference:
GpuCpuBridgeExpression.scala: an unsupported expression subtree runs on
the CPU instead of failing the whole query). When an expression cannot
bind for the device (a type signature refuses it, a LIKE with an
escape, a pattern that is a column), the planner keeps the UNBOUND tree
and this interpreter evaluates it row by row over host Python values;
the result goes back to the device.

Slow by design. Integers ride as width-typed numpy scalars (see
`exec/host_fallback.py` `_batch_rows`), so int32 and int64 arithmetic
wraps as Java's does; decimals arrive as Python `Decimal` and dates as
`datetime.date`, from Arrow. Each rule is the JAX package's, even where
it departs from Spark (the Cast rule's `str` of a double, its
truncating string -> int). The rules for RLike, RegexpExtract,
RegexpReplace, GetJsonObject, FromJson, ToJson and ParseUrl come with
their expression classes (ROADMAP A.10); an expression with no host
rule raises UnsupportedExpr.
"""
from __future__ import annotations

import functools
import re as _re
from typing import Any, Callable, Dict, List, Optional

from ..columnar import dtypes as dt
from .expressions import Expression, UnsupportedExpr

__all__ = ["host_eval_rows", "host_output_dtype"]


@functools.lru_cache(maxsize=256)
def _java_like_to_re(pattern: str, escape: str = "\\"):
    """Full SQL LIKE semantics (incl escapes) as a compiled anchored
    regex (cached per pattern — one translation, not one per row)."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(_re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(_re.escape(c))
        i += 1
    return _re.compile("(?s)^" + "".join(out) + "$")


# Each rule: fn(expr, child_values: list, row_env) -> value (None = null)
_RULES: Dict[str, Callable] = {}


def _rule(*names):
    def deco(fn):
        for n in names:
            _RULES[n] = fn
        return fn
    return deco


@_rule("Literal")
def _lit(e, cv, env):
    import numpy as np
    v = e.value
    np_dt = getattr(getattr(e, "dtype", None), "np_dtype", None)
    # typed numpy scalar so arithmetic wraps at the literal's width,
    # matching the device (Java/Spark non-ANSI overflow)
    if (np_dt is not None and isinstance(v, int)
            and not isinstance(v, bool)
            and np.issubdtype(np.dtype(np_dt), np.integer)):
        return np.dtype(np_dt).type(v)
    return v


@_rule("ColumnRef")
def _colref(e, cv, env):
    return env[e.name]


@_rule("BoundRef")
def _bref(e, cv, env):
    return env[e.name]


@_rule("Alias")
def _alias(e, cv, env):
    return cv[0]


@_rule("Add")
def _add(e, cv, env):
    a, b = cv
    return None if a is None or b is None else a + b


@_rule("Subtract")
def _sub(e, cv, env):
    a, b = cv
    return None if a is None or b is None else a - b


@_rule("Multiply")
def _mul(e, cv, env):
    a, b = cv
    return None if a is None or b is None else a * b


@_rule("Divide")
def _div(e, cv, env):
    a, b = cv
    if a is None or b is None or b == 0:
        return None
    return a / b


@_rule("Negate")
def _neg(e, cv, env):
    return None if cv[0] is None else -cv[0]


@_rule("Abs")
def _abs(e, cv, env):
    return None if cv[0] is None else abs(cv[0])


def _cmp(op):
    def fn(e, cv, env):
        a, b = cv
        if a is None or b is None:
            return None
        # native bool: numpy comparison results (np.bool_) would break
        # the And/Or rules' `is False` Kleene short-circuits
        return bool(op(a, b))
    return fn


_RULES["Eq"] = _cmp(lambda a, b: a == b)
_RULES["Ne"] = _cmp(lambda a, b: a != b)
_RULES["Lt"] = _cmp(lambda a, b: a < b)
_RULES["Le"] = _cmp(lambda a, b: a <= b)
_RULES["Gt"] = _cmp(lambda a, b: a > b)
_RULES["Ge"] = _cmp(lambda a, b: a >= b)


@_rule("EqNullSafe")
def _eqns(e, cv, env):
    a, b = cv
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    return a == b


@_rule("And")
def _and(e, cv, env):
    a, b = cv
    if a is False or b is False:
        return False
    if a is None or b is None:
        return None
    return bool(a) and bool(b)


@_rule("Or")
def _or(e, cv, env):
    a, b = cv
    if a is True or b is True:
        return True
    if a is None or b is None:
        return None
    return bool(a) or bool(b)


@_rule("Not")
def _not(e, cv, env):
    return None if cv[0] is None else not cv[0]


@_rule("IsNull")
def _isnull(e, cv, env):
    return cv[0] is None


@_rule("IsNotNull")
def _isnotnull(e, cv, env):
    return cv[0] is not None


@_rule("Coalesce")
def _coalesce(e, cv, env):
    for v in cv:
        if v is not None:
            return v
    return None


@_rule("If")
def _if(e, cv, env):
    return cv[1] if cv[0] else cv[2]


@_rule("In")
def _in(e, cv, env):
    v = cv[0]
    if v is None:
        return None
    vals = cv[1:]
    if v in [x for x in vals if x is not None]:
        return True
    return None if any(x is None for x in vals) else False


# ---- strings ---------------------------------------------------------
@_rule("Length")
def _length(e, cv, env):
    return None if cv[0] is None else len(cv[0])


@_rule("Upper")
def _upper(e, cv, env):
    return None if cv[0] is None else cv[0].upper()


@_rule("Lower")
def _lower(e, cv, env):
    return None if cv[0] is None else cv[0].lower()


@_rule("Contains")
def _contains(e, cv, env):
    a, b = cv
    return None if a is None or b is None else (b in a)


@_rule("StartsWith")
def _startswith(e, cv, env):
    a, b = cv
    return None if a is None or b is None else a.startswith(b)


@_rule("EndsWith")
def _endswith(e, cv, env):
    a, b = cv
    return None if a is None or b is None else a.endswith(b)


@_rule("ConcatStr")
def _concatstr(e, cv, env):
    if any(v is None for v in cv):
        return None
    return "".join(cv)


@_rule("Like")
def _like(e, cv_or_child, env):
    s = cv_or_child[0]
    if s is None:
        return None
    return _java_like_to_re(e.pattern).match(s) is not None


# ---------------------------------------------------------------------
def _eval_one(e: Expression, env) -> Any:
    name = type(e).__name__
    fn = _RULES.get(name)
    if fn is None:
        raise UnsupportedExpr(
            f"no host (CPU fallback) implementation for {name}")
    child_vals = [_eval_one(c, env) for c in e.children if c is not None]
    return fn(e, child_vals, env)


def host_eval_rows(expr: Expression, rows: List[dict]) -> List[Any]:
    """Evaluate an UNBOUND expression tree over row dicts (name->value).
    Integer inputs should be numpy width-typed scalars (see
    host_fallback._batch_rows) so arithmetic wraps like the device;
    overflow warnings from that wrapping are expected and silenced."""
    import numpy as np
    import warnings
    with np.errstate(over="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return [_eval_one(expr, row) for row in rows]


# output dtype WITHOUT capability checks, for planning around fallbacks
_DTYPE_HINTS = {
    "Like": dt.BOOL, "Contains": dt.BOOL,
    "StartsWith": dt.BOOL, "EndsWith": dt.BOOL, "And": dt.BOOL,
    "Or": dt.BOOL, "Not": dt.BOOL, "Eq": dt.BOOL, "Ne": dt.BOOL,
    "Lt": dt.BOOL, "Le": dt.BOOL, "Gt": dt.BOOL, "Ge": dt.BOOL,
    "EqNullSafe": dt.BOOL, "IsNull": dt.BOOL, "IsNotNull": dt.BOOL,
    "In": dt.BOOL,
    "Upper": dt.STRING, "Lower": dt.STRING, "ConcatStr": dt.STRING,
    "Length": dt.INT32,
}


def host_output_dtype(expr: Expression) -> Optional[dt.DataType]:
    name = type(expr).__name__
    if name == "Alias":
        return host_output_dtype(expr.children[0])
    hd = getattr(expr, "host_dtype", None)
    if hd is not None:
        return hd
    if name == "Cast":
        return expr.to
    return _DTYPE_HINTS.get(name)


@_rule("Cast")
def _cast(e, cv, env):
    """Host-side Spark CAST over Python values (the common scalar
    matrix; string->number trims, failures -> null)."""
    v = cv[0]
    if v is None:
        return None
    to = e.to
    try:
        if isinstance(to, dt.StringType):
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)
        if isinstance(to, dt.BooleanType):
            if isinstance(v, str):
                t = v.strip().lower()
                if t in ("t", "true", "y", "yes", "1"):
                    return True
                if t in ("f", "false", "n", "no", "0"):
                    return False
                return None
            return bool(v)
        if isinstance(to, (dt.ByteType, dt.ShortType, dt.IntegerType,
                           dt.LongType)):
            if isinstance(v, str):
                t = v.strip()
                try:
                    return int(t)    # exact for integral strings
                except ValueError:
                    return int(float(t))
            return int(v)
        if isinstance(to, (dt.FloatType, dt.DoubleType)):
            return float(v.strip() if isinstance(v, str) else v)
    except (ValueError, TypeError, OverflowError):
        return None
    raise UnsupportedExpr(f"host cast to {to} not implemented")
