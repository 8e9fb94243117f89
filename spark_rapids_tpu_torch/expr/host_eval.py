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
truncating string -> int). RLike, RegexpExtract and RegexpReplace run
through Python `re` (a Java replacement's `$n` and `\\X` translated by
`_java_repl_to_py`); GetJsonObject, FromJson, ToJson and ParseUrl
through `json` and `urllib.parse`. An expression with no host rule
raises UnsupportedExpr.
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


@functools.lru_cache(maxsize=256)
def _java_repl_to_py(repl: str) -> str:
    """Java regexp_replace replacement dialect -> Python re.sub template:
    \\X = literal X, $n = group reference, all else literal."""
    out = []
    i = 0
    while i < len(repl):
        c = repl[i]
        if c == "\\" and i + 1 < len(repl):
            nxt = repl[i + 1]
            out.append("\\\\" if nxt == "\\" else nxt)
            i += 2
        elif c == "$" and i + 1 < len(repl) and repl[i + 1].isdigit():
            out.append("\\" + repl[i + 1])
            i += 2
        else:
            out.append("\\\\" if c == "\\" else c)
            i += 1
    return "".join(out)


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


@_rule("RLike")
def _rlike(e, cv, env):
    s = cv[0]
    if s is None:
        return None
    return _re.search(e.pattern, s) is not None


@_rule("RegexpExtract")
def _regexp_extract(e, cv, env):
    s = cv[0]
    if s is None:
        return None
    m = _re.search(e.pattern, s)
    if not m or e.idx > (m.re.groups):
        return ""
    g = m.group(e.idx)
    return g if g is not None else ""


@_rule("RegexpReplace")
def _regexp_replace(e, cv, env):
    s = cv[0]
    if s is None:
        return None
    return _re.sub(e.pattern, _java_repl_to_py(e.replacement), s)


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
    "RLike": dt.BOOL, "Like": dt.BOOL, "Contains": dt.BOOL,
    "StartsWith": dt.BOOL, "EndsWith": dt.BOOL, "And": dt.BOOL,
    "Or": dt.BOOL, "Not": dt.BOOL, "Eq": dt.BOOL, "Ne": dt.BOOL,
    "Lt": dt.BOOL, "Le": dt.BOOL, "Gt": dt.BOOL, "Ge": dt.BOOL,
    "EqNullSafe": dt.BOOL, "IsNull": dt.BOOL, "IsNotNull": dt.BOOL,
    "In": dt.BOOL,
    "RegexpExtract": dt.STRING, "RegexpReplace": dt.STRING,
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


# -- JSON / URL expressions (expr/json_exprs.py) -----------------------
import json as _json  # noqa: E402


@_rule("GetJsonObject")
def _get_json_object(e, cv, env):
    s = cv[0]
    if s is None:
        return None
    from .json_exprs import render_json_value, walk_json_path
    try:
        obj = _json.loads(s)
    except (ValueError, TypeError):
        return None
    matches = walk_json_path(obj, e.steps)
    if not matches:
        return None
    if len(matches) == 1:
        return render_json_value(matches[0])
    return _json.dumps(matches, separators=(",", ":"))


def _coerce_json(v, dtype):
    if v is None:
        return None
    if isinstance(dtype, dt.StructType):
        if not isinstance(v, dict):
            return None
        return {f.name: _coerce_json(v.get(f.name), f.dtype)
                for f in dtype.fields}
    if isinstance(dtype, dt.ArrayType):
        if not isinstance(v, list):
            return None
        return [_coerce_json(x, dtype.element) for x in v]
    if isinstance(dtype, dt.MapType):
        if not isinstance(v, dict):
            return None
        return {str(k): _coerce_json(x, dtype.value)
                for k, x in v.items()}
    try:
        if isinstance(dtype, dt.StringType):
            return v if isinstance(v, str) else _json.dumps(v)
        if isinstance(dtype, dt.BooleanType):
            return v if isinstance(v, bool) else None
        if isinstance(dtype, (dt.ByteType, dt.ShortType, dt.IntegerType,
                              dt.LongType)):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            return int(v)
        if isinstance(dtype, (dt.FloatType, dt.DoubleType)):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            return float(v)
    except (ValueError, TypeError, OverflowError):
        return None
    return None


@_rule("FromJson")
def _from_json(e, cv, env):
    s = cv[0]
    if s is None:
        return None
    try:
        obj = _json.loads(s)
    except (ValueError, TypeError):
        return None
    return _coerce_json(obj, e.host_dtype)


def _jsonable(v):
    import datetime
    import decimal
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, decimal.Decimal):
        return float(v)
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    return v


@_rule("ToJson")
def _to_json(e, cv, env):
    v = cv[0]
    if v is None:
        return None
    return _json.dumps(_jsonable(v), separators=(",", ":"))


@_rule("ParseUrl")
def _parse_url(e, cv, env):
    s = cv[0]
    if s is None:
        return None
    from urllib.parse import urlparse
    try:
        u = urlparse(s)
    except ValueError:
        return None
    part = e.part
    if part == "QUERY" and e.key is not None:
        # Spark extracts the RAW value with (&|^)key=([^&]*): no URL
        # decoding, empty string preserved
        mt = _re.search(r"(?:^|&)" + _re.escape(e.key) + r"=([^&]*)",
                        u.query)
        return mt.group(1) if mt else None
    if part == "HOST":
        return u.hostname
    if part == "PATH":
        return u.path or ""
    if part == "QUERY":
        return u.query or None
    if part == "REF":
        return u.fragment or None
    if part == "PROTOCOL":
        return u.scheme or None
    if part == "FILE":
        return (u.path or "") + (f"?{u.query}" if u.query else "")
    if part == "AUTHORITY":
        return u.netloc or None
    if part == "USERINFO":
        if u.username is None and u.password is None:
            return None
        return (u.username or "") + (f":{u.password}"
                                     if u.password is not None else "")
    return None


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
