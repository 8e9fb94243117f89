"""String expressions: SUBSTRING and the literal-pattern predicates
CONTAINS, STARTSWITH, ENDSWITH and LIKE.

The port's copy of the JAX package's `expr/string_exprs.py` pieces the
TPC-H queries reach, with the same binding rules: the child must be a
string or binary column, and a predicate's pattern must be a literal.
LIKE takes a literal pattern of runs separated by `%`, where `_` matches
exactly one byte; a pattern holding `\\` raises, as in the JAX package.
Like the reference, LIKE checks each middle run for containment on its
own, between the bytes its prefix and suffix runs consumed, so runs may
overlap or come in either order (`docs/compatibility.md`): `%a%b%`
matches "b a".
"""
from __future__ import annotations

from typing import Optional

import torch

from ..columnar import dtypes as dt
from ..ops import strings as ops_str
from ..ops.kernel_utils import CV
from .expressions import Expression, Literal, UnsupportedExpr

__all__ = ["Substring", "Contains", "StartsWith", "EndsWith", "Like"]


def _require_string(e: Expression, what: str):
    if not isinstance(e.dtype, (dt.StringType, dt.BinaryType)):
        raise UnsupportedExpr(f"{what} on {e.dtype}")


class Substring(Expression):
    def __init__(self, child: Expression, start: int,
                 length: Optional[int] = None):
        self.child = child
        self.start = start
        self.length = length
        self.children = [child]

    def bind(self, schema):
        b = Substring(self.child.bind(schema), self.start, self.length)
        _require_string(b.child, "substring")
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        return ops_str.substring(self.child.emit(ctx), self.start,
                                 self.length)

    def __repr__(self):
        return f"substring({self.child}, {self.start}, {self.length})"


class _LiteralPatternPredicate(Expression):
    kernel = None

    def __init__(self, child: Expression, pattern: Expression):
        self.child = child
        self.pattern = pattern
        self.children = [child, pattern]

    def bind(self, schema):
        c = self.child.bind(schema)
        p = self.pattern.bind(schema)
        _require_string(c, type(self).__name__.lower())
        if not isinstance(p, Literal) or not isinstance(p.value,
                                                        (str, bytes)):
            raise UnsupportedExpr(
                f"{type(self).__name__} requires a literal pattern")
        b = type(self)(c, p)
        b.dtype = dt.BOOL
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        v = self.pattern.value
        out = type(self).kernel(cv, v.encode() if isinstance(v, str) else v)
        return CV(out, cv.validity)

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.child}, {self.pattern})"


class Contains(_LiteralPatternPredicate):
    kernel = staticmethod(ops_str.contains)


class StartsWith(_LiteralPatternPredicate):
    kernel = staticmethod(ops_str.startswith)


class EndsWith(_LiteralPatternPredicate):
    kernel = staticmethod(ops_str.endswith)


_WILD = ord("_")


class Like(Expression):
    """SQL LIKE with a literal pattern (the module docstring gives the
    semantics)."""

    def __init__(self, child: Expression, pattern: str):
        self.child = child
        self.pattern = pattern
        self.children = [child]

    def bind(self, schema):
        c = self.child.bind(schema)
        _require_string(c, "like")
        if "\\" in self.pattern:
            raise UnsupportedExpr("LIKE escapes land with the regex "
                                  "transpiler")
        b = Like(c, self.pattern)
        b.dtype = dt.BOOL
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        pat = self.pattern
        lens = ops_str.str_len_bytes(cv)
        if "%" not in pat:
            raw = pat.encode()
            ok = (lens == len(raw)) & (ops_str.startswith(cv, raw, _WILD)
                                       if raw else (lens == 0))
            return CV(ok, cv.validity)
        parts = [p.encode() for p in pat.split("%")]
        inner = [p for p in parts if p]
        if not inner:
            # only % signs: anything matches, the empty string too
            return CV(torch.ones_like(cv.validity), cv.validity)
        ok = lens >= sum(len(p) for p in inner)
        # with a % in the pattern, the prefix and the suffix run are two
        # different runs
        lead, trail = not pat.startswith("%"), not pat.endswith("%")
        middle = list(inner)
        if lead:
            ok = ok & ops_str.startswith(cv, parts[0], _WILD)
            middle = middle[1:]
        if trail:
            ok = ok & ops_str.endswith(cv, parts[-1], _WILD)
            middle = middle[:-1]
        skip_pre = len(parts[0]) if lead else 0
        skip_suf = len(parts[-1]) if trail else 0
        for p in middle:
            ok = ok & ops_str.contains(cv, p, _WILD, skip_pre, skip_suf)
        return CV(ok, cv.validity)

    def __repr__(self):
        return f"({self.child} LIKE '{self.pattern}')"
