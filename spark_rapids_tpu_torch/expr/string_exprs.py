"""String expressions: the port's copy of the JAX package's
`expr/string_exprs.py`, with its binding rules (a string or binary
child; a literal pattern where the JAX package wants one).

length (in UTF-8 characters), upper / lower (ASCII), substring, concat
(null if any input is null), the literal-pattern predicates CONTAINS,
STARTSWITH, ENDSWITH and LIKE, trim / ltrim / rtrim, reverse, instr /
locate, lpad / rpad, repeat and concat_ws (which skips nulls). LIKE
takes a literal pattern of runs separated by `%`, where `_` matches
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
from .expressions import Expression, Literal, UnsupportedExpr, _UnaryOp

__all__ = ["Length", "Upper", "Lower", "Substring", "ConcatStr",
           "Contains", "StartsWith", "EndsWith", "Like", "Trim",
           "Reverse", "Instr", "Pad", "Repeat", "ConcatWs"]


def _require_string(e: Expression, what: str):
    if not isinstance(e.dtype, (dt.StringType, dt.BinaryType)):
        raise UnsupportedExpr(f"{what} on {e.dtype}")


class Length(_UnaryOp):
    def _resolve_type(self):
        _require_string(self.child, "length")
        self.dtype = dt.INT32

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        return CV(ops_str.str_len_chars(cv).to(torch.int32), cv.validity)

    def __repr__(self):
        return f"length({self.child})"


class Upper(_UnaryOp):
    def _resolve_type(self):
        _require_string(self.child, "upper")
        self.dtype = dt.STRING

    def emit(self, ctx):
        return ops_str.upper(self.child.emit(ctx))

    def __repr__(self):
        return f"upper({self.child})"


class Lower(_UnaryOp):
    def _resolve_type(self):
        _require_string(self.child, "lower")
        self.dtype = dt.STRING

    def emit(self, ctx):
        return ops_str.lower(self.child.emit(ctx))

    def __repr__(self):
        return f"lower({self.child})"


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


class ConcatStr(Expression):
    def __init__(self, *children: Expression):
        self.children = list(children)

    def bind(self, schema):
        bc = [c.bind(schema) for c in self.children]
        for c in bc:
            _require_string(c, "concat")
        b = ConcatStr(*bc)
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        cvs = [c.emit(ctx) for c in self.children]
        return ops_str.concat_strings(cvs, sum(cv.data.shape[0]
                                               for cv in cvs))

    def __repr__(self):
        return "concat(" + ", ".join(map(repr, self.children)) + ")"


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
                f"{type(self).__name__} requires a literal pattern round-1")
        b = type(self)(c, p)
        b.dtype = dt.BOOL
        return b

    def _pattern_bytes(self) -> bytes:
        v = self.pattern.value
        return v.encode() if isinstance(v, str) else v

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        return CV(type(self).kernel(cv, self._pattern_bytes()), cv.validity)

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


class Trim(Expression):
    def __init__(self, child: Expression, left: bool = True,
                 right: bool = True):
        self.child = child
        self.left, self.right = left, right
        self.children = [child]

    def bind(self, schema):
        b = Trim(self.child.bind(schema), self.left, self.right)
        _require_string(b.child, "trim")
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        return ops_str.trim(self.child.emit(ctx), self.left, self.right)

    def __repr__(self):
        kind = "trim" if self.left and self.right else (
            "ltrim" if self.left else "rtrim")
        return f"{kind}({self.child})"


class Reverse(_UnaryOp):
    def _resolve_type(self):
        _require_string(self.child, "reverse")
        self.dtype = dt.STRING

    def emit(self, ctx):
        return ops_str.reverse(self.child.emit(ctx))

    def __repr__(self):
        return f"reverse({self.child})"


class Instr(_LiteralPatternPredicate):
    """instr(str, substr): the 1-based position, 0 when absent."""

    def bind(self, schema):
        b = super().bind(schema)
        b.dtype = dt.INT32
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        return CV(ops_str.find_first(cv, self._pattern_bytes()),
                  cv.validity)


class Pad(Expression):
    def __init__(self, child: Expression, target_len: int, pad: str,
                 left: bool):
        self.child = child
        self.target_len = int(target_len)
        self.pad = pad
        self.left = left
        self.children = [child]

    def bind(self, schema):
        b = Pad(self.child.bind(schema), self.target_len, self.pad,
                self.left)
        _require_string(b.child, "lpad/rpad")
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        return ops_str.pad(self.child.emit(ctx), self.target_len,
                           self.pad.encode(), self.left)

    def __repr__(self):
        return f"{'l' if self.left else 'r'}pad({self.child})"


class Repeat(Expression):
    def __init__(self, child: Expression, times: int):
        self.child = child
        self.times = int(times)
        self.children = [child]

    def bind(self, schema):
        b = Repeat(self.child.bind(schema), self.times)
        _require_string(b.child, "repeat")
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        out_cap = max(cv.data.shape[0] * max(self.times, 1), 1)
        return ops_str.repeat_str(cv, self.times, out_cap)

    def __repr__(self):
        return f"repeat({self.child}, {self.times})"


class ConcatWs(Expression):
    """concat_ws(sep, cols...): null inputs are skipped (Spark), never
    null itself."""

    def __init__(self, sep: str, *children: Expression):
        self.sep = sep
        self.children = list(children)

    def bind(self, schema):
        bc = [c.bind(schema) for c in self.children]
        for c in bc:
            _require_string(c, "concat_ws")
        b = ConcatWs(self.sep, *bc)
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        cvs = [c.emit(ctx) for c in self.children]
        cap, dev = ctx.capacity, ctx.device
        every = torch.ones(cap, dtype=torch.bool, device=dev)
        if not cvs:
            return CV(torch.zeros(0, dtype=torch.uint8, device=dev), every,
                      torch.zeros(cap + 1, dtype=torch.int32, device=dev))
        sep = self.sep.encode()
        # [c0, sep1, c1, sep2, c2, ...]: sep_i is there when c_i and one
        # of c_0 .. c_i-1 are not null
        parts = []
        prefix_has = None
        for i, cv in enumerate(cvs):
            has = cv.validity
            lens = ops_str.str_len_bytes(cv)
            safe = ops_str.rebuild_strings(cv, cv.offsets[:-1],
                                           torch.where(has, lens, 0))
            if i > 0 and sep:
                parts.append(ops_str.literal_column(
                    sep, prefix_has & has, cap * len(sep)))
            parts.append(CV(safe.data, every, safe.offsets))
            prefix_has = has if prefix_has is None else prefix_has | has
        out = ops_str.concat_strings(parts, sum(p.data.shape[0]
                                                for p in parts))
        return CV(out.data, every, out.offsets)

    def __repr__(self):
        return f"concat_ws('{self.sep}', ...)"
