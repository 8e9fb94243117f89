"""Regex expressions: RLike, RegexpExtract, RegexpReplace.

The port of the JAX package's `expr/regex_exprs.py` (reference: the
regex transpiler RegexParser.scala:47 / CudfRegexTranspiler:696 feeding
cuDF RegexProgram kernels via stringFunctions.scala rules). Patterns
compile at bind time to a bit-parallel NFA (ops/regex_nfa.py); a pattern
outside the subset raises UnsupportedExpr, so the planner tags the node
for the host interpreter (or refuses it with the fallback off); a
pattern Java would reject raises RegexSyntaxError, never a fallback.

Deviations documented in docs/compatibility.md (Regex): byte-domain
matching, greedy-longest alternation order, MAX_SCAN-byte scan bound.
The port scans min(MAX_SCAN, the batch's longest row) steps (one host
read), where the JAX package scans min(MAX_SCAN, the byte buffer's
capacity): steps past every row's end change nothing, so the answers are
the same. Its strings are not capacity-bucketed, so a replacement's
output holds exactly its bytes.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..ops.kernel_utils import CV
from ..ops.regex_exec import (MAX_SCAN, extract_first, nfa_match,
                              replace_all)
from ..ops.regex_nfa import (Concat, Group, RegexUnsupported, _len_bounds,
                             compile_nfa, parse)
from ..utils.transfer import fetch_int
from .expressions import Expression, UnsupportedExpr
from .string_exprs import _require_string

__all__ = ["RLike", "RegexpExtract", "RegexpReplace"]


def _compile(pattern: str):
    try:
        return compile_nfa(pattern)
    except RegexUnsupported as e:
        raise UnsupportedExpr(
            f"regex pattern {pattern!r} outside the TPU-transpilable "
            f"subset: {e}") from e


def _longest_row(cv: CV) -> int:
    """The batch's longest row in bytes (one host read)."""
    if cv.offsets.shape[0] <= 1:
        return 0
    return fetch_int((cv.offsets[1:] - cv.offsets[:-1]).max())


def _scan_bound(rx, cv: CV) -> int:
    """Steps of a match_spans scan: no match is longer than its row."""
    return min(rx.max_len if rx.max_len is not None else MAX_SCAN,
               MAX_SCAN, _longest_row(cv))


class RLike(Expression):
    """`str rlike pattern`: unanchored regex search (Java semantics on
    the supported subset)."""

    def __init__(self, child: Expression, pattern: str):
        self.child = child
        self.pattern = pattern
        self.children = [child]

    def bind(self, schema):
        c = self.child.bind(schema)
        _require_string(c, "rlike")
        b = RLike(c, self.pattern)
        b._rx = _compile(self.pattern)
        b.dtype = dt.BOOL
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        # scan whole rows (an unanchored match can start anywhere), up to
        # the MAX_SCAN byte bound (documented)
        m = nfa_match(self._rx, cv, min(MAX_SCAN, _longest_row(cv)))
        return CV(m, cv.validity)

    def __repr__(self):
        return f"({self.child!r} RLIKE {self.pattern!r})"


class RegexpReplace(Expression):
    """regexp_replace(str, pattern, replacement-literal): replace all
    non-overlapping matches."""

    def __init__(self, child: Expression, pattern: str, replacement: str):
        self.child = child
        self.pattern = pattern
        self.replacement = replacement
        self.children = [child]

    def bind(self, schema):
        c = self.child.bind(schema)
        _require_string(c, "regexp_replace")
        if "$" in self.replacement or "\\" in self.replacement:
            # group references need capture tracking: the host fallback
            # serves these (expr/host_eval.py translates $n)
            raise UnsupportedExpr(
                "regexp_replace group references in replacement")
        b = RegexpReplace(c, self.pattern, self.replacement)
        b._rx = _compile(self.pattern)
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        cv = self.child.emit(ctx)
        return replace_all(self._rx, cv, self.replacement.encode(),
                           _scan_bound(self._rx, cv))

    def __repr__(self):
        return (f"regexp_replace({self.child!r}, {self.pattern!r}, "
                f"{self.replacement!r})")


class RegexpExtract(Expression):
    """regexp_extract(str, pattern, idx): substring matched by group idx
    of the first match; '' when no match (Spark semantics).

    idx=0 extracts the whole match. idx>0 is supported when the group is
    a top-level concat element with fixed-length prefix and suffix
    subpatterns (e.g. `foo=([0-9]+);`, the group's margins), else tagged
    unsupported."""

    def __init__(self, child: Expression, pattern: str, idx: int = 0):
        self.child = child
        self.pattern = pattern
        self.idx = idx
        self.children = [child]

    def bind(self, schema):
        c = self.child.bind(schema)
        _require_string(c, "regexp_extract")
        b = RegexpExtract(c, self.pattern, self.idx)
        b._rx = _compile(self.pattern)
        b._pre, b._post = self._group_margins()
        b.dtype = dt.STRING
        return b

    def _group_margins(self):
        if self.idx == 0:
            return 0, 0
        ast, _, aend, ngroups = parse(self.pattern)
        if aend:
            # the compiled NFA consumes an optional final line terminator
            # for '$', which would shift the fixed post-margin
            raise UnsupportedExpr(
                "regexp_extract group with a $-anchored pattern")
        if self.idx > ngroups:
            raise UnsupportedExpr(
                f"regexp_extract group {self.idx} of {ngroups}")
        parts = ast.parts if isinstance(ast, Concat) else [ast]
        gpos = None
        for i, p in enumerate(parts):
            if isinstance(p, Group) and p.index == self.idx:
                gpos = i
                break
        if gpos is None:
            raise UnsupportedExpr(
                "regexp_extract group must be a top-level concat element")
        pre_lo, pre_hi = _len_bounds(Concat(parts[:gpos]))
        post_lo, post_hi = _len_bounds(Concat(parts[gpos + 1:]))
        if pre_lo != pre_hi or post_lo != post_hi:
            raise UnsupportedExpr(
                "regexp_extract needs fixed-length text around the group")
        return pre_lo, post_lo

    def emit(self, ctx):
        from ..ops.strings import rebuild_strings
        cv = self.child.emit(ctx)
        start, ln, found = extract_first(self._rx, cv,
                                         _scan_bound(self._rx, cv))
        # no match -> empty string (Spark), null in -> null out
        gstart = torch.where(found, start + self._pre, 0)
        glen = torch.where(found, (ln - self._pre - self._post).clamp(
            min=0), 0)
        out = rebuild_strings(cv, gstart, glen)
        return CV(out.data, cv.validity, out.offsets)

    def __repr__(self):
        return (f"regexp_extract({self.child!r}, {self.pattern!r}, "
                f"{self.idx})")
