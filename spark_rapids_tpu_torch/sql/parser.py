"""Minimal SQL frontend: the port's copy of the JAX package's
`sql/parser.py`.

In the reference, Spark parses SQL and the plugin only sees physical
plans; standalone, this subset makes `session.sql(...)` work:

  [WITH name AS (SELECT ...), ...]
  SELECT [DISTINCT] <exprs> FROM <view> [alias]
  [[INNER|LEFT [OUTER|SEMI|ANTI]|RIGHT|FULL|CROSS] JOIN <view>
   ON <cond> | USING (c, ...)] [WHERE <pred>] [GROUP BY <exprs>]
  [HAVING <pred>] [ORDER BY <expr> [ASC|DESC], ...] [LIMIT n]

Expressions: identifiers (qualified names too), string and number
literals, + - * / %, comparisons, AND / OR / NOT, IS [NOT] NULL,
[NOT] BETWEEN, [NOT] IN (...), [NOT] LIKE, CASE WHEN, CAST(e AS type),
and function calls (the aggregates, then the port's `functions.py`).
Subqueries: derived tables, [NOT] EXISTS and [NOT] IN (SELECT ...)
rewritten to semi / anti joins, uncorrelated scalar subqueries run to a
literal, correlated scalar subqueries decorrelated into a grouped
aggregate LEFT join. `EXPLAIN <select>` returns a one-row `plan` column
of the port's explain; `EXPLAIN ANALYZE` waits for the profiler
(ROADMAP A.13). A hand-rolled precedence-climbing parser, no
dependencies.
"""
from __future__ import annotations

import re

from ..columnar import dtypes as dt
from ..expr import aggregates as agg
from ..expr.expressions import (CaseWhen, Cast, ColumnRef, Literal,
                                UnsupportedExpr)
from ..plan.logical import SortOrder

__all__ = ["parse_sql", "register_view"]

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d+|\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|\+|-|/|%|\.)
    )""", re.VERBOSE)

_KEYWORDS = {"select", "from", "where", "group", "by", "order", "limit",
             "as", "and", "or", "not", "is", "null", "between", "in",
             "case", "when", "then", "else", "end", "cast", "join",
             "inner", "left", "right", "full", "outer", "on", "using",
             "asc", "desc", "distinct", "like", "true", "false", "semi",
             "anti", "cross", "having", "exists", "with"}

_TYPES = {"int": dt.INT32, "integer": dt.INT32, "bigint": dt.INT64,
          "long": dt.INT64, "smallint": dt.INT16, "tinyint": dt.INT8,
          "float": dt.FLOAT32, "real": dt.FLOAT32, "double": dt.FLOAT64,
          "string": dt.STRING, "boolean": dt.BOOL, "date": dt.DATE,
          "timestamp": dt.TIMESTAMP}

_AGG_FNS = {"sum": agg.Sum, "count": agg.Count, "min": agg.Min,
            "max": agg.Max, "avg": agg.Avg, "first": agg.First,
            "last": agg.Last}


def _tokenize(sql: str):
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            if sql[pos:].strip() == "":
                break
            raise ValueError(f"SQL tokenize error at: {sql[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            t = m.group("num")
            out.append(("num", float(t) if "." in t else int(t)))
        elif m.lastgroup == "str":
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "id":
            word = m.group("id")
            if word.lower() in _KEYWORDS:
                out.append(("kw", word.lower()))
            else:
                out.append(("id", word))
        else:
            out.append(("op", m.group("op")))
    out.append(("eof", None))
    return out


class OuterRef(ColumnRef):
    """A column reference that resolves in the ENCLOSING query's scope
    (correlated subquery predicate, Spark's OuterReference)."""


class _SubqueryMarker:
    """Base for the parser-internal subquery markers. Markers are only
    consumable as top-level AND-connected WHERE conjuncts (where_parts /
    _apply_marker); combining one into any larger expression — HAVING,
    SELECT list, JOIN ON, OR trees, arithmetic — raises a clear
    UnsupportedExpr here instead of leaking a non-Expression object that
    dies later with an opaque AttributeError."""

    _CTX = ("subquery predicates are only supported as top-level "
            "AND-connected WHERE conjuncts")

    def _reject(self, *_a, **_k):
        raise UnsupportedExpr(self._CTX)

    __and__ = __rand__ = __or__ = __ror__ = _reject
    __add__ = __radd__ = __sub__ = __rsub__ = _reject
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _reject
    __mod__ = __rmod__ = __neg__ = __invert__ = _reject

    def __getattr__(self, name):
        # .alias/.bind/.isNull/.between/... — anything an Expression
        # would support — means the marker escaped its WHERE context
        raise UnsupportedExpr(
            f"{self._CTX} (attempted .{name} on a subquery marker)")


def _no_subquery(e, where: str):
    """Reject a subquery marker escaping into a non-WHERE context with a
    clear message — including markers buried inside an expression tree
    (an Expression operator wraps unknown operands as Literals)."""
    def bad():
        raise UnsupportedExpr(
            f"subquery in {where} is not supported; "
            + _SubqueryMarker._CTX)
    if isinstance(e, _SubqueryMarker):
        bad()
    if isinstance(e, Literal) and isinstance(e.value, _SubqueryMarker):
        bad()
    if isinstance(e, str):                       # '*' projection
        return e
    for c in (getattr(e, "children", None) or []):
        if c is not None and not isinstance(c, (int, float, str, bool)):
            _no_subquery(c, where)
    return e


class _Exists(_SubqueryMarker):
    """Marker conjunct: [NOT] EXISTS (subquery) — rewritten to a
    left_semi / left_anti join (the reference rides Spark's
    RewritePredicateSubquery; InSubqueryExec analog)."""

    def __init__(self, sub, negated=False):
        self.sub = sub
        self.negated = negated

    def __invert__(self):
        return _Exists(self.sub, not self.negated)


class _InSub(_SubqueryMarker):
    """Marker conjunct: expr [NOT] IN (subquery) -> semi/anti join."""

    def __init__(self, left, sub, negated=False):
        self.left = left
        self.sub = sub
        self.negated = negated

    def __invert__(self):
        return _InSub(self.left, self.sub, not self.negated)


class _ScalarSub(_SubqueryMarker):
    """Marker operand: (SELECT <agg expr> ...) inside a comparison.
    Uncorrelated -> executed to a Literal; correlated -> decorrelated
    into a grouped-aggregate LEFT join."""

    def __init__(self, sub):
        self.sub = sub


class _SubCompare(_SubqueryMarker):
    """Marker conjunct: comparison with a _ScalarSub operand."""

    def __init__(self, op, left, right):
        self.op = op
        self.left = left
        self.right = right


class _SubInfo:
    """A parsed (correlated) subquery: the inner DataFrame with
    inner-only filters applied, the correlation conjuncts (containing
    OuterRef nodes), and the projection info."""

    def __init__(self, df, corr, projs, group_keys, having):
        self.df = df
        self.corr = corr          # list[Expression with OuterRefs]
        self.projs = projs        # [(expr-or-'*', alias)]
        self.group_keys = group_keys
        self.having = having


class _Parser:
    def __init__(self, tokens, session=None, outer_aliases=()):
        self.toks = tokens
        self.i = 0
        self.session = session
        self.outer_aliases = set(outer_aliases)
        self.local_aliases = set()

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind, val=None):
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            return self.next()
        return None

    def expect(self, kind, val=None):
        t = self.accept(kind, val)
        if t is None:
            raise ValueError(f"expected {val or kind}, got {self.peek()}")
        return t

    # ---- expressions (precedence climbing) ----------------------------
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        left = self.and_expr()
        while self.accept("kw", "or"):
            left = left | self.and_expr()
        return left

    def and_expr(self):
        left = self.not_expr()
        while self.accept("kw", "and"):
            left = left & self.not_expr()
        return left

    def not_expr(self):
        if self.accept("kw", "not"):
            return ~self.not_expr()
        return self.comparison()

    def comparison(self):
        if self.accept("kw", "exists"):
            self.expect("op", "(")
            sub = self._subquery()
            self.expect("op", ")")
            return _Exists(sub)
        left = self.additive()
        k, v = self.peek()
        if k == "op" and v in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            right = self.additive()
            if isinstance(left, _ScalarSub) or isinstance(right,
                                                          _ScalarSub):
                return _SubCompare(v, left, right)
            return {"=": lambda: left == right,
                    "!=": lambda: left != right,
                    "<>": lambda: left != right,
                    "<": lambda: left < right,
                    "<=": lambda: left <= right,
                    ">": lambda: left > right,
                    ">=": lambda: left >= right}[v]()
        if k == "kw" and v == "is":
            self.next()
            if self.accept("kw", "not"):
                self.expect("kw", "null")
                return left.isNotNull()
            self.expect("kw", "null")
            return left.isNull()
        if k == "kw" and v == "between":
            self.next()
            lo = self.additive()
            self.expect("kw", "and")
            hi = self.additive()
            return left.between(lo, hi)
        if k == "kw" and v == "like":
            self.next()
            kk, pat = self.expect("str")
            from ..expr.string_exprs import Like
            return Like(left, pat)
        if k == "kw" and v == "in":
            self.next()
            self.expect("op", "(")
            if self.peek() == ("kw", "select"):
                sub = self._subquery()
                self.expect("op", ")")
                return _InSub(left, sub)
            vals = [self.expr()]
            while self.accept("op", ","):
                vals.append(self.expr())
            self.expect("op", ")")
            from ..expr.expressions import In
            return In(left, vals)
        if k == "kw" and v == "not":
            # NOT LIKE / NOT IN / NOT BETWEEN
            save = self.i
            self.next()
            k2, v2 = self.peek()
            if k2 == "kw" and v2 in ("like", "in", "between"):
                self.i = save
                self.next()
                inner = self.comparison_tail(left)
                return ~inner
            self.i = save
        return left

    def comparison_tail(self, left):
        k, v = self.peek()
        if v == "like":
            self.next()
            _, pat = self.expect("str")
            from ..expr.string_exprs import Like
            return Like(left, pat)
        if v == "in":
            self.next()
            self.expect("op", "(")
            if self.peek() == ("kw", "select"):
                sub = self._subquery()
                self.expect("op", ")")
                return _InSub(left, sub)
            vals = [self.expr()]
            while self.accept("op", ","):
                vals.append(self.expr())
            self.expect("op", ")")
            from ..expr.expressions import In
            return In(left, vals)
        if v == "between":
            self.next()
            lo = self.additive()
            self.expect("kw", "and")
            hi = self.additive()
            return left.between(lo, hi)
        raise ValueError(f"unexpected after NOT: {v}")

    def additive(self):
        left = self.multiplicative()
        while True:
            if self.accept("op", "+"):
                left = left + self.multiplicative()
            elif self.accept("op", "-"):
                left = left - self.multiplicative()
            else:
                return left

    def multiplicative(self):
        left = self.unary()
        while True:
            if self.accept("op", "*"):
                left = left * self.unary()
            elif self.accept("op", "/"):
                left = left / self.unary()
            elif self.accept("op", "%"):
                left = left % self.unary()
            else:
                return left

    def unary(self):
        if self.accept("op", "-"):
            return -self.unary()
        return self.primary()

    def primary(self):
        k, v = self.next()
        if k == "num":
            return Literal(v)
        if k == "str":
            return Literal(v)
        if k == "kw" and v == "null":
            return Literal(None)
        if k == "kw" and v in ("true", "false"):
            return Literal(v == "true")
        if k == "kw" and v == "case":
            branches = []
            default = None
            while self.accept("kw", "when"):
                p = self.expr()
                self.expect("kw", "then")
                val = self.expr()
                branches.append((p, val))
            if self.accept("kw", "else"):
                default = self.expr()
            self.expect("kw", "end")
            return CaseWhen(branches, default)
        if k == "kw" and v == "cast":
            self.expect("op", "(")
            e = self.expr()
            self.expect("kw", "as")
            tk, tv = self.next()
            typ = _TYPES.get(tv.lower() if isinstance(tv, str) else "")
            if typ is None:
                raise ValueError(f"unknown type {tv}")
            self.expect("op", ")")
            return Cast(e, typ)
        if k == "op" and v == "(":
            if self.peek() == ("kw", "select"):
                sub = self._subquery()
                self.expect("op", ")")
                return _ScalarSub(sub)
            e = self.expr()
            self.expect("op", ")")
            return e
        if k == "id":
            if self.accept("op", "("):
                return self._call(v)
            # qualified name a.b: an alias bound in the ENCLOSING query
            # (and not shadowed locally) makes this an OuterRef —
            # correlated-subquery scoping; otherwise use the last part
            qualifier = None
            while self.accept("op", "."):
                qualifier = v
                _, v2 = self.expect("id")
                v = v2
            if (qualifier is not None
                    and qualifier.lower() in self.outer_aliases
                    and qualifier.lower() not in self.local_aliases):
                return OuterRef(v)
            return ColumnRef(v)
        if k == "op" and v == "*":
            return "*"
        raise ValueError(f"unexpected token {k} {v}")

    # ---- WHERE with subquery-marker conjuncts -------------------------
    def _and_level(self):
        parts = [self.not_expr()]
        while self.accept("kw", "and"):
            parts.append(self.not_expr())
        for x in parts:
            if isinstance(x, _ScalarSub):
                raise UnsupportedExpr(
                    "scalar subquery must be used inside a comparison "
                    "(e.g. col = (SELECT ...))")
        plains = [x for x in parts
                  if not isinstance(x, (_Exists, _InSub, _SubCompare))]
        marks = [x for x in parts
                 if isinstance(x, (_Exists, _InSub, _SubCompare))]
        return plains, marks

    def where_parts(self):
        """Parse a WHERE body honoring SQL precedence (OR lowest):
        returns (plain_predicate_or_None, [subquery marker conjuncts]).
        Subquery predicates under OR are unsupported."""
        plains, marks = self._and_level()

        def combine(ps):
            out = ps[0]
            for x in ps[1:]:
                out = out & x
            return out
        if self.peek() == ("kw", "or"):
            if marks:
                raise UnsupportedExpr("subquery predicate under OR")
            left = combine(plains)
            while self.accept("kw", "or"):
                p2, m2 = self._and_level()
                if m2:
                    raise UnsupportedExpr("subquery predicate under OR")
                left = left | combine(p2)
            return left, []
        return (combine(plains) if plains else None), marks

    # ---- subquery parse (at 'select', stops before ')') ---------------
    def _subquery(self) -> "_SubInfo":
        saved_outer = self.outer_aliases
        saved_local = self.local_aliases
        self.outer_aliases = saved_outer | saved_local
        self.local_aliases = set()
        try:
            self.expect("kw", "select")
            self.accept("kw", "distinct")
            projs = self._select_list()
            self.expect("kw", "from")
            df = _parse_from(self, self.session)
            sub_names = set(df.schema.names)
            corr = []
            if self.accept("kw", "where"):
                plain, marks = self.where_parts()
                if marks:
                    raise UnsupportedExpr("nested subquery predicates")
                conjs = _split_and(plain) if plain is not None else []
                for c in conjs:
                    c2 = _mark_outer(c, sub_names)
                    if _has_outer(c2):
                        corr.append(c2)
                    else:
                        df = df.filter(c2)
            group_keys = None
            having = None
            if self.accept("kw", "group"):
                self.expect("kw", "by")
                group_keys = [_no_subquery(self.expr(), "GROUP BY")]
                while self.accept("op", ","):
                    group_keys.append(_no_subquery(self.expr(),
                                                   "GROUP BY"))
            if self.accept("kw", "having"):
                having = _no_subquery(self.expr(), "HAVING")
            return _SubInfo(df, corr, projs, group_keys, having)
        finally:
            self.outer_aliases = saved_outer
            self.local_aliases = saved_local

    def _select_list(self):
        projs = []
        while True:
            e = _no_subquery(self.expr(), "the SELECT list")
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect("id")[1]
            else:
                t = self.accept("id")
                if t:
                    alias = t[1]
            projs.append((e, alias))
            if not self.accept("op", ","):
                break
        return projs

    def _call(self, name):
        name_l = name.lower()
        args = []
        if self.accept("op", "*"):
            self.expect("op", ")")
            if name_l == "count":
                return agg.CountStar()
            raise ValueError(f"{name}(*) unsupported")
        if not self.accept("op", ")"):
            args.append(self.expr())
            while self.accept("op", ","):
                args.append(self.expr())
            self.expect("op", ")")
        if name_l in _AGG_FNS:
            return _AGG_FNS[name_l](args[0])
        from .. import functions as F
        fn = getattr(F, name_l, None)
        if fn is None or name_l in ("col", "lit"):
            raise UnsupportedExpr(f"unknown function {name}")
        # numeric literals past the first argument pass as python
        # scalars (substring start/len, round digits, ...): many F
        # functions consume them numerically at build time, and a
        # deferred emit-time failure is not catchable here
        conv = [args[0]] + [
            a.value if (isinstance(a, Literal)
                        and isinstance(a.value, (int, float))
                        and not isinstance(a.value, bool)) else a
            for a in args[1:]]
        try:
            return fn(*conv)
        except TypeError:
            conv2 = [a.value if isinstance(a, Literal) else a
                     for a in args]
            return fn(conv2[0], *conv2[1:])


def register_view(session, name: str, df):
    if not hasattr(session, "_views"):
        session._views = {}
    session._views[name.lower()] = df


# ---- scoping / decorrelation helpers ----------------------------------
def _split_and(e):
    from ..expr.expressions import And
    if isinstance(e, And):
        return _split_and(e.children[0]) + _split_and(e.children[1])
    return [e]


def _walk_replace(e, fn, _memo=None):
    """Rebuild an expression tree bottom-up through fn (children first,
    then the node itself). Memoized by node identity: the same child is
    commonly referenced from BOTH an attr (.left/.child) and the
    .children list — it must be visited (and replaced) exactly once."""
    if _memo is None:
        _memo = {}
    if id(e) in _memo:
        return _memo[id(e)]
    for attr in ("left", "right", "child", "pred", "t", "f"):
        c = getattr(e, attr, None)
        if c is not None and hasattr(c, "bind"):
            setattr(e, attr, _walk_replace(c, fn, _memo))
    kids = getattr(e, "children", None)
    if kids:
        e.children = [(_walk_replace(c, fn, _memo)
                       if hasattr(c, "bind") else c) for c in kids]
    out = fn(e)
    _memo[id(e)] = out
    return out


def _mark_outer(e, sub_names):
    """ColumnRefs not resolvable in the subquery's schema (and not
    already alias-qualified OuterRefs) become OuterRefs."""
    def fn(x):
        if type(x) is ColumnRef and x.name not in sub_names:
            return OuterRef(x.name)
        return x
    return _walk_replace(e, fn)


def _has_outer(e) -> bool:
    found = []

    def fn(x):
        if isinstance(x, OuterRef):
            found.append(x)
        return x
    _walk_replace(e, fn)
    return bool(found)


def _resolve_scopes(e, rename):
    """OuterRef(n) -> ColumnRef(n) (enclosing scope); inner
    ColumnRef(n) -> ColumnRef(rename[n]) — builds the join condition
    over the combined (outer ++ renamed inner) schema."""
    def fn(x):
        if isinstance(x, OuterRef):
            return ColumnRef(x.name)
        if type(x) is ColumnRef:
            return ColumnRef(rename[x.name])
        return x
    return _walk_replace(e, fn)


_SQ_COUNTER = [0]


def _rename_all(df, prefix=None):
    """Project every column to a collision-proof name; returns
    (renamed_df, {old: new})."""
    _SQ_COUNTER[0] += 1
    tag = prefix or f"__sq{_SQ_COUNTER[0]}"
    mapping = {n: f"{tag}_{n}" for n in df.schema.names}
    out = df.select(*[ColumnRef(n).alias(m) for n, m in mapping.items()])
    return out, mapping


def _extract_aggs(e, aggs):
    """Replace aggregate nodes inside a projection expression with
    references to hidden agg output columns (collected into `aggs`)."""
    def fn(x):
        if isinstance(x, agg.AggExpr):
            nm = f"__sqa{len(aggs)}"
            aggs.append((nm, x))
            return ColumnRef(nm)
        return x
    return _walk_replace(e, fn)


def _finalize_sub_output(session, info: "_SubInfo", extra_keys=(),
                         require_agg: bool = False):
    """Build the subquery's output DataFrame: GROUP BY (declared keys
    plus decorrelation keys) + hidden aggregates + HAVING + the single
    projection. Returns (df, out_col_name, count_shaped) where
    count_shaped marks a projection that is exactly a COUNT aggregate —
    its empty-group value is 0, not NULL (Spark scalar-subquery
    semantics; the LEFT-join decorrelation coalesces it).

    `require_agg` (correlated scalar subqueries): a subquery with no
    aggregate cannot guarantee at most one row per correlation key —
    duplicate inner rows would silently multiply outer rows — so it is
    rejected instead of decorrelated."""
    df = info.df
    if len(info.projs) != 1 or isinstance(info.projs[0][0], str):
        raise UnsupportedExpr(
            "subquery must select exactly one expression")
    proj, alias = info.projs[0]
    aggs = []
    proj = _extract_aggs(proj, aggs)
    having = info.having
    if having is not None:
        having = _extract_aggs(having, aggs)
    keys = list(info.group_keys or []) + [ColumnRef(k)
                                          for k in extra_keys]
    if aggs:
        count_shaped = (isinstance(proj, ColumnRef) and len(aggs) == 1
                        and proj.name == aggs[0][0]
                        and isinstance(aggs[0][1],
                                       (agg.Count, agg.CountStar)))
        gp = df.group_by(*keys)
        df = gp.agg(*[a.alias(n) for n, a in aggs])
        if having is not None:
            df = df.filter(having)
        out_name = alias or "__sqout"
        df = df.select(*(list(keys) + [proj.alias(out_name)]))
        return df, out_name, count_shaped
    if require_agg:
        raise UnsupportedExpr(
            "correlated scalar subquery without an aggregate: cannot "
            "guarantee a single row per correlation key (duplicate "
            "inner rows would multiply outer rows); aggregate the "
            "subquery output (e.g. min/max/count)")
    if having is not None:
        raise UnsupportedExpr("HAVING without aggregates in subquery")
    out_name = alias or (proj.name if isinstance(proj, ColumnRef)
                         else "__sqout")
    df = df.select(*(list(keys) + [proj.alias(out_name)]))
    return df, out_name, False


def _corr_inner_names(corr):
    """Inner (non-outer) column names referenced by correlation
    conjuncts — the columns the decorrelated subquery must keep."""
    names = []

    def fn(x):
        if type(x) is ColumnRef and not isinstance(x, OuterRef):
            names.append(x.name)
        return x
    for c in corr:
        _walk_replace(c, fn)
    return list(dict.fromkeys(names))


def _apply_marker(session, df, m):
    """Rewrite one WHERE subquery conjunct into joins/filters on `df`
    (Spark's RewritePredicateSubquery / scalar-subquery decorrelation;
    reference: these arrive pre-rewritten from Catalyst, and runtime
    filters ride InSubqueryExec)."""
    from ..expr.expressions import Literal as Lit
    if isinstance(m, _Exists):
        info = m.sub
        if info.group_keys or info.having:
            raise UnsupportedExpr("EXISTS over grouped subquery")
        if not info.corr:
            rows = info.df.limit(1).to_arrow().num_rows
            keep = (rows > 0) != m.negated
            return df if keep else df.filter(Lit(False))
        sdf, rename = _rename_all(info.df)
        cond = None
        for c in info.corr:
            c2 = _resolve_scopes(c, rename)
            cond = c2 if cond is None else (cond & c2)
        return df.join(sdf, on=cond,
                       how="left_anti" if m.negated else "left_semi")
    if isinstance(m, _InSub):
        info = m.sub
        # correlation columns must survive the subquery's projection so
        # the join condition can reference them post-rename
        extra = [n for n in _corr_inner_names(info.corr)]
        sub_out, out_name, _ = _finalize_sub_output(session, info,
                                                    extra_keys=extra)
        if m.negated:
            # NOT IN is null-AWARE (three-valued logic): any NULL in
            # the subquery makes every comparison UNKNOWN -> empty
            # result, and outer rows with a NULL probe drop too
            if info.corr:
                raise UnsupportedExpr(
                    "correlated NOT IN (use NOT EXISTS)")
            has_null = sub_out.filter(
                ColumnRef(out_name).isNull()).limit(1) \
                .to_arrow().num_rows
            if has_null:
                return df.filter(Lit(False))
            df = df.filter(m.left.isNotNull())
        sdf, rename = _rename_all(sub_out)
        cond = m.left == ColumnRef(rename[out_name])
        for c in info.corr:
            cond = cond & _resolve_scopes(c, rename)
        return df.join(sdf, on=cond,
                       how="left_anti" if m.negated else "left_semi")
    if isinstance(m, _SubCompare):
        sub = m.left if isinstance(m.left, _ScalarSub) else m.right
        other = m.right if sub is m.left else m.left
        info = sub.sub
        ops = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
               "<>": lambda a, b: a != b, "<": lambda a, b: a < b,
               "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
               ">=": lambda a, b: a >= b}
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                "=": "=", "!=": "!=", "<>": "<>"}
        op = m.op if sub is m.right else flip[m.op]
        # now the comparison reads: other <op> subquery-value
        if not info.corr:
            val_df, out_name, _ = _finalize_sub_output(session, info)
            rows = val_df.to_arrow().to_pylist()
            if len(rows) > 1:
                raise ValueError(
                    f"scalar subquery returned {len(rows)} rows")
            val = rows[0][out_name] if rows else None
            return df.filter(ops[op](other, Lit(val)))
        # correlated: every corr conjunct must be outer == inner
        from ..expr.expressions import Eq
        inner_keys = []
        outer_keys = []
        for c in info.corr:
            if not isinstance(c, Eq):
                raise UnsupportedExpr(
                    "correlated scalar subquery needs equality "
                    "correlation")
            a, b = c.children
            if isinstance(a, OuterRef) and type(b) is ColumnRef:
                outer_keys.append(a.name)
                inner_keys.append(b.name)
            elif isinstance(b, OuterRef) and type(a) is ColumnRef:
                outer_keys.append(b.name)
                inner_keys.append(a.name)
            else:
                raise UnsupportedExpr(
                    "correlated scalar subquery needs col = col "
                    "correlation")
        sub_out, out_name, count_shaped = _finalize_sub_output(
            session, info, extra_keys=inner_keys, require_agg=True)
        sdf, rename = _rename_all(sub_out)
        cond = None
        for ok, ik in zip(outer_keys, inner_keys):
            c2 = ColumnRef(ok) == ColumnRef(rename[ik])
            cond = c2 if cond is None else (cond & c2)
        # LEFT join (not inner): outer rows whose correlation group is
        # EMPTY survive with a NULL subquery value. NULL comparisons
        # drop the row — Spark's scalar-subquery semantics for
        # sum/min/max/avg — while COUNT-shaped aggregates read 0 for
        # empty groups, so `0 = (SELECT count(*) ...)` keeps unmatched
        # outer rows.
        val = ColumnRef(rename[out_name])
        if count_shaped:
            from ..expr.expressions import Coalesce
            val = Coalesce(val, Literal(0))
        joined = df.join(sdf, on=cond, how="left")
        return joined.filter(ops[op](other, val))
    raise UnsupportedExpr(f"unhandled subquery marker {m!r}")


def _parse_from(p: "_Parser", session):
    """FROM item [alias] + JOIN chain -> DataFrame (derived tables via
    parenthesized subselects); records aliases in p.local_aliases."""
    from ..plan import logical as L
    from ..session import DataFrame
    views = getattr(session, "_views", {})

    def get_view(nm):
        if nm.lower() not in views:
            raise ValueError(f"unknown table/view {nm}")
        return views[nm.lower()]

    def from_item():
        if p.accept("op", "("):
            sub = p._subquery()
            if sub.corr:
                raise UnsupportedExpr("correlated derived table")
            p.expect("op", ")")
            d = _finalize_derived(session, sub)
        else:
            nm = p.expect("id")[1]
            d = get_view(nm)
            # the TABLE NAME is itself a scope alias: a correlated
            # predicate may qualify by it (t1.k) with no explicit alias
            p.local_aliases.add(nm.lower())
        t = p.accept("id")
        if t:
            p.local_aliases.add(t[1].lower())
        return d

    base = from_item()
    while True:
        how = None
        if p.accept("kw", "join") or (p.accept("kw", "inner")
                                      and p.expect("kw", "join")):
            how = "inner"
        elif p.accept("kw", "left"):
            p.accept("kw", "outer")
            if p.accept("kw", "semi"):
                how = "left_semi"
            elif p.accept("kw", "anti"):
                how = "left_anti"
            else:
                how = "left"
            p.expect("kw", "join")
        elif p.accept("kw", "right"):
            p.accept("kw", "outer")
            p.expect("kw", "join")
            how = "right"
        elif p.accept("kw", "full"):
            p.accept("kw", "outer")
            p.expect("kw", "join")
            how = "full"
        elif p.accept("kw", "cross"):
            p.expect("kw", "join")
            how = "cross"
        else:
            break
        other = from_item()
        if how == "cross":
            base = DataFrame(session, L.Join(base._plan, other._plan, [],
                                             [], "cross"))
            continue
        if p.accept("kw", "using"):
            p.expect("op", "(")
            cols = [p.expect("id")[1]]
            while p.accept("op", ","):
                cols.append(p.expect("id")[1])
            p.expect("op", ")")
            base = base.join(other, on=cols, how=how)
        else:
            p.expect("kw", "on")
            cond = _no_subquery(p.expr(), "JOIN ON")
            base = base.join(other, on=cond, how=how)
    return base


def _finalize_derived(session, info: "_SubInfo"):
    """Materialize a derived table (FROM (SELECT ...) t): projection +
    optional grouping, no correlation."""
    df = info.df
    if len(info.projs) == 1 and isinstance(info.projs[0][0], str):
        return df          # SELECT *
    aggs_present = any(isinstance(e, agg.AggExpr)
                       for e, _ in info.projs
                       if not isinstance(e, str))
    if info.group_keys is not None or aggs_present:
        keys = info.group_keys or []
        out_aggs = []
        sel = []
        for e, alias in info.projs:
            if isinstance(e, agg.AggExpr):
                nm = alias or f"__d{len(out_aggs)}"
                out_aggs.append((nm, e))
                sel.append(ColumnRef(nm))
            else:
                sel.append(e.alias(alias) if alias else e)
        gp = df.group_by(*keys)
        df = gp.agg(*[a.alias(n) for n, a in out_aggs])
        if info.having is not None:
            hv_aggs = []
            hv = _extract_aggs(info.having, hv_aggs)
            if hv_aggs:
                raise UnsupportedExpr(
                    "derived-table HAVING over new aggregates")
            df = df.filter(hv)
        return df.select(*sel)
    if info.having is not None:
        raise UnsupportedExpr("HAVING without aggregation")
    return df.select(*[e.alias(a) if a else e for e, a in info.projs])


def parse_sql(session, sql: str):
    from ..session import DataFrame
    from ..plan import logical as L

    # EXPLAIN [ANALYZE] <select>: ANALYZE runs the query and renders the
    # plan annotated with runtime metrics; plain EXPLAIN renders the
    # placement tagging. Either way the result is a one-row `plan`
    # column DataFrame (the Spark EXPLAIN output shape).
    m = re.match(r"\s*explain\b(\s+analyze\b)?", sql, re.IGNORECASE)
    if m:
        inner = parse_sql(session, sql[m.end():])
        text = inner.explain("ANALYZE" if m.group(1) else "ALL")
        import pyarrow as pa
        return DataFrame(session,
                         L.InMemoryScan(pa.table({"plan": [text or ""]})))

    p = _Parser(_tokenize(sql), session=session)
    undo_ctes = _parse_ctes(p, session)
    try:
        return _finish_select(p, session)
    finally:
        undo_ctes()


_CTE_ABSENT = object()


def _parse_ctes(p: "_Parser", session):
    """WITH name AS (subquery) [, ...]: each CTE materializes as a
    statement-scoped view — later CTEs and the main query resolve it by
    name through session._views. Same-named session views are shadowed
    for the statement and restored by the returned undo callable."""
    if not p.accept("kw", "with"):
        return lambda: None
    if not hasattr(session, "_views"):
        session._views = {}
    views = session._views
    shadowed = {}
    while True:
        nm = p.expect("id")[1].lower()
        p.expect("kw", "as")
        p.expect("op", "(")
        info = p._subquery()
        if info.corr:
            raise UnsupportedExpr("correlated CTE")
        p.expect("op", ")")
        if nm not in shadowed:
            shadowed[nm] = views.get(nm, _CTE_ABSENT)
        views[nm] = _finalize_derived(session, info)
        if not p.accept("op", ","):
            break

    def undo():
        for name, old in shadowed.items():
            if old is _CTE_ABSENT:
                views.pop(name, None)
            else:
                views[name] = old
    return undo


def _finish_select(p: "_Parser", session):
    from ..session import DataFrame
    from ..plan import logical as L
    p.expect("kw", "select")
    distinct = bool(p.accept("kw", "distinct"))
    projs = p._select_list()
    p.expect("kw", "from")
    base = _parse_from(p, session)

    df = base
    if p.accept("kw", "where"):
        plain, marks = p.where_parts()
        for m in marks:
            df = _apply_marker(session, df, m)
        if plain is not None:
            df = df.filter(plain)

    group_keys = None
    having_expr = None
    if p.accept("kw", "group"):
        p.expect("kw", "by")
        group_keys = [_no_subquery(p.expr(), "GROUP BY")]
        while p.accept("op", ","):
            group_keys.append(_no_subquery(p.expr(), "GROUP BY"))
    if p.accept("kw", "having"):
        having_expr = _no_subquery(p.expr(), "HAVING")

    # build select
    def is_agg(e):
        return isinstance(e, agg.AggExpr)

    def contains_agg(e):
        found = []

        def fn(x):
            if is_agg(x):
                found.append(x)
            return x
        _walk_replace(e, fn)
        return bool(found)

    has_agg = any(contains_agg(e) for e, _ in projs
                  if not isinstance(e, str))
    if group_keys is not None or has_agg:
        keys = group_keys or []
        aggs = []
        # expressions CONTAINING aggregates (sum(x)/7.0) extract the agg
        # nodes into hidden columns and project over them afterwards
        new_projs = []
        for j, (e, alias) in enumerate(projs):
            if isinstance(e, str):
                raise ValueError("SELECT * with GROUP BY")
            if is_agg(e):
                aggs.append((alias or f"{e!r}", e))
                new_projs.append((e, alias))
            elif contains_agg(e):
                # extract into the SHARED list: hidden names are
                # __sqa{len(aggs)} so they stay unique across projections
                e2 = _extract_aggs(e, aggs)
                new_projs.append((e2, alias))
            else:
                new_projs.append((e, alias))
        projs = new_projs
        # HAVING: rewrite aggregate calls to (possibly hidden) agg columns
        # BEFORE projection (SQL applies HAVING pre-projection)
        if having_expr is not None:
            by_repr = {repr(a): n for n, a in aggs}

            def rw(e):
                if is_agg(e):
                    nm = by_repr.get(repr(e))
                    if nm is None:
                        nm = f"_having{len(aggs)}"
                        aggs.append((nm, e))
                        by_repr[repr(e)] = nm
                    return ColumnRef(nm)
                for attr in ("left", "right", "child", "pred", "t", "f"):
                    c = getattr(e, attr, None)
                    if c is not None and hasattr(c, "bind"):
                        setattr(e, attr, rw(c))
                if getattr(e, "children", None):
                    e.children = [rw(c) if hasattr(c, "bind") else c
                                  for c in e.children]
                return e

            having_expr = rw(having_expr)
        gp = df.group_by(*keys) if keys else df.group_by()
        df = gp.agg(*[a.alias(n) for n, a in aggs]) if aggs             else gp.count()
        if having_expr is not None:
            df = df.filter(having_expr)
        # reorder/select per projection list (drops hidden having cols)
        sel = []
        for e, alias in projs:
            if is_agg(e):
                nm = alias or [n for n, a in aggs if a is e][0]
                sel.append(ColumnRef(nm).alias(alias) if alias
                           else ColumnRef(nm))
            else:
                sel.append(e.alias(alias) if alias else e)
        df = df.select(*sel)
    else:
        if having_expr is not None:
            raise ValueError("HAVING without aggregation")
        if len(projs) == 1 and isinstance(projs[0][0], str):
            pass
        else:
            sel = [e.alias(a) if a else e for e, a in projs]
            df = df.select(*sel)

    if distinct:
        df = df.distinct()

    if p.accept("kw", "order"):
        p.expect("kw", "by")
        orders = []
        while True:
            e = _no_subquery(p.expr(), "ORDER BY")
            asc = True
            if p.accept("kw", "desc"):
                asc = False
            else:
                p.accept("kw", "asc")
            orders.append(SortOrder(e, asc))
            if not p.accept("op", ","):
                break
        df = DataFrame(session, L.Sort(df._plan, orders))

    if p.accept("kw", "limit"):
        n = p.expect("num")[1]
        df = df.limit(int(n))

    p.expect("eof")
    return df
