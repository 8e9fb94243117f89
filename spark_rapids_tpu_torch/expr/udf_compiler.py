"""Python-UDF compiler: translate simple Python functions into engine
expression trees, so they run as device expressions instead of a host
call; a copy of the JAX package's `expr/udf_compiler.py` over the port's
Expression algebra and `functions`.

(reference: udf-compiler/ — CFG recovery + symbolic execution of JVM
bytecode into Catalyst expressions, CatalystExpressionBuilder.scala. The
Python analog is far simpler: parse the function's AST and map the
supported node set onto the engine's Expression algebra; anything outside
the subset raises CompileError, and `udf` falls back to the PyUDF host
call, exactly like the reference falling back to a black-box UDF.)

Supported subset: arithmetic (+ - * / // % **), comparisons (incl.
chains), and/or/not, `x if c else y`, `is None` / `is not None`,
abs/min/max/round/len, math.{sqrt,floor,ceil,exp,log,sin,cos}, string
methods upper/lower/strip/startswith/endswith/contains, closures over
plain numeric/string constants.
"""
from __future__ import annotations

import ast
import inspect
import math
import textwrap
from typing import Callable, List, Optional

from .expressions import Expression, Literal

__all__ = ["compile_udf", "CompileError"]


class CompileError(Exception):
    pass


def _fn_ast(fn: Callable):
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError) as e:
        raise CompileError(f"no source: {e}")
    src = textwrap.dedent(src)
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # lambda embedded in a larger expression (e.g. an argument):
        # re-parse in eval mode after slicing at the lambda keyword
        i = src.find("lambda")
        if i < 0:
            raise CompileError("cannot locate function source")
        # try progressively shorter tails until one parses
        for end in range(len(src), i, -1):
            try:
                tree = ast.parse(src[i:end], mode="eval")
                return tree.body
            except SyntaxError:
                continue
        raise CompileError("cannot parse lambda source")
    fdefs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
    if fdefs:
        return fdefs[0]
    lams = [n for n in ast.walk(tree) if isinstance(n, ast.Lambda)]
    if len(lams) != 1:
        # two lambdas in one source statement: inspect can't tell which
        # one `fn` is, and guessing compiles the wrong body
        raise CompileError("ambiguous lambda source")
    return lams[0]


def _resolve_const(fn: Callable, name: str):
    """Closure/global lookup for plain constants."""
    if fn.__closure__ and fn.__code__.co_freevars:
        for nm, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            if nm == name:
                return cell.cell_contents
    g = getattr(fn, "__globals__", {})
    if name in g:
        return g[name]
    raise CompileError(f"unresolved name {name!r}")


class _Builder:
    def __init__(self, fn: Callable, params: List[str],
                 args: List[Expression]):
        self.fn = fn
        self.env = dict(zip(params, args))

    def build(self, node) -> Expression:
        meth = getattr(self, f"_n_{type(node).__name__}", None)
        if meth is None:
            raise CompileError(f"unsupported syntax {type(node).__name__}")
        return meth(node)

    # -- leaves --------------------------------------------------------
    def _n_Name(self, n):
        if n.id in self.env:
            return self.env[n.id]
        v = _resolve_const(self.fn, n.id)
        if isinstance(v, (int, float, str, bool)) or v is None:
            return Literal(v)
        raise CompileError(f"{n.id!r} is not a plain constant")

    def _n_Constant(self, n):
        if isinstance(n.value, (int, float, str, bool)) \
                or n.value is None:
            return Literal(n.value)
        raise CompileError(f"unsupported constant {n.value!r}")

    # -- operators -----------------------------------------------------
    _BINOPS = {ast.Add: "__add__", ast.Sub: "__sub__",
               ast.Mult: "__mul__", ast.Div: "__truediv__",
               ast.FloorDiv: "__floordiv__", ast.Mod: "__mod__",
               ast.Pow: "__pow__"}

    def _n_BinOp(self, n):
        a, b = self.build(n.left), self.build(n.right)
        meth = self._BINOPS.get(type(n.op))
        if meth is None or not hasattr(a, meth):
            raise CompileError(f"unsupported operator {type(n.op).__name__}")
        out = getattr(a, meth)(b)
        if out is NotImplemented:
            raise CompileError(f"operator {meth} not supported")
        return out

    def _n_UnaryOp(self, n):
        v = self.build(n.operand)
        if isinstance(n.op, ast.USub):
            return Literal(0) - v if not hasattr(v, "__neg__") else -v
        if isinstance(n.op, ast.Not):
            return ~v
        raise CompileError(f"unsupported unary {type(n.op).__name__}")

    _CMPOPS = {ast.Eq: "__eq__", ast.NotEq: "__ne__", ast.Lt: "__lt__",
               ast.LtE: "__le__", ast.Gt: "__gt__", ast.GtE: "__ge__"}

    def _n_Compare(self, n):
        terms = []
        left = self.build(n.left)
        for op, cmp_ in zip(n.ops, n.comparators):
            if isinstance(op, (ast.Is, ast.IsNot)):
                if not (isinstance(cmp_, ast.Constant)
                        and cmp_.value is None):
                    raise CompileError("`is` only supported against None")
                from .expressions import IsNotNull, IsNull
                terms.append(IsNull(left) if isinstance(op, ast.Is)
                             else IsNotNull(left))
                continue
            meth = self._CMPOPS.get(type(op))
            if meth is None:
                raise CompileError(
                    f"unsupported comparison {type(op).__name__}")
            right = self.build(cmp_)
            terms.append(getattr(left, meth)(right))
            left = right
        out = terms[0]
        for t in terms[1:]:
            out = out & t
        return out

    def _n_BoolOp(self, n):
        vals = [self.build(v) for v in n.values]
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if isinstance(n.op, ast.And) else (out | v)
        return out

    def _n_IfExp(self, n):
        from .expressions import CaseWhen
        return CaseWhen([(self.build(n.test), self.build(n.body))],
                        self.build(n.orelse))

    # -- calls ---------------------------------------------------------
    def _n_Call(self, n):
        from .. import functions as F
        if n.keywords:
            raise CompileError("keyword arguments not supported")
        args = [self.build(a) for a in n.args]
        if isinstance(n.func, ast.Name):
            nm = n.func.id
            if nm == "abs" and len(args) == 1:
                return F.abs(args[0])
            if nm == "round" and len(args) in (1, 2):
                sc = 0
                if len(args) == 2:
                    if not isinstance(args[1], Literal):
                        raise CompileError("round scale must be constant")
                    sc = args[1].value
                return F.round(args[0], sc)
            if nm == "min" and len(args) >= 2:
                return F.least(*args)
            if nm == "max" and len(args) >= 2:
                return F.greatest(*args)
            if nm == "len" and len(args) == 1:
                return F.length(args[0])
            raise CompileError(f"unsupported function {nm}")
        if isinstance(n.func, ast.Attribute):
            base = n.func.value
            meth = n.func.attr
            if isinstance(base, ast.Name):
                try:
                    mod = _resolve_const(self.fn, base.id)
                except CompileError:
                    mod = None
                if mod is math:
                    mfn = getattr(F, meth, None)
                    if mfn is None or len(args) != 1:
                        raise CompileError(f"unsupported math.{meth}")
                    return mfn(args[0])
            # string methods on a compiled subexpression
            recv = self.build(base)
            if meth == "upper" and not args:
                return F.upper(recv)
            if meth == "lower" and not args:
                return F.lower(recv)
            if meth == "strip" and not args:
                from .string_exprs import Trim
                return Trim(recv)
            if meth == "startswith" and len(args) == 1:
                from .string_exprs import StartsWith
                return StartsWith(recv, args[0])
            if meth == "endswith" and len(args) == 1:
                from .string_exprs import EndsWith
                return EndsWith(recv, args[0])
            raise CompileError(f"unsupported method .{meth}()")
        raise CompileError("unsupported call form")


def compile_udf(fn: Callable,
                args: List[Expression]) -> Optional[Expression]:
    """Compile `fn` applied to the given argument expressions; returns
    the expression tree, or raises CompileError when fn is outside the
    supported subset (caller falls back to PyUDF)."""
    node = _fn_ast(fn)
    if isinstance(node, ast.Lambda):
        params = [a.arg for a in node.args.args]
        body = node.body
    elif isinstance(node, ast.FunctionDef):
        params = [a.arg for a in node.args.args]
        stmts = [s_ for s_ in node.body
                 if not isinstance(s_, (ast.Expr,))  # docstrings
                 or not isinstance(getattr(s_, "value", None),
                                   ast.Constant)]
        if len(stmts) != 1 or not isinstance(stmts[0], ast.Return):
            raise CompileError("only single-return functions compile")
        body = stmts[0].value
    else:
        raise CompileError("unsupported callable")
    if len(params) != len(args):
        raise CompileError(
            f"arity mismatch: {len(params)} params, {len(args)} columns")
    return _Builder(fn, params, args).build(body)
