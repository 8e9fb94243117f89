"""Collection (array, map, struct) expressions and higher-order functions.

The port's copy of the JAX package's `expr/collection_exprs.py`. A list
column is int32 offsets [n + 1] over one flat element child
(`ops/kernel_utils.py` `CV`). A per-row operation over elements is one
flat op over the element buffer plus a segment reduction keyed by the
element -> row map (`elem_rows`); no op loops over rows. Offsets may
leave gaps (a null row's range, elements before the first row): every op
masks the elements it reads through `elem_rows`'s `live`.

A lambda body (transform, filter, exists, forall) runs once over the
whole element buffer; an outer column it captures is gathered to the
element domain on first use, and a string or nested capture is refused,
as the JAX package refuses it. `aggregate` folds each row's elements in
order: one vectorized step of its merge function per element position,
over all rows at once (the JAX package scans the element buffer), and
its merge captures no outer column.
"""
from __future__ import annotations

import inspect
import itertools
from typing import Callable, List, Optional

import torch

from ..columnar import dtypes as dt
from ..ops import concat as ops_concat
from ..ops import gather as ops_gather
from ..ops.kernel_utils import CV
from ..utils import transfer
from .expressions import (BoundRef, Cast, EmitCtx, Expression,
                          UnsupportedExpr, _UnaryOp, _wrap)

__all__ = [
    "CreateArray", "GetArrayItem", "ElementAt", "Size", "ArrayContains",
    "ArrayMin", "ArrayMax", "SortArray", "CreateNamedStruct",
    "GetStructField", "MapKeys", "MapValues", "Explode", "PosExplode",
    "NamedLambdaVariable", "ArrayTransform", "ArrayFilter", "ArrayExists",
    "ArrayForAll", "ArrayAggregate", "arr_lens", "elem_rows",
]


# ----------------------------------------------------------------------
# element-domain helpers
# ----------------------------------------------------------------------
def arr_lens(cv: CV) -> torch.Tensor:
    """int32 element counts per row (0 for a null row)."""
    lens = (cv.offsets[1:] - cv.offsets[:-1]).to(torch.int32)
    return torch.where(cv.validity, lens, 0)


def elem_rows(cv: CV):
    """(rows, live): the row that owns each element of the child (int64,
    in [0, n - 1]), and whether the element belongs to a valid row's
    range (False in a gap, under a null row, past the last row)."""
    ecap = cv.child.capacity
    cap = cv.capacity
    dev = cv.validity.device
    if cap == 0 or ecap == 0:
        return (torch.zeros(ecap, dtype=torch.int64, device=dev),
                torch.zeros(ecap, dtype=torch.bool, device=dev))
    off = cv.offsets.to(torch.int64)
    rows = ops_gather.row_of_unit(cv.offsets, cap, ecap)
    pos = torch.arange(ecap, dtype=torch.int64, device=dev)
    lens = arr_lens(cv).to(torch.int64)
    live = (pos >= off[rows]) & (pos < off[rows] + lens[rows]) \
        & cv.validity[rows]
    return rows, live


def _take_elems(child: CV, pos: torch.Tensor, ok: torch.Tensor) -> CV:
    """One element per row (positions `pos` where `ok`), null elsewhere."""
    if child.capacity == 0:
        return ops_gather.null_like(child, pos.shape[0])
    return ops_gather.take(child, pos.to(torch.int64).clamp(
        0, child.capacity - 1), ok)


def _seg_min_pos(x: torch.Tensor, rows: torch.Tensor, cap: int,
                 fill: int) -> torch.Tensor:
    out = torch.full((cap,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, rows, x, "amin", include_self=True)


class _LazyElemCvs:
    """ctx.cvs for a lambda body: an outer column is gathered to the
    element domain on first use (a captured variable)."""

    def __init__(self, cvs, rows, live):
        self._cvs = cvs
        self._rows = rows
        self._live = live
        self._cache = {}

    def __getitem__(self, i):
        if i not in self._cache:
            self._cache[i] = ops_gather.take(self._cvs[i], self._rows,
                                             self._live)
        return self._cache[i]

    def __len__(self):
        return len(self._cvs)


def _elem_ctx(ctx: EmitCtx, arr: CV):
    rows, live = elem_rows(arr)
    ectx = EmitCtx([], arr.child.capacity, ctx.device)
    ectx.cvs = _LazyElemCvs(ctx.cvs, rows, live)
    ectx.lambda_vals = dict(ctx.lambda_vals)
    return ectx, rows, live


def _coerce(e: Expression, target: dt.DataType, what: str) -> Expression:
    """Spark's implicit cast of a bound expression to `target`."""
    if e.dtype == target:
        return e
    if e.dtype.is_numeric and target.is_numeric:
        return Cast.bound(e, target)
    raise UnsupportedExpr(f"{what}: cannot coerce {e.dtype} to {target}")


def _require_array(e: Expression, what: str):
    if not isinstance(e.dtype, (dt.ArrayType, dt.MapType)):
        raise UnsupportedExpr(f"{what} requires an array/map, got {e.dtype}")


def _bool(cv: CV) -> torch.Tensor:
    return cv.data.to(torch.bool)


# ----------------------------------------------------------------------
# constructors
# ----------------------------------------------------------------------
class CreateArray(Expression):
    """array(e1, ..., ek): row i -> [e1[i], ..., ek[i]]. The k children
    concatenate (child j at rows [j n, (j + 1) n)), then one interleaving
    gather, src(i k + j) = j n + i, gives the element child, of any
    element type."""

    def __init__(self, children: List[Expression]):
        if not children:
            raise UnsupportedExpr("array() needs at least one element")
        self.children = list(children)

    def bind(self, schema):
        b = CreateArray([c.bind(schema) for c in self.children])
        et = b.children[0].dtype
        for c in b.children[1:]:
            if c.dtype != et:
                raise UnsupportedExpr(
                    f"array() elements must share a type: {et} vs {c.dtype}")
        b.dtype = dt.ArrayType(et)
        return b

    def emit(self, ctx: EmitCtx) -> CV:
        k = len(self.children)
        cap, dev = ctx.capacity, ctx.device
        cvs = [c.emit(ctx) for c in self.children]
        comb = (ops_concat.concat_cvs(cvs, self.children[0].dtype)
                if k > 1 else cvs[0])
        e = torch.arange(cap * k, dtype=torch.int64, device=dev)
        child = ops_gather.take(comb, (e % k) * cap + e // k)
        off = torch.arange(cap + 1, dtype=torch.int32, device=dev) * k
        return CV(torch.zeros(0, dtype=torch.int8, device=dev),
                  torch.ones(cap, dtype=torch.bool, device=dev), off,
                  (child,))

    def __repr__(self):
        return f"array({', '.join(map(repr, self.children))})"


class CreateNamedStruct(Expression):
    """named_struct / struct(...): one field a child, never null."""

    def __init__(self, names: List[str], children: List[Expression]):
        assert len(names) == len(children)
        self.names = list(names)
        self.children = list(children)

    def bind(self, schema):
        b = CreateNamedStruct(self.names,
                              [c.bind(schema) for c in self.children])
        b.dtype = dt.StructType(tuple(
            dt.StructField(n, c.dtype) for n, c in zip(b.names, b.children)))
        return b

    def emit(self, ctx: EmitCtx) -> CV:
        kids = tuple(c.emit(ctx) for c in self.children)
        dev = ctx.device
        return CV(torch.zeros(0, dtype=torch.int8, device=dev),
                  torch.ones(ctx.capacity, dtype=torch.bool, device=dev),
                  None, kids)

    def __repr__(self):
        inner = ", ".join(f"{n}: {c!r}"
                          for n, c in zip(self.names, self.children))
        return f"struct({inner})"


class GetStructField(Expression):
    """col.field: the field's column under the struct's validity."""

    def __init__(self, child: Expression, field: str):
        self.child = child
        self.field = field
        self.children = [child]

    def bind(self, schema):
        b = GetStructField(self.child.bind(schema), self.field)
        if not isinstance(b.child.dtype, dt.StructType):
            raise UnsupportedExpr(f"getField on {b.child.dtype}")
        for i, f in enumerate(b.child.dtype.fields):
            if f.name == self.field:
                b._ordinal = i
                b.dtype = f.dtype
                return b
        raise UnsupportedExpr(
            f"no field {self.field!r} in {b.child.dtype}")

    def emit(self, ctx: EmitCtx) -> CV:
        cv = self.child.emit(ctx)
        ch = cv.children[self._ordinal]
        return CV(ch.data, ch.validity & cv.validity, ch.offsets,
                  ch.children)

    def __repr__(self):
        return f"{self.child}.{self.field}"


# ----------------------------------------------------------------------
# extractors and scalar ops
# ----------------------------------------------------------------------
class Size(_UnaryOp):
    """size(array | map) -> int32; a null input gives null."""

    def _resolve_type(self):
        _require_array(self.child, "size")
        self.dtype = dt.INT32

    def emit(self, ctx: EmitCtx) -> CV:
        cv = self.child.emit(ctx)
        return CV(arr_lens(cv), cv.validity)

    def __repr__(self):
        return f"size({self.child})"


def _index_cv(idx: CV, cap: int) -> torch.Tensor:
    return idx.data.to(torch.int64).expand(cap) if idx.data.dim() == 0 \
        else idx.data.to(torch.int64)


class GetArrayItem(Expression):
    """arr[i], 0-based; out of bounds or negative gives null."""

    def __init__(self, child: Expression, index):
        self.child = child
        self.index = _wrap(index)
        self.children = [self.child, self.index]

    def bind(self, schema):
        b = GetArrayItem(self.child.bind(schema), self.index.bind(schema))
        if not isinstance(b.child.dtype, dt.ArrayType):
            raise UnsupportedExpr(f"getItem on {b.child.dtype}")
        if not b.index.dtype.is_integral:
            raise UnsupportedExpr(f"array index must be integral, "
                                  f"got {b.index.dtype}")
        b.dtype = b.child.dtype.element
        return b

    def emit(self, ctx: EmitCtx) -> CV:
        arr = self.child.emit(ctx)
        idx = self.index.emit(ctx)
        k = _index_cv(idx, ctx.capacity)
        lens = arr_lens(arr)
        ok = arr.validity & idx.validity & (k >= 0) & (k < lens)
        pos = arr.offsets[:-1].to(torch.int64) + torch.where(ok, k, 0)
        return _take_elems(arr.child, pos, ok)

    def __repr__(self):
        return f"{self.child}[{self.index}]"


def _equal_rowmap(ecv: CV, vcv: CV, rows, live) -> torch.Tensor:
    """bool per element: element e equals the row value vcv[rows[e]]."""
    if ecv.offsets is not None:
        from ..ops import strings as ops_str
        return ops_str.str_equal_rowmap(ecv, vcv, rows, live)
    return ((ecv.data == vcv.data[rows]) & ecv.validity
            & vcv.validity[rows] & live)


class ElementAt(Expression):
    """element_at(array, i), 1-based (a negative i counts from the end),
    or element_at(map, key): the value of the first entry whose key
    equals `key`."""

    def __init__(self, child: Expression, key):
        self.child = child
        self.key = _wrap(key)
        self.children = [self.child, self.key]

    def bind(self, schema):
        b = ElementAt(self.child.bind(schema), self.key.bind(schema))
        cdt = b.child.dtype
        if isinstance(cdt, dt.ArrayType):
            if not b.key.dtype.is_integral:
                raise UnsupportedExpr("element_at(array, non-integer index)")
            b.dtype = cdt.element
        elif isinstance(cdt, dt.MapType):
            if cdt.key.is_nested:
                raise UnsupportedExpr("element_at over nested map keys")
            b.key = _coerce(b.key, cdt.key, "element_at")
            b.children = [b.child, b.key]
            b.dtype = cdt.value
        else:
            raise UnsupportedExpr(f"element_at on {cdt}")
        return b

    def emit(self, ctx: EmitCtx) -> CV:
        arr = self.child.emit(ctx)
        cap = ctx.capacity
        if isinstance(self.child.dtype, dt.ArrayType):
            idx = self.key.emit(ctx)
            k = _index_cv(idx, cap)
            lens = arr_lens(arr).to(torch.int64)
            k0 = torch.where(k > 0, k - 1, lens + k)
            ok = (arr.validity & idx.validity & (k != 0) & (k0 >= 0)
                  & (k0 < lens))
            pos = arr.offsets[:-1].to(torch.int64) + torch.where(ok, k0, 0)
            return _take_elems(arr.child, pos, ok)
        key = self.key.emit(ctx)
        rows, live = elem_rows(arr)
        kcv, vcv = arr.child.children
        ecap = rows.shape[0]
        match = _equal_rowmap(kcv, key, rows, live)
        epos = torch.arange(ecap, dtype=torch.int64, device=ctx.device)
        first = _seg_min_pos(torch.where(match, epos, ecap), rows, cap,
                             ecap)
        found = first < ecap
        return _take_elems(vcv, first, found & arr.validity & key.validity)

    def __repr__(self):
        return f"element_at({self.child}, {self.key})"


class ArrayContains(Expression):
    """array_contains(arr, value), Spark's nulls: a null array gives
    null; no match where the array holds a null element gives null."""

    def __init__(self, child: Expression, value):
        self.child = child
        self.value = _wrap(value)
        self.children = [self.child, self.value]

    def bind(self, schema):
        b = ArrayContains(self.child.bind(schema), self.value.bind(schema))
        if not isinstance(b.child.dtype, dt.ArrayType):
            raise UnsupportedExpr(f"array_contains on {b.child.dtype}")
        if b.child.dtype.element.is_nested:
            raise UnsupportedExpr("array_contains over nested elements")
        b.value = _coerce(b.value, b.child.dtype.element, "array_contains")
        b.children = [b.child, b.value]
        b.dtype = dt.BOOL
        return b

    def emit(self, ctx: EmitCtx) -> CV:
        from .aggregates import seg_any
        arr = self.child.emit(ctx)
        rows, live = elem_rows(arr)
        cap = ctx.capacity
        val = self.value.emit(ctx)
        ecv = arr.child
        has = seg_any(_equal_rowmap(ecv, val, rows, live), rows, cap)
        has_null = seg_any(live & ~ecv.validity, rows, cap)
        return CV(has, arr.validity & val.validity & (has | ~has_null))

    def __repr__(self):
        return f"array_contains({self.child}, {self.value})"


class _ArrayReduce(_UnaryOp):
    _kind = "min"

    def _resolve_type(self):
        _require_array(self.child, f"array_{self._kind}")
        et = self.child.dtype.element
        if not (et.is_numeric or et in (dt.DATE, dt.TIMESTAMP)):
            raise UnsupportedExpr(f"array_{self._kind} on array<{et}>")
        if isinstance(et, dt.DecimalType) and et.is_decimal128:
            raise UnsupportedExpr(f"array_{self._kind} on decimal128")
        self.dtype = et

    def emit(self, ctx: EmitCtx) -> CV:
        from .aggregates import ident, seg_any, seg_min_max
        cv = self.child.emit(ctx)
        rows, live = elem_rows(cv)
        cap = ctx.capacity
        e = cv.child
        m = live & e.validity
        for_min = self._kind == "min"
        vals = torch.where(m, e.data, ident(e.data.dtype, for_min))
        red = seg_min_max(vals, rows, cap, for_min)
        if red.is_floating_point():
            # a NaN element makes the row's min and max NaN, as XLA's
            # minimum and maximum give it in the JAX package (ROADMAP
            # C.20: Spark's array_min skips NaN)
            nan = seg_any(m & torch.isnan(e.data), rows, cap)
            red = torch.where(nan, float("nan"), red)
        return CV(red, cv.validity & seg_any(m, rows, cap))

    def __repr__(self):
        return f"array_{self._kind}({self.child})"


class ArrayMin(_ArrayReduce):
    _kind = "min"


class ArrayMax(_ArrayReduce):
    _kind = "max"


class SortArray(Expression):
    """sort_array(arr, asc): each row's elements sorted, nulls first
    ascending and last descending (Spark's). One stable sort of the whole
    element buffer by (row start, null tier, value): a valid row's
    elements stay in its range, and an element outside every valid row
    keys on its own position, so it stays where it is."""

    def __init__(self, child: Expression, asc: bool = True):
        self.child = child
        self.asc = asc
        self.children = [child]

    def bind(self, schema):
        b = SortArray(self.child.bind(schema), self.asc)
        if not isinstance(b.child.dtype, dt.ArrayType):
            raise UnsupportedExpr(f"sort_array on {b.child.dtype}")
        et = b.child.dtype.element
        if not (et.is_numeric or et in (dt.DATE, dt.TIMESTAMP, dt.BOOL)):
            raise UnsupportedExpr(f"sort_array on array<{et}> "
                                  "(fixed-width elements only)")
        b.dtype = b.child.dtype
        return b

    def emit(self, ctx: EmitCtx) -> CV:
        from ..ops import sortkeys as sk
        arr = self.child.emit(ctx)
        e = arr.child
        if e.capacity == 0:
            return arr
        rows, live = elem_rows(arr)
        et = self.child.dtype.element
        keys = sk.order_keys(CV(e.data, e.validity), et,
                             descending=not self.asc)
        nullk = torch.where(e.validity, 1, 0 if self.asc else 2).to(
            torch.uint8)
        pos = torch.arange(e.capacity, dtype=torch.int64,
                           device=ctx.device)
        group = torch.where(live, arr.offsets.to(torch.int64)[rows], pos)
        order = sk.lexsort([group, nullk] + keys)
        child = ops_gather.take(e, order, live[order])
        return CV(arr.data, arr.validity, arr.offsets, (child,))

    def __repr__(self):
        return f"sort_array({self.child}, asc={self.asc})"


class MapKeys(_UnaryOp):
    def _resolve_type(self):
        if not isinstance(self.child.dtype, dt.MapType):
            raise UnsupportedExpr(f"map_keys on {self.child.dtype}")
        self.dtype = dt.ArrayType(self.child.dtype.key, False)

    def emit(self, ctx: EmitCtx) -> CV:
        cv = self.child.emit(ctx)
        return CV(cv.data, cv.validity, cv.offsets,
                  (cv.child.children[0],))

    def __repr__(self):
        return f"map_keys({self.child})"


class MapValues(_UnaryOp):
    def _resolve_type(self):
        if not isinstance(self.child.dtype, dt.MapType):
            raise UnsupportedExpr(f"map_values on {self.child.dtype}")
        self.dtype = dt.ArrayType(self.child.dtype.value)

    def emit(self, ctx: EmitCtx) -> CV:
        cv = self.child.emit(ctx)
        return CV(cv.data, cv.validity, cv.offsets,
                  (cv.child.children[1],))

    def __repr__(self):
        return f"map_values({self.child})"


# ----------------------------------------------------------------------
# generators (run by GenerateExec, never emitted inline)
# ----------------------------------------------------------------------
class Explode(_UnaryOp):
    """explode(arr): the number of rows changes, so `DataFrame.select`
    lifts it into a Generate node (`exec/generate.py`)."""

    outer = False
    with_position = False

    def bind(self, schema):
        b = type(self)(self.child.bind(schema))
        b.outer = self.outer
        b._resolve_type()
        return b

    def _resolve_type(self):
        _require_array(self.child, "explode")
        self.dtype = dt.element_dtype(self.child.dtype)

    def emit(self, ctx):
        raise UnsupportedExpr(
            "explode() must be the top-level expression of a select "
            "(planner lifts it into GenerateExec)")

    def __repr__(self):
        return f"explode({self.child})"


class PosExplode(Explode):
    with_position = True

    def __repr__(self):
        return f"posexplode({self.child})"


# ----------------------------------------------------------------------
# higher-order functions
# ----------------------------------------------------------------------
_hof_ids = itertools.count()


class NamedLambdaVariable(Expression):
    """A lambda parameter: emits the element-domain CV its higher-order
    function registered."""

    def __init__(self, name: str, dtype: Optional[dt.DataType] = None,
                 var_id: Optional[int] = None):
        self._name = name
        self.dtype = dtype
        self.var_id = var_id if var_id is not None else next(_hof_ids)
        self.children = []

    @property
    def name(self):
        return self._name

    def bind(self, schema):
        return self

    def emit(self, ctx: EmitCtx) -> CV:
        try:
            return ctx.lambda_vals[self.var_id]
        except KeyError:
            raise UnsupportedExpr(
                f"lambda variable {self._name} used outside its function")

    def __repr__(self):
        return self._name


def _reject_varwidth_captures(bound_body: Expression):
    """A lambda body runs over the element domain: a captured outer
    column is replicated to its row's elements. The JAX package cannot
    size that for a string or nested column and refuses it; so does the
    port. (The lambda's own variables are fine.)"""
    stack = [bound_body]
    while stack:
        e = stack.pop()
        if isinstance(e, BoundRef) and (
                e.dtype.is_variable_width or e.dtype.is_nested):
            raise UnsupportedExpr(
                f"lambda captures var-width outer column {e!r} "
                "(element-domain replication is unsized on TPU)")
        stack.extend(getattr(e, "children", []))


def _captures(bound_body: Expression) -> bool:
    stack = [bound_body]
    while stack:
        e = stack.pop()
        if isinstance(e, BoundRef):
            return True
        stack.extend(getattr(e, "children", []))
    return False


def _nargs(fn: Callable) -> int:
    return len(inspect.signature(fn).parameters)


class _HigherOrder(Expression):
    """Binds the array child, then the lambda body with its variables
    typed by the element type."""

    def __init__(self, child: Expression, fn: Callable, bound=None):
        self.child = child
        self.fn = fn
        self._bound = bound  # (bound child, var, pos var, bound body)
        # the lambda expanded once over placeholders, so tree walks
        # (column pruning) see the outer columns it captures
        tvars = [NamedLambdaVariable(f"_t{i}") for i in range(_nargs(fn))]
        self.children = [child, _wrap(fn(*tvars))]

    def bind(self, schema):
        bchild = self.child.bind(schema)
        if not isinstance(bchild.dtype, (dt.ArrayType, dt.MapType)):
            raise UnsupportedExpr(f"{type(self).__name__} on {bchild.dtype}")
        var = NamedLambdaVariable("x", dt.element_dtype(bchild.dtype))
        pos_var = (NamedLambdaVariable("i", dt.INT32)
                   if _nargs(self.fn) >= 2 else None)
        body = self.fn(var, pos_var) if pos_var is not None else self.fn(var)
        bbody = _wrap(body).bind(schema)
        _reject_varwidth_captures(bbody)
        b = type(self)(bchild, self.fn, (bchild, var, pos_var, bbody))
        b._resolve_type(bchild, bbody)
        return b

    def _emit_body(self, ctx: EmitCtx):
        bchild, var, pos_var, bbody = self._bound
        arr = bchild.emit(ctx)
        ectx, rows, live = _elem_ctx(ctx, arr)
        ectx.lambda_vals[var.var_id] = arr.child
        if pos_var is not None:
            pos = torch.arange(rows.shape[0], dtype=torch.int64,
                               device=ctx.device)
            idx = pos - arr.offsets[:-1].to(torch.int64)[rows]
            ectx.lambda_vals[pos_var.var_id] = CV(idx.to(torch.int32), live)
        return arr, rows, live, bbody.emit(ectx)


class ArrayTransform(_HigherOrder):
    """transform(arr, x -> f(x)) or (x, i) -> f(x, i): the body over the
    whole element buffer."""

    def _resolve_type(self, bchild, bbody):
        self.dtype = dt.ArrayType(bbody.dtype)

    def emit(self, ctx: EmitCtx) -> CV:
        arr, rows, live, out = self._emit_body(ctx)
        return CV(arr.data, arr.validity, arr.offsets, (out,))

    def __repr__(self):
        return f"transform({self.child}, <lambda>)"


class ArrayFilter(_HigherOrder):
    """filter(arr, x -> pred(x)): the kept elements, in order (one
    compaction of the element buffer keeps (row, position) order)."""

    def _resolve_type(self, bchild, bbody):
        if bbody.dtype != dt.BOOL:
            raise UnsupportedExpr("filter lambda must return boolean")
        self.dtype = bchild.dtype

    def emit(self, ctx: EmitCtx) -> CV:
        from .aggregates import seg_sum
        arr, rows, live, out = self._emit_body(ctx)
        keep = live & out.validity & _bool(out)
        cap = ctx.capacity
        new_off = torch.zeros(cap + 1, dtype=torch.int32, device=ctx.device)
        if cap:
            torch.cumsum(seg_sum(keep.to(torch.int32), rows, cap), 0,
                         dtype=torch.int32, out=new_off[1:])
        idx = torch.nonzero(keep).squeeze(1)
        transfer.note_sync()
        child = ops_gather.take(arr.child, idx)
        return CV(arr.data, arr.validity, new_off, (child,))

    def __repr__(self):
        return f"filter({self.child}, <lambda>)"


class _ArrayPredicate(_HigherOrder):
    _any = True

    def _resolve_type(self, bchild, bbody):
        if bbody.dtype != dt.BOOL:
            raise UnsupportedExpr("exists/forall lambda must return boolean")
        self.dtype = dt.BOOL

    def emit(self, ctx: EmitCtx) -> CV:
        from .aggregates import seg_any
        arr, rows, live, out = self._emit_body(ctx)
        cap = ctx.capacity
        if self._any:
            red = seg_any(live & out.validity & _bool(out), rows, cap)
        else:
            miss = live & (~_bool(out) | ~out.validity)
            red = ~seg_any(miss, rows, cap)
        return CV(red, arr.validity)


class ArrayExists(_ArrayPredicate):
    _any = True

    def __repr__(self):
        return f"exists({self.child}, <lambda>)"


class ArrayForAll(_ArrayPredicate):
    _any = False

    def __repr__(self):
        return f"forall({self.child}, <lambda>)"


class ArrayAggregate(Expression):
    """aggregate(arr, zero, (acc, x) -> merge): a left fold of each row's
    elements from its own zero (the zero may be any expression; the
    merge may not capture an outer column, which the JAX package cannot
    evaluate). Step k applies the merge to the k-th element of every row
    that has one, all rows at once: as many steps as the longest row
    (one host read of it), each a vectorized body."""

    def __init__(self, child: Expression, zero, fn: Callable, bound=None):
        self.child = child
        self.zero = _wrap(zero)
        self.fn = fn
        self._bound = bound
        tvars = [NamedLambdaVariable("_ta"), NamedLambdaVariable("_tx")]
        self.children = [self.child, self.zero, _wrap(fn(*tvars))]

    def bind(self, schema):
        bchild = self.child.bind(schema)
        if not isinstance(bchild.dtype, dt.ArrayType):
            raise UnsupportedExpr(f"aggregate on {bchild.dtype}")
        bzero = self.zero.bind(schema)
        acc_var = NamedLambdaVariable("acc", bzero.dtype)
        x_var = NamedLambdaVariable("x", bchild.dtype.element)
        bbody = _wrap(self.fn(acc_var, x_var)).bind(schema)
        if bbody.dtype != bzero.dtype:
            # widen the accumulator to the merge's type (Spark's implicit
            # cast of the zero) and bind the lambda once more
            bzero = _coerce(bzero, bbody.dtype, "aggregate zero")
            acc_var = NamedLambdaVariable("acc", bzero.dtype)
            bbody = _wrap(self.fn(acc_var, x_var)).bind(schema)
        if bbody.dtype != bzero.dtype:
            raise UnsupportedExpr(
                f"aggregate merge type {bbody.dtype} != zero {bzero.dtype}")
        if bbody.dtype.is_nested or bbody.dtype.is_variable_width:
            raise UnsupportedExpr("aggregate acc must be fixed-width")
        if _captures(bbody):
            # the JAX package folds with no outer columns in reach (its
            # scan fails on a capture); the port refuses one at bind
            raise UnsupportedExpr("aggregate's merge captures an outer "
                                  "column")
        b = ArrayAggregate(bchild, bzero, self.fn,
                           (bchild, bzero, acc_var, x_var, bbody))
        b.dtype = bzero.dtype
        return b

    def emit(self, ctx: EmitCtx) -> CV:
        bchild, bzero, acc_var, x_var, bbody = self._bound
        arr = bchild.emit(ctx)
        cap = ctx.capacity
        zcv = bzero.emit(ctx)
        acc_d = zcv.data.expand(cap).clone() if zcv.data.dim() == 0 \
            else zcv.data.clone()
        acc_v = zcv.validity.expand(cap).clone() \
            if zcv.validity.dim() == 0 else zcv.validity.clone()
        lens = arr_lens(arr).to(torch.int64)
        steps = transfer.fetch_int(lens.max()) if cap else 0
        starts = arr.offsets[:-1].to(torch.int64)
        for k in range(steps):
            active = lens > k
            x = _take_elems(arr.child, starts + k, active)
            ectx = EmitCtx(ctx.cvs, cap, ctx.device)
            ectx.lambda_vals = dict(ctx.lambda_vals)
            ectx.lambda_vals[acc_var.var_id] = CV(acc_d, acc_v)
            ectx.lambda_vals[x_var.var_id] = x
            out = bbody.emit(ectx)
            acc_d = torch.where(active, out.data, acc_d)
            acc_v = torch.where(active, out.validity, acc_v)
        return CV(acc_d, acc_v & arr.validity)

    def __repr__(self):
        return f"aggregate({self.child}, {self.zero}, <lambda>)"
