"""Aggregate functions: the update / merge / finalize protocol, ungrouped
and grouped.

Ported subset: Sum, Count, CountStar, Avg, Min, Max and CountDistinct
(which runs only through the optimizer's two-level rewrite,
`plan/optimizer.py` `rewrite_distinct_aggs`). Ungrouped states
are tuples of 0-d tensors; grouped states (`g_update`) are tuples of
[num_segments] tensors, one per entry of `state_reducers`, which names
how the grouped merge combines each ("sum", "or", "min" or "max"), and
`state_dtypes` their column types on the partial-aggregate wire; an
aggregate whose reducers are ("custom",) merges its `num_state_cols()`
columns itself (`g_merge_custom`). Null semantics follow Spark: sum,
min and max over zero valid rows are null, count is never null, avg is
null when its count is 0.

Min and max follow the JAX package: NaN is the greatest float, but a
float min maps NaN to +Infinity first, so a min over only NaN is
+Infinity (`docs/compatibility.md`); -0.0 orders below 0.0 (XLA's
min/max). A float reduces as its order-preserving integer key
(`float_key`), so the result is exact and the same on any device and in
any row order; a decimal128 reduces its high word, then its low word
(bias-flipped to signed order) among the rows that hold the winning
high word. Strings are refused, as in the JAX package.

A decimal sum whose result precision exceeds 18 (Q6's decimal(17,4)
product sums into decimal(27,4); Q1's decimal(24,6) charge into
decimal(34,6)) accumulates EXACTLY: each value splits into 32-bit limbs
(two for a decimal64 input, four for a decimal128 one; the top limb
signed), each limb sums in int64, and finalize recombines the limb sums
with carries; a total beyond the result precision is null (Spark
non-ANSI). Every such accumulator is an integer (limbs, counts, the
avg's sum), so `index_add_` sums are exact on any device. A double
accumulator (a sum or avg of doubles) depends on the order of its
additions: `seg_sum` adds each segment's rows in a fixed order on the
card, so a grouped double sum repeats bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..columnar import dtypes as dt
from ..ops.kernel_utils import CV
from .expressions import Expression, UnsupportedExpr

__all__ = ["AggExpr", "Sum", "Count", "CountStar", "Avg", "Min", "Max",
           "CountDistinct", "seg_sum", "seg_any", "seg_min_max", "float_key"]


def seg_sum(x: torch.Tensor, seg_ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum: per-segment sums of x. An integer sum is
    exact in any order (`index_add_`). A floating `index_add_` on CUDA
    adds by atomics, in an order that changes from run to run, so there
    a floating sum goes through `index_put_(accumulate=True)`, which
    sorts the ids stably and adds each segment's rows in that fixed
    order. On the CPU `index_add_` adds in row order already."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.is_floating_point() and x.device.type == "cuda":
        return out.index_put_((seg_ids.long(),), x, accumulate=True)
    return out.index_add_(0, seg_ids, x)


def seg_any(m: torch.Tensor, seg_ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """segment_max(m) > 0 of a bool m: does any row of a segment hold."""
    return seg_sum(m.to(torch.int32), seg_ids, num_segments) > 0


_INT_OF_FLOAT = {torch.float64: torch.int64, torch.float32: torch.int32}


def float_key(x: torch.Tensor) -> torch.Tensor:
    """A float tensor as integers of the same order, -0.0 below 0.0 and
    every NaN above +Infinity: the bits, with a negative value's
    magnitude bits flipped. `key_float` inverts it (a NaN comes back as
    one NaN)."""
    it = _INT_OF_FLOAT[x.dtype]
    top = torch.iinfo(it).max
    b = x.view(it)
    return torch.where(torch.isnan(x), top,
                       b ^ ((b >> (b.element_size() * 8 - 1)) & top))


def key_float(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.iinfo(k.dtype).max
    x = (k ^ ((k >> (k.element_size() * 8 - 1)) & top)).view(dtype)
    return torch.where(k == top, float("nan"), x)


def ident(dtype: torch.dtype, for_min: bool):
    """min/max identity of a tensor dtype (JAX `_ident`)."""
    if dtype.is_floating_point:
        return float("inf") if for_min else float("-inf")
    if dtype == torch.bool:
        return for_min
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def seg_min_max(x: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                for_min: bool) -> torch.Tensor:
    """jax.ops.segment_min / segment_max: an empty segment holds the
    identity. Floats reduce as `float_key`s, booleans as bytes."""
    red = "amin" if for_min else "amax"
    if x.is_floating_point():
        k = float_key(x)
        out = torch.full((num_segments,), float_key(torch.tensor(
            [ident(x.dtype, for_min)], dtype=x.dtype)).item(),
            dtype=k.dtype, device=x.device)
        out.scatter_reduce_(0, seg_ids, k, red, include_self=True)
        return key_float(out, x.dtype)
    if x.dtype == torch.bool:
        return seg_min_max(x.to(torch.uint8), seg_ids, num_segments,
                           for_min).bool()
    out = torch.full((num_segments,), ident(x.dtype, for_min),
                     dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg_ids, x, red, include_self=True)


def _min_max(x: torch.Tensor, for_min: bool) -> torch.Tensor:
    """The 0-d min or max of x under seg_min_max's order."""
    return seg_min_max(x, torch.zeros_like(x, dtype=torch.int64), 1,
                       for_min)[0]


class AggExpr(Expression):
    """An aggregate over a child expression."""

    def __init__(self, child: Optional[Expression]):
        self.child = child
        self.children = [child] if child is not None else []

    def bind(self, schema):
        b = type(self)(self.child.bind(schema) if self.child else None)
        b._resolve_type()
        return b

    def _resolve_type(self):
        raise NotImplementedError

    # update(cv, mask) -> state; merge(s1, s2) -> state;
    # finalize(state) -> (value, valid), elementwise over grouped states;
    # g_update(cv, mask, seg_ids, num_segments) -> grouped state
    state_reducers = ("sum",)

    def state_dtypes(self):
        """Column types of the grouped state, one per state_reducers
        entry."""
        return [dt.INT64]

    def __repr__(self):
        return f"{type(self).__name__.lower()}({self.child})"


class Sum(AggExpr):
    state_reducers = ("sum", "or")

    def _resolve_type(self):
        ct = self.child.dtype
        self._d128 = False
        self._in_d128 = False
        if isinstance(ct, dt.DecimalType):
            self.dtype = dt.DecimalType(min(38, ct.precision + 10),
                                        ct.scale)
            if self.dtype.is_decimal128:
                self._d128 = True
                self._in_d128 = ct.is_decimal128
                nlimbs = 4 if self._in_d128 else 2
                self.state_reducers = ("sum",) * nlimbs + ("or",)
        elif ct.is_integral or isinstance(ct, dt.BooleanType):
            self.dtype = dt.INT64
        elif ct.is_floating or isinstance(ct, dt.NullType):
            self.dtype = dt.FLOAT64
        else:
            raise UnsupportedExpr(f"sum({ct})")

    def state_dtypes(self):
        acc = dt.FLOAT64 if self.dtype == dt.FLOAT64 else dt.INT64
        return [acc] * (len(self.state_reducers) - 1) + [dt.BOOL]

    def _limbs(self, cv: CV, m):
        from ..ops import decimal128 as d128
        raw = (d128.split_d128_limbs(cv.data) if self._in_d128
               else d128.split_i64_limbs(cv.data))
        return [torch.where(m, l, 0) for l in raw]

    def _values(self, cv: CV, m):
        acc = dt.torch_dtype(self.dtype)
        return torch.where(m, cv.data.to(acc),
                           torch.zeros((), dtype=acc, device=m.device))

    def update(self, cv: CV, mask):
        m = mask & cv.validity
        if self._d128:
            return tuple(l.sum() for l in self._limbs(cv, m)) + (m.any(),)
        return (self._values(cv, m).sum(), m.any())

    def g_update(self, cv: CV, mask, seg_ids, num_segments):
        m = mask & cv.validity
        has = seg_any(m, seg_ids, num_segments)
        if self._d128:
            return tuple(seg_sum(l, seg_ids, num_segments)
                         for l in self._limbs(cv, m)) + (has,)
        return (seg_sum(self._values(cv, m), seg_ids, num_segments), has)

    def merge(self, s1, s2):
        return tuple(a + b for a, b in zip(s1[:-1], s2[:-1])) \
            + (s1[-1] | s2[-1],)

    def finalize(self, s):
        if self._d128:
            from ..ops.decimal128 import combine_limb_sums
            val, ovf = combine_limb_sums(list(s[:-1]), self.dtype.precision)
            return val, s[-1] & ~ovf
        return s[0], s[1]


class Count(AggExpr):
    def _resolve_type(self):
        self.dtype = dt.INT64

    def update(self, cv: CV, mask):
        return ((mask & cv.validity).sum(dtype=torch.int64),)

    def g_update(self, cv, mask, seg_ids, num_segments):
        return (seg_sum((mask & cv.validity).to(torch.int64), seg_ids,
                        num_segments),)

    def merge(self, s1, s2):
        return (s1[0] + s2[0],)

    def finalize(self, s):
        return s[0], torch.ones((), dtype=torch.bool, device=s[0].device)


class CountStar(AggExpr):
    def __init__(self, child=None):
        super().__init__(None)

    def _resolve_type(self):
        self.dtype = dt.INT64

    def bind(self, schema):
        b = CountStar()
        b._resolve_type()
        return b

    def update(self, cv, mask):
        return (mask.sum(dtype=torch.int64),)

    def g_update(self, cv, mask, seg_ids, num_segments):
        return (seg_sum(mask.to(torch.int64), seg_ids, num_segments),)

    def merge(self, s1, s2):
        return (s1[0] + s2[0],)

    def finalize(self, s):
        return s[0], torch.ones((), dtype=torch.bool, device=s[0].device)

    def __repr__(self):
        return "count(*)"


class Avg(AggExpr):
    """sum / count. Over a decimal(p, s) input the result is
    decimal(18, min(s + 4, 18)): the int64 sum scaled up and divided by
    the count with HALF_UP rounding, exactly as the JAX package does it
    (`total * 10^shift` in int64)."""

    state_reducers = ("sum", "sum")

    def _resolve_type(self):
        ct = self.child.dtype
        self._int_acc = False
        if isinstance(ct, dt.DecimalType):
            if ct.is_decimal128:
                raise UnsupportedExpr(
                    "avg over decimal precision > 18 (sum/count it "
                    "explicitly, or cast)")
            self.dtype = dt.DecimalType(18, min(ct.scale + 4, 18))
            self._sum_scale = ct.scale
        elif ct.is_integral or isinstance(ct, dt.BooleanType):
            # Spark computes avg(long) from the wrapping int64 sum
            self.dtype = dt.FLOAT64
            self._sum_scale = None
            self._int_acc = True
        elif ct.is_numeric or isinstance(ct, dt.NullType):
            self.dtype = dt.FLOAT64
            self._sum_scale = None
        else:
            raise UnsupportedExpr(f"avg({ct})")

    def state_dtypes(self):
        exact = self._sum_scale is not None or self._int_acc
        return [dt.INT64 if exact else dt.FLOAT64, dt.INT64]

    def _acc(self, cv, m):
        acc = (torch.int64 if self._sum_scale is not None or self._int_acc
               else torch.float64)
        return torch.where(m, cv.data.to(acc),
                           torch.zeros((), dtype=acc, device=m.device))

    def update(self, cv: CV, mask):
        m = mask & cv.validity
        return (self._acc(cv, m).sum(), m.sum(dtype=torch.int64))

    def merge(self, s1, s2):
        return (s1[0] + s2[0], s1[1] + s2[1])

    def finalize(self, s):
        total, cnt = s
        valid = cnt > 0
        safe = torch.where(valid, cnt, 1)
        if self._sum_scale is not None:
            num = total * (10 ** (self.dtype.scale - self._sum_scale))
            half = safe // 2
            adj = torch.where(num >= 0, num + half, num - half)
            q = torch.div(adj, safe, rounding_mode="floor")
            r = adj - q * safe
            q = torch.where((r != 0) & (adj < 0), q + 1, q)
            return q, valid
        return total.to(torch.float64) / safe, valid

    def g_update(self, cv, mask, seg_ids, num_segments):
        m = mask & cv.validity
        return (seg_sum(self._acc(cv, m), seg_ids, num_segments),
                seg_sum(m.to(torch.int64), seg_ids, num_segments))


def _d128_sortable(data2):
    """[n, 2] words -> (hi, lo'): the lexicographic min/max of (hi, lo')
    is the signed 128-bit min/max (lo bias-flipped to signed order)."""
    return data2[..., 1], data2[..., 0] ^ (-(1 << 63))


def _d128_unsortable(hi, lo):
    return torch.stack([lo ^ (-(1 << 63)), hi], dim=-1)


class _MinMax(AggExpr):
    for_min = True

    def _resolve_type(self):
        ct = self.child.dtype
        if ct.is_variable_width:
            raise UnsupportedExpr(f"min/max({ct}) round-1")
        self._d128_in = isinstance(ct, dt.DecimalType) and ct.is_decimal128
        self.state_reducers = (("custom",) if self._d128_in else
                               ("min" if self.for_min else "max", "or"))
        self.dtype = ct

    def num_state_cols(self):
        return 3 if self._d128_in else 2

    def state_dtypes(self):
        if self._d128_in:
            return [dt.INT64, dt.INT64, dt.BOOL]
        return [self.dtype, dt.BOOL]

    def _masked(self, cv, m):
        """Invalid rows become the identity; a float min maps NaN to
        +Infinity (NaN is the greatest value, so it must lose to any
        real one)."""
        x = torch.where(m, cv.data, ident(cv.data.dtype, self.for_min))
        if self.for_min and x.is_floating_point():
            x = torch.where(torch.isnan(x), float("inf"), x)
        return x

    def _lex(self, hi, lo, seg_ids, n):
        """(hi, lo) of each segment's lexicographic min/max."""
        red_hi = seg_min_max(hi, seg_ids, n, self.for_min)
        cand = torch.where(hi == red_hi[seg_ids], lo,
                           ident(torch.int64, self.for_min))
        return red_hi, seg_min_max(cand, seg_ids, n, self.for_min)

    def _d128_masked(self, cv, m):
        hi, lo = _d128_sortable(cv.data)
        i = ident(torch.int64, self.for_min)
        return torch.where(m, hi, i), torch.where(m, lo, i)

    def update(self, cv: CV, mask):
        m = mask & cv.validity
        if self._d128_in:
            hi, lo = self._d128_masked(cv, m)
            zeros = torch.zeros_like(hi)
            red_hi, red_lo = self._lex(hi, lo, zeros, 1)
            return (red_hi[0], red_lo[0], m.any())
        return (_min_max(self._masked(cv, m), self.for_min), m.any())

    def merge(self, s1, s2):
        if self._d128_in:
            h = torch.stack([s1[0], s2[0]])
            lo = torch.stack([s1[1], s2[1]])
            red_hi, red_lo = self._lex(h, lo, torch.zeros_like(h), 1)
            return (red_hi[0], red_lo[0], s1[2] | s2[2])
        # an all-invalid state holds the identity: a plain min/max is safe
        return (_min_max(torch.stack([s1[0], s2[0]]), self.for_min),
                s1[1] | s2[1])

    def finalize(self, s):
        if self._d128_in:
            return _d128_unsortable(s[0], s[1]), s[2]
        return s[0], s[1]

    def g_update(self, cv, mask, seg_ids, num_segments):
        m = mask & cv.validity
        has = seg_any(m, seg_ids, num_segments)
        if self._d128_in:
            hi, lo = self._d128_masked(cv, m)
            return self._lex(hi, lo, seg_ids, num_segments) + (has,)
        return (seg_min_max(self._masked(cv, m), seg_ids, num_segments,
                            self.for_min), has)

    def g_merge_custom(self, cols_sorted, live, seg_ids, num_segments):
        hi, lo, has = cols_sorted
        eligible = live & has.bool()
        i = ident(torch.int64, self.for_min)
        return self._lex(torch.where(eligible, hi, i),
                         torch.where(eligible, lo, i), seg_ids,
                         num_segments) + (seg_any(eligible, seg_ids,
                                                  num_segments),)


class Min(_MinMax):
    for_min = True


class Max(_MinMax):
    for_min = False


class CountDistinct(AggExpr):
    """count(DISTINCT x), an INT64 that skips nulls. The JAX package
    answers it on the sort path (`CollectAggExec`); the port runs it
    only as the optimizer's two-level rewrite (an inner DISTINCT
    aggregate over the keys and x, an outer Count), and the planner
    refuses any shape that rewrite leaves alone."""

    is_collect = True

    def _resolve_type(self):
        if isinstance(self.child.dtype, dt.NestedType):
            raise UnsupportedExpr("count distinct over nested input")
        self.dtype = dt.INT64

    def __repr__(self):
        return f"count(DISTINCT {self.child})"
