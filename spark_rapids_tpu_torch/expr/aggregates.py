"""Aggregate functions: the update / merge / finalize protocol, ungrouped
and grouped.

Ported: Sum, Count, CountStar, Avg, Min, Max, First, Last, Variance,
Stddev, ApproxCountDistinct (HyperLogLog++) and ApproxPercentile (a
t-digest), which ride the partial states; CountDistinct (the optimizer's
two-level rewrite, `plan/optimizer.py` `rewrite_distinct_aggs`, or
`CollectAggExec`), Percentile and Median are `is_collect`: they run on
`CollectAggExec`'s sort path, as a string's First / Last does. Not
ported: CollectList, CollectSet and percentiles over a list (ArrayType,
ROADMAP A.5). BloomFilterAggregate builds one filter, ungrouped only,
as in the JAX package; `parse_bloom_filter` reads its payload back.
Ungrouped states
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

import math
from typing import Optional

import torch

from ..columnar import dtypes as dt
from ..ops.kernel_utils import CV
from .expressions import Expression, UnsupportedExpr

__all__ = ["AggExpr", "Sum", "Count", "CountStar", "Avg", "Min", "Max",
           "CountDistinct", "First", "Last", "Variance", "Stddev",
           "ApproxCountDistinct", "Percentile", "ApproxPercentile",
           "Median", "CollectList", "CollectSet", "BloomFilterAggregate",
           "parse_bloom_filter", "seg_sum", "seg_any", "seg_min_max",
           "float_key"]


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
        if ct.is_variable_width or ct.is_nested:
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
    """count(DISTINCT x), an INT64 that skips nulls: the optimizer's
    two-level rewrite (an inner DISTINCT aggregate over the keys and x,
    an outer Count) where it applies, else `CollectAggExec`'s sort path
    (the first of each group's equal values counts)."""

    is_collect = True

    def _resolve_type(self):
        if self.child.dtype.is_nested:
            raise UnsupportedExpr("count distinct over nested input")
        self.dtype = dt.INT64

    def __repr__(self):
        return f"count(DISTINCT {self.child})"


class _Collect(AggExpr):
    """collect_list / collect_set on `CollectAggExec`'s sort path (JAX
    `expr/aggregates.py:568-600`): one stable sort by the keys makes each
    group's values contiguous, in input order, and the kept values are
    the list child. collect_set keeps each value's first occurrence (a
    second sort by value finds it), in that same order. Nulls are
    skipped; an empty group gives an empty list."""

    state_reducers = None
    is_collect = True
    is_set = False

    def _resolve_type(self):
        if self.child.dtype.is_nested:
            raise UnsupportedExpr(
                f"{type(self).__name__.lower()} over nested input")
        self.dtype = dt.ArrayType(self.child.dtype, contains_null=False)


class CollectList(_Collect):
    def __repr__(self):
        return f"collect_list({self.child})"


class CollectSet(_Collect):
    is_set = True

    def __repr__(self):
        return f"collect_set({self.child})"


# ----------------------------------------------------------------------
# first / last
# ----------------------------------------------------------------------
def _seg_extreme_pos(eligible, seg_ids, num_segments: int,
                     take_first: bool):
    """Per segment, the position of its first (or last) eligible row:
    (a safe index, found)."""
    n = eligible.shape[0]
    cand = torch.where(eligible, torch.arange(n, device=eligible.device),
                       n if take_first else -1)
    pos = seg_min_max(cand, seg_ids, num_segments, take_first)
    found = (pos < n) if take_first else (pos >= 0)
    return pos.clamp(0, max(n - 1, 0)), found


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx]; zeros when x has no rows (every idx then unfound)."""
    if x.shape[0] == 0:
        return torch.zeros(tuple(idx.shape) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=x.device)
    return x[idx]


class _FirstLast(AggExpr):
    """State (value, valid, has): `has` marks that an eligible row was
    seen. The grouped merge takes the first (last) eligible partial in
    concatenation order, which every merge keeps (stable sorts, partials
    and exchange pieces in input order), so the answer is the first
    (last) row in scan order. A string input cannot ride the
    fixed-width state wire: it runs on `CollectAggExec`'s sort path."""

    take_first = True
    state_reducers = ("custom",)

    def __init__(self, child, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def bind(self, schema):
        b = type(self)(self.child.bind(schema), self.ignore_nulls)
        b._resolve_type()
        return b

    def _resolve_type(self):
        ct = self.child.dtype
        if ct.is_nested:
            raise UnsupportedExpr("first/last on nested input")
        if ct.is_variable_width:
            self.is_collect = True
        self.dtype = ct

    def num_state_cols(self):
        return 3

    def state_dtypes(self):
        return [self.dtype, dt.BOOL, dt.BOOL]

    def update(self, cv: CV, mask):
        v, ok, has = self.g_update(
            cv, mask, torch.zeros_like(mask, dtype=torch.int64), 1)
        return v[0], ok[0], has[0]

    def merge(self, s1, s2):
        a, b = (s1, s2) if self.take_first else (s2, s1)
        return (torch.where(a[2], a[0], b[0]),
                torch.where(a[2], a[1], b[1]), a[2] | b[2])

    def finalize(self, s):
        return s[0], s[1]

    def g_update(self, cv, mask, seg_ids, num_segments):
        elig = mask & cv.validity if self.ignore_nulls else mask
        safe, has = _seg_extreme_pos(elig, seg_ids, num_segments,
                                     self.take_first)
        return (_pick(cv.data, safe), _pick(cv.validity, safe) & has, has)

    def g_merge_custom(self, cols_sorted, live, seg_ids, num_segments):
        val, valid, has = cols_sorted
        safe, found = _seg_extreme_pos(live & has.bool(), seg_ids,
                                       num_segments, self.take_first)
        return (_pick(val, safe), _pick(valid, safe).bool() & found, found)

    def __repr__(self):
        ign = ", ignorenulls" if self.ignore_nulls else ""
        return f"{type(self).__name__.lower()}({self.child}{ign})"


class First(_FirstLast):
    take_first = True


class Last(_FirstLast):
    take_first = False


# ----------------------------------------------------------------------
# variance / stddev
# ----------------------------------------------------------------------
class Variance(AggExpr):
    """var_samp (Spark's variance). State (n, mean, M2): an update takes
    each segment's mean, then M2 = sum((x - mean)^2); merges combine by
    Chan's formula. Never E[x^2] - E[x]^2, which cancels catastrophically
    for large magnitudes. A decimal input scales by 10^-scale."""

    state_reducers = ("custom",)
    ddof = 1

    def _resolve_type(self):
        ct = self.child.dtype
        if not (ct.is_numeric or isinstance(ct, dt.NullType)):
            raise UnsupportedExpr(f"variance({ct})")
        if isinstance(ct, dt.DecimalType) and ct.is_decimal128:
            raise UnsupportedExpr(
                "variance over decimal precision > 18 (cast first)")
        self.dtype = dt.FLOAT64
        self._scale = (10.0 ** -ct.scale
                       if isinstance(ct, dt.DecimalType) else 1.0)

    def num_state_cols(self):
        return 3

    def state_dtypes(self):
        return [dt.INT64, dt.FLOAT64, dt.FLOAT64]

    def _xs(self, cv, m):
        return torch.where(m, cv.data.to(torch.float64), 0.0) * self._scale

    def update(self, cv: CV, mask):
        m = mask & cv.validity
        x = self._xs(cv, m)
        n = m.sum(dtype=torch.int64)
        mean = x.sum() / n.clamp(min=1).to(torch.float64)
        d = torch.where(m, x - mean, 0.0)
        return (n, mean, (d * d).sum())

    def merge(self, s1, s2):
        n1, m1, q1 = s1
        n2, m2, q2 = s2
        n = n1 + n2
        nf = n.clamp(min=1).to(torch.float64)
        delta = m2 - m1
        mean = m1 + delta * (n2.to(torch.float64) / nf)
        q = q1 + q2 + delta * delta * (n1.to(torch.float64)
                                       * n2.to(torch.float64) / nf)
        return (n, mean, q)

    def finalize(self, s):
        n, _, m2 = s
        valid = n > self.ddof
        denom = torch.where(valid, (n - self.ddof).to(torch.float64), 1.0)
        return self._final_value(m2.clamp(min=0.0) / denom), valid

    def _final_value(self, var):
        return var

    def g_update(self, cv, mask, seg_ids, num_segments):
        m = mask & cv.validity
        x = self._xs(cv, m)
        n = seg_sum(m.to(torch.int64), seg_ids, num_segments)
        mean = seg_sum(x, seg_ids, num_segments) \
            / n.clamp(min=1).to(torch.float64)
        d = torch.where(m, x - mean[seg_ids], 0.0)
        return (n, mean, seg_sum(d * d, seg_ids, num_segments))

    def g_merge_custom(self, cols_sorted, live, seg_ids, num_segments):
        """Chan's combine of a segment's partial states: Mean =
        sum(n_i mean_i) / N, M2 = sum(M2_i) + sum(n_i (mean_i - Mean)^2);
        differences of means stay small, so nothing cancels."""
        n_i, mean_i, m2_i = cols_sorted
        n_i = torch.where(live, n_i, 0)
        mean_i = torch.where(live, mean_i, 0.0)
        m2_i = torch.where(live, m2_i, 0.0)
        n = seg_sum(n_i, seg_ids, num_segments)
        mean = seg_sum(n_i.to(torch.float64) * mean_i, seg_ids,
                       num_segments) / n.clamp(min=1).to(torch.float64)
        dev = mean_i - mean[seg_ids]
        m2 = seg_sum(m2_i, seg_ids, num_segments) \
            + seg_sum(n_i.to(torch.float64) * dev * dev, seg_ids,
                      num_segments)
        return (n, mean, m2)


class Stddev(Variance):
    """stddev_samp (Spark's stddev)."""

    def _final_value(self, var):
        return torch.sqrt(var)


# ----------------------------------------------------------------------
# approx_count_distinct: HyperLogLog++
# ----------------------------------------------------------------------
class _HllHash(Expression):
    """Internal: the murmur3 of the child (seed 42) with the CHILD's
    validity, so a null skips the sketch. Any input type reaches the
    sketch as one 32-bit word (unsigned, in int64)."""

    def __init__(self, child):
        self.child = child
        self.children = [child]
        self.dtype = dt.INT32

    def bind(self, schema):
        return _HllHash(self.child.bind(schema))

    def emit(self, ctx):
        from ..ops.hash import murmur3_cv
        cv = self.child.emit(ctx)
        seed = torch.full(cv.validity.shape, 42, dtype=torch.int64,
                          device=cv.validity.device)
        return CV(murmur3_cv(cv, self.child.dtype, seed), cv.validity)

    def __repr__(self):
        return f"hll_hash({self.child})"


_M32 = 0xFFFFFFFF


def _clz32(x):
    """Leading zeros of 32-bit words (unsigned, in int64)."""
    zero = x == 0
    c = torch.zeros_like(x)
    for sh in (16, 8, 4, 2, 1):
        cond = x < (1 << (32 - sh))
        c = c + torch.where(cond, sh, 0)
        x = torch.where(cond, (x << sh) & _M32, x)
    return torch.where(zero, 32, c)


class ApproxCountDistinct(AggExpr):
    """approx_count_distinct as HyperLogLog++ with 2^p registers a group
    (reference: GpuHyperLogLogPlusPlus), p from rsd = 1.04 / sqrt(2^p),
    clamped to [4, 12]. The registers of a group pack 8 a word into
    W = 2^p / 8 int64 state columns, so a partial rides the partial
    wire, the spill store and the exchange like any other aggregate.

    Each row's register index and rho come from its 32-bit murmur3
    (`_HllHash`); one scatter-max over (segment * 2^p + register) ids
    fills the registers. They are bytes, and a register byte's place in
    its word is little-endian, so the byte tensor viewed as int64 IS the
    packed state: the JAX package's words, bit for bit, without its
    int32 (segments, 2^p) intermediate (ROADMAP C.10). Merge is a byte-
    wise max. The estimate uses the HLL++ alpha, linear counting below
    2.5m and the 32-bit large-range correction; the empirical bias table
    is omitted (docs/compatibility.md), as in the JAX package."""

    state_reducers = ("custom",)

    def __init__(self, child, rsd: float = 0.05):
        super().__init__(child)
        self.rsd = rsd
        p = math.ceil(2 * math.log2(1.04 / rsd))
        self.p = max(4, min(12, p))
        self.m = 1 << self.p
        self.W = self.m // 8

    def bind(self, schema):
        bc = self.child.bind(schema)
        if bc.dtype.is_nested:
            raise UnsupportedExpr("approx_count_distinct over nested")
        b = type(self)(_HllHash(bc), self.rsd)
        b._resolve_type()
        return b

    def _resolve_type(self):
        self.dtype = dt.INT64

    def num_state_cols(self):
        return self.W

    def state_dtypes(self):
        return [dt.INT64] * self.W

    def _registers(self, cv: CV, mask, seg_ids, num_segments):
        """(num_segments, 2^p) uint8 registers of the rows under mask."""
        h = cv.data
        valid = mask & cv.validity
        idx = torch.where(valid, h >> (32 - self.p), 0)
        rho = (_clz32((h << self.p) & _M32) + 1).clamp(
            max=32 - self.p + 1)
        rho = torch.where(valid, rho, 0).to(torch.uint8)
        regs = torch.zeros(num_segments * self.m, dtype=torch.uint8,
                           device=h.device)
        regs.scatter_reduce_(0, seg_ids.to(torch.int64) * self.m + idx,
                             rho, "amax", include_self=True)
        return regs.view(num_segments, self.m)

    def _words(self, regs):
        """(n, 2^p) uint8 registers -> the W packed int64 columns."""
        return tuple(regs.view(torch.int64).unbind(1))

    def g_update(self, cv: CV, mask, seg_ids, num_segments):
        return self._words(self._registers(cv, mask, seg_ids,
                                           num_segments))

    def g_merge_custom(self, cols_sorted, live, seg_ids, num_segments):
        regs = torch.stack(list(cols_sorted), dim=1).view(torch.uint8)
        regs = torch.where(live[:, None], regs, 0)
        out = torch.zeros(num_segments, self.m, dtype=torch.uint8,
                          device=regs.device)
        out.scatter_reduce_(0, seg_ids.to(torch.int64)[:, None].expand(
            -1, self.m), regs, "amax", include_self=True)
        return self._words(out)

    # ungrouped: ONE (W,) int64 vector
    def update(self, cv: CV, mask):
        return (self._registers(cv, mask, torch.zeros_like(
            mask, dtype=torch.int64), 1).view(torch.int64)[0],)

    def merge(self, s1, s2):
        return (torch.maximum(s1[0].view(torch.uint8),
                              s2[0].view(torch.uint8)).view(torch.int64),)

    def finalize(self, s):
        ungrouped = len(s) == 1
        words = s[0][None, :] if ungrouped else torch.stack(list(s), 1)
        regs = words.contiguous().view(torch.uint8).to(torch.float64)
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        e_raw = alpha * m * m / torch.exp2(-regs).sum(dim=1)
        zeros = (regs == 0).to(torch.float64).sum(dim=1)
        lin = m * torch.log(m / zeros.clamp(min=1.0))
        est = torch.where((e_raw <= 2.5 * m) & (zeros > 0), lin, e_raw)
        two32 = 4294967296.0
        est = torch.where(
            est > two32 / 30.0,
            -two32 * torch.log1p(-est.clamp(max=two32 * 0.999) / two32),
            est)
        out = torch.round(est).to(torch.int64)
        ok = torch.ones_like(out, dtype=torch.bool)
        return (out[0], ok[0]) if ungrouped else (out, ok)

    def __repr__(self):
        return f"approx_count_distinct({self.child}, rsd={self.rsd})"


# ----------------------------------------------------------------------
# bloom_filter_agg
# ----------------------------------------------------------------------
class BloomFilterAggregate(AggExpr):
    """bloom_filter_agg: an m-bit Bloom filter over the input (JAX
    `expr/aggregates.py:809`; reference: GpuBloomFilterAggregate.scala).

    The filter lives as ONE device bool vector of num_bits (update is an
    index fill of k = 5 positions a row, `ops/hash.py` `bloom_positions`);
    finalize packs it into little-endian bytes behind a 'BF1|k|num_bits|'
    header, one BinaryType value, byte for byte the JAX package's.
    Ungrouped only, matching Spark (the agg returns ONE filter for the
    build side)."""

    state_reducers = None            # grouped path unsupported

    def __init__(self, child, estimated_items: int = 1_000_000,
                 num_bits: int = None):
        super().__init__(child)
        if num_bits is None:
            # Spark default sizing: ~8 bits/item
            num_bits = max(64, int(estimated_items) * 8)
        # cap below 2^31, as the JAX package does (its positions are
        # int32 on the device)
        num_bits = min(int(num_bits), 1 << 30)
        self.num_bits = 1 << max(6, int(num_bits - 1).bit_length())
        self.k = 5

    def bind(self, schema):
        b = type(self)(self.child.bind(schema), num_bits=self.num_bits)
        b._resolve_type()
        return b

    def _resolve_type(self):
        if self.child.dtype.is_nested:
            raise UnsupportedExpr("bloom_filter_agg over nested input")
        self.dtype = dt.BINARY

    def update(self, cv: CV, mask):
        from ..ops.hash import bloom_positions
        masked = CV(cv.data, mask & cv.validity, cv.offsets, cv.children)
        # dead rows route to a SACRIFICIAL slot (num_bits), dropped below
        bits = torch.zeros(self.num_bits + 1, dtype=torch.bool,
                           device=mask.device)
        for p in bloom_positions(masked, self.child.dtype, self.k,
                                 self.num_bits):
            bits.index_fill_(0, torch.where(p >= 0, p, self.num_bits),
                             True)
        return (bits[:self.num_bits],)

    def merge(self, s1, s2):
        return (s1[0] | s2[0],)

    def finalize(self, s):
        bits = s[0].reshape(-1, 8).to(torch.uint8)
        shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
        packed = (bits << shifts).sum(dim=1).to(torch.uint8)
        head = torch.tensor(list(f"BF1|{self.k}|{self.num_bits}|".encode()),
                            dtype=torch.uint8, device=bits.device)
        data = torch.cat([head, packed])
        off = torch.tensor([0, data.shape[0]], dtype=torch.int32,
                           device=bits.device)
        ok = torch.ones((), dtype=torch.bool, device=bits.device)
        return CV(data, ok.reshape(1), off), ok

    def __repr__(self):
        return f"bloom_filter_agg({self.child}, bits={self.num_bits})"


def parse_bloom_filter(blob: bytes):
    """'BF1|k|num_bits|'-prefixed packed filter -> (k, num_bits, numpy
    bool bit vector)."""
    import numpy as np
    if not blob.startswith(b"BF1|"):
        raise ValueError("not a bloom filter payload")
    _, k, m, rest = blob.split(b"|", 3)
    bits = np.unpackbits(np.frombuffer(rest, np.uint8), bitorder="little")
    return int(k), int(m), bits.astype(bool)


# ----------------------------------------------------------------------
# percentile, median (the sort path) and percentile_approx (t-digest)
# ----------------------------------------------------------------------
class Percentile(AggExpr):
    """percentile / median over `CollectAggExec`'s value sort: each
    group's values lie contiguous and ordered, so a percentile is a rank
    selection, linearly interpolated (Spark's percentile). Exact, and
    the accuracy argument is accepted and ignored. A list of
    percentages returns an array of doubles, one element a percentage."""

    is_collect = True
    state_reducers = None

    def __init__(self, child, percentages, accuracy: int = 10000):
        super().__init__(child)
        self.scalar_out = not isinstance(percentages, (list, tuple))
        self.percentages = ([float(percentages)] if self.scalar_out
                            else [float(p) for p in percentages])
        for p in self.percentages:
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"percentage out of [0,1]: {p}")
        self.accuracy = accuracy

    def bind(self, schema):
        b = type(self)(self.child.bind(schema),
                       (self.percentages[0] if self.scalar_out
                        else list(self.percentages)), self.accuracy)
        b._resolve_type()
        return b

    def _resolve_type(self):
        ct = self.child.dtype
        if not ct.is_numeric or isinstance(ct, dt.DecimalType):
            raise UnsupportedExpr(f"percentile over {ct}")
        self.dtype = (dt.FLOAT64 if self.scalar_out
                      else dt.ArrayType(dt.FLOAT64))

    def __repr__(self):
        return f"percentile({self.child}, {self.percentages})"


def percentile_list(values, ok) -> CV:
    """Per-percentage value columns [n] as a list column of n rows, each
    holding one element a percentage, row-major; the rows' validity is
    `ok`, their elements' too."""
    n, k = ok.shape[0], len(values)
    data = torch.stack(values, dim=1).reshape(-1)
    off = torch.arange(n + 1, dtype=torch.int32, device=ok.device) * k
    child = CV(data, ok.repeat_interleave(k))
    return CV(torch.zeros(0, dtype=torch.int8, device=ok.device), ok, off,
              (child,))


class Median(Percentile):
    def __init__(self, child, percentages=0.5, accuracy: int = 10000):
        super().__init__(child, 0.5, accuracy)

    def __repr__(self):
        return f"median({self.child})"


def _sort3(minor, mid, major):
    """Stable argsort by (major, mid, minor): stable single-key sorts,
    least significant first."""
    p = torch.argsort(minor, stable=True)
    p = p[torch.argsort(mid[p], stable=True)]
    return p[torch.argsort(major[p], stable=True)]


class ApproxPercentile(Percentile):
    """percentile_approx as a t-digest with C centroids a group
    (reference: GpuApproximatePercentile over cuDF's t-digest), C =
    clamp(accuracy // 50, 16, 128), stored as 2C + 2 float64 state
    columns (means, weights, min, max) so partial digests ride the
    partial wire like any other aggregate.

    An update sorts the rows by (segment, valid first, value), bins each
    row's within-group rank through the k1 scale function k(q) = (C/pi)
    (asin(2q - 1) + pi/2), and sums by (segment * C + bin). A merge
    flattens the digests to candidate centroids, sorts them by (segment,
    mean) and re-bins the cumulative-weight midpoints the same way.
    finalize interpolates between centroid midranks, with the min and
    max at the tails. The result is a float64 approximation, not an
    input element as Spark's CPU returns (docs/compatibility.md); the
    rank error of a bucket is about pi / (2C) at the median, smaller
    toward the tails. NaN is the greatest value. Its update sorts, so it
    keeps the grouped aggregate off its sort-free hash pass."""

    is_collect = False
    state_reducers = ("custom",)
    sort_free_update = False

    def __init__(self, child, percentages, accuracy: int = 10000):
        super().__init__(child, percentages, accuracy)
        if int(accuracy) <= 0:
            raise ValueError(
                f"accuracy must be greater than 0 (got {accuracy})")
        self.C = max(16, min(128, int(accuracy) // 50))

    def num_state_cols(self):
        return 2 * self.C + 2

    def state_dtypes(self):
        return [dt.FLOAT64] * (2 * self.C + 2)

    def _kbin(self, q):
        """The k1 scale function: a centroid bin in [0, C - 1]."""
        t = (torch.asin((2.0 * q - 1.0).clamp(-1.0, 1.0)) + math.pi / 2) \
            * (self.C / math.pi)
        return t.to(torch.int32).clamp(0, self.C - 1)

    def _binned(self, sseg, b, w, x, num_segments):
        """(num_segments, C) weights and means of rows in bin `b`."""
        comb = sseg.to(torch.int64) * self.C + b.to(torch.int64)
        n = num_segments * self.C
        wsum = seg_sum(w, comb, n)
        xsum = seg_sum(x, comb, n)
        means = torch.where(wsum > 0, xsum / wsum.clamp(min=1.0), 0.0)
        return (means.reshape(num_segments, self.C),
                wsum.reshape(num_segments, self.C))

    def _columns(self, means, ws, vmin, vmax):
        return tuple(means.unbind(1)) + tuple(ws.unbind(1)) + (vmin, vmax)

    def g_update(self, cv: CV, mask, seg_ids, num_segments):
        cap = mask.shape[0]
        dev = mask.device
        valid = mask & cv.validity
        x = cv.data.to(torch.float64)
        # (segment, valid first, value): NaN sorts after +inf, the
        # greatest value, as Java's Double.compare orders it
        perm = _sort3(x, (~valid).to(torch.uint8), seg_ids)
        sseg = seg_ids[perm]
        pos = torch.arange(cap, device=dev)
        segstart = seg_min_max(pos, sseg, num_segments, True)
        rank = (pos - _pick(segstart, sseg)).to(torch.float64)
        ng = seg_sum(valid.to(torch.float64), seg_ids, num_segments)
        q = (rank + 0.5) / _pick(ng, sseg).clamp(min=1.0)
        svalid = valid[perm]
        means, ws = self._binned(
            sseg, self._kbin(q), svalid.to(torch.float64),
            torch.where(svalid, x[perm], 0.0), num_segments)
        # NaN stays out of the min (its identity +inf resolves to the
        # max in finalize for an all-NaN group) but reaches the max
        fin = valid & ~torch.isnan(x)
        vmax = seg_min_max(torch.where(valid, x, float("-inf")), seg_ids,
                           num_segments, False)
        vmin = seg_min_max(torch.where(fin, x, float("inf")), seg_ids,
                           num_segments, True)
        return self._columns(means, ws, vmin, vmax)

    def _recompress(self, fm, fw, fseg, num_segments):
        """Flat candidate centroids (mean fm, weight fw, segment fseg)
        merged into (num_segments, C) digests: sorted by (segment, empty
        last, mean), cumulative-weight midpoints re-binned."""
        n = fm.shape[0]
        p = _sort3(torch.where(fw > 0, fm, float("inf")),
                   (fw <= 0).to(torch.uint8), fseg)
        sseg = fseg[p]
        sw = fw[p]
        sm = torch.where(sw > 0, fm[p], 0.0)      # no 0 * inf NaNs below
        pre = torch.cumsum(sw, 0) - sw               # exclusive prefix
        sstart = seg_min_max(torch.arange(n, device=fm.device), sseg,
                             num_segments, True).clamp(0, max(n - 1, 0))
        segbase = _pick(_pick(pre, sstart), sseg)
        totw = seg_sum(fw, fseg, num_segments)
        q = (pre - segbase + sw / 2) / _pick(totw, sseg).clamp(min=1e-300)
        comb = sseg.to(torch.int64) * self.C \
            + self._kbin(q).to(torch.int64)
        nw = seg_sum(sw, comb, num_segments * self.C)
        nx = seg_sum(sw * sm, comb, num_segments * self.C)
        nm = torch.where(nw > 0, nx / nw.clamp(min=1e-300), 0.0)
        return (nm.reshape(num_segments, self.C),
                nw.reshape(num_segments, self.C))

    def g_merge_custom(self, cols_sorted, live, seg_ids, num_segments):
        C = self.C
        means = torch.stack(list(cols_sorted[:C]), dim=1)
        ws = torch.where(live[:, None],
                         torch.stack(list(cols_sorted[C:2 * C]), dim=1),
                         0.0)
        nm, nw = self._recompress(
            means.reshape(-1), ws.reshape(-1),
            seg_ids.repeat_interleave(C), num_segments)
        vmin = seg_min_max(torch.where(live, cols_sorted[2 * C],
                                       float("inf")), seg_ids,
                           num_segments, True)
        vmax = seg_min_max(torch.where(live, cols_sorted[2 * C + 1],
                                       float("-inf")), seg_ids,
                           num_segments, False)
        return self._columns(nm, nw, vmin, vmax)

    # ungrouped: (means (C,), weights (C,), (min, max))
    def update(self, cv: CV, mask):
        cols = self.g_update(cv, mask, torch.zeros_like(
            mask, dtype=torch.int64), 1)
        C = self.C
        return (torch.cat(cols[:C]), torch.cat(cols[C:2 * C]),
                torch.cat(cols[2 * C:]))

    def merge(self, s1, s2):
        nm, nw = self._recompress(
            torch.cat([s1[0], s2[0]]), torch.cat([s1[1], s2[1]]),
            torch.zeros(2 * self.C, dtype=torch.int64,
                        device=s1[0].device), 1)
        return (nm[0], nw[0], torch.stack([
            torch.minimum(s1[2][0], s2[2][0]),
            torch.maximum(s1[2][1], s2[2][1])]))

    def finalize(self, s):
        C = self.C
        ungrouped = len(s) == 3
        if ungrouped:
            means, ws = s[0][None, :], s[1][None, :]
            vmin, vmax = s[2][:1], s[2][1:]
        else:
            means = torch.stack(list(s[:C]), dim=1)
            ws = torch.stack(list(s[C:2 * C]), dim=1)
            vmin, vmax = s[2 * C], s[2 * C + 1]
        # an all-NaN group kept vmin at its +inf identity: resolve to
        # vmax (NaN); an all-+inf group has vmax = +inf and stands
        vmin = torch.where(torch.isposinf(vmin) & ~torch.isposinf(vmax),
                           vmax, vmin)
        # the nonempty centroids first, in rank order; an empty one's
        # midpoint is +inf, so it is never selected
        order = torch.argsort((ws <= 0).to(torch.uint8), dim=1,
                              stable=True)
        cm = torch.gather(means, 1, order)
        cw = torch.gather(ws, 1, order)
        nc = (cw > 0).sum(dim=1)
        totw = cw.sum(dim=1)
        mid = torch.where(cw > 0, torch.cumsum(cw, 1) - cw / 2,
                          float("inf"))
        outs = []
        for pq in self.percentages:
            t = pq * totw
            j = (mid <= t[:, None]).sum(dim=1)
            jl = (j - 1).clamp(0, C - 1)[:, None]
            jr = j.clamp(0, C - 1)[:, None]
            lm = torch.where(j > 0, torch.gather(cm, 1, jl)[:, 0], vmin)
            lr = torch.where(j > 0, torch.gather(mid, 1, jl)[:, 0], 0.0)
            rm = torch.where(j < nc, torch.gather(cm, 1, jr)[:, 0], vmax)
            rr = torch.where(j < nc, torch.gather(mid, 1, jr)[:, 0], totw)
            frac = ((t - lr) / (rr - lr).clamp(min=1e-300)).clamp(0.0, 1.0)
            # a NaN neighbour must not poison an answer at frac 0 or 1;
            # an interior frac with a NaN right neighbour keeps the left
            # centroid, so NaN comes back only from the NaN centroid's
            # own midpoint on (docs/compatibility.md)
            mid_v = lm + frac * (rm - lm)
            mid_v = torch.where(torch.isnan(rm) & ~torch.isnan(lm), lm,
                                mid_v)
            outs.append(torch.where(frac <= 0.0, lm, torch.where(
                frac >= 1.0, rm, mid_v)))
        ok = totw > 0
        if self.scalar_out:
            v = outs[0]
            return (v[0], ok[0]) if ungrouped else (v, ok)
        v = percentile_list(outs, torch.ones_like(ok))
        return (v, ok[0]) if ungrouped else (v, ok)

    def __repr__(self):
        return f"percentile_approx({self.child}, {self.percentages})"
