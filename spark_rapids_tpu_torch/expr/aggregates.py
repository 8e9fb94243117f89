"""Aggregate functions: the update / merge / finalize protocol, ungrouped
and grouped.

Ported subset: Sum, Count, CountStar and Avg. Ungrouped states are tuples
of 0-d tensors; grouped states (`g_update`) are tuples of [num_segments]
tensors, one per entry of `state_reducers`, which names how the grouped
merge combines each ("sum" or "or"), and `state_dtypes` their column
types on the partial-aggregate wire. Null semantics follow Spark: sum
over zero valid rows is null, count is never null, avg is null when its
count is 0.

A decimal sum whose result precision exceeds 18 (Q6's decimal(17,4)
product sums into decimal(27,4); Q1's decimal(24,6) charge into
decimal(34,6)) accumulates EXACTLY: each value splits into 32-bit limbs
(two for a decimal64 input, four for a decimal128 one; the top limb
signed), each limb sums in int64, and finalize recombines the limb sums
with carries; a total beyond the result precision is null (Spark
non-ANSI). Every grouped accumulator is an integer (limbs, counts, the
avg's sum), so `index_add_` sums are exact on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..columnar import dtypes as dt
from ..ops.kernel_utils import CV
from .expressions import Expression, UnsupportedExpr

__all__ = ["AggExpr", "Sum", "Count", "CountStar", "Avg", "seg_sum",
           "seg_any"]


def seg_sum(x: torch.Tensor, seg_ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum: per-segment sums of x."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg_ids, x)


def seg_any(m: torch.Tensor, seg_ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """segment_max(m) > 0 of a bool m: does any row of a segment hold."""
    return seg_sum(m.to(torch.int32), seg_ids, num_segments) > 0


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
