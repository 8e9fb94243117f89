"""CAST with Spark (non-ANSI) semantics: the ported subset.

Covers the casts the slice's type coercion inserts and their near
kin: null -> any, numeric widening and integral narrowing (wraps),
boolean -> numeric, integral -> decimal64, decimal64 rescale (HALF_UP,
overflow -> null) and decimal64 -> integral/floating. Every other cast
(floating -> integral or decimal, to boolean, temporal, string, and any
decimal128 side) raises NotPorted.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..errors import NotPorted
from .kernel_utils import CV

__all__ = ["cast_cv"]

_INT_RANGE = {
    dt.ByteType: (-128, 127),
    dt.ShortType: (-32768, 32767),
    dt.IntegerType: (-2**31, 2**31 - 1),
    dt.LongType: (-2**63, 2**63 - 1),
}


def cast_cv(cv: CV, from_t: dt.DataType, to_t: dt.DataType) -> CV:
    if from_t == to_t:
        return cv
    x, valid = cv.data, cv.validity
    if isinstance(from_t, dt.NullType):
        if to_t.is_variable_width:
            return CV(torch.zeros(0, dtype=torch.uint8, device=x.device),
                      torch.zeros_like(valid),
                      torch.zeros(cv.capacity + 1, dtype=torch.int32,
                                  device=x.device))
        return CV(torch.zeros(dt.alloc_shape(to_t, cv.capacity),
                              dtype=dt.torch_dtype(to_t), device=x.device),
                  torch.zeros_like(valid))
    for t in (from_t, to_t):
        if isinstance(t, dt.DecimalType) and t.is_decimal128:
            raise NotPorted(f"cast {from_t} -> {to_t}")

    if isinstance(from_t, dt.BooleanType):
        if isinstance(to_t, dt.DecimalType):
            return CV(x.to(torch.int64) * (10 ** to_t.scale), valid)
        if to_t.is_numeric:
            return CV(x.to(dt.torch_dtype(to_t)), valid)
    elif isinstance(from_t, dt.DecimalType):
        s = from_t.scale
        if isinstance(to_t, dt.DecimalType):
            return _rescale_decimal(x, valid, s, to_t)
        if to_t.is_floating:
            return CV((x.to(torch.float64) / (10.0 ** s)).to(
                dt.torch_dtype(to_t)), valid)
        if to_t.is_integral:
            p = 10 ** s
            q = torch.div(x, p, rounding_mode="floor")
            r = x - q * p
            q = torch.where((r != 0) & (x < 0), q + 1, q)  # toward zero
            lo, hi = _INT_RANGE[type(to_t)]
            ok = (q >= lo) & (q <= hi)
            return CV(q.to(dt.torch_dtype(to_t)), valid & ok)
    elif isinstance(to_t, dt.DecimalType):
        if from_t.is_integral:
            x64 = x.to(torch.int64)
            ok = torch.abs(x64) < 10 ** (to_t.precision - to_t.scale)
            return CV(x64 * (10 ** to_t.scale), valid & ok)
    elif from_t.is_numeric and to_t.is_numeric and not (
            from_t.is_floating and to_t.is_integral):
        # widening, and integral narrowing that wraps like Java
        return CV(x.to(dt.torch_dtype(to_t)), valid)
    raise NotPorted(f"cast {from_t} -> {to_t}")


def _rescale_decimal(x, valid, from_scale: int, to_t: dt.DecimalType) -> CV:
    ds = to_t.scale - from_scale
    if ds >= 0:
        out = x * (10 ** ds)
    else:
        p = 10 ** (-ds)
        half = p // 2
        adj = torch.where(x >= 0, x + half, x - half)
        q = torch.div(adj, p, rounding_mode="floor")
        r = adj - q * p
        out = torch.where((r != 0) & (adj < 0), q + 1, q)
    ok = torch.abs(out) < 10 ** to_t.precision
    return CV(out, valid & ok)
