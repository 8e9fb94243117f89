"""CAST with Spark (non-ANSI) semantics between the numeric, boolean
and temporal types (the casts from and to strings are
`ops/cast_strings.py`'s), as the JAX package's `ops/cast.py` computes
them:
  - integral narrowing wraps (Java); floating -> integral saturates at
    the target's range, NaN -> 0 (Scala `Double.toInt`);
  - to a decimal, HALF_UP rounding; a value past the precision -> null;
  - decimal -> integral truncates toward zero, null out of range;
  - decimal128 (an int64 [n, 2] of words) on either side goes through
    the limb kernels of `ops/decimal128.py`;
  - decimal -> double is the unscaled value (decimal128: hi 2^64 +
    unsigned lo, the JAX formula) divided by 10^scale, the quotient the
    JAX package's source writes, bit for bit its eager result, on the
    CPU and the card alike (XLA may compile that division into a product
    with the reciprocal, one unit in the last place away). The formula
    rounds the unsigned low word near 2^64 for a negative decimal128, so
    such a value loses up to 2^11 units of its unscaled value, as in the
    reference (ROADMAP C);
  - boolean <-> numeric: true is 1; a number is true when it is not 0;
  - timestamp (int64 microseconds) -> date and -> integral seconds floor
    toward negative infinity (a timestamp before 1970 too); -> double is
    microseconds / 10^6; -> decimal is the seconds at scale 6, rescaled;
  - date (int32 days) -> timestamp is midnight UTC; -> int is the days;
  - integral -> timestamp is seconds; floating -> timestamp keeps the
    fraction in microseconds and gives null for NaN and +-infinity;
    decimal -> timestamp truncates sub-microsecond digits toward zero.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..errors import NotPorted
from .datetime import MICROS_PER_DAY, MICROS_PER_SEC
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
    if isinstance(from_t, dt.BooleanType):
        if isinstance(to_t, dt.DecimalType) and to_t.is_decimal128:
            # the [n, 2] words of 0 or 10^scale (the JAX package emits
            # one int64 here and breaks, ROADMAP C.17)
            from .decimal128 import dec_from_i64, dec_rescale
            out, _ = dec_rescale(dec_from_i64(x.to(torch.int64)), 0,
                                 to_t.scale, 38)
            return CV(out, valid)
        if isinstance(to_t, dt.DecimalType):
            return CV(x.to(torch.int64) * (10 ** to_t.scale), valid)
        if to_t.is_numeric:
            return CV(x.to(dt.torch_dtype(to_t)), valid)
    elif isinstance(to_t, dt.BooleanType):
        if from_t.is_numeric:
            nz = x != 0
            return CV(nz.any(-1) if nz.dim() > 1 else nz, valid)
    elif isinstance(from_t, dt.TimestampType):
        return _from_timestamp(x, valid, to_t)
    elif isinstance(from_t, dt.DateType):
        if isinstance(to_t, dt.TimestampType):
            return CV(x.to(torch.int64) * MICROS_PER_DAY, valid)
        if isinstance(to_t, dt.IntegerType):
            return CV(x.to(torch.int32), valid)
    elif isinstance(to_t, dt.TimestampType) and not isinstance(
            from_t, dt.DecimalType):
        if from_t.is_integral:
            return CV(x.to(torch.int64) * MICROS_PER_SEC, valid)
        if from_t.is_floating:
            # seconds, the fraction kept in microseconds; NaN and
            # +-infinity -> null (Spark)
            xf = x.to(torch.float64)
            ok = torch.isfinite(xf)
            return CV(_f64_to_i64(torch.where(ok, xf * MICROS_PER_SEC,
                                              0.0)), valid & ok)
    elif isinstance(from_t, dt.DecimalType):
        s = from_t.scale
        if from_t.is_decimal128 or (isinstance(to_t, dt.DecimalType)
                                    and to_t.is_decimal128):
            return _cast_decimal128(cv, from_t, to_t)
        if isinstance(to_t, dt.DecimalType):
            return _rescale_decimal(x, valid, s, to_t)
        if to_t.is_floating:
            return CV(_over_pow10(x.to(torch.float64), s).to(
                dt.torch_dtype(to_t)), valid)
        if to_t.is_integral:
            p = 10 ** s
            q = torch.div(x, p, rounding_mode="floor")
            r = x - q * p
            q = torch.where((r != 0) & (x < 0), q + 1, q)  # toward zero
            lo, hi = _INT_RANGE[type(to_t)]
            ok = (q >= lo) & (q <= hi)
            return CV(q.to(dt.torch_dtype(to_t)), valid & ok)
        if isinstance(to_t, dt.TimestampType):
            # decimal seconds -> microseconds; sub-microsecond digits
            # truncate toward zero (Spark's decimalToTimestamp)
            ds = 6 - s
            if ds >= 0:
                return CV(x.to(torch.int64) * (10 ** ds), valid)
            p = 10 ** (-ds)
            q = torch.div(x, p, rounding_mode="floor")
            r = x - q * p
            return CV(torch.where((r != 0) & (x < 0), q + 1, q), valid)
    elif isinstance(to_t, dt.DecimalType):
        if to_t.is_decimal128 and from_t.is_integral:
            from .decimal128 import dec_from_i64, dec_rescale
            out, ovf = dec_rescale(dec_from_i64(x.to(torch.int64)), 0,
                                   to_t.scale, to_t.precision)
            return CV(out, valid & ~ovf)
        if to_t.is_decimal128 and from_t.is_floating:
            return _float_to_decimal128(x, valid, to_t)
        if from_t.is_integral:
            x64 = x.to(torch.int64)
            ok = torch.abs(x64) < 10 ** (to_t.precision - to_t.scale)
            return CV(x64 * (10 ** to_t.scale), valid & ok)
        if from_t.is_floating:
            scaled = _scaled_half_up(x, to_t.scale)
            ok = (torch.abs(scaled) < 10 ** to_t.precision) & ~torch.isnan(x)
            return CV(scaled.to(torch.int64), valid & ok)
    elif from_t.is_floating and to_t.is_integral:
        # clamped in the source's precision, then converted saturating,
        # as XLA converts (float(2^31 - 1) in float32, and 2^63 - 1 in
        # float64, round up past the range)
        lo, hi = _INT_RANGE[type(to_t)]
        xf = torch.nan_to_num(x, nan=0.0).clamp(float(lo), float(hi))
        if isinstance(to_t, dt.LongType):
            return CV(_f64_to_i64(xf.to(torch.float64)), valid)
        return CV(xf.to(torch.float64).clamp(lo, hi).to(
            dt.torch_dtype(to_t)), valid)
    elif from_t.is_numeric and to_t.is_numeric:
        # widening, and integral narrowing that wraps like Java
        return CV(x.to(dt.torch_dtype(to_t)), valid)
    raise NotPorted(f"cast {from_t} -> {to_t}")


def _from_timestamp(x, valid, to_t) -> CV:
    """Casts of int64 microseconds since the epoch."""
    if isinstance(to_t, dt.DateType):
        return CV(torch.div(x, MICROS_PER_DAY, rounding_mode="floor")
                  .to(torch.int32), valid)
    secs = torch.div(x, MICROS_PER_SEC, rounding_mode="floor")
    if to_t.is_integral:
        # long -> int and narrower wraps like Java (Spark non-ANSI)
        return CV(secs.to(dt.torch_dtype(to_t)), valid)
    if to_t.is_floating:
        return CV(_over_pow10(x.to(torch.float64), 6).to(
            dt.torch_dtype(to_t)), valid)
    if isinstance(to_t, dt.DecimalType):
        # seconds with 6 fractional digits, rescaled to the target
        if to_t.is_decimal128:
            from .decimal128 import dec_from_i64, dec_rescale
            out, ovf = dec_rescale(dec_from_i64(x), 6, to_t.scale,
                                   to_t.precision)
            return CV(out, valid & ~ovf)
        return _rescale_decimal(x, valid, 6, to_t)
    raise NotPorted(f"cast timestamp -> {to_t}")


def _f64_to_i64(x):
    """float64 -> int64 as XLA converts: truncation toward zero, values
    past the range saturate and NaN gives 0 (torch's own conversion of
    such values is undefined and differs by device)."""
    big = x >= 2.0 ** 63
    small = x < -(2.0 ** 63)
    safe = torch.where(big | small | torch.isnan(x), 0.0, x)
    out = safe.to(torch.int64)
    out = torch.where(big, (1 << 63) - 1, out)
    return torch.where(small, -(1 << 63), out)


def _over_pow10(x: torch.Tensor, scale: int) -> torch.Tensor:
    """x / 10^scale, correctly rounded on every device: the divisor is a
    tensor on x's device, since CUDA torch turns a division by a Python
    number into a product with its reciprocal."""
    return x / torch.full((), 10.0 ** scale, dtype=x.dtype, device=x.device)


def _scaled_half_up(x, scale: int):
    """x * 10^scale in float64, rounded half away from zero."""
    xf = x.to(torch.float64) * (10.0 ** scale)
    return torch.where(xf >= 0, torch.floor(xf + 0.5), torch.ceil(xf - 0.5))


def _float_to_decimal128(x, valid, to_t: dt.DecimalType) -> CV:
    """float -> decimal(p > 18): scale, round HALF_UP, then split the
    (at most 53 significant bits) magnitude into 32-bit limbs exactly."""
    from .decimal128 import _neg_raw, from_limbs
    scaled = _scaled_half_up(x, to_t.scale)
    ok = (torch.abs(scaled) < 10.0 ** to_t.precision) & ~torch.isnan(x)
    rem = torch.abs(torch.where(ok, scaled, 0.0))
    limbs = []
    for _ in range(4):
        limbs.append(torch.remainder(rem, 2.0 ** 32).to(torch.int64))
        rem = torch.floor(rem / (2.0 ** 32))
    out = torch.where((scaled < 0).unsqueeze(-1),
                      from_limbs(_neg_raw(limbs)), from_limbs(limbs))
    return CV(out, valid & ok)


def _cast_decimal128(cv: CV, from_t: dt.DecimalType,
                     to_t: dt.DataType) -> CV:
    """The casts where either side is a decimal128."""
    from .decimal128 import dec_from_i64, dec_rescale, dec_to_i64
    x, valid = cv.data, cv.validity
    wide = x if from_t.is_decimal128 else dec_from_i64(x)
    if isinstance(to_t, dt.DecimalType):
        out, ovf = dec_rescale(wide, from_t.scale, to_t.scale,
                               to_t.precision)
        if to_t.is_decimal128:
            return CV(out, valid & ~ovf)
        v64, fits = dec_to_i64(out)
        return CV(v64, valid & ~ovf & fits)
    if to_t.is_floating:
        lo, hi = wide[:, 0], wide[:, 1]
        ulo = torch.where(lo < 0, lo.to(torch.float64) + 2.0 ** 64,
                          lo.to(torch.float64))
        f = _over_pow10(hi.to(torch.float64) * (2.0 ** 64) + ulo,
                        from_t.scale)
        return CV(f.to(dt.torch_dtype(to_t)), valid)
    if to_t.is_integral:
        # truncation toward zero, as from a decimal64
        out, ovf = dec_rescale(wide, from_t.scale, 0, 38, half_up=False)
        v64, fits = dec_to_i64(out)
        lo_b, hi_b = _INT_RANGE[type(to_t)]
        ok = (v64 >= lo_b) & (v64 <= hi_b) & fits & ~ovf
        return CV(v64.to(dt.torch_dtype(to_t)), valid & ok)
    if isinstance(to_t, dt.TimestampType):
        # sub-microsecond digits truncate toward zero (Spark longValue)
        out, ovf = dec_rescale(wide, from_t.scale, 6, 38, half_up=False)
        v64, fits = dec_to_i64(out)
        return CV(v64, valid & ~ovf & fits)
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
