"""Exact decimal128 arithmetic on 32-bit limbs.

A decimal128 column is an int64 [n, 2] tensor: the (lo, hi) words of the
little-endian two's-complement int128. The arithmetic works on FOUR
32-bit limbs held in int64 lanes (each limb in [0, 2^32)), bit for bit as
the JAX package's `ops/decimal128.py`:

  add/sub    : 4-limb ripple carry, signed overflow detect
  mul        : 16x16-bit half-limb column products (each below 2^32, so
               no product leaves int64) -> 256-bit magnitude
  rescale    : multiply by 10^k, or shift-subtract long division by 10^k
               with HALF_UP rounding
  div        : sign and magnitude; the numerator times 10^shift in 256
               bits, shift-subtract long division over the bits its
               digits can fill, HALF_UP rounding as Spark's
  compare    : sign + unsigned limbs; across scales the smaller scale's
               magnitude is multiplied up into 256 bits (no overflow)
  sum limbs  : per-limb int64 sums + a final carry recombination

Overflow is Spark non-ANSI: the caller nulls the row. Every shift below
is arithmetic (torch's `>>` on int64), and every mask keeps a value
inside [0, 2^32). A constant limb may be a Python int, and a product
with a zero constant limb is skipped.
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["split_i64_limbs", "split_d128_limbs", "combine_limb_sums",
           "fits_precision", "dec_from_i64", "to_limbs", "from_limbs",
           "dec_add", "dec_sub", "dec_rescale", "dec_mul_scaled",
           "dec_cmp", "dec_cmp_scaled", "dec_div", "dec_to_i64",
           "POW10_128"]

_MASK32 = 0xFFFFFFFF

#: 10^k as four 32-bit limbs, k = 0..38
POW10_128 = [tuple(((10 ** k) >> (32 * i)) & _MASK32 for i in range(4))
             for k in range(39)]


def _bound_limbs(p: int):
    """10^p - 1, the largest |unscaled| of precision p, as 4 limbs."""
    v = 10 ** p - 1
    return tuple((v >> (32 * i)) & _MASK32 for i in range(4))


def to_limbs(data2: torch.Tensor) -> List[torch.Tensor]:
    """[n, 2] words -> [l0, l1, l2, l3] raw two's-complement limbs."""
    lo, hi = data2[..., 0], data2[..., 1]
    return [lo & _MASK32, (lo >> 32) & _MASK32,
            hi & _MASK32, (hi >> 32) & _MASK32]


def from_limbs(limbs) -> torch.Tensor:
    """[l0..l3] (each in [0, 2^32)) -> [n, 2] words."""
    l0, l1, l2, l3 = limbs
    return torch.stack([_join(l0, l1), _join(l2, l3)], dim=-1)


def _join(lo32, hi32):
    """The int64 whose high and low 32 bits are hi32 and lo32. hi32 is
    first brought to its signed value, so no step overflows."""
    shi = torch.where(hi32 >= (1 << 31), hi32 - (1 << 32), hi32)
    return shi * (1 << 32) + lo32


def _neg_raw(limbs):
    """Two's-complement negation of a limb list."""
    out = []
    carry = torch.ones_like(limbs[0])
    for l in limbs:
        v = (l ^ _MASK32) + carry
        out.append(v & _MASK32)
        carry = v >> 32
    return out


def _cmp_raw(a, b):
    """Unsigned compare of equal-length limb lists (a's limbs tensors):
    -1/0/1 per lane."""
    res = torch.zeros_like(a[0])
    for ai, bi in zip(reversed(a), reversed(b)):
        res = torch.where(res != 0, res, torch.sign(ai - bi))
    return res


def _is_neg(limbs):
    return limbs[3] >= (1 << 31)


def _abs(limbs):
    """(magnitude limbs, sign) of two's-complement limbs."""
    neg = _is_neg(limbs)
    return [torch.where(neg, a, b)
            for a, b in zip(_neg_raw(limbs), limbs)], neg


def _add_raw(a, b, k=None):
    """Limbwise add with ripple carry: (limbs, carry out)."""
    k = k or max(len(a), len(b))
    out = []
    carry = torch.zeros_like(a[0])
    for i in range(k):
        v = (a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0) \
            + carry
        out.append(v & _MASK32)
        carry = v >> 32
    return out, carry


def _sub_raw(a, b, k=None):
    """a - b limbwise with borrow: (limbs, borrow out in {0, 1})."""
    k = k or max(len(a), len(b))
    out = []
    borrow = torch.zeros_like(a[0])
    for i in range(k):
        v = (a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0) \
            - borrow
        out.append(v & _MASK32)
        borrow = (v >> 32) & 1
    return out, borrow


def fits_precision_mag(mag_limbs, precision: int):
    return _cmp_raw(mag_limbs, list(_bound_limbs(precision))) <= 0


def fits_precision(limbs, precision: int):
    """|value| <= 10^precision - 1, on raw two's-complement limbs."""
    neg = limbs[3] >= (1 << 31)
    mag = [torch.where(neg, a, b) for a, b in zip(_neg_raw(limbs), limbs)]
    return fits_precision_mag(mag, precision)


def split_i64_limbs(x: torch.Tensor) -> List[torch.Tensor]:
    """int64 -> [lo32 (unsigned), hi32 (signed)] for exact summation."""
    return [x & _MASK32, x >> 32]


def split_d128_limbs(data2: torch.Tensor) -> List[torch.Tensor]:
    """[n, 2] -> [l0, l1, l2 (unsigned 32), l3 (signed 32)] for exact
    summation (value = l0 + l1 2^32 + l2 2^64 + l3 2^96)."""
    l = to_limbs(data2)
    return [l[0], l[1], l[2], data2[..., 1] >> 32]


# ----------------------------------------------------------------------
def dec_add(a2, b2):
    """(result [n, 2], overflow): 128-bit signed add."""
    a, b = to_limbs(a2), to_limbs(b2)
    s, _ = _add_raw(a, b, 4)
    sa, sb, sr = _is_neg(a), _is_neg(b), _is_neg(s)
    return from_limbs(s), (sa == sb) & (sr != sa)


def dec_sub(a2, b2):
    """(result [n, 2], overflow): a + (-b); -MIN128 negates to itself, so
    the sign of -b is taken as the opposite of b's."""
    a, b = to_limbs(a2), to_limbs(b2)
    s, _ = _add_raw(a, _neg_raw(b), 4)
    sa, sb, sr = _is_neg(a), ~_is_neg(b), _is_neg(s)
    return from_limbs(s), (sa == sb) & (sr != sa)


def _mul_raw_columns(a, b, out_limbs=8):
    """Magnitude multiply over 16-bit half limbs: each half product is
    below 2^32 and a column sums at most 8 of them, so nothing leaves
    int64. Returns (out_limbs 32-bit limbs, carry out)."""
    ah, bh = [], []
    for l in a:
        ah += [l & 0xFFFF, l >> 16]
    for l in b:
        bh += [l & 0xFFFF, l >> 16]
    like = next(x for x in a + b if isinstance(x, torch.Tensor))
    H = out_limbs * 2
    cols = [torch.zeros_like(like) for _ in range(H)]
    for i in range(8):
        for j in range(8):
            k = i + j
            if k >= H or (isinstance(ah[i], int) and ah[i] == 0) \
                    or (isinstance(bh[j], int) and bh[j] == 0):
                continue
            cols[k] = cols[k] + ah[i] * bh[j]
    out16 = []
    carry = torch.zeros_like(like)
    for k in range(H):
        v = cols[k] + carry
        out16.append(v & 0xFFFF)
        carry = v >> 16
    return [out16[2 * i] | (out16[2 * i + 1] << 16)
            for i in range(out_limbs)], carry


def _shift_left_one(limbs, bit_in):
    """(limbs << 1) | bit_in over k 32-bit limbs: (limbs, bit out)."""
    out = []
    carry = bit_in
    for l in limbs:
        v = (l << 1) | carry
        out.append(v & _MASK32)
        carry = (v >> 32) & 1
    return out, carry


def _long_div(num, den, nbits: int):
    """Unsigned shift-subtract division of a k-limb magnitude by a 4-limb
    one (tensors or Python ints), over the low `nbits` bits of num:
    (quotient k limbs, remainder 4 limbs). The JAX package scans the
    bits in one program; here each bit is a few dozen eager ops."""
    k = len(num)
    zero = torch.zeros_like(num[0])
    den5 = list(den) + [0]
    quo = [zero for _ in range(k)]
    rem = [zero for _ in range(5)]
    for bit in range(nbits - 1, -1, -1):
        li, sh = bit // 32, bit % 32
        rem, _ = _shift_left_one(rem, (num[li] >> sh) & 1)
        ge = _cmp_raw(rem, den5) >= 0
        sub, _ = _sub_raw(rem, den5, 5)
        rem = [torch.where(ge, s_, r_) for s_, r_ in zip(sub, rem)]
        quo[li] = torch.where(ge, quo[li] | (1 << sh), quo[li])
    return quo, rem[:4]


def _round_half_up(quo, rem, den):
    """quo + 1 where 2 * rem >= den (HALF_UP on magnitudes)."""
    rem2, c = _shift_left_one(rem, torch.zeros_like(rem[0]))
    ge = (_cmp_raw(rem2, list(den)) >= 0) | (c > 0)
    up, _ = _add_raw(quo, [torch.ones_like(quo[0])], len(quo))
    return [torch.where(ge, u, q) for u, q in zip(up, quo)]


def _signed(mag, neg):
    return from_limbs([torch.where(neg, x, y)
                       for x, y in zip(_neg_raw(mag), mag)])


def dec_rescale(a2, from_scale: int, to_scale: int, precision: int,
                half_up: bool = True):
    """Rescale by 10^(to - from): up is an exact multiply (overflow
    checked), down a division with HALF_UP (or truncation toward zero
    without half_up). Returns (result [n, 2], overflow)."""
    a = to_limbs(a2)
    if to_scale == from_scale:
        return a2, ~fits_precision(a, precision)
    ma, neg = _abs(a)
    if to_scale > from_scale:
        prod, carry = _mul_raw_columns(
            ma, list(POW10_128[to_scale - from_scale]), 8)
        mag = prod[:4]
        ovf = ((sum(prod[4:]) + carry) > 0) \
            | ~fits_precision_mag(mag, precision)
    else:
        pow_l = list(POW10_128[from_scale - to_scale])
        quo, rem = _long_div(ma + [torch.zeros_like(ma[0])] * 4, pow_l,
                             128)
        if half_up:
            quo = _round_half_up(quo, rem, pow_l)
        mag = quo[:4]
        ovf = ~fits_precision_mag(mag, precision)
    return _signed(mag, neg), ovf


def dec_mul_scaled(a2, b2, down_shift: int, precision: int):
    """Exact multiply at the full scale (s1 + s2), then a HALF_UP rescale
    down by 10^down_shift on the 256-bit product: Spark's clamped result
    scale without an intermediate overflow. Returns (result, overflow)."""
    ma, na = _abs(to_limbs(a2))
    mb, nb = _abs(to_limbs(b2))
    prod, carry = _mul_raw_columns(ma, mb, 8)
    if down_shift > 0:
        pow_l = list(POW10_128[down_shift])
        quo, rem = _long_div(prod, pow_l, 256)
        prod = _round_half_up(quo, rem, pow_l)
        carry = torch.zeros_like(carry)
    ovf = ((sum(prod[4:]) + carry) > 0) \
        | ~fits_precision_mag(prod[:4], precision)
    return _signed(prod[:4], na ^ nb), ovf


def dec_div(a2, b2, scale_shift: int, precision: int,
            num_digits: int = 38):
    """Spark decimal divide: (a * 10^scale_shift) / b with HALF_UP
    rounding. The numerator is formed in 256 bits; the long division
    runs over the bits that `num_digits` (the dividend's precision) plus
    the shift can fill (about 3.33 bits a digit), as the JAX package
    bounds it. Returns (result [n, 2], overflow, divide by zero)."""
    ma, na = _abs(to_limbs(a2))
    mb, nb = _abs(to_limbs(b2))
    divzero = sum(mb) == 0
    den = [torch.where(divzero, int(i == 0), x) for i, x in enumerate(mb)]
    num, _ = _mul_raw_columns(ma, list(POW10_128[scale_shift]), 8)
    nbits = min(256, int((num_digits + scale_shift) * 3.33) + 2)
    quo, rem = _long_div(num, den, nbits)
    quo = _round_half_up(quo, rem, den)
    ovf = (sum(quo[4:]) > 0) | ~fits_precision_mag(quo[:4], precision)
    return _signed(quo[:4], na ^ nb), ovf, divzero


def dec_cmp(a2, b2):
    """Signed three-way compare (-1/0/1, int32) of two [n, 2] decimals of
    one scale. Two's-complement values of one sign order like their raw
    unsigned limbs, so nothing is subtracted and nothing wraps."""
    a, b = to_limbs(a2), to_limbs(b2)
    na, nb = _is_neg(a), _is_neg(b)
    res = torch.where(na != nb, torch.where(na, -1, 1), _cmp_raw(a, b))
    return res.to(torch.int32)


def dec_cmp_scaled(a2, sa: int, b2, sb: int):
    """Three-way compare (-1/0/1, int32) of decimals of scales sa and sb:
    the side of the smaller scale is multiplied by 10^|sa - sb| into 256
    bits (a magnitude below 2^127 times 10^38 stays below 2^254, so
    nothing overflows), then sign and 8-limb magnitude decide."""
    ma, na = _abs(to_limbs(a2))
    mb, nb = _abs(to_limbs(b2))
    wa, ca = _mul_raw_columns(ma, list(POW10_128[max(sb - sa, 0)]), 8)
    wb, cb = _mul_raw_columns(mb, list(POW10_128[max(sa - sb, 0)]), 8)
    mag = _cmp_raw(wa + [ca], wb + [cb])
    both_zero = ((sum(wa) + ca) == 0) & ((sum(wb) + cb) == 0)
    res = torch.where(na & ~nb, -1, torch.where(
        nb & ~na, 1, torch.where(na & nb, -mag, mag)))
    return torch.where(both_zero, 0, res).to(torch.int32)


def combine_limb_sums(sums, precision: int):
    """The exact total from per-limb int64 sums (sums[k] weighs 2^(32k),
    the last is signed). Returns ([..., 2] words, overflow beyond
    `precision`). Exact while each |sums[k]| < 2^62."""
    K = 6
    cols = [torch.zeros_like(sums[0]) for _ in range(K)]
    for k, s in enumerate(sums):
        cols[k] = cols[k] + (s & _MASK32)
        if k + 1 < K:
            cols[k + 1] = cols[k + 1] + (s >> 32)
    limbs = []
    carry = torch.zeros_like(cols[0])
    for k in range(K):
        v = cols[k] + carry
        limbs.append(v & _MASK32)
        carry = v >> 32
    # the carry out of the top limb is the sign extension
    neg = carry < 0
    full = limbs + [carry & _MASK32]
    mag = [torch.where(neg, a, b) for a, b in zip(_neg_raw(full), full)]
    hi_any = (mag[4] + mag[5] + mag[6]) > 0
    fits = fits_precision_mag(mag[:4], precision) & ~hi_any
    res_mag = mag[:4]
    res = [torch.where(neg, a, b)
           for a, b in zip(_neg_raw(res_mag), res_mag)]
    return from_limbs(res), ~fits


def dec_from_i64(x: torch.Tensor) -> torch.Tensor:
    """int64 unscaled -> [n, 2] words (sign-extended)."""
    return torch.stack([x, torch.where(x < 0, -1, 0).to(x.dtype)], dim=-1)


def dec_to_i64(a2: torch.Tensor):
    """[n, 2] words -> (int64 low word, whether the value fits 64 bits)."""
    lo, hi = a2[..., 0], a2[..., 1]
    fits = ((hi == 0) & (lo >= 0)) | ((hi == -1) & (lo < 0))
    return lo.contiguous(), fits
