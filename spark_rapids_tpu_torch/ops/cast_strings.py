"""String <-> number, boolean, date and timestamp casts with Spark
(non-ANSI) semantics: the port's copy of the JAX package's
`ops/cast_strings.py`, every function of it.

Parsing works as the JAX package's does: each row's bytes are read at a
bounded number of positions from its trimmed start (ASCII whitespace
trimmed within 64 bytes of either end), one tensor op per position over
all rows, and a malformed row is null. The port stops each scan at the
batch's longest row (one host read a cast), where the JAX package runs
the whole bound: a position past every row's end changes nothing. The
bounds are the JAX package's:
an integer of at most 19 digits, a float within 40 bytes after its sign,
a decimal within 64 bytes (up to 38 significant digits, scaled
positionally during the scan, HALF_UP on the first dropped digit, no
float detour). A float parses its digits into a double and scales by
10^exponent, the JAX package's formula as its CPU compile computes it
(each digit step one fused multiply-add, correctly rounded powers of
ten), not Python's `float()` (docs/compatibility.md). Dates are
'YYYY-MM-DD', timestamps 'YYYY-MM-DD[ HH:MM:SS]' (a 'T' may separate),
UTC.

Rendering builds each row right-aligned in an [n, W] staging matrix, W
the JAX package's bound for the type (20 bytes for an integer, 22 for a
scaled decimal, 10 for a date, 26 for a timestamp), then scatters the
rows' bytes to their offsets (`_emit_from_staging`): the output's byte
buffer is n * W bytes, sized from that bound with no host read, zero
past the last row. INT64_MIN renders as the JAX package renders it.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..utils.transfer import fetch_int
from .kernel_utils import CV, fma
from .strings import str_len_bytes

__all__ = ["string_to_int", "string_to_float", "string_to_bool",
           "string_to_decimal", "int_to_string", "bool_to_string",
           "decimal_to_string", "date_to_string", "timestamp_to_string",
           "string_to_date", "string_to_timestamp"]

_MAX_DIGITS = 19


def _reader(cv: CV, tstart, tlen):
    """byte_at(k): each row's byte at trimmed offset k (an int or a
    tensor), as int32, or -1 past the row's end."""
    data = cv.data
    dcap = data.shape[0]

    def byte_at(k):
        if dcap == 0:
            return torch.full_like(tlen, -1, dtype=torch.int32)
        idx = (tstart + k).clamp(0, dcap - 1)
        return torch.where(k < tlen, data[idx].to(torch.int32), -1)
    return byte_at


def _is_ws(b):
    return (b == 32) | ((b >= 9) & (b <= 13))


def _trim_bounds(cv: CV):
    """(start, length) of each row after trimming ASCII whitespace from
    either end, looking at most 64 bytes in, and the longest row's byte
    length: one host read a call, which bounds every scan of the parse
    (a position past every row's end changes no row's state)."""
    lens = str_len_bytes(cv).to(torch.int64)
    starts = cv.offsets[:-1].to(torch.int64)
    data = cv.data
    dcap = data.shape[0]
    lead = torch.zeros_like(lens)
    trail = torch.zeros_like(lens)
    longest = fetch_int(lens.max()) if lens.shape[0] and dcap else 0
    if dcap:
        for k in range(min(64, longest)):
            b = data[(starts + k).clamp(0, dcap - 1)]
            lead = torch.where((lead == k) & (k < lens) & _is_ws(b), k + 1,
                               lead)
            b2 = data[(starts + lens - 1 - k).clamp(0, dcap - 1)]
            trail = torch.where((trail == k) & (k < lens) & _is_ws(b2),
                                k + 1, trail)
    return starts + lead, (lens - lead - trail).clamp(min=0), longest


def _parse_digits(cv: CV, tstart, tlen, longest: int):
    """[sign] digits [. digits] -> (value int64, valid)."""
    byte_at = _reader(cv, tstart, tlen)
    n = tlen.shape[0]
    dev = tlen.device
    b0 = byte_at(0)
    neg = b0 == 45
    skip = ((b0 == 45) | (b0 == 43)).to(torch.int64)
    value = torch.zeros(n, dtype=torch.int64, device=dev)
    ndig = torch.zeros(n, dtype=torch.int32, device=dev)
    seen_dot = torch.zeros(n, dtype=torch.bool, device=dev)
    invalid = torch.zeros_like(seen_dot)
    done = torch.zeros_like(seen_dot)
    for k in range(min(_MAX_DIGITS + 22, longest)):
        p = skip + k
        b = byte_at(p)
        active = (p < tlen) & ~done
        is_digit = (b >= 48) & (b <= 57)
        int_dig = active & is_digit & ~seen_dot
        value = torch.where(int_dig, value * 10 + (b - 48), value)
        ndig = torch.where(int_dig, ndig + 1, ndig)
        newly_dot = active & (b == 46) & ~seen_dot
        seen_dot = seen_dot | newly_dot
        bad = active & ~is_digit & ~newly_dot
        invalid = invalid | bad
        done = done | bad
    invalid = invalid | (tlen > skip + _MAX_DIGITS + 21)
    invalid = invalid | (ndig == 0) | (ndig > _MAX_DIGITS) | (tlen == 0)
    # a 19-digit magnitude can wrap int64 (the accumulator goes
    # negative); the one legal wrap is INT64_MIN
    invalid = invalid | ((value < 0) & ~(neg & (value == -(1 << 63))))
    return torch.where(neg, -value, value), ~invalid


def string_to_int(cv: CV, to_t: dt.DataType) -> CV:
    from .cast import _INT_RANGE
    tstart, tlen, longest = _trim_bounds(cv)
    value, ok = _parse_digits(cv, tstart, tlen, longest)
    lo, hi = _INT_RANGE.get(type(to_t), (-2**63, 2**63 - 1))
    in_range = (value >= lo) & (value <= hi)
    return CV(value.to(dt.torch_dtype(to_t)), cv.validity & ok & in_range)


def _literal_at(byte_at, tlen, lit: bytes, offset):
    """Rows whose trimmed bytes from `offset` on are `lit`, ASCII case
    folded, and nothing after."""
    m = torch.ones_like(tlen, dtype=torch.bool)
    for j, ch in enumerate(lit):
        b = byte_at(offset + j)
        low = torch.where((b >= 65) & (b <= 90), b + 32, b)
        m = m & (low == (ch | 0x20 if 65 <= ch <= 122 else ch))
    return m & (tlen == offset + len(lit))


def string_to_float(cv: CV) -> CV:
    """[sign] digits [. digits] [eE [sign] digits], and the literals
    Infinity, Inf and NaN (any case), as a double."""
    tstart, tlen, longest = _trim_bounds(cv)
    byte_at = _reader(cv, tstart, tlen)
    n = tlen.shape[0]
    dev = tlen.device
    b0 = byte_at(0)
    neg = b0 == 45
    skip = ((b0 == 45) | (b0 == 43)).to(torch.int64)
    mant = torch.zeros(n, dtype=torch.float64, device=dev)
    frac_scale = torch.zeros(n, dtype=torch.int32, device=dev)
    exp_val = torch.zeros_like(frac_scale)
    ndig = torch.zeros_like(frac_scale)
    exp_ndig = torch.zeros_like(frac_scale)
    exp_neg = torch.zeros(n, dtype=torch.bool, device=dev)
    seen_dot = torch.zeros_like(exp_neg)
    in_exp = torch.zeros_like(exp_neg)
    invalid = torch.zeros_like(exp_neg)
    prev_was_e = torch.zeros_like(exp_neg)
    for k in range(min(40, longest)):
        p = skip + k
        b = byte_at(p)
        active = p < tlen
        is_digit = (b >= 48) & (b <= 57)
        mdig = active & is_digit & ~in_exp
        # XLA contracts mant * 10 + d into one fused multiply-add
        mant = torch.where(mdig, fma(mant, 10.0, (b - 48).to(torch.float64)),
                           mant)
        frac_scale = torch.where(mdig & seen_dot, frac_scale + 1,
                                 frac_scale)
        ndig = torch.where(mdig, ndig + 1, ndig)
        exp_val = torch.where(active & is_digit & in_exp,
                              exp_val * 10 + (b - 48), exp_val)
        newly_dot = active & (b == 46) & ~seen_dot & ~in_exp
        seen_dot = seen_dot | newly_dot
        newly_exp = active & ((b == 101) | (b == 69)) & ~in_exp \
            & (ndig > 0)
        exp_neg = exp_neg | (newly_exp & (byte_at(p + 1) == 45))
        in_exp = in_exp | newly_exp
        # a sign inside the exponent is legal only right after e / E
        sign_ok = prev_was_e & ((b == 45) | (b == 43))
        invalid = invalid | (active & ~(is_digit | newly_dot | newly_exp
                                        | sign_ok))
        prev_was_e = newly_exp
        exp_ndig = torch.where(active & is_digit & in_exp & ~newly_exp,
                               exp_ndig + 1, exp_ndig)
    invalid = invalid | (tlen > skip + 40) | (in_exp & (exp_ndig == 0))
    exp = torch.where(exp_neg, -exp_val, exp_val) - frac_scale
    out = mant * _pow10(exp)
    out = torch.where(neg, -out, out)
    ok = ~invalid & (ndig > 0) & (tlen > 0)
    inf = (_literal_at(byte_at, tlen, b"infinity", skip)
           | _literal_at(byte_at, tlen, b"inf", skip))
    nan = _literal_at(byte_at, tlen, b"nan", 0)
    out = torch.where(inf, torch.where(neg, -torch.inf, torch.inf), out)
    out = torch.where(nan, torch.nan, out)
    return CV(out, cv.validity & (ok | inf | nan))


_POW10_SPAN = 400


def _pow10(exp):
    """10.0 ** exp, correctly rounded (XLA's pow gives these exactly;
    torch's vectorized pow may be an ulp off): a table of the doubles
    nearest 10^k, k in [-400, 400], which holds 0.0 and inf at its ends,
    where any larger |exp| lands."""
    table = torch.tensor([float(f"1e{k}") for k in range(
        -_POW10_SPAN, _POW10_SPAN + 1)], dtype=torch.float64,
        device=exp.device)
    return table[(exp.to(torch.int64) + _POW10_SPAN).clamp(
        0, 2 * _POW10_SPAN)]


def _dec_mul_pow10_dyn(v2, k):
    """v2 * 10^k for a per-row 0 <= k <= 38, exactly in 128 bits: one
    product with the row's power of ten gathered from a table (the JAX
    package multiplies by k's binary digits, the same value). Returns
    (v2, overflow past 38 digits)."""
    from .decimal128 import POW10_128, dec_mul_scaled, from_limbs
    table = from_limbs([torch.tensor([p[i] for p in POW10_128],
                                     dtype=torch.int64, device=v2.device)
                        for i in range(4)])
    return dec_mul_scaled(v2, table[k.to(torch.int64)], 0, 38)


def string_to_decimal(cv: CV, to_t: dt.DecimalType) -> CV:
    """Exact string -> decimal(p, s): [sign] digits [. digits] [eE [sign]
    digits]. Pass 1 checks the syntax and counts (mantissa digits,
    integer digits, leading zeros, exponent); pass 2 routes the
    significant digits that land at or above scale s into 18 + 18 + 2
    digit int64 chunks, combined in 128 bits, and the digit just past
    scale s drives HALF_UP."""
    from .decimal128 import (_neg_raw, dec_add, dec_from_i64, dec_to_i64,
                             fits_precision, from_limbs, to_limbs)
    p_, s_ = to_t.precision, to_t.scale
    tstart, tlen, longest = _trim_bounds(cv)
    byte_at = _reader(cv, tstart, tlen)
    n = tlen.shape[0]
    dev = tlen.device
    b0 = byte_at(0)
    neg = b0 == 45
    skip = ((b0 == 45) | (b0 == 43)).to(torch.int64)
    scan = 64
    i32 = dict(dtype=torch.int32, device=dev)
    bl = dict(dtype=torch.bool, device=dev)
    nd, nint, lead = (torch.zeros(n, **i32) for _ in range(3))
    exp_val, exp_ndig = torch.zeros(n, **i32), torch.zeros(n, **i32)
    lead_run = torch.ones(n, **bl)
    seen_dot, in_exp, exp_neg, prev_was_e, invalid = (
        torch.zeros(n, **bl) for _ in range(5))
    for k in range(min(scan, longest)):
        pos = skip + k
        b = byte_at(pos)
        active = pos < tlen
        is_digit = (b >= 48) & (b <= 57)
        m_dig = active & is_digit & ~in_exp
        nd = torch.where(m_dig, nd + 1, nd)
        nint = torch.where(m_dig & ~seen_dot, nint + 1, nint)
        is_lead0 = m_dig & ~seen_dot & lead_run & (b == 48)
        lead = torch.where(is_lead0, lead + 1, lead)
        lead_run = lead_run & (~m_dig | is_lead0)
        newly_dot = active & (b == 46) & ~seen_dot & ~in_exp
        seen_dot = seen_dot | newly_dot
        newly_exp = active & ((b == 101) | (b == 69)) & ~in_exp & (nd > 0)
        exp_neg = exp_neg | (newly_exp & (byte_at(pos + 1) == 45))
        in_exp = in_exp | newly_exp
        e_dig = active & is_digit & in_exp & ~newly_exp
        exp_val = torch.where(e_dig, torch.clamp(exp_val * 10 + (b - 48),
                                                 max=9999), exp_val)
        exp_ndig = torch.where(e_dig, exp_ndig + 1, exp_ndig)
        sign_ok = prev_was_e & ((b == 45) | (b == 43))
        invalid = invalid | (active & ~(is_digit | newly_dot | newly_exp
                                        | sign_ok))
        prev_was_e = newly_exp
    invalid = invalid | (tlen > skip + scan) | (nd == 0) | (tlen == 0)
    invalid = invalid | (in_exp & (exp_ndig == 0))
    exp = torch.where(exp_neg, -exp_val, exp_val)
    # the digits [lead, end) of the mantissa are kept; the digit at
    # `end` rounds
    end = nint + exp + s_
    nsig = (torch.minimum(end, nd) - lead).clamp(0, 40)
    invalid = invalid | ((end - lead) > 38)
    pad = (end - torch.maximum(nd, lead)).clamp(0, 38)

    i64 = dict(dtype=torch.int64, device=dev)
    h0, h1, h2 = (torch.zeros(n, **i64) for _ in range(3))
    roundup = torch.zeros(n, **bl)
    mi = torch.zeros(n, **i32)
    in_e2 = torch.zeros(n, **bl)
    for k in range(min(scan, longest)):
        pos = skip + k
        b = byte_at(pos)
        active = pos < tlen
        in_e2 = in_e2 | (active & ((b == 101) | (b == 69)))
        m_dig = active & (b >= 48) & (b <= 57) & ~in_e2
        d = (b - 48).to(torch.int64)
        c = mi - lead
        acc = m_dig & (mi >= lead) & (mi < end)
        h0 = torch.where(acc & (c < 18), h0 * 10 + d, h0)
        h1 = torch.where(acc & (c >= 18) & (c < 36), h1 * 10 + d, h1)
        h2 = torch.where(acc & (c >= 36), h2 * 10 + d, h2)
        roundup = roundup | (m_dig & (mi == end) & (d >= 5))
        mi = torch.where(m_dig, mi + 1, mi)
    n1 = (nsig - 18).clamp(0, 18)
    n2 = (nsig - 36).clamp(0, 2)
    v = dec_from_i64(h0)
    v, o1 = _dec_mul_pow10_dyn(v, n1)
    v, oa = dec_add(v, dec_from_i64(h1))
    v, o2 = _dec_mul_pow10_dyn(v, n2)
    v, ob = dec_add(v, dec_from_i64(h2))
    v, o3 = _dec_mul_pow10_dyn(v, pad)
    v, oc = dec_add(v, dec_from_i64(roundup.to(torch.int64)))
    ovf = o1 | oa | o2 | ob | o3 | oc
    ok = ~invalid & ~ovf & fits_precision(to_limbs(v), p_) & cv.validity
    v = torch.where(neg.unsqueeze(-1), from_limbs(_neg_raw(to_limbs(v))),
                    v)
    if to_t.is_decimal128:
        return CV(torch.where(ok.unsqueeze(-1), v, 0), ok)
    v64, fits = dec_to_i64(v)
    ok = ok & fits
    return CV(torch.where(ok, v64, 0), ok)


def string_to_bool(cv: CV) -> CV:
    """true / t / yes / y / 1 and false / f / no / n / 0, any case;
    anything else is null."""
    tstart, tlen, _ = _trim_bounds(cv)
    byte_at = _reader(cv, tstart, tlen)

    def match(lit: bytes):
        return _literal_at(byte_at, tlen, lit, 0)

    true_m = (match(b"true") | match(b"t") | match(b"yes") | match(b"y")
              | match(b"1"))
    false_m = (match(b"false") | match(b"f") | match(b"no") | match(b"n")
               | match(b"0"))
    return CV(true_m, cv.validity & (true_m | false_m))


# ----------------------------------------------------------------------
# number, boolean, date and timestamp -> string
# ----------------------------------------------------------------------
def _digits_matrix(absval, max_digits: int):
    """([n, max_digits] ASCII digits, most significant first, and each
    row's digit count, at least 1). Floor division and modulo, as jnp's,
    so INT64_MIN (whose absolute value wraps) renders as in the JAX
    package."""
    cols = []
    v = absval
    for _ in range(max_digits):
        cols.append((torch.remainder(v, 10) + 48).to(torch.uint8))
        v = torch.div(v, 10, rounding_mode="floor")
    mat = torch.stack(cols[::-1], dim=1)
    lead0 = (torch.cumsum((mat != 48).to(torch.int32), dim=1) == 0).sum(1)
    return mat, (max_digits - lead0).clamp(min=1).to(torch.int32)


def _emit_from_staging(staging, row_lens, validity) -> CV:
    """A string CV from an [n, W] staging matrix whose rows hold their
    bytes in their last row_lens columns. The byte buffer is n * W (the
    bound), each row's bytes scattered to its offset: no host read."""
    n, w = staging.shape
    dev = staging.device
    lens = torch.where(validity, row_lens, 0).to(torch.int32)
    off = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    if n:
        torch.cumsum(lens, 0, dtype=torch.int32, out=off[1:])
    cap = n * w
    col = torch.arange(w, device=dev).unsqueeze(0)
    first = (w - lens.to(torch.int64)).unsqueeze(1)
    keep = col >= first
    dest = off[:-1].to(torch.int64).unsqueeze(1) + (col - first)
    dest = torch.where(keep, dest, cap)     # the rest to a dropped slot
    out = torch.zeros(cap + 1, dtype=torch.uint8, device=dev)
    out.scatter_(0, dest.reshape(-1), staging.reshape(-1))
    return CV(out[:cap], validity, off)


def _signed_digits(x, width: int):
    """[n, width] staging of [sign] digits right-aligned, and lengths."""
    neg = x < 0
    mat, ndig = _digits_matrix(torch.where(neg, -x, x), 19)
    c = torch.arange(width, device=x.device)          # from the right
    digit = mat[:, (18 - c).clamp(0, 18)]
    ndc = ndig.unsqueeze(1)
    val = torch.where(c < ndc, digit,
                      torch.where((c == ndc) & neg.unsqueeze(1), 45, 0))
    return val.flip(1).to(torch.uint8), ndig + neg.to(torch.int32)


def int_to_string(cv: CV) -> CV:
    staging, lens = _signed_digits(cv.data.to(torch.int64), 20)
    return _emit_from_staging(staging, lens, cv.validity)


def bool_to_string(cv: CV) -> CV:
    b = cv.data.to(torch.bool)
    dev = b.device
    t = torch.tensor(list(b"\0true"), dtype=torch.uint8, device=dev)
    f = torch.tensor(list(b"false"), dtype=torch.uint8, device=dev)
    staging = torch.where(b.unsqueeze(1), t.unsqueeze(0), f.unsqueeze(0))
    lens = torch.where(b, 4, 5).to(torch.int32)
    return _emit_from_staging(staging, lens, cv.validity)


def decimal_to_string(cv: CV, scale: int) -> CV:
    """A decimal64's unscaled value rendered at its scale: the integer
    part (at least one digit), '.', then `scale` digits."""
    x = cv.data.to(torch.int64)
    if scale == 0:
        staging, lens = _signed_digits(x, 20)
        return _emit_from_staging(staging, lens, cv.validity)
    neg = x < 0
    mat, ndig = _digits_matrix(torch.where(neg, -x, x), 19)
    int_digits = (ndig - scale).clamp(min=1)
    w = 22
    c = torch.arange(w, device=x.device)              # from the right
    is_frac = c < scale
    digit_i = torch.where(is_frac, c, c - 1)
    mval = mat[:, (18 - digit_i).clamp(0, 18)]
    int_pos = (c - scale - 1).unsqueeze(0)
    idig = int_digits.unsqueeze(1)
    val = torch.where(is_frac, mval, torch.where(
        c == scale, 46, torch.where(
            int_pos < idig, mval,
            torch.where((int_pos == idig) & neg.unsqueeze(1), 45, 0))))
    lens = int_digits + 1 + scale + neg.to(torch.int32)
    return _emit_from_staging(val.flip(1).to(torch.uint8), lens,
                              cv.validity)


def _two(v):
    """Tens and units digits of v (floor semantics, as jnp's)."""
    return torch.remainder(torch.div(v, 10, rounding_mode="floor"), 10), \
        torch.remainder(v, 10)


def date_to_string(cv: CV) -> CV:
    """Days since the epoch -> 'YYYY-MM-DD'."""
    from .datetime import civil_from_days
    y, m, d = civil_from_days(cv.data)
    fl = lambda v, p: torch.remainder(                      # noqa: E731
        torch.div(v, p, rounding_mode="floor"), 10)
    cols = [fl(y, 1000), fl(y, 100), fl(y, 10), fl(y, 1), None,
            *_two(m), None, *_two(d)]
    n = cv.data.shape[0]
    staging = torch.stack(
        [torch.full((n,), 45, dtype=torch.int32, device=y.device)
         if v is None else v + 48 for v in cols], dim=1)
    lens = torch.full((n,), 10, dtype=torch.int32, device=y.device)
    return _emit_from_staging(staging.to(torch.uint8), lens, cv.validity)


def timestamp_to_string(cv: CV) -> CV:
    """Microseconds since the epoch -> 'YYYY-MM-DD HH:MM:SS[.ffffff]',
    the fraction without its trailing zeros and omitted when 0 (Spark's
    rendering); a year outside 1..9999 is null."""
    from .datetime import MICROS_PER_DAY, MICROS_PER_SEC, civil_from_days
    x = cv.data.to(torch.int64)
    dev = x.device
    days = torch.div(x, MICROS_PER_DAY, rounding_mode="floor")
    tod = x - days * MICROS_PER_DAY
    y, mo, d = civil_from_days(days.to(torch.int32))
    secs = torch.div(tod, MICROS_PER_SEC, rounding_mode="floor")
    fr = (tod - secs * MICROS_PER_SEC).to(torch.int32)
    hh = torch.div(secs, 3600, rounding_mode="floor").to(torch.int32)
    mi = torch.remainder(torch.div(secs, 60, rounding_mode="floor"),
                         60).to(torch.int32)
    ss = torch.remainder(secs, 60).to(torch.int32)
    n = x.shape[0]
    fd = [torch.remainder(torch.div(fr, 10 ** i, rounding_mode="floor"),
                          10) for i in range(6)]
    tz = torch.zeros(n, dtype=torch.int32, device=dev)
    run = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(6):
        run = run & (fd[i] == 0)
        tz = torch.where(run, tz + 1, tz)
    fl = torch.where(fr == 0, 0, 6 - tz + 1)       # with '.', 0 if none
    lens = (19 + fl).to(torch.int32)
    validity = cv.validity & (y >= 1) & (y <= 9999)
    w = 26
    yd = lambda p: torch.remainder(                         # noqa: E731
        torch.div(y, p, rounding_mode="floor"), 10)
    s10, s1 = _two(ss)
    m10, m1 = _two(mi)
    h10, h1 = _two(hh)
    d10, d1 = _two(d)
    o10, o1 = _two(mo)
    # the fixed 'YYYY-MM-DD HH:MM:SS' from the right; None a separator
    fixed = [s1, s10, None, m1, m10, None, h1, h10, None, d1, d10, None,
             o1, o10, None, yd(1), yd(10), yd(100), yd(1000)]
    seps = {2: 58, 5: 58, 8: 32, 11: 45, 14: 45}
    fixed_vals = torch.stack(
        [torch.full((n,), seps[i], dtype=torch.int32, device=dev)
         if v is None else v.to(torch.int32) + 48
         for i, v in enumerate(fixed)], dim=1)               # [n, 19]
    frac_mat = torch.stack(fd, dim=1).to(torch.int32)        # lsd first
    c = torch.arange(w, device=dev).unsqueeze(0)             # from right
    flc = fl.unsqueeze(1)
    fval = torch.gather(frac_mat, 1, (tz.unsqueeze(1) + c).clamp(0, 5)
                        .to(torch.int64)) + 48
    fxv = torch.gather(fixed_vals, 1, (c - flc).clamp(0, 18)
                       .to(torch.int64))
    val = torch.where(c < flc - 1, fval, torch.where(
        c == flc - 1, 46, torch.where(c - flc < 19, fxv, 0)))
    return _emit_from_staging(val.flip(1).to(torch.uint8), lens, validity)


def _digits_at(byte_at, pos: int, width: int):
    """`width` digits at trimmed offset `pos`: (value int32, ok)."""
    val = None
    ok = None
    for k in range(width):
        b = byte_at(pos + k)
        is_d = (b >= 48) & (b <= 57)
        ok = is_d if ok is None else ok & is_d
        v = torch.where(is_d, b - 48, 0)
        val = v if val is None else val * 10 + v
    return val, ok


def _date_parts(byte_at):
    y, oky = _digits_at(byte_at, 0, 4)
    m, okm = _digits_at(byte_at, 5, 2)
    d, okd = _digits_at(byte_at, 8, 2)
    from .datetime import days_in_month
    ok = (oky & okm & okd & (byte_at(4) == 45) & (byte_at(7) == 45)
          & (m >= 1) & (m <= 12) & (d >= 1))
    return y, m, d, ok & (d <= days_in_month(y, m))


def string_to_date(cv: CV) -> CV:
    """'YYYY-MM-DD' (Spark's default date format; other layouts are
    null, as in the JAX package)."""
    from .datetime import days_from_civil
    tstart, tlen, _ = _trim_bounds(cv)
    byte_at = _reader(cv, tstart, tlen)
    y, m, d, ok = _date_parts(byte_at)
    ok = ok & (tlen == 10)
    days = days_from_civil(y, m, d)
    return CV(torch.where(ok, days, 0).to(torch.int32), cv.validity & ok)


def string_to_timestamp(cv: CV) -> CV:
    """'YYYY-MM-DD[ HH:MM:SS]' (or 'T' between) as UTC microseconds; a
    bare date is midnight; a fraction or a zone is null, as in the JAX
    package."""
    from .datetime import MICROS_PER_DAY, MICROS_PER_SEC, days_from_civil
    tstart, tlen, _ = _trim_bounds(cv)
    byte_at = _reader(cv, tstart, tlen)
    y, m, d, date_ok = _date_parts(byte_at)
    hh, okh = _digits_at(byte_at, 11, 2)
    mi, okmi = _digits_at(byte_at, 14, 2)
    ss, oks = _digits_at(byte_at, 17, 2)
    sep = byte_at(10)
    time_ok = (okh & okmi & oks & ((sep == 32) | (sep == 84))
               & (byte_at(13) == 58) & (byte_at(16) == 58)
               & (hh < 24) & (mi < 60) & (ss < 60) & (tlen == 19))
    bare_date = tlen == 10
    ok = date_ok & (bare_date | time_ok)
    days = days_from_civil(y, m, d).to(torch.int64)
    tod = torch.where(bare_date, 0, (hh.to(torch.int64) * 3600 + mi * 60
                                     + ss) * MICROS_PER_SEC)
    micros = days * MICROS_PER_DAY + tod
    return CV(torch.where(ok, micros, 0), cv.validity & ok)
