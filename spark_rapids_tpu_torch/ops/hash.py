"""Spark-compatible Murmur3_x86_32 (seed 42), hash partitioning, and the
aggregation's hash-once 64-bit row hash.

The port's copy of the JAX package's `ops/hash.py`: murmur3 of bool,
byte/short/int/date/float (hashInt), long/timestamp/decimal/double
(hashLong) and
string/binary keys (hashUnsafeBytes, with the JAX package's fold past 64
bytes, docs/compatibility.md:59), folded left to right across key
columns; `pmod(hash, n)` partition ids; and `fold64` / `avalanche32` /
`hash_once_rows`, the xxhash64-style bucket hash of the grouped
aggregation. Float, double and decimal128 keys hash as the JAX package
hashes them (`_float_bits`, `_double_word`, the limbs folded), its CPU
compile's ids for every value; a float NaN whose bits are not the
canonical 0x7FC00000 is the one departure (ROADMAP C.15). Bit-identical
to the JAX functions otherwise. The Spark-facing xxhash64 (seed 42,
Spark's XXH64 hashInt / hashLong / hashUnsafeBytes schedule, with the
JAX package's 64-byte string bound and fold) and hive_hash (Hive's
31-polynomial row hashCode) follow, with the same float and double
inputs as murmur3. Last, `bloom_positions`: the k bit positions of the
bloom filter, which the aggregate that builds it, the probe and the
runtime join filter share.

torch has no unsigned 32-bit arithmetic on every build, and `>>` on
int64 is arithmetic. So every 32-bit word here lives in an int64 tensor
holding its unsigned value in [0, 2^32); multiplies are split so no
product leaves int64, and each step masks back to 32 bits. A 64-bit
word is a pair (hi, lo) of such halves.
"""
from __future__ import annotations

import torch

from ..columnar import dtypes as dt
from ..errors import NotPorted
from .kernel_utils import CV

__all__ = ["hash_int32", "hash_int64", "murmur3_cv", "murmur3_row_hash",
           "partition_ids", "to_signed32", "fold64", "avalanche32",
           "hash_once_rows", "xxhash64_cv", "xxhash64_row_hash",
           "hive_hash_cv", "hive_hash_row_hash", "BLOOM_SEED1",
           "BLOOM_SEED2", "bloom_positions"]

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _mix_k1(k1):
    return _mul32(_rotl(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1, k1):
    h1 = _rotl(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _u32(x):
    """Any integer tensor -> its low 32 bits as an int64 in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def to_signed32(u):
    """[0, 2^32) int64 -> the int32 with those bits."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def hash_int32(x, seed):
    """Murmur3 hashInt of int32 values `x` into unsigned-word seeds."""
    return _fmix(_mix_h1(seed, _mix_k1(_u32(x))), 4)


def hash_int64(x, seed):
    """Murmur3 hashLong: the low word, then the high word."""
    x = x.to(torch.int64)
    h1 = _mix_h1(seed, _mix_k1(x & _M32))
    h1 = _mix_h1(h1, _mix_k1((x >> 32) & _M32))
    return _fmix(h1, 8)


def murmur3_cv(cv: CV, dtype: dt.DataType, seed):
    """Per-row murmur3 of one column folded into `seed` (unsigned words
    in int64). Rows with a null input keep the seed (Spark semantics)."""
    x = cv.data
    if isinstance(dtype, dt.BooleanType):
        h = hash_int32(x.to(torch.int32), seed)
    elif isinstance(dtype, (dt.ByteType, dt.ShortType, dt.IntegerType,
                            dt.DateType)):
        h = hash_int32(x, seed)
    elif isinstance(dtype, (dt.LongType, dt.TimestampType)):
        h = hash_int64(x, seed)
    elif isinstance(dtype, dt.DecimalType):
        # decimal128: the two limbs folded (the JAX package's departure
        # from Spark, which hashes the unscaled value's bytes)
        h = hash_int64(x[:, 0] ^ x[:, 1] if dtype.is_decimal128 else x,
                       seed)
    elif isinstance(dtype, dt.FloatType):
        h = hash_int32(_float_bits(x), seed)
    elif isinstance(dtype, dt.DoubleType):
        h = hash_int64(_double_word(x), seed)
    elif dtype.is_variable_width:
        h = _hash_string(cv, seed)
    else:
        raise NotPorted(f"hash({dtype})")
    return torch.where(cv.validity, h, seed)


def _flush_zero(x):
    """-0.0 and the subnormals as 0.0: the JAX package's CPU compiles
    flush subnormals to zero, so they hash as 0.0 there."""
    tiny = torch.finfo(x.dtype).tiny
    return torch.where(x.abs() < tiny, torch.zeros_like(x), x)


def _float_bits(x):
    """Spark's float hash input: -0.0 as 0.0, then the int32 bits; every
    NaN as the one canonical NaN 0x7FC00000 (Java's floatToIntBits), so
    NaN rows land in one partition whatever bits a device computed."""
    bits = _flush_zero(x).view(torch.int32)
    return torch.where(torch.isnan(x), 0x7FC00000, bits)


def _double_word(x):
    """The JAX package's float64 hash input (engine-internal, not Spark's
    doubleToLongBits, docs/compatibility.md:44-46): m, e = frexp(|x|),
    mant = trunc(m * 2^53) with x's sign, then mant ^ (e << 1). Its CPU
    compile hashes NaN as 0.0 (frexp gives NaN and 0, the cast of NaN
    gives 0) and +-Infinity as mant = +-(2^63 - 1), e = 0 (the cast
    saturates); those values are written out here, since a cast of a
    NaN or an infinity to int64 is undefined in C and differs by
    device."""
    xx = _flush_zero(x)
    m, e = torch.frexp(xx.abs())
    finite = torch.isfinite(xx)
    mant = (torch.where(finite, m, 0.0) * (2.0 ** 53)).to(torch.int64)
    mant = torch.where(torch.isinf(xx), (1 << 63) - 1, mant)
    mant = torch.where(xx < 0, -mant, mant)
    e = torch.where(finite, e.to(torch.int64), 0)
    return mant ^ (e << 1)


def _hash_string(cv: CV, seed):
    """Spark Murmur3_x86_32.hashUnsafeBytes: mix each full 4-byte
    little-endian word, then each tail byte as a sign-extended int in its
    own round. Exact for strings up to 64 bytes; past that the JAX
    package folds in the last word instead of the tail, and so does
    this."""
    starts = cv.offsets[:-1].to(torch.int64)
    lens = (cv.offsets[1:] - cv.offsets[:-1]).to(torch.int64)
    data = cv.data
    dcap = data.shape[0]

    def byte_at(pos):
        if dcap == 0:
            return torch.zeros_like(pos)
        return data[pos.clamp(0, dcap - 1)].to(torch.int64)

    maxb = 64
    h1 = seed
    nfull = lens // 4
    for w in range(maxb // 4):
        base = starts + 4 * w
        word = torch.zeros_like(starts)
        for b in range(4):
            word = word | (byte_at(base + b) << (8 * b))
        h1 = torch.where(w < nfull, _mix_h1(h1, _mix_k1(word)), h1)
    overlong = lens > maxb
    aligned = nfull * 4
    for t in range(3):
        pos = aligned + t
        byte = byte_at(starts + pos)
        signed = torch.where(byte >= 128, byte - 256, byte)
        active = (pos < lens) & ~overlong
        h1 = torch.where(active, _mix_h1(h1, _mix_k1(_u32(signed))), h1)
    tail_base = torch.maximum(starts, starts + lens - 4)
    tail = torch.zeros_like(starts)
    for b in range(4):
        byte = torch.where(b < lens, byte_at(tail_base + b), 0)
        tail = tail | (byte << (8 * b))
    h1 = torch.where(overlong, _mix_h1(h1, _mix_k1(tail)), h1)
    return _fmix(h1, lens)


def murmur3_row_hash(cvs, dtypes, seed: int = 42):
    """Row hash across columns, Spark style: fold column hashes left to
    right starting from the seed. Returns unsigned words in int64."""
    n = cvs[0].validity.shape[0]
    h = torch.full((n,), seed & _M32, dtype=torch.int64,
                   device=cvs[0].validity.device)
    for cv, dtp in zip(cvs, dtypes):
        h = murmur3_cv(cv, dtp, h)
    return h


def pmod_signed(h, num_partitions: int):
    """Spark pmod of the signed 32-bit hash: an int32 id in [0, n)."""
    signed = torch.where(h >= (1 << 31), h - (1 << 32), h)
    return torch.remainder(signed, num_partitions).to(torch.int32)


def partition_ids(cvs, dtypes, num_partitions: int, seed: int = 42):
    """Spark's HashPartitioning: pmod(murmur3, n)."""
    return pmod_signed(murmur3_row_hash(cvs, dtypes, seed), num_partitions)


# ----------------------------------------------------------------------
# Hash-once 64-bit keying (xxhash64-style) for the aggregation's hash
# pass: the bucket hash folds the same key arrays the exact verify step
# compares, so a string key is read once. Engine-internal; exchanges keep
# Spark's murmur3.
# ----------------------------------------------------------------------
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9


def _mul32_wide(x, c: int):
    """The 64-bit product of x in [0, 2^32) and a 32-bit constant, as
    (hi, lo) halves; each partial product stays below 2^48."""
    t0 = x * (c & 0xFFFF)
    t1 = x * (c >> 16)
    s = (t0 & _M32) + ((t1 & 0xFFFF) << 16)
    return ((t0 >> 32) + (t1 >> 16) + (s >> 32)) & _M32, s & _M32


def _mul64(w, c: int):
    """(hi, lo) * c mod 2^64 for a 64-bit constant c."""
    hi, lo = w
    ch, cl = c >> 32, c & _M32
    p_hi, p_lo = _mul32_wide(lo, cl)
    return (p_hi + _mul32(hi, cl) + _mul32(lo, ch)) & _M32, p_lo


def _rotl64(w, r: int):
    """Rotate left by 0 < r < 32."""
    hi, lo = w
    return (((hi << r) & _M32) | (lo >> (32 - r)),
            ((lo << r) & _M32) | (hi >> (32 - r)))


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _add64c(w, c: int):
    hi, lo = w
    lo = lo + (c & _M32)
    return (hi + (c >> 32) + (lo >> 32)) & _M32, lo & _M32


def _split64(a):
    """An integer key array as the halves of its uint64 value (signed
    values sign-extend, as a cast to uint64 does)."""
    a = a.to(torch.int64)
    return (a >> 32) & _M32, a & _M32


def fold64(h, a):
    """One xxhash64-style round folding integer array `a` into the 64-bit
    accumulator `h` (a (hi, lo) pair)."""
    return _fold64_w(h, _split64(a))


def _fold64_w(h, w):
    a64 = _mul64(_rotl64(_mul64(w, _P64_2), 31), _P64_1)
    h = _xor64(h, a64)
    return _add64c(_mul64(_rotl64(h, 27), _P64_1), _P64_3)


def avalanche32(h):
    """A 64-bit accumulator finalized to its low 32 bits (unsigned, in
    int64), the bucket index source."""
    hi, lo = h
    h = (hi, lo ^ (hi >> 1))                                # ^= h >> 33
    hi, lo = _mul64(h, _P64_2)
    h = (hi ^ (hi >> 29), lo ^ ((lo >> 29) | ((hi << 3) & _M32)))
    hi, lo = _mul64(h, _P64_3)
    return lo ^ hi                                          # ^= h >> 32


def hash_once_rows(eq_arrays, seed: int = 0x9E3779B1):
    """Row bucket hash from the equality key arrays (null flags and
    order-key words, adjacent chunk words packed): every array of every
    column folds into one 64-bit accumulator, avalanched to 32 bits.
    Equal rows hash equal by construction."""
    n = eq_arrays[0][0].shape[0] if eq_arrays and eq_arrays[0] else 0
    dev = eq_arrays[0][0].device
    h = (torch.zeros(n, dtype=torch.int64, device=dev),
         torch.full((n,), seed & _M32, dtype=torch.int64, device=dev))
    for arrs in eq_arrays:
        for a in arrs:
            h = fold64(h, a)
    return avalanche32(h)


# ----------------------------------------------------------------------
# Spark-facing xxhash64 and hive_hash (the JAX package's `ops/hash.py`
# `xxhash64_*` and `hive_hash_*`). xxhash64 folds left to right from the
# seed, a null input passing the running hash through; hive_hash folds
# result * 31 + column hash from 0, a null contributing 0.
# ----------------------------------------------------------------------
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5


def _add64(w, x):
    """(hi, lo) + x for x in [0, 2^32), mod 2^64."""
    hi, lo = w
    lo = lo + x
    return (hi + (lo >> 32)) & _M32, lo & _M32


def _xxh_fmix(h):
    hi, lo = h
    h = (hi, lo ^ (hi >> 1))                                # ^= h >> 33
    hi, lo = _mul64(h, _P64_2)
    h = (hi ^ (hi >> 29), lo ^ ((lo >> 29) | ((hi << 3) & _M32)))
    hi, lo = _mul64(h, _P64_3)
    return hi, lo ^ hi                                      # ^= h >> 32


def _xxh_int(x, seed):
    """Spark XXH64.hashInt of int32 values `x`."""
    h = _add64c(seed, _P64_5 + 4)
    w = _mul64((torch.zeros_like(seed[0]), _u32(x)), _P64_1)
    h = _add64c(_mul64(_rotl64(_xor64(h, w), 23), _P64_2), _P64_3)
    return _xxh_fmix(h)


def _xxh_long_w(w, seed):
    """Spark XXH64.hashLong of the 64-bit words `w` ((hi, lo) pairs)."""
    h = _add64c(seed, _P64_5 + 8)
    k1 = _mul64(_rotl64(_mul64(w, _P64_2), 31), _P64_1)
    h = _add64c(_mul64(_rotl64(_xor64(h, k1), 27), _P64_1), _P64_4)
    return _xxh_fmix(h)


def _word_at(byte_at, base, nbytes: int):
    """Little-endian word of `nbytes` (4 or 8) bytes from `base`, as an
    (hi, lo) pair."""
    lo = torch.zeros_like(base)
    for b in range(4):
        lo = lo | (byte_at(base + b) << (8 * b))
    hi = torch.zeros_like(base)
    for b in range(4, nbytes):
        hi = hi | (byte_at(base + b) << (8 * (b - 4)))
    return hi, lo


def _xxh_string(cv: CV, seed):
    """XXH64 over a string's bytes: Spark's hashUnsafeBytes small-input
    schedule (8-byte rounds, one 4-byte round, then a round a byte) over
    the first 64 bytes, and past 64 bytes a fold of the last 8, as the
    JAX package bounds it (docs/compatibility.md)."""
    starts = cv.offsets[:-1].to(torch.int64)
    lens = (cv.offsets[1:] - cv.offsets[:-1]).to(torch.int64)
    data = cv.data
    dcap = data.shape[0]

    def byte_at(pos):
        if dcap == 0:
            return torch.zeros_like(pos)
        return data[pos.clamp(0, dcap - 1)].to(torch.int64)

    maxb = 64
    h = _add64(_add64c(seed, _P64_5), lens)
    overlong = lens > maxb
    eff = torch.where(overlong, maxb, lens)
    nfull8 = torch.div(eff, 8, rounding_mode="floor")

    def pick(c, a, b):
        return torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1])

    for w in range(maxb // 8):
        word = _word_at(byte_at, starts + 8 * w, 8)
        k1 = _mul64(_rotl64(_mul64(word, _P64_2), 31), _P64_1)
        step = _add64c(_mul64(_rotl64(_xor64(h, k1), 27), _P64_1), _P64_4)
        h = pick(w < nfull8, step, h)
    aligned = nfull8 * 8
    word4 = _word_at(byte_at, starts + aligned, 4)
    has4 = aligned + 4 <= eff
    step = _add64c(_mul64(_rotl64(_xor64(h, _mul64(word4, _P64_1)), 23),
                          _P64_2), _P64_3)
    h = pick(has4, step, h)
    aligned = torch.where(has4, aligned + 4, aligned)
    zero = torch.zeros_like(starts)
    for t in range(3):
        pos = aligned + t
        k = _mul64((zero, byte_at(starts + pos)), _P64_5)
        step = _mul64(_rotl64(_xor64(h, k), 11), _P64_1)
        h = pick(pos < eff, step, h)
    tail = _word_at(byte_at, torch.maximum(starts, starts + lens - 8), 8)
    h = pick(overlong, _fold64_w(h, tail), h)
    return _xxh_fmix(h)


def xxhash64_cv(cv: CV, dtype: dt.DataType, seed):
    """Per-row xxhash64 of one column folded into `seed` ((hi, lo)
    unsigned halves); a null row keeps the seed."""
    x = cv.data
    if isinstance(dtype, dt.BooleanType):
        h = _xxh_int(x.to(torch.int32), seed)
    elif isinstance(dtype, (dt.ByteType, dt.ShortType, dt.IntegerType,
                            dt.DateType)):
        h = _xxh_int(x, seed)
    elif isinstance(dtype, (dt.LongType, dt.TimestampType)):
        h = _xxh_long_w(_split64(x), seed)
    elif isinstance(dtype, dt.DecimalType):
        h = _xxh_long_w(_split64(x[:, 0] ^ x[:, 1] if dtype.is_decimal128
                                 else x), seed)
    elif isinstance(dtype, dt.FloatType):
        h = _xxh_int(_float_bits(x), seed)
    elif isinstance(dtype, dt.DoubleType):
        h = _xxh_long_w(_split64(_double_word(x)), seed)
    elif dtype.is_variable_width:
        h = _xxh_string(cv, seed)
    else:
        raise NotPorted(f"xxhash64({dtype})")
    return (torch.where(cv.validity, h[0], seed[0]),
            torch.where(cv.validity, h[1], seed[1]))


def xxhash64_row_hash(cvs, dtypes, seed: int = 42):
    """Row xxhash64 across columns, Spark style: the column hashes
    folded left to right from the seed; int64."""
    n = cvs[0].validity.shape[0]
    dev = cvs[0].validity.device
    h = (torch.full((n,), (seed >> 32) & _M32, dtype=torch.int64,
                    device=dev),
         torch.full((n,), seed & _M32, dtype=torch.int64, device=dev))
    for cv, dtp in zip(cvs, dtypes):
        h = xxhash64_cv(cv, dtp, h)
    hi, lo = h
    return torch.where(hi >= (1 << 31), hi - (1 << 32), hi) * (1 << 32) \
        + lo


def _hive_long(x):
    """Hive's hash of a long: (int) (v ^ (v >>> 32)), unsigned here."""
    hi, lo = _split64(x)
    return hi ^ lo


def hive_hash_cv(cv: CV, dtype: dt.DataType):
    """Hive hashCode of one column as unsigned words in int64; a null row
    is 0."""
    x = cv.data
    if isinstance(dtype, dt.BooleanType):
        h = x.to(torch.int64)
    elif isinstance(dtype, (dt.ByteType, dt.ShortType, dt.IntegerType,
                            dt.DateType)):
        h = _u32(x)
    elif isinstance(dtype, (dt.LongType, dt.TimestampType)):
        h = _hive_long(x)
    elif isinstance(dtype, dt.DecimalType):
        h = _hive_long(x[:, 0] ^ x[:, 1] if dtype.is_decimal128 else x)
    elif isinstance(dtype, dt.FloatType):
        h = _u32(_float_bits(x))
    elif isinstance(dtype, dt.DoubleType):
        h = _hive_long(_double_word(x))
    elif dtype.is_variable_width:
        h = _hive_string(cv)
    else:
        raise NotPorted(f"hive_hash({dtype})")
    return torch.where(cv.validity, h, 0)


def _hive_string(cv: CV):
    """Java's String.hashCode polynomial over the (sign-extended) UTF-8
    bytes, bounded at the first 64 bytes as the JAX package bounds it."""
    starts = cv.offsets[:-1].to(torch.int64)
    lens = (cv.offsets[1:] - cv.offsets[:-1]).to(torch.int64)
    data = cv.data
    dcap = data.shape[0]
    h = torch.zeros_like(starts)
    if dcap == 0:
        return h
    for pos in range(64):
        byte = data[(starts + pos).clamp(0, dcap - 1)].to(torch.int64)
        signed = torch.where(byte >= 128, byte - 256, byte)
        h = torch.where(pos < lens, (h * 31 + signed) & _M32, h)
    return h


def hive_hash_row_hash(cvs, dtypes):
    """Hive row hash: result * 31 + column hash, folded left to right
    from 0 (int32 wrap-around); int32."""
    n = cvs[0].validity.shape[0]
    h = torch.zeros(n, dtype=torch.int64, device=cvs[0].validity.device)
    for cv, dtp in zip(cvs, dtypes):
        h = (h * 31 + hive_hash_cv(cv, dtp)) & _M32
    return to_signed32(h)


# bloom-filter hash scheme shared by BloomFilterAggregate (build),
# BloomFilterMightContain (foldable probe), and RuntimeBloomFilterExec
# (runtime join filter): TWO murmur3 passes combined as h1 + i*h2 over
# a power-of-two bit count. ONE definition — a drifted copy would
# build and probe mismatched positions (silent false negatives).
BLOOM_SEED1 = 0
BLOOM_SEED2 = -1749833076


def bloom_positions(cv: CV, dtype: dt.DataType, k: int, num_bits: int):
    """Per-row bloom bit positions: k int64 tensors; invalid rows get
    -1 in every position. (h1 + i*h2) wraps at 32 bits before the
    modulo, as the JAX package's uint32 arithmetic does."""
    n = cv.validity.shape[0]
    dev = cv.validity.device
    h1 = murmur3_cv(cv, dtype, torch.full((n,), BLOOM_SEED1 & _M32,
                                          dtype=torch.int64, device=dev))
    h2 = murmur3_cv(cv, dtype, torch.full((n,), BLOOM_SEED2 & _M32,
                                          dtype=torch.int64, device=dev))
    out = []
    for i in range(k):
        p = ((h1 + i * h2) & _M32) % num_bits
        out.append(torch.where(cv.validity, p, -1))
    return out
