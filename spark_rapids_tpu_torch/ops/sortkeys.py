"""Order-key normalization: every column as sortable key tensors.

The port's copy of the JAX package's `ops/sortkeys.py`. The keys and
their order are the JAX package's:

  - bool/ints/decimal64/date/timestamp: the value itself (signed order);
    descending = bitwise NOT
  - decimal128: (hi word, lo word with its top bit flipped)
  - float32: the IEEE bit trick as an unsigned 32-bit key; NaN
    canonicalized and greatest (Spark), -0.0 == +0.0
  - float64: two keys (isnan, canonical value)
  - strings/binary: big-endian 4-byte chunks, padding 0x00 sorting first
    = byte-lexicographic order

torch has no unsigned 32-bit type on every build, so a uint32 key (a
string chunk, the float32 key) lives in an int64 tensor holding its
unsigned value, and descending is `2^32 - 1 - k`, which keeps it
unsigned. `lexsort` has no variadic stable sort to call (the JAX package
uses one `lax.sort`): it packs adjacent narrow keys into int64 words
where their widths allow and chains stable sorts from the last word to
the first, which orders and breaks ties exactly as the variadic sort.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..utils.transfer import fetch_ints
from .kernel_utils import CV

__all__ = ["order_keys", "key_widths", "string_chunk_keys", "pack_keys",
           "lexsort", "group_boundaries", "nchunks_for_len", "key_nchunks",
           "string_nchunks"]

_M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)


def nchunks_for_len(maxlen: int) -> int:
    """Chunk count for string keys of max byte length `maxlen`: the next
    power of two of the 4-byte chunks (the JAX package's default shape
    grid, which keeps its hash-pass bucket hashes the same)."""
    n = max(1, -(-maxlen // 4))
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _f32_key(x, descending):
    x = torch.where(x == 0, torch.zeros_like(x), x)          # -0.0 -> +0.0
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(torch.int32).to(torch.int64) & _M32
    sign = 0x80000000
    k = torch.where((b & sign) != 0, b ^ _M32, b | sign)
    return [_M32 - k if descending else k]


def _f64_keys(x, descending):
    x = torch.where(x == 0, torch.zeros_like(x), x)
    nan = torch.isnan(x)
    canon = torch.where(nan, torch.zeros_like(x), x)
    nankey = nan.to(torch.uint8)                            # NaN greatest
    if descending:
        return [~nankey, -canon]
    return [nankey, canon]


def order_keys(cv: CV, dtype: dt.DataType, nchunks: int = 0,
               descending: bool = False) -> List[torch.Tensor]:
    """Key tensors for one column (excluding the null key), most
    significant first. Ascending order of the keys == requested order."""
    if dtype.is_variable_width:
        ks = string_chunk_keys(cv, nchunks)
        return [_M32 - k for k in ks] if descending else ks
    x = cv.data
    if isinstance(dtype, dt.BooleanType):
        k = x.to(torch.uint8)
        return [~k if descending else k]
    if isinstance(dtype, dt.FloatType):
        return _f32_key(x, descending)
    if isinstance(dtype, dt.DoubleType):
        return _f64_keys(x, descending)
    if isinstance(dtype, dt.NullType):
        return [torch.zeros(cv.capacity, dtype=torch.uint8,
                            device=x.device)]
    if isinstance(dtype, dt.DecimalType) and dtype.is_decimal128:
        hi = x[:, 1]
        lo = x[:, 0] ^ _I64_MIN                  # flip the sign bit
        if descending:
            return [~hi, ~lo]
        return [hi, lo]
    return [~x if descending else x]


def key_widths(dtype: dt.DataType, nchunks: int = 0) -> List[Optional[int]]:
    """Bits of each `order_keys` tensor that `lexsort` may pack: the
    uint32 keys held in int64 are 32 bits wide; None leaves a key's width
    to its dtype."""
    if dtype.is_variable_width:
        return [32] * nchunks
    if isinstance(dtype, dt.FloatType):
        return [32]
    if isinstance(dtype, dt.DoubleType):
        return [None, None]
    if isinstance(dtype, dt.DecimalType) and dtype.is_decimal128:
        return [None, None]
    return [None]


def string_chunk_keys(cv: CV, nchunks: int) -> List[torch.Tensor]:
    """Big-endian 4-byte chunk keys, unsigned values in int64 tensors."""
    starts = cv.offsets[:-1].to(torch.int64)
    lens = (cv.offsets[1:] - cv.offsets[:-1]).to(torch.int64)
    data = cv.data
    dcap = data.shape[0]
    keys = []
    for c in range(nchunks):
        key = torch.zeros_like(starts)
        for b in range(4):
            inb = (4 * c + b) < lens
            if dcap:
                idx = (starts + 4 * c + b).clamp(0, dcap - 1)
                byte = torch.where(inb, data[idx].to(torch.int64), 0)
            else:
                byte = torch.zeros_like(starts)
            key = (key << 8) | byte
        keys.append(key)
    return keys


def _unsigned(k: torch.Tensor, width: Optional[int]):
    """(k as a non-negative int64 in order, its bits), or None when k
    cannot share a word (a full 64-bit or floating key)."""
    if k.dtype == torch.bool:
        return k.to(torch.int64), 1
    if k.dtype == torch.uint8:
        return k.to(torch.int64), 8
    bits = {torch.int8: 8, torch.int16: 16, torch.int32: 32}.get(k.dtype)
    if bits is not None:
        return k.to(torch.int64) + (1 << (bits - 1)), bits
    if k.dtype == torch.int64 and width is not None:
        return k, width
    return None


def pack_keys(keys: Sequence[torch.Tensor],
              widths: Optional[Sequence[Optional[int]]] = None):
    """Adjacent packable keys as int64 words of at most 63 bits, most
    significant first; any other key as a word of its own. The words
    order and compare as the keys do, lexicographically."""
    widths = list(widths) if widths is not None else [None] * len(keys)
    words, cur, cur_bits = [], None, 0
    for k, w in zip(keys, widths):
        u = _unsigned(k, w)
        if u is None:
            if cur is not None:
                words.append(cur)
                cur, cur_bits = None, 0
            words.append(k)
            continue
        t, bits = u
        if cur is not None and cur_bits + bits <= 63:
            cur = (cur << bits) | t
            cur_bits += bits
        else:
            if cur is not None:
                words.append(cur)
            cur, cur_bits = t, bits
    if cur is not None:
        words.append(cur)
    return words


def lexsort(keys: Sequence[torch.Tensor],
            widths: Optional[Sequence[Optional[int]]] = None):
    """Stable permutation (int64) ordering rows by keys[0], then keys[1],
    ...: narrow keys packed into words, then one stable sort per word
    from the least significant up."""
    words = pack_keys(keys, widths)
    perm = torch.argsort(words[-1], stable=True)
    for w in reversed(words[:-1]):
        perm = perm[torch.argsort(w[perm], stable=True)]
    return perm


def group_boundaries(sorted_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool[n]: True where a row starts a new group (row 0 is True)."""
    n = sorted_keys[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    if n == 0:
        return new
    for k in sorted_keys:
        new[1:] |= k[1:] != k[:-1]
    new[0] = True
    return new


def key_nchunks(key_cvs, dtypes, mask: torch.Tensor):
    """Chunk count of each string key (0 for any other) covering its
    longest live, valid string (dead and padding rows must not inflate
    it): one host read for all of them. A non-string key's CV may be
    None."""
    maxes = {}
    for i, (kcv, t) in enumerate(zip(key_cvs, dtypes)):
        if t.is_variable_width and mask.shape[0]:
            lens = kcv.offsets[1:] - kcv.offsets[:-1]
            maxes[i] = torch.where(mask & kcv.validity, lens, 0).max()
    got = dict(zip(maxes, fetch_ints(list(maxes.values()))))
    return tuple(nchunks_for_len(max(got.get(i, 1), 1))
                 if t.is_variable_width else 0
                 for i, t in enumerate(dtypes))


def string_nchunks(cv: CV, mask: torch.Tensor) -> int:
    """Chunk count covering the longest live, valid string: one host
    read."""
    return key_nchunks([cv], [dt.STRING], mask)[0]
