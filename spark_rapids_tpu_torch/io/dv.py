"""Delta deletion vectors: 64-bit roaring bitmap codec + DV files (the
JAX package's `io/dv.py`, copied: the payloads are byte-equal).

Reference: the plugin's Delta deletion-vector read support (delta-33x
GpuDeltaParquetFileFormat applying DVs as row filters). Format follows
the Delta spec: a DV file holds a 1-byte version then, at each DV's
offset, [4-byte BE length][bitmap payload][4-byte BE CRC32]. The
payload is a little-endian magic (1681511377) followed by a
RoaringBitmapArray: i64 bucket count, then per bucket a u32 high key
and a standard 32-bit roaring bitmap in the portable serialization
(no-run cookie 12347 written here; array, bitmap AND run containers
readable)."""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, List

__all__ = ["serialize_dv", "deserialize_dv", "write_dv_file",
           "read_dv_file", "load_dv_positions", "apply_dv_to_table"]

_MAGIC = 1681511377
_NO_RUN_COOKIE = 12347
_RUN_COOKIE = 12346


def _ser_rb32(values: List[int]) -> bytes:
    """Sorted u32 values -> portable 32-bit roaring bytes."""
    containers = {}
    for v in values:
        containers.setdefault(v >> 16, []).append(v & 0xFFFF)
    keys = sorted(containers)
    out = bytearray()
    out += struct.pack("<II", _NO_RUN_COOKIE, len(keys))
    for k in keys:
        out += struct.pack("<HH", k, len(containers[k]) - 1)
    # offsets section (present for the no-run cookie)
    off = 8 + 4 * len(keys) + 4 * len(keys)
    offs = []
    for k in keys:
        offs.append(off)
        card = len(containers[k])
        off += (2 * card if card <= 4096 else 8192)
    for o in offs:
        out += struct.pack("<I", o)
    for k in keys:
        vals = sorted(containers[k])
        if len(vals) <= 4096:
            out += struct.pack(f"<{len(vals)}H", *vals)
        else:
            bits = bytearray(8192)
            for v in vals:
                bits[v >> 3] |= 1 << (v & 7)
            out += bits
    return bytes(out)


def _de_rb32(buf: bytes, base: int, out: List[int]):
    cookie = struct.unpack_from("<I", buf, base)[0]
    pos = base
    if (cookie & 0xFFFF) == _RUN_COOKIE:
        n = (cookie >> 16) + 1
        pos += 4
        runbits = buf[pos:pos + (n + 7) // 8]
        pos += (n + 7) // 8
        has_run = [bool(runbits[i >> 3] & (1 << (i & 7)))
                   for i in range(n)]
        has_offsets = False
    elif cookie == _NO_RUN_COOKIE:
        n = struct.unpack_from("<I", buf, base + 4)[0]
        pos += 8
        has_run = [False] * n
        has_offsets = True
    else:
        raise ValueError(f"bad roaring cookie {cookie}")
    heads = []
    for i in range(n):
        k, cm1 = struct.unpack_from("<HH", buf, pos)
        pos += 4
        heads.append((k, cm1 + 1))
    if has_offsets or n >= 4:
        pos += 4 * n    # offsets section (run cookie: present at n>=4)
    for i, (k, card) in enumerate(heads):
        hi = k << 16
        if has_run[i]:
            nruns = struct.unpack_from("<H", buf, pos)[0]
            pos += 2
            for _ in range(nruns):
                start, length = struct.unpack_from("<HH", buf, pos)
                pos += 4
                out.extend(hi | v for v in range(start,
                                                 start + length + 1))
        elif card <= 4096:
            vals = struct.unpack_from(f"<{card}H", buf, pos)
            pos += 2 * card
            out.extend(hi | v for v in vals)
        else:
            bits = buf[pos:pos + 8192]
            pos += 8192
            for byte_i, b in enumerate(bits):
                while b:
                    low = b & (-b)
                    out.append(hi | (byte_i << 3 | low.bit_length() - 1))
                    b ^= low
    return pos


def serialize_dv(positions: Iterable[int]) -> bytes:
    """Sorted 64-bit row positions -> magic + RoaringBitmapArray."""
    buckets = {}
    for p in sorted(set(positions)):
        buckets.setdefault(p >> 32, []).append(p & 0xFFFFFFFF)
    out = bytearray(struct.pack("<I", _MAGIC))
    out += struct.pack("<q", len(buckets))
    for hk in sorted(buckets):
        out += struct.pack("<I", hk)
        out += _ser_rb32(buckets[hk])
    return bytes(out)


def deserialize_dv(buf: bytes) -> List[int]:
    magic = struct.unpack_from("<I", buf, 0)[0]
    if magic != _MAGIC:
        raise ValueError(f"bad DV magic {magic}")
    nb = struct.unpack_from("<q", buf, 4)[0]
    pos = 12
    out: List[int] = []
    for _ in range(nb):
        hk = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        sub: List[int] = []
        pos = _de_rb32(buf, pos, sub)
        out.extend((hk << 32) | v for v in sub)
    return out


def write_dv_file(path: str, positions: Iterable[int]) -> dict:
    """One-DV file: version byte + [len BE][payload][crc BE]. Returns
    the descriptor fields (offset, sizeInBytes, cardinality)."""
    plist = sorted(set(positions))         # materialize ONCE (iterables)
    payload = serialize_dv(plist)
    with open(path, "wb") as f:
        f.write(b"\x01")
        f.write(struct.pack(">i", len(payload)))
        f.write(payload)
        f.write(struct.pack(">I", zlib.crc32(payload)))
    return {"offset": 1, "sizeInBytes": len(payload),
            "cardinality": len(plist)}


def read_dv_file(path: str, offset: int = 1,
                 size: int = None) -> List[int]:
    with open(path, "rb") as f:
        raw = f.read()
    n = struct.unpack_from(">i", raw, offset)[0]
    if size is not None and n != size:
        raise IOError(
            f"DV length mismatch in {path}: stored {n}, "
            f"descriptor sizeInBytes {size}")
    payload = raw[offset + 4:offset + 4 + n]
    crc = struct.unpack_from(">I", raw, offset + 4 + n)[0]
    if crc != zlib.crc32(payload):
        raise IOError(f"DV checksum mismatch in {path}")
    return deserialize_dv(payload)


def load_dv_positions(table_root: str, descriptor: dict) -> List[int]:
    """Dead row positions from an add action's deletionVector
    descriptor. storageType 'p' carries an absolute path per the Delta
    protocol; tolerate legacy table-relative names too (tables written
    by earlier versions of this engine)."""
    p = descriptor["pathOrInlineDv"]
    if not os.path.isabs(p):
        p = os.path.join(table_root, p)
    return read_dv_file(
        p, descriptor.get("offset", 1), descriptor.get("sizeInBytes"))


def apply_dv_to_table(t, dead) -> "object":
    """Drop dead row positions from an arrow table — vectorized mask,
    no per-row Python loop."""
    import numpy as np
    import pyarrow as pa
    if not dead:
        return t
    mask = np.ones(t.num_rows, bool)
    idx = np.fromiter((d for d in dead if d < t.num_rows), np.int64)
    mask[idx] = False
    return t.filter(pa.array(mask))
