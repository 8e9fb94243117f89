"""Device-side Parquet decode ops, as torch ops on tensors of one device.

The port's counterpart of the JAX package's `ops/parquet_decode.py`
(GpuParquetScan.scala:3364 Table.readParquet decodes column chunks on
the accelerator). The host reads RAW column-chunk bytes and parses only
page-header and run metadata (`io/parquet_thrift.py`, O(pages)), uploads
the bytes ONCE, and everything that touches values runs here: PLAIN
fixed-width assembly from byte lanes, RLE/bit-packed hybrid expansion
(def levels and dictionary indices) through the scatter + cummax
run-ownership map (`ops/gather.py` `row_of_unit`), dictionary gather,
def-level -> validity + packed-value scatter, string extents by pointer
doubling, and the byte gather into the string layout.

Raw value words are int64 (the JAX package's uint64 words, bit for
bit): CUDA torch lacks most uint64 ops, so the words are bitcast to
their column type with `.view` (`words_to_device`). Every op takes its
output length (`cap`) from the caller; the JAX package's power-of-two
buckets existed for XLA's static shapes, and the scan passes the row
group's true row count instead.
"""
from __future__ import annotations

import numpy as np
import torch

from .gather import gather_bytes, row_of_unit

__all__ = ["decode_plain_fixed", "expand_hybrid", "apply_def_levels",
           "bucket_len", "byte_array_index", "rows_from_packed",
           "dict_rows", "assemble_strings", "snappy_expand",
           "words_to_np_values", "words_to_device"]


def bucket_len(n: int, floor: int = 8) -> int:
    """Pow2 bucket (the JAX package's metadata-table lengths)."""
    c = floor
    while c < n:
        c <<= 1
    return c


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _bytes_at(chunk: torch.Tensor, pos: torch.Tensor,
              width: int) -> torch.Tensor:
    """uint8 [len(pos), width]: chunk[pos + b] for b < width, positions
    clipped into the chunk (an out-of-range position yields bytes the
    caller masks)."""
    idx = pos.to(torch.int64)[:, None] + _arange(width, chunk.device)
    return chunk[idx.clamp_(0, chunk.shape[0] - 1)]


def decode_plain_fixed(chunk, page_payload_off, page_first_val, n_pages,
                       total, width: int, cap: int) -> torch.Tensor:
    """Assemble little-endian fixed-width values from PLAIN page
    payloads. chunk: uint8; page_payload_off / page_first_val: one row
    per page (rows past n_pages, if any, carry the sentinel `total`).

    Returns int64 [cap] raw value words (zero-extended from `width`
    bytes; zero at and past `total`)."""
    dev = chunk.device
    i = _arange(cap, dev)
    pg = row_of_unit(page_first_val, page_payload_off.shape[0], cap)
    pg = pg.clamp(max=n_pages - 1)
    base = page_payload_off[pg].to(torch.int64) \
        + (i - page_first_val[pg].to(torch.int64)) * width
    lanes = _bytes_at(chunk, base, width)
    if width < 8:
        lanes = torch.cat([lanes, torch.zeros(cap, 8 - width,
                                              dtype=torch.uint8,
                                              device=dev)], 1)
    word = lanes.contiguous().view(torch.int64).reshape(cap)
    return torch.where(i < total, word, 0)


def expand_hybrid(chunk, run_start, run_count, run_packed, run_value,
                  run_byteoff, n_runs, total, bit_width: int,
                  cap: int) -> torch.Tensor:
    """Expand an RLE/bit-packed hybrid section to one value per output
    index. Run tables have one row per run (padding rows, if any, must
    carry out_start == total). Returns int32 [cap].

    Value j of a bit-packed run occupies bits [j*bw, (j+1)*bw) of its
    payload. The word holding them is built in int64 from at most 5
    bytes (bw <= 32 plus a shift <= 7 needs 39 bits), so it is never
    negative and an arithmetic shift is a logical one."""
    if not 0 <= bit_width <= 32:
        raise ValueError(f"hybrid bit width {bit_width} outside 0..32")
    dev = chunk.device
    i = _arange(cap, dev)
    rid = row_of_unit(run_start, run_start.shape[0], cap)
    rid = rid.clamp(max=max(n_runs - 1, 0))
    within = i - run_start[rid].to(torch.int64)
    bitpos = run_byteoff[rid].to(torch.int64) * 8 + within * bit_width
    shift = bitpos & 7
    nbytes = min((bit_width + 7 + 7) // 8, 8)
    lanes = _bytes_at(chunk, bitpos >> 3, nbytes).to(torch.int64)
    word = (lanes << (8 * _arange(nbytes, dev))).sum(1)
    packed = ((word >> shift) & ((1 << bit_width) - 1)).to(torch.int32)
    rle = run_value[rid].to(torch.int32)
    out = torch.where(run_packed[rid].to(torch.bool), packed, rle)
    return torch.where(i < total, out, 0)


def apply_def_levels(def_levels, packed_words, max_def, total,
                     cap: int):
    """def level == max_def -> valid; packed (non-null-only) values
    scatter to their row positions. Returns (int64 [cap] words,
    bool [cap] validity)."""
    i = _arange(cap, def_levels.device)
    valid = (def_levels == max_def) & (i < total)
    vidx = (torch.cumsum(valid, 0) - 1).clamp(
        0, packed_words.shape[0] - 1)
    return torch.where(valid, packed_words[vidx], 0), valid


def _le32_at(chunk, pos) -> torch.Tensor:
    """Little-endian int32 read at arbitrary byte positions
    (out-of-range positions clip and yield garbage the caller masks)."""
    return _bytes_at(chunk, pos, 4).view(torch.int32).reshape(-1)


def _le32_every(chunk) -> torch.Tensor:
    """_le32_at at every byte position of the chunk, without an index
    tensor: four-byte windows of the chunk, its last byte repeating past
    the end (as clipped positions read)."""
    nb = chunk.shape[0]
    padded = torch.cat([chunk, chunk[nb - 1:nb].expand(3)])
    return padded.unfold(0, 4, 1).contiguous().view(torch.int32) \
        .reshape(nb)


def byte_array_index(chunk, page_payload_off, page_first_val, n_pages,
                     total, kbits: int, cap: int):
    """Locate every PACKED value of a PLAIN BYTE_ARRAY section: returns
    (byte_start int32 [cap], byte_len int32 [cap]) into `chunk`.

    The [uint32 len][bytes] stream is a linked list (each length tells
    where the next one starts), so value positions are found by pointer
    doubling: a jump table next[b] = b + 4 + le32(b) over every byte
    position, squared kbits times; value i applies the 2^k jump for
    each set bit of its within-page ordinal. `kbits` must cover the max
    per-page value count; page_first_val rows past n_pages, if any,
    must carry the sentinel `total`."""
    dev = chunk.device
    i = _arange(cap, dev)
    pg = row_of_unit(page_first_val, page_payload_off.shape[0], cap)
    pg = pg.clamp(max=max(n_pages - 1, 0))
    k = (i - page_first_val[pg].to(torch.int64)).clamp(min=0)
    pos = page_payload_off[pg].to(torch.int64)
    nb = chunk.shape[0]
    nxt = (_arange(nb, dev) + 4 + _le32_every(chunk)).clamp(0, nb - 1)
    for bit in range(kbits):
        take = ((k >> bit) & 1).to(torch.bool)
        pos = torch.where(take, nxt[pos.clamp(0, nb - 1)], pos)
        if bit != kbits - 1:
            nxt = nxt[nxt]
    live = i < total
    lens = _le32_at(chunk, pos).clamp(0, nb)
    return (torch.where(live, pos + 4, 0).to(torch.int32),
            torch.where(live, lens, 0).to(torch.int32))


def _rank(valid, total, cap: int):
    """(the live rows, the packed-stream rank of each row)."""
    v = valid & (_arange(cap, valid.device) < total)
    return v, torch.cumsum(v, 0) - 1


def rows_from_packed(starts, lens, valid, total, cap: int):
    """Map packed-stream (start, len) pairs to the ROW domain: nulls get
    length 0, non-null row r takes packed value rank(r)."""
    v, vidx = _rank(valid, total, cap)
    vidx = vidx.clamp(0, starts.shape[0] - 1)
    return starts[vidx], torch.where(v, lens[vidx], 0)


def dict_rows(idx, dstart, dlen, valid, total, cap: int):
    """Per-row (start, len) for dictionary-encoded strings: packed
    index stream -> row domain via validity rank, then dictionary entry
    extents."""
    v, vidx = _rank(valid, total, cap)
    rid = idx[vidx.clamp(0, idx.shape[0] - 1)].to(torch.int64) \
        .clamp(0, dstart.shape[0] - 1)
    return dstart[rid], torch.where(v, dlen[rid], 0)


def assemble_strings(chunk, row_start, row_len, total, cap: int,
                     dcap: int):
    """Gather per-row byte ranges of `chunk` into the string layout:
    (data uint8 [dcap], offsets int32 [cap + 1]); bytes past the last
    row are zero. Rows at and past `total` are empty."""
    live = _arange(cap, chunk.device) < total
    row_len = torch.where(live, row_len.clamp(min=0), 0).to(torch.int32)
    off, data = gather_bytes(chunk, row_start, row_len, dcap)
    return data, off


def snappy_expand(comp, el_dst, el_lit, el_src, n_el, out_len,
                  kbits: int, cap: int) -> torch.Tensor:
    """Device snappy decompression of ONE page from its host-parsed
    element table (conf `sql.parquet.deviceSnappy`).

    Each output byte first maps to its owning element (scatter +
    cummax). Literal bytes resolve directly to a compressed-buffer
    position (encoded as -(pos+1)); copy bytes point at an EARLIER
    output byte (i - back_offset, overlapping copies included). kbits
    pointer-doubling rounds (src = src[src]) then resolve every byte to
    a literal source, and one gather materializes the page. el_dst rows
    past n_el, if any, must carry the sentinel out_len."""
    dev = comp.device
    i = _arange(cap, dev)
    eid = row_of_unit(el_dst, el_dst.shape[0], cap)
    eid = eid.clamp(max=max(n_el - 1, 0))
    within = i - el_dst[eid].to(torch.int64)
    lit = el_lit[eid].to(torch.bool)
    s = el_src[eid].to(torch.int64)
    src = torch.where(lit, -(s + within) - 1, i - s)
    for _ in range(kbits):
        src = torch.where(src >= 0, src[src.clamp(0, cap - 1)], src)
    out = comp[(-src - 1).clamp(0, comp.shape[0] - 1)]
    return torch.where(i < out_len, out, 0).to(torch.uint8)


def words_to_np_values(words: np.ndarray, physical: str):
    """Bitcast raw LE words to numpy values (host-side helper for the
    parity tests; the scan bitcasts on the device)."""
    if physical == "INT32":
        return words.astype(np.uint32).view(np.int32)
    if physical == "INT64":
        return words.view(np.int64)
    if physical == "FLOAT":
        return words.astype(np.uint32).view(np.float32)
    if physical == "DOUBLE":
        return words.view(np.float64)
    raise ValueError(physical)


def words_to_device(words: torch.Tensor, np_name: str) -> torch.Tensor:
    """Bitcast int64 raw words to the column's dtype, on their device:
    a 4-byte value is the low half of its word (little-endian)."""
    words = words.contiguous()
    if np_name == "int64":
        return words
    if np_name == "float64":
        return words.view(torch.float64)
    if np_name == "bool":
        return words != 0
    low = words.view(torch.int32)[0::2].contiguous()
    if np_name == "int32":
        return low
    if np_name == "float32":
        return low.view(torch.float32)
    raise ValueError(np_name)
