"""Device Parquet decode orchestration: the port's counterpart of the JAX
package's `io/parquet_device.py`, with the same eligibility rules and the
same per-chunk decisions.

Reference: GpuParquetScan.scala:3364 (Table.readParquet decodes column
chunks on the accelerator). The shape of it here:

  host:   read RAW column-chunk bytes into pinned staging buffers, parse
          page headers + RLE run tables (O(pages + runs), no value bytes
          touched), and, for snappy chunks, decompress pages IN PARALLEL
          on the multithreaded prefetch pool, off the compute thread
  device: ONE uint8 upload per chunk (a non-blocking copy from the
          pinned buffer, with a CUDA event after it); PLAIN lane
          assembly, hybrid run expansion (def levels, dictionary
          indices), dictionary gather, BYTE_ARRAY extents by pointer
          doubling, def-level -> validity + packed-value scatter, all as
          torch ops (`ops/parquet_decode.py`) on the session's device.

Eligibility (everything else falls back to the pyarrow host path, per
column, with a reason counter): UNCOMPRESSED or SNAPPY chunks; flat
INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY physical types; PLAIN or
RLE_DICTIONARY/PLAIN_DICTIONARY data pages; v1 (RLE def levels) and v2
(uncompressed-levels layout) data pages. `decode_chunk_device` returns
None for the page shapes it does not take (a malformed page section, a
chunk that mixes PLAIN and dictionary pages, several index bit widths,
a string blowup); a torch or CUDA error raises.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import parquet_decode as pd
from . import parquet_thrift as pt

__all__ = ["chunk_device_plan", "decode_chunk_device",
           "eligible_chunks", "fallback_reasons", "DeviceChunk"]

_PHYS_WIDTH = {"INT32": 4, "INT64": 8, "FLOAT": 4, "DOUBLE": 8}
_PHYS_NP = {"INT32": "int32", "INT64": "int64",
            "FLOAT": "float32", "DOUBLE": "float64"}
_OK_PHYS = set(_PHYS_WIDTH) | {"BYTE_ARRAY"}
_OK_CODECS = {"UNCOMPRESSED", "SNAPPY"}

_OK_ENCODINGS = {"PLAIN", "RLE", "PLAIN_DICTIONARY", "RLE_DICTIONARY",
                 "BIT_PACKED"}

# dictionary pages past this entry count skip the host extent walk
_MAX_DICT_VALUES = 1 << 20
# string output buffers past this bound fall back (pathological blowup)
_MAX_STRING_BYTES = 1 << 30


class DeviceChunk:
    """Host-parsed metadata for one device-decodable column chunk."""

    def __init__(self, name: str, physical: str, nullable: bool,
                 raw, pages: List[pt.PageInfo], num_values: int,
                 staging=None, dev_pages=None):
        self.name = name
        self.physical = physical
        self.nullable = nullable
        self.raw = raw                # bytes | memoryview (live prefix)
        self.pages = pages
        self.num_values = num_values
        # staging-pool leases backing `raw`; released via close()
        self.staging = staging or []
        # device-snappy work: (slot_off, comp np.uint8, el_dst, el_lit,
        # el_src, n_el, out_len) per page decompressed ON device
        self.dev_pages = dev_pages or []
        self.uploaded = None          # device uint8 chunk (set by decode)
        self.upload_done = None       # CUDA event after the H2D copy

    def close(self, sync: bool = False):
        """Return staging buffers to the pool. With sync=True, waits for
        the upload first: the H2D copy may still be reading the pinned
        buffer (the prefetch worker pays this wait, never the compute
        thread)."""
        if sync and self.upload_done is not None:
            self.upload_done.synchronize()
        for b in self.staging:
            b.release()
        self.staging = []


def _classify(col, name: str) -> Optional[Tuple[str, str]]:
    """(category, detail) why this chunk cannot device-decode, or None
    when it is eligible. Categories are the fallback-counter keys:
    codec / type / encoding / nested."""
    if "." in name:
        return ("nested", "nested column (repetition levels)")
    if col.compression not in _OK_CODECS:
        return ("codec", f"codec {col.compression}")
    if col.physical_type not in _OK_PHYS:
        return ("type", f"physical type {col.physical_type}")
    bad = set(col.encodings) - _OK_ENCODINGS
    if bad:
        return ("encoding", f"encoding {'/'.join(sorted(bad))}")
    return None


def _column_index(pf, rg: int) -> Dict[str, int]:
    md = pf.metadata.row_group(rg)
    return {md.column(ci).path_in_schema: ci
            for ci in range(pf.metadata.num_columns)}


def eligible_chunks(pf, rg: int, columns: List[str]) -> Dict[str, int]:
    """Map column name -> column index for chunks the device path can
    decode in row group `rg`."""
    names = _column_index(pf, rg)
    md = pf.metadata.row_group(rg)
    return {name: names[name] for name in columns
            if name in names
            and _classify(md.column(names[name]), name) is None}


def fallback_reasons(pf, rg: int,
                     columns: List[str]) -> Dict[str, Tuple[str, str]]:
    """Per-column (category, detail) for the columns of `columns` that
    CANNOT device-decode in row group `rg` (fed to the scan's
    deviceDecodeFallback.* counters)."""
    names = _column_index(pf, rg)
    md = pf.metadata.row_group(rg)
    out = {}
    for name in columns:
        if name in names:
            got = _classify(md.column(names[name]), name)
            if got is not None:
                out[name] = got
    return out


# ----------------------------------------------------------------------
# snappy: host tag parse (device op input) + pool decompression
# ----------------------------------------------------------------------
def _parse_snappy_elements(buf, start: int, end: int):
    """Walk one snappy-compressed span's tag stream into an element
    table for ops/parquet_decode.snappy_expand: O(elements) host work,
    literal bytes untouched. Returns (out_len, dst[], is_lit[], src[])
    where src is a buffer offset for literals and a back-offset for
    copies. Raises ThriftError on a malformed stream."""
    p = start
    # preamble: varint uncompressed length
    out_len = 0
    shift = 0
    while True:
        if p >= end:
            raise pt.ThriftError("snappy preamble past end")
        b = buf[p]
        p += 1
        out_len |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 35:
            raise pt.ThriftError("snappy preamble varint too long")
    dst_l: List[int] = []
    lit_l: List[int] = []
    src_l: List[int] = []
    dst = 0
    while dst < out_len:
        if p >= end:
            raise pt.ThriftError("snappy tag past end")
        tag = buf[p]
        t = tag & 3
        if t == 0:                          # literal
            ln = (tag >> 2) + 1
            p += 1
            if ln > 60:
                nb = ln - 60
                if p + nb > end:
                    raise pt.ThriftError("snappy literal len past end")
                ln = 0
                for j in range(nb):
                    ln |= buf[p + j] << (8 * j)
                ln += 1
                p += nb
            if p + ln > end:
                raise pt.ThriftError("snappy literal bytes past end")
            dst_l.append(dst)
            lit_l.append(1)
            src_l.append(p - start)    # relative to the compressed span
            p += ln
        else:                               # copy
            if t == 1:
                if p + 2 > end:
                    raise pt.ThriftError("snappy copy1 past end")
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | buf[p + 1]
                p += 2
            elif t == 2:
                if p + 3 > end:
                    raise pt.ThriftError("snappy copy2 past end")
                ln = (tag >> 2) + 1
                off = buf[p + 1] | (buf[p + 2] << 8)
                p += 3
            else:
                if p + 5 > end:
                    raise pt.ThriftError("snappy copy4 past end")
                ln = (tag >> 2) + 1
                off = (buf[p + 1] | (buf[p + 2] << 8)
                       | (buf[p + 3] << 16) | (buf[p + 4] << 24))
                p += 5
            if off <= 0 or off > dst:
                raise pt.ThriftError("snappy copy offset out of range")
            dst_l.append(dst)
            lit_l.append(0)
            src_l.append(off)
            ln = min(ln, out_len - dst)
        dst += ln
    return out_len, dst_l, lit_l, src_l


def _snappy_codec():
    """pyarrow's snappy codec: it releases the GIL, so pages of a chunk
    really decompress in parallel on the prefetch pool."""
    import pyarrow as pa
    return pa.Codec("snappy")


def _decompress_page(codec, src, out, out_off: int, expect: int):
    """Decompress one page payload into `out[out_off:out_off+expect]`."""
    buf = codec.decompress(src, expect)
    got = np.frombuffer(buf, np.uint8, len(buf))
    if len(got) != expect:
        raise pt.ThriftError(
            f"snappy page decompressed to {len(got)}, expected {expect}")
    out[out_off:out_off + expect] = got


def chunk_device_plan(pf, path: str, rg: int, ci: int,
                      name: str, nullable: bool, pool=None,
                      decomp_pool=None, device_snappy: bool = False,
                      metrics=None) -> Optional[DeviceChunk]:
    """Read raw bytes + parse page metadata for one column chunk.
    Snappy chunks come back REASSEMBLED: page payloads decompressed
    (in parallel on `decomp_pool`, or host-inline) into one contiguous
    staging buffer whose PageInfo offsets mirror the uncompressed
    layout, so the device decode is codec-blind. With `device_snappy`,
    qualifying pages instead carry a host-parsed element table and
    decompress on the device. None: the chunk's pages defeat the path
    (a short read, a malformed header, a page encoding or level layout
    it does not take, a page that does not decompress)."""
    import pyarrow as pa

    col = pf.metadata.row_group(rg).column(ci)
    start = col.data_page_offset
    if col.has_dictionary_page and col.dictionary_page_offset is not None:
        start = min(start, col.dictionary_page_offset)
    size = col.total_compressed_size
    staging = []

    def give_up():
        for b in staging:
            b.release()
        return None

    if pool is not None:
        lease = pool.acquire(size)
        staging.append(lease)
        with open(path, "rb") as f:
            f.seek(start)
            if f.readinto(lease.view()) != size:
                return give_up()
        raw = memoryview(lease.array)[:size]
    else:
        with open(path, "rb") as f:
            f.seek(start)
            raw = f.read(size)
    try:
        pages = pt.parse_page_headers(raw, col.num_values)
    except pt.ThriftError:
        return give_up()
    for p in pages:
        ok = True
        if p.page_type == pt.DATA_PAGE:
            if p.encoding not in (pt.PLAIN, pt.PLAIN_DICTIONARY,
                                  pt.RLE_DICTIONARY):
                ok = False
            if nullable and p.def_level_encoding != pt.RLE:
                ok = False
        elif p.page_type == pt.DATA_PAGE_V2:
            if p.encoding not in (pt.PLAIN, pt.PLAIN_DICTIONARY,
                                  pt.RLE_DICTIONARY):
                ok = False
            if p.rep_levels_byte_length > 0:
                ok = False                 # flat columns only
        if not ok:
            return give_up()

    dev_pages = []
    if col.compression == "SNAPPY":
        t0 = time.perf_counter()
        total_out = sum(max(p.uncompressed_size, 0) for p in pages)
        if pool is not None:
            out_lease = pool.acquire(total_out)
            staging.append(out_lease)
            out = out_lease.array
        else:
            out = np.zeros(max(total_out, 1), np.uint8)
        new_pages = []
        tasks = []                    # (src span, out_off, expect)
        dst = 0
        for p in pages:
            usize = max(p.uncompressed_size, 0)
            new_pages.append(replace(p, data_offset=dst,
                                     compressed_size=usize))
            off, end = p.data_offset, p.data_offset + p.compressed_size
            if p.page_type == pt.DATA_PAGE_V2:
                # v2 keeps levels UNCOMPRESSED ahead of the data section
                lvl = max(p.rep_levels_byte_length, 0) \
                    + max(p.def_levels_byte_length, 0)
                lvl = min(lvl, min(p.compressed_size, usize))
                out[dst:dst + lvl] = np.frombuffer(
                    raw[off:off + lvl], np.uint8)
                if p.data_compressed:
                    tasks.append((raw[off + lvl:end], dst + lvl,
                                  usize - lvl))
                else:
                    out[dst + lvl:dst + usize] = np.frombuffer(
                        raw[off + lvl:end], np.uint8)
            elif (device_snappy and p.page_type == pt.DATA_PAGE
                  and p.encoding == pt.PLAIN and not nullable):
                try:
                    out_len, dl, ll, sl = _parse_snappy_elements(
                        raw, off, end)
                except pt.ThriftError:
                    tasks.append((raw[off:end], dst, usize))
                else:
                    if out_len != usize:
                        tasks.append((raw[off:end], dst, usize))
                    else:
                        comp = np.frombuffer(raw[off:end], np.uint8)
                        dev_pages.append(
                            (dst, comp, np.asarray(dl, np.int64),
                             np.asarray(ll, np.int64),
                             np.asarray(sl, np.int64), len(dl), out_len))
            else:
                tasks.append((raw[off:end], dst, usize))
            dst += usize
        codec = _snappy_codec()
        try:
            if decomp_pool is not None and len(tasks) > 1:
                # per-page, parallel across pages
                list(decomp_pool.map(
                    lambda t: _decompress_page(codec, t[0], out, t[1],
                                               t[2]), tasks))
            else:
                for src, ooff, expect in tasks:
                    _decompress_page(codec, src, out, ooff, expect)
        except (pt.ThriftError, pa.ArrowException, OSError):
            return give_up()
        if metrics is not None:
            metrics.add("decompressBusySecs", time.perf_counter() - t0)
            metrics.add("decompressedBytes", total_out)
        raw = memoryview(out)[:total_out]
        pages = new_pages
    return DeviceChunk(name, col.physical_type, nullable, raw, pages,
                       col.num_values, staging=staging,
                       dev_pages=dev_pages)


def _parse_sections(c: DeviceChunk):
    """Split every data page into (def-level runs, value section).
    Returns (def_runs, plain_pages, dict_pages, dict_page) where
    def_runs: list[pt.RleRun] with ABSOLUTE out_start,
    plain_pages: [(payload_off, first_row)],
    dict_pages:  [(bit_width, runs, first_row, num_values)],
    dict_page:   PageInfo | None. Handles v1 (length-prefixed RLE def
    levels) and v2 (separate uncompressed level sections) layouts."""
    def_runs: List[pt.RleRun] = []
    plain_pages: List[Tuple[int, int]] = []
    dict_idx_pages: List[Tuple[int, List[pt.RleRun], int, int]] = []
    dict_page = None
    row = 0
    for p in c.pages:
        if p.page_type == pt.DICTIONARY_PAGE:
            dict_page = p
            continue
        if p.page_type not in (pt.DATA_PAGE, pt.DATA_PAGE_V2):
            continue
        off = p.data_offset
        end = p.data_offset + p.compressed_size
        if p.page_type == pt.DATA_PAGE_V2:
            lvl = max(p.rep_levels_byte_length, 0) \
                + max(p.def_levels_byte_length, 0)
            if c.nullable:
                if p.def_levels_byte_length > 0:
                    runs = pt.parse_hybrid_runs(
                        c.raw, off + max(p.rep_levels_byte_length, 0),
                        off + lvl, p.num_values, 1)
                    for r in runs:
                        def_runs.append(pt.RleRun(
                            row + r.out_start, r.count, r.is_packed,
                            r.value, r.byte_offset))
                else:
                    # no level section: every value present
                    def_runs.append(pt.RleRun(row, p.num_values, False,
                                              value=1))
            off += lvl
        elif c.nullable:
            # v1: [int32 LE length][RLE/bit-packed hybrid, bit width 1]
            ln = int.from_bytes(bytes(c.raw[off:off + 4]), "little")
            runs = pt.parse_hybrid_runs(c.raw, off + 4, off + 4 + ln,
                                        p.num_values, 1)
            for r in runs:
                def_runs.append(pt.RleRun(
                    row + r.out_start, r.count, r.is_packed, r.value,
                    r.byte_offset))
            off += 4 + ln
        if p.encoding == pt.PLAIN:
            plain_pages.append((off, row))
        else:                                  # dictionary indices
            bw = c.raw[off] if off < len(c.raw) else 255
            if bw > 32:
                # spec max is 32; a corrupt byte here must route to the
                # host fallback, not overflow the run tables
                raise pt.ThriftError(f"dict index bit width {bw}")
            runs = pt.parse_hybrid_runs(c.raw, off + 1, end,
                                        p.num_values, bw)
            # index runs address the PACKED (non-null) value stream;
            # out_start is rebased on the device by per-page valid counts
            dict_idx_pages.append((bw, runs, row, p.num_values))
        row += p.num_values
    return def_runs, plain_pages, dict_idx_pages, dict_page


def _run_tables(runs: List[pt.RleRun], device):
    """The device run tables (out_start, count, is_packed, value,
    byte_offset) of `runs`, int64, in one copy."""
    from ..exec.batch import to_device
    t = np.asarray([(r.out_start, r.count, int(r.is_packed), r.value,
                     r.byte_offset) for r in runs], np.int64)
    return list(to_device([np.ascontiguousarray(t.reshape(-1, 5).T)],
                          device)[0])


def _chunk_device_bytes(c: DeviceChunk, device, metrics=None):
    """Upload the (reassembled) chunk bytes, the live prefix only, in one
    copy, and patch in the device-snappy pages. On CUDA the copy is
    non-blocking from the pinned staging buffer, and `upload_done`
    marks its end for close(sync=True); on the CPU the bytes are copied,
    so the pool may reuse its buffer at once."""
    from ..exec.batch import to_device
    n = len(c.raw)
    t0 = time.perf_counter()
    if c.staging:
        src = c.staging[-1].tensor[:n]
    else:
        src = torch.from_numpy(np.frombuffer(c.raw, np.uint8).copy())
    if device.type == "cuda":
        chunk_dev = src.to(device, non_blocking=True)
        c.upload_done = torch.cuda.Event()
        c.upload_done.record(torch.cuda.current_stream(device))
    else:
        chunk_dev = src.clone()
    if metrics is not None:
        metrics.add("uploadSecs", time.perf_counter() - t0)
        metrics.add("uploadedBytes", n)
    for (slot, comp, dl, ll, sl, n_el, out_len) in c.dev_pages:
        comp_d, dst, lit, srcs = to_device([comp, dl, ll, sl], device)
        kbits = max(1, (max(out_len, 1) - 1).bit_length())
        page = pd.snappy_expand(comp_d, dst, lit, srcs, n_el, out_len,
                                kbits, max(out_len, 1))
        chunk_dev[slot:slot + out_len] = page[:out_len]
    c.uploaded = chunk_dev
    return chunk_dev


def _first_values(valid, rows: np.ndarray, n: int, nullable: bool,
                  device):
    """Per page, the index of its first value in the PACKED stream (a
    PLAIN page stores non-null values only: the count of valid rows
    before it, on the device), and the packed stream's length."""
    from ..exec.batch import to_device
    pr = to_device([rows], device)[0]
    if not nullable:
        return pr, n
    vcnt = torch.cumsum(valid, 0)
    cap = valid.shape[0]
    first = torch.where(pr > 0, vcnt[(pr - 1).clamp(0, cap - 1)], 0)
    return first, vcnt[min(max(n - 1, 0), cap - 1)]


def _dict_indices(c: DeviceChunk, valid, dict_idx_pages, cap: int):
    """Expand the per-page RLE/bit-packed index runs into ONE packed
    index stream (int32 [cap]): run out_starts are page-relative to the
    packed stream, rebased by per-page valid counts on the device."""
    n = c.num_values
    bws = {bw for bw, _, _, _ in dict_idx_pages}
    if len(bws) != 1:
        return None                   # one bit width per chunk
    bw = bws.pop()
    allruns: List[pt.RleRun] = []
    run_page_row = []
    for _bw, runs, row, _nv in dict_idx_pages:
        allruns.extend(runs)
        run_page_row.extend([row] * len(runs))
    if not allruns:
        return None
    dev = valid.device
    rs, rc, rp, rv, rb = _run_tables(allruns, dev)
    base, _ = _first_values(valid, np.asarray(run_page_row, np.int64),
                            n, True, dev)
    return pd.expand_hybrid(c.uploaded, rs + base, rc, rp, rv, rb,
                            len(allruns), n, bw, cap)


def _walk_byte_array_extents(buf, off: int, end: int, n: int):
    """Host walk of a PLAIN BYTE_ARRAY section's [len][bytes] chain
    (dictionary pages only: n is small). Returns (starts, lens)
    int64 [n] or raises ThriftError."""
    starts = np.zeros(n, np.int64)
    lens = np.zeros(n, np.int64)
    p = off
    for i in range(n):
        if p + 4 > end:
            raise pt.ThriftError("byte-array extent walk past end")
        ln = int.from_bytes(bytes(buf[p:p + 4]), "little")
        if ln < 0 or p + 4 + ln > end:
            raise pt.ThriftError("byte-array length out of range")
        starts[i] = p + 4
        lens[i] = ln
        p += 4 + ln
    return starts, lens


def _decode_strings(c: DeviceChunk, valid, cap: int, plain_pages,
                    dict_idx_pages, dict_page):
    """BYTE_ARRAY decode: per-row extents (length extraction) ->
    exclusive prefix-sum offsets -> byte gather into the string layout.
    Returns (data uint8, validity, offsets int32 [cap + 1]) or None
    (fallback). The byte buffer is sized by a host bound (the pages'
    payload, or rows x the longest dictionary entry), not read back
    from the device; bytes past the last row are zero."""
    from ..exec.batch import to_device
    n = c.num_values
    dev = valid.device
    if plain_pages:
        payload_total = sum(
            p.compressed_size for p in c.pages
            if p.page_type in (pt.DATA_PAGE, pt.DATA_PAGE_V2))
        if payload_total > _MAX_STRING_BYTES:
            return None
        dcap = max(payload_total, 1)
        offs = np.asarray([off for off, _ in plain_pages], np.int64)
        rows = np.asarray([row for _, row in plain_pages], np.int64)
        maxv = max([1] + [p.num_values for p in c.pages
                          if p.page_type in (pt.DATA_PAGE,
                                             pt.DATA_PAGE_V2)])
        first_val, total_packed = _first_values(valid, rows, n,
                                                c.nullable, dev)
        kbits = max(1, (max(maxv - 1, 1)).bit_length())
        starts, lens = pd.byte_array_index(
            c.uploaded, to_device([offs], dev)[0], first_val,
            len(plain_pages), total_packed, kbits, cap)
        row_start, row_len = pd.rows_from_packed(starts, lens, valid, n,
                                                 cap)
    elif dict_idx_pages:
        if dict_page is None:
            return None
        ndict = dict_page.num_values
        if ndict > _MAX_DICT_VALUES:
            return None
        try:
            dstarts, dlens = _walk_byte_array_extents(
                c.raw, dict_page.data_offset,
                dict_page.data_offset + dict_page.compressed_size,
                ndict)
        except pt.ThriftError:
            return None
        max_len = int(dlens.max()) if ndict else 0
        bound = max(n, 1) * max(max_len, 1)
        if bound > _MAX_STRING_BYTES:
            return None
        idx = _dict_indices(c, valid, dict_idx_pages, cap)
        if idx is None:
            return None
        # one empty entry stands in for an empty dictionary
        ds, dl = to_device([np.append(dstarts, 0)[:max(ndict, 1)],
                            np.append(dlens, 0)[:max(ndict, 1)]], dev)
        row_start, row_len = pd.dict_rows(idx, ds, dl, valid, n, cap)
        dcap = bound
    else:
        return None
    data, offsets = pd.assemble_strings(c.uploaded, row_start, row_len,
                                        n, cap, dcap)
    new_valid = valid & (torch.arange(cap, device=dev) < n)
    return data, new_valid, offsets


def decode_chunk_device(c: DeviceChunk, cap: int, device,
                        metrics=None):
    """Decode one chunk into `cap` rows on `device`. Fixed-width chunks
    return (values, validity); BYTE_ARRAY chunks return (data bytes,
    validity, offsets). Returns None when a page shape defeats the path
    (the caller falls back to host decode); a torch or CUDA error
    raises."""
    from ..exec.batch import to_device
    try:
        def_runs, plain_pages, dict_idx_pages, dict_page = \
            _parse_sections(c)
    except pt.ThriftError:
        return None                   # malformed page section: fallback
    if plain_pages and dict_idx_pages:
        return None                   # mixed-encoding chunk: fallback
    device = torch.device(device)
    chunk_dev = _chunk_device_bytes(c, device, metrics)
    n = c.num_values

    # -- def levels -> validity ----------------------------------------
    if c.nullable and def_runs:
        rs, rc, rp, rv, rb = _run_tables(def_runs, device)
        def_levels = pd.expand_hybrid(chunk_dev, rs, rc, rp, rv, rb,
                                      len(def_runs), n, 1, cap)
        valid = def_levels == 1
    else:
        valid = torch.arange(cap, device=device) < n
        def_levels = valid.to(torch.int32)

    if c.physical == "BYTE_ARRAY":
        return _decode_strings(c, valid, cap, plain_pages,
                               dict_idx_pages, dict_page)

    width = _PHYS_WIDTH[c.physical]
    np_name = _PHYS_NP[c.physical]

    # -- packed value stream -------------------------------------------
    if plain_pages:
        offs = np.asarray([off for off, _ in plain_pages], np.int64)
        rows = np.asarray([row for _, row in plain_pages], np.int64)
        first_val, _ = _first_values(valid, rows, n, c.nullable, device)
        packed = pd.decode_plain_fixed(
            chunk_dev, to_device([offs], device)[0], first_val,
            len(plain_pages), n, width, cap)
    elif dict_idx_pages:
        if dict_page is None:
            return None
        ndict = dict_page.num_values
        dcap = max(ndict, 1)
        d_po, d_pr = to_device([np.asarray([dict_page.data_offset],
                                           np.int64),
                                np.zeros(1, np.int64)], device)
        dict_words = pd.decode_plain_fixed(chunk_dev, d_po, d_pr, 1,
                                           ndict, width, dcap)
        idx = _dict_indices(c, valid, dict_idx_pages, cap)
        if idx is None:
            return None
        packed = dict_words[idx.to(torch.int64).clamp(0, dcap - 1)]
    else:
        return None

    if c.nullable:
        words, valid = pd.apply_def_levels(def_levels, packed, 1, n, cap)
    else:
        words = torch.where(valid, packed, 0)
    return pd.words_to_device(words, np_name), valid
