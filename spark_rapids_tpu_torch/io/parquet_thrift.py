"""Minimal Thrift compact-protocol reader for Parquet page headers.

The device Parquet decode path (GpuParquetScan.scala:3364 decodes
column chunks on the accelerator via Table.readParquet) needs page
boundaries + encodings from the raw column-chunk bytes. Page headers
are Thrift compact structs; this parses JUST the fields the decoder
needs (~O(pages) host work, no value bytes touched). It is the port's
own copy of the JAX package's parser.

Format notes (parquet.thrift):
  PageHeader: 1:type 2:uncompressed_page_size 3:compressed_page_size
              4:crc 5:data_page_header 7:dictionary_page_header
              8:data_page_header_v2
  DataPageHeader: 1:num_values 2:encoding 3:definition_level_encoding
                  4:repetition_level_encoding 5:statistics
  DictionaryPageHeader: 1:num_values 2:encoding 3:is_sorted
  DataPageHeaderV2: 1:num_values 2:num_nulls 3:num_rows 4:encoding
                    5:definition_levels_byte_length
                    6:repetition_levels_byte_length 7:is_compressed
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

# Parquet encodings (format/Encoding.thrift)
PLAIN = 0
PLAIN_DICTIONARY = 2
RLE = 3
BIT_PACKED = 4
RLE_DICTIONARY = 8

# Page types
DATA_PAGE = 0
INDEX_PAGE = 1
DICTIONARY_PAGE = 2
DATA_PAGE_V2 = 3


class ThriftError(ValueError):
    pass


def _zigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


class _CompactReader:
    """Enough of the Thrift compact protocol to walk Parquet headers."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise ThriftError("varint past end")
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ThriftError("varint too long")

    def _skip(self, ftype: int):
        if ftype in (1, 2):            # BOOL true/false (value in type)
            return
        if ftype == 3:                 # BYTE
            self.pos += 1
        elif ftype in (4, 5, 6):       # I16/I32/I64 zigzag varint
            self.varint()
        elif ftype == 7:               # DOUBLE
            self.pos += 8
        elif ftype == 8:               # BINARY/STRING
            n = self.varint()
            self.pos += n
        elif ftype == 9:               # LIST
            sz = self.buf[self.pos]
            self.pos += 1
            n = sz >> 4
            et = sz & 0x0F
            if n == 15:
                n = self.varint()
            for _ in range(n):
                self._skip(et)
        elif ftype == 12:              # STRUCT
            self.skip_struct()
        else:
            raise ThriftError(f"unsupported thrift type {ftype}")

    def skip_struct(self):
        for _fid, ftype in self.fields():
            self._skip(ftype)

    def fields(self):
        """Yield (field_id, field_type) until STOP; caller must consume
        the value (read or _skip) before advancing."""
        fid = 0
        while True:
            if self.pos >= len(self.buf):
                raise ThriftError("struct past end")
            b = self.buf[self.pos]
            self.pos += 1
            if b == 0:
                return
            delta = b >> 4
            ftype = b & 0x0F
            if delta == 0:
                fid = _zigzag(self.varint())
            else:
                fid += delta
            yield fid, ftype

    def i32(self) -> int:
        return _zigzag(self.varint())


@dataclass
class PageInfo:
    page_type: int
    uncompressed_size: int = 0
    compressed_size: int = 0
    num_values: int = 0
    encoding: int = PLAIN
    def_level_encoding: int = RLE
    # v2 only
    num_nulls: int = 0
    def_levels_byte_length: int = -1   # -1: v1 (length-prefixed in data)
    rep_levels_byte_length: int = 0    # v2; must be 0 for flat columns
    data_compressed: bool = True       # v2 is_compressed flag
    data_offset: int = 0               # payload start within chunk bytes
    is_v2: bool = False


def parse_page_headers(chunk: bytes, total_values: int) -> List[PageInfo]:
    """Walk every page header in a raw column-chunk byte span."""
    out: List[PageInfo] = []
    pos = 0
    seen = 0
    while seen < total_values and pos < len(chunk):
        r = _CompactReader(chunk, pos)
        info = PageInfo(page_type=-1)
        for fid, ftype in r.fields():
            if fid == 1 and ftype in (4, 5, 6):
                info.page_type = r.i32()
            elif fid == 2 and ftype in (4, 5, 6):
                info.uncompressed_size = r.i32()
            elif fid == 3 and ftype in (4, 5, 6):
                info.compressed_size = r.i32()
            elif fid == 5 and ftype == 12 and info.page_type == DATA_PAGE:
                for f2, t2 in r.fields():
                    if f2 == 1 and t2 in (4, 5, 6):
                        info.num_values = r.i32()
                    elif f2 == 2 and t2 in (4, 5, 6):
                        info.encoding = r.i32()
                    elif f2 == 3 and t2 in (4, 5, 6):
                        info.def_level_encoding = r.i32()
                    else:
                        r._skip(t2)
            elif fid == 7 and ftype == 12 \
                    and info.page_type == DICTIONARY_PAGE:
                for f2, t2 in r.fields():
                    if f2 == 1 and t2 in (4, 5, 6):
                        info.num_values = r.i32()
                    elif f2 == 2 and t2 in (4, 5, 6):
                        info.encoding = r.i32()
                    else:
                        r._skip(t2)
            elif fid == 8 and ftype == 12 \
                    and info.page_type == DATA_PAGE_V2:
                info.is_v2 = True
                for f2, t2 in r.fields():
                    if f2 == 1 and t2 in (4, 5, 6):
                        info.num_values = r.i32()
                    elif f2 == 2 and t2 in (4, 5, 6):
                        info.num_nulls = r.i32()
                    elif f2 == 4 and t2 in (4, 5, 6):
                        info.encoding = r.i32()
                    elif f2 == 5 and t2 in (4, 5, 6):
                        info.def_levels_byte_length = r.i32()
                    elif f2 == 6 and t2 in (4, 5, 6):
                        info.rep_levels_byte_length = r.i32()
                    elif f2 == 7 and t2 in (1, 2):
                        # BOOL carries its value in the field type
                        info.data_compressed = (t2 == 1)
                    else:
                        r._skip(t2)
            else:
                r._skip(ftype)
        info.data_offset = r.pos
        out.append(info)
        if info.page_type in (DATA_PAGE, DATA_PAGE_V2):
            seen += info.num_values
        pos = r.pos + info.compressed_size
    return out


@dataclass
class RleRun:
    """One run of the RLE/bit-packed hybrid encoding."""
    out_start: int          # first output value index
    count: int              # number of output values
    is_packed: bool
    value: int = 0          # RLE literal value
    byte_offset: int = 0    # payload offset of packed bits (is_packed)


def parse_hybrid_runs(buf: bytes, start: int, end: int, n_values: int,
                      bit_width: int) -> List[RleRun]:
    """Host walk of an RLE/bit-packed hybrid section: O(runs), value
    bytes untouched (the device expands them)."""
    runs: List[RleRun] = []
    r = _CompactReader(buf, min(start, len(buf)), )
    produced = 0
    byte_w = (bit_width + 7) // 8
    end = min(end, len(buf))
    while produced < n_values and r.pos < end:
        try:
            header = r.varint()
        except ThriftError:
            break
        if header & 1:                   # bit-packed: header>>1 groups of 8
            n = (header >> 1) * 8
            n = min(n, n_values - produced)
            runs.append(RleRun(produced, n, True,
                               byte_offset=r.pos))
            r.pos += (header >> 1) * bit_width
            produced += n
        else:                            # RLE run: count, value
            n = header >> 1
            if r.pos + byte_w > len(buf):
                break
            v = 0
            for i in range(byte_w):
                v |= buf[r.pos + i] << (8 * i)
            r.pos += byte_w
            runs.append(RleRun(produced, min(n, n_values - produced),
                               False, value=v))
            produced += n
    return runs
