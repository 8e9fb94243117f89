"""Avro Object Container File reader/writer (pure Python, no deps).

The JAX package's `io/avro.py`, copied. Two consumers: the `read.avro`
scan format (reference: GpuAvroScan in the avro module) and Iceberg
manifest/manifest-list files (io/iceberg.py).
Implements the container spec (magic 'Obj\\x01', header metadata map,
sync-marker-delimited deflate/null blocks) and the binary encoding
(zigzag varints, length-prefixed bytes/strings, records, arrays, maps,
unions, fixed, enums) — Avro spec §object container files.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["AvroReader", "AvroWriter", "read_avro_to_arrow",
           "iter_avro_blocks", "write_avro"]

_MAGIC = b"Obj\x01"


# ----------------------------------------------------------------------
# binary decoding
# ----------------------------------------------------------------------
class _Decoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)          # zigzag

    def read_bytes(self) -> bytes:
        n = self.read_long()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_value(self, schema):
        if isinstance(schema, list):               # union
            idx = self.read_long()
            return self.read_value(schema[idx])
        t = schema["type"] if isinstance(schema, dict) else schema
        if isinstance(t, (dict, list)):            # wrapped nested type
            return self.read_value(t)
        if t == "null":
            return None
        if t == "boolean":
            b = self.buf[self.pos]
            self.pos += 1
            return bool(b)
        if t in ("int", "long"):
            return self.read_long()
        if t == "float":
            (v,) = struct.unpack_from("<f", self.buf, self.pos)
            self.pos += 4
            return v
        if t == "double":
            (v,) = struct.unpack_from("<d", self.buf, self.pos)
            self.pos += 8
            return v
        if t == "bytes":
            return self.read_bytes()
        if t == "string":
            return self.read_bytes().decode("utf-8")
        if t == "record":
            return {f["name"]: self.read_value(f["type"])
                    for f in schema["fields"]}
        if t == "array":
            out = []
            while True:
                n = self.read_long()
                if n == 0:
                    break
                if n < 0:                       # block with byte size
                    n = -n
                    self.read_long()
                for _ in range(n):
                    out.append(self.read_value(schema["items"]))
            return out
        if t == "map":
            out = {}
            while True:
                n = self.read_long()
                if n == 0:
                    break
                if n < 0:
                    n = -n
                    self.read_long()
                for _ in range(n):
                    k = self.read_bytes().decode("utf-8")
                    out[k] = self.read_value(schema["values"])
            return out
        if t == "fixed":
            n = schema["size"]
            out = self.buf[self.pos:self.pos + n]
            self.pos += n
            return out
        if t == "enum":
            return schema["symbols"][self.read_long()]
        raise ValueError(f"unsupported avro type: {t!r}")


class _Encoder:
    def __init__(self):
        self.out = bytearray()

    def write_long(self, v: int):
        v = (v << 1) ^ (v >> 63)               # zigzag (python ints)
        if v < 0:
            v &= (1 << 64) - 1
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                break

    def write_bytes(self, b: bytes):
        self.write_long(len(b))
        self.out += b

    def write_value(self, schema, v):
        if isinstance(schema, list):           # union: null else first match
            for i, s in enumerate(schema):
                st = s["type"] if isinstance(s, dict) else s
                if (v is None) == (st == "null"):
                    self.write_long(i)
                    return self.write_value(s, v)
            raise ValueError("no union branch matched")
        t = schema["type"] if isinstance(schema, dict) else schema
        if isinstance(t, (dict, list)):        # wrapped nested type
            return self.write_value(t, v)
        if t == "null":
            return
        if t == "boolean":
            self.out.append(1 if v else 0)
            return
        if t in ("int", "long"):
            self.write_long(int(v))
            return
        if t == "float":
            self.out += struct.pack("<f", v)
            return
        if t == "double":
            self.out += struct.pack("<d", v)
            return
        if t == "bytes":
            self.write_bytes(bytes(v))
            return
        if t == "string":
            self.write_bytes(str(v).encode("utf-8"))
            return
        if t == "record":
            for f in schema["fields"]:
                self.write_value(f["type"], v.get(f["name"]))
            return
        if t == "array":
            if v:
                self.write_long(len(v))
                for item in v:
                    self.write_value(schema["items"], item)
            self.write_long(0)
            return
        if t == "map":
            if v:
                self.write_long(len(v))
                for k, val in v.items():
                    self.write_bytes(str(k).encode("utf-8"))
                    self.write_value(schema["values"], val)
            self.write_long(0)
            return
        if t == "fixed":
            assert len(v) == schema["size"]
            self.out += v
            return
        if t == "enum":
            self.write_long(schema["symbols"].index(v))
            return
        raise ValueError(f"unsupported avro type: {t!r}")


# ----------------------------------------------------------------------
# container files
# ----------------------------------------------------------------------
class AvroReader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.raw = f.read()
        if self.raw[:4] != _MAGIC:
            raise IOError(f"not an avro container file: {path}")
        d = _Decoder(self.raw)
        d.pos = 4
        self.meta: Dict[str, bytes] = {}
        while True:
            n = d.read_long()
            if n == 0:
                break
            if n < 0:
                n = -n
                d.read_long()
            for _ in range(n):
                k = d.read_bytes().decode("utf-8")
                self.meta[k] = d.read_bytes()
        self.schema = json.loads(self.meta["avro.schema"])
        self.codec = self.meta.get("avro.codec", b"null").decode()
        self.sync = self.raw[d.pos:d.pos + 16]
        self._body = d.pos + 16

    def blocks(self) -> Iterator[List[Any]]:
        pos = self._body
        while pos < len(self.raw):
            d = _Decoder(self.raw)
            d.pos = pos
            count = d.read_long()
            nbytes = d.read_long()
            payload = self.raw[d.pos:d.pos + nbytes]
            pos = d.pos + nbytes + 16          # skip sync marker
            if self.codec == "deflate":
                payload = zlib.decompress(payload, -15)
            elif self.codec != "null":
                raise IOError(f"unsupported avro codec {self.codec!r}")
            bd = _Decoder(payload)
            yield [bd.read_value(self.schema) for _ in range(count)]

    def records(self) -> Iterator[Any]:
        for block in self.blocks():
            yield from block


class AvroWriter:
    def __init__(self, path: str, schema: Dict, codec: str = "deflate"):
        self.path = path
        self.schema = schema
        self.codec = codec
        self.sync = os.urandom(16)
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        e = _Encoder()
        meta = {"avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode()}
        e.write_long(len(meta))
        for k, v in meta.items():
            e.write_bytes(k.encode())
            e.write_bytes(v)
        e.write_long(0)
        self._f.write(bytes(e.out))
        self._f.write(self.sync)

    def write_block(self, records: List[Any]):
        if not records:
            return
        e = _Encoder()
        for r in records:
            e.write_value(self.schema, r)
        payload = bytes(e.out)
        if self.codec == "deflate":
            co = zlib.compressobj(wbits=-15)
            payload = co.compress(payload) + co.flush()
        h = _Encoder()
        h.write_long(len(records))
        h.write_long(len(payload))
        self._f.write(bytes(h.out))
        self._f.write(payload)
        self._f.write(self.sync)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_avro(path: str, schema: Dict, records: List[Any],
               codec: str = "deflate", block_records: int = 4096):
    with AvroWriter(path, schema, codec) as w:
        for i in range(0, len(records), block_records):
            w.write_block(records[i:i + block_records])


# ----------------------------------------------------------------------
# arrow bridge
# ----------------------------------------------------------------------
def _arrow_type(schema):
    import pyarrow as pa
    t = schema["type"] if isinstance(schema, dict) else schema
    if isinstance(schema, list):                # union: null + one type
        others = [s for s in schema
                  if (s["type"] if isinstance(s, dict) else s) != "null"]
        return _arrow_type(others[0])
    if isinstance(t, (dict, list)):
        return _arrow_type(t)
    m = {"null": pa.null(), "boolean": pa.bool_(), "int": pa.int32(),
         "long": pa.int64(), "float": pa.float32(),
         "double": pa.float64(), "bytes": pa.binary(),
         "string": pa.string()}
    if t in m:
        return m[t]
    if t == "record":
        return pa.struct([(f["name"], _arrow_type(f["type"]))
                          for f in schema["fields"]])
    if t == "array":
        return pa.list_(_arrow_type(schema["items"]))
    if t == "map":
        return pa.map_(pa.string(), _arrow_type(schema["values"]))
    if t == "fixed":
        return pa.binary(schema["size"])
    if t == "enum":
        return pa.string()
    raise ValueError(f"unsupported avro type for arrow: {t!r}")


def avro_arrow_schema(schema):
    import pyarrow as pa
    assert schema["type"] == "record", "top-level avro type must be record"
    return pa.schema([(f["name"], _arrow_type(f["type"]))
                      for f in schema["fields"]])


def iter_avro_blocks(path: str, columns=None):
    """Arrow tables, one per container block (the lazy scan unit)."""
    import pyarrow as pa
    r = AvroReader(path)
    aschema = avro_arrow_schema(r.schema)
    if columns is not None:
        aschema = pa.schema([f for f in aschema
                             if f.name in set(columns)])
    for block in r.blocks():
        if columns is not None:
            block = [{k: rec.get(k) for k in aschema.names}
                     for rec in block]
        yield pa.Table.from_pylist(block, schema=aschema)


def read_avro_to_arrow(path: str, columns=None):
    import pyarrow as pa
    tables = list(iter_avro_blocks(path, columns))
    if not tables:
        r = AvroReader(path)
        return avro_arrow_schema(r.schema).empty_table()
    return pa.concat_tables(tables)
