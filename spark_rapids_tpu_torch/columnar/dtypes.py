"""SQL data types of the port and their tensor representations.

The port's own copy of the JAX package's type system, cut to what the
ported slice needs. Device representations:

  - BooleanType      -> torch.bool
  - ByteType / ShortType / IntegerType / LongType -> int8/16/32/64
  - FloatType / DoubleType -> float32 / float64
  - DateType         -> int32 (days since epoch)
  - DecimalType(p,s) -> int64 unscaled for p <= 18 (decimal64);
                        p > 18 as an int64 [n, 2] (lo, hi) two's-complement
                        pair (decimal128)
  - NullType         -> int8, all null
  - StringType / BinaryType -> uint8 bytes plus int32 offsets [n + 1]
  - TimestampType    -> int64 microseconds since the epoch (UTC)

  - ArrayType        -> int32 offsets [n + 1] plus one element child
  - StructType       -> one child per field
  - MapType          -> a list of struct<key, value>

A nested column's own data tensor is empty: its values live in its
children (`ops/kernel_utils.py` `CV`).
"""
from __future__ import annotations

from typing import Optional

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..errors import NotPorted

__all__ = [
    "DataType", "BooleanType", "ByteType", "ShortType", "IntegerType",
    "LongType", "FloatType", "DoubleType", "StringType", "BinaryType",
    "DateType", "TimestampType", "DecimalType", "NullType", "ArrayType",
    "StructType", "StructField", "MapType",
    "BOOL", "INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
    "STRING", "BINARY", "DATE", "TIMESTAMP", "NULLTYPE",
    "promote", "from_arrow", "to_arrow", "torch_dtype", "alloc_shape",
    "from_name", "element_dtype",
]


class DataType:
    """Base class for all SQL data types."""

    #: numpy dtype of the primary host buffer, or None for nested
    np_dtype: Optional[np.dtype] = None

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, (ByteType, ShortType, IntegerType, LongType,
                                 FloatType, DoubleType, DecimalType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, (ByteType, ShortType, IntegerType, LongType))

    @property
    def is_floating(self) -> bool:
        return isinstance(self, (FloatType, DoubleType))

    @property
    def is_variable_width(self) -> bool:
        """Bytes plus offsets: string and binary. (The JAX package counts
        arrays and maps here too; the port asks `is_nested` for them.)"""
        return isinstance(self, (StringType, BinaryType))

    @property
    def is_nested(self) -> bool:
        return isinstance(self, (ArrayType, StructType, MapType))

    def simple_name(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __repr__(self) -> str:
        return self.simple_name()

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)


class ByteType(DataType):
    np_dtype = np.dtype(np.int8)


class ShortType(DataType):
    np_dtype = np.dtype(np.int16)


class IntegerType(DataType):
    np_dtype = np.dtype(np.int32)


class LongType(DataType):
    np_dtype = np.dtype(np.int64)


class FloatType(DataType):
    np_dtype = np.dtype(np.float32)


class DoubleType(DataType):
    np_dtype = np.dtype(np.float64)


class StringType(DataType):
    np_dtype = np.dtype(np.uint8)


class BinaryType(DataType):
    np_dtype = np.dtype(np.uint8)


class DateType(DataType):
    np_dtype = np.dtype(np.int32)


class TimestampType(DataType):
    np_dtype = np.dtype(np.int64)


class NullType(DataType):
    np_dtype = np.dtype(np.int8)


class DecimalType(DataType):
    """Fixed-point decimal. p <= 18 is backed by a scaled int64."""

    MAX_INT64_PRECISION = 18
    MAX_PRECISION = 38

    def __init__(self, precision: int = 10, scale: int = 0):
        if not (1 <= precision <= self.MAX_PRECISION):
            raise ValueError(f"precision out of range: {precision}")
        if not (0 <= scale <= precision):
            raise ValueError(
                f"scale out of range: {scale} (precision {precision})")
        self.precision = precision
        self.scale = scale

    @property
    def np_dtype(self):  # type: ignore[override]
        return np.dtype(np.int64)

    @property
    def is_decimal128(self) -> bool:
        """precision > 18: data travels as an [n, 2] int64 buffer."""
        return self.precision > self.MAX_INT64_PRECISION

    def simple_name(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def __eq__(self, other):
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self):
        return hash((DecimalType, self.precision, self.scale))


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    dtype: "DataType"
    nullable: bool = True


class StructType(DataType):
    def __init__(self, fields: Tuple[StructField, ...]):
        self.fields = tuple(fields)

    def simple_name(self) -> str:
        inner = ",".join(f"{f.name}:{f.dtype.simple_name()}"
                         for f in self.fields)
        return f"struct<{inner}>"

    def __eq__(self, other):
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self):
        return hash((StructType, self.fields))


class ArrayType(DataType):
    def __init__(self, element: DataType, contains_null: bool = True):
        self.element = element
        self.contains_null = contains_null

    def simple_name(self) -> str:
        return f"array<{self.element.simple_name()}>"

    def __eq__(self, other):
        return isinstance(other, ArrayType) and other.element == self.element

    def __hash__(self):
        return hash((ArrayType, self.element))


class MapType(DataType):
    def __init__(self, key: DataType, value: DataType,
                 value_contains_null: bool = True):
        self.key = key
        self.value = value
        self.value_contains_null = value_contains_null

    def simple_name(self) -> str:
        return f"map<{self.key.simple_name()},{self.value.simple_name()}>"

    def __eq__(self, other):
        return (isinstance(other, MapType) and other.key == self.key
                and other.value == self.value)

    def __hash__(self):
        return hash((MapType, self.key, self.value))


def element_dtype(dtype: DataType) -> DataType:
    """The element type of a list layout; a map is a list of
    struct<key, value> (JAX `Column.element_dtype`)."""
    if isinstance(dtype, MapType):
        return StructType((StructField("key", dtype.key, False),
                           StructField("value", dtype.value)))
    return dtype.element


BOOL = BooleanType()
INT8 = ByteType()
INT16 = ShortType()
INT32 = IntegerType()
INT64 = LongType()
FLOAT32 = FloatType()
FLOAT64 = DoubleType()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULLTYPE = NullType()

_NUMERIC_ORDER = [ByteType, ShortType, IntegerType, LongType, FloatType,
                  DoubleType]

_TORCH = {
    BooleanType: torch.bool, ByteType: torch.int8, ShortType: torch.int16,
    IntegerType: torch.int32, LongType: torch.int64,
    FloatType: torch.float32, DoubleType: torch.float64,
    DateType: torch.int32, TimestampType: torch.int64,
    DecimalType: torch.int64, NullType: torch.int8,
    StringType: torch.uint8, BinaryType: torch.uint8,
}


def torch_dtype(dt: DataType) -> torch.dtype:
    """Tensor dtype of a column's data buffer (a nested column's is an
    empty int8 tensor)."""
    if dt.is_nested:
        return torch.int8
    try:
        return _TORCH[type(dt)]
    except KeyError:
        raise NotPorted(f"{dt.simple_name()} columns") from None


def alloc_shape(dt: DataType, n: int) -> tuple:
    """Data-buffer shape of a fixed-width column of n rows: decimal128
    keeps two int64 words per row. (A string column's data is its bytes,
    not n rows: its empty form is `alloc_shape(dt, 0)`.)"""
    if isinstance(dt, DecimalType) and dt.is_decimal128:
        return (n, 2)
    return (n,)


def promote(a: DataType, b: DataType) -> DataType:
    """Numeric type promotion following Spark's binary-arithmetic widening."""
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise TypeError("decimal promotion handled by expression layer")
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"cannot promote {a} and {b}")
    ia = _NUMERIC_ORDER.index(type(a))
    ib = _NUMERIC_ORDER.index(type(b))
    if {type(a), type(b)} == {LongType, FloatType}:
        return FLOAT64
    return a if ia >= ib else b


def from_arrow(at) -> DataType:
    """Map a pyarrow type to a DataType."""
    import pyarrow as pa
    simple = [(pa.types.is_boolean, BOOL), (pa.types.is_int8, INT8),
              (pa.types.is_int16, INT16), (pa.types.is_int32, INT32),
              (pa.types.is_int64, INT64), (pa.types.is_float32, FLOAT32),
              (pa.types.is_float64, FLOAT64), (pa.types.is_string, STRING),
              (pa.types.is_large_string, STRING),
              (pa.types.is_binary, BINARY),
              (pa.types.is_large_binary, BINARY),
              (pa.types.is_date32, DATE), (pa.types.is_timestamp, TIMESTAMP),
              (pa.types.is_null, NULLTYPE)]
    for pred, dt in simple:
        if pred(at):
            return dt
    if pa.types.is_decimal(at):
        return DecimalType(at.precision, at.scale)
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return ArrayType(from_arrow(at.value_type))
    if pa.types.is_struct(at):
        return StructType(tuple(StructField(f.name, from_arrow(f.type))
                                for f in at))
    if pa.types.is_map(at):
        return MapType(from_arrow(at.key_type), from_arrow(at.item_type))
    raise TypeError(f"unsupported arrow type: {at}")


def to_arrow(dt: DataType):
    import pyarrow as pa
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, ArrayType):
        return pa.list_(to_arrow(dt.element))
    if isinstance(dt, StructType):
        return pa.struct([(f.name, to_arrow(f.dtype)) for f in dt.fields])
    if isinstance(dt, MapType):
        return pa.map_(to_arrow(dt.key), to_arrow(dt.value))
    return {BooleanType: pa.bool_(), ByteType: pa.int8(),
            ShortType: pa.int16(), IntegerType: pa.int32(),
            LongType: pa.int64(), FloatType: pa.float32(),
            DoubleType: pa.float64(), StringType: pa.string(),
            BinaryType: pa.binary(), DateType: pa.date32(),
            TimestampType: pa.timestamp("us", tz="UTC"),
            NullType: pa.null()}[type(dt)]


_NAME_TO_DTYPE = {
    "boolean": BOOL, "bool": BOOL,
    "byte": INT8, "tinyint": INT8,
    "short": INT16, "smallint": INT16,
    "int": INT32, "integer": INT32,
    "long": INT64, "bigint": INT64,
    "float": FLOAT32, "real": FLOAT32,
    "double": FLOAT64,
    "string": STRING, "binary": BINARY,
    "date": DATE, "timestamp": TIMESTAMP,
}


def from_name(name: str) -> DataType:
    """Resolve a Spark SQL type name ('int', 'bigint', 'decimal(10,2)',
    ...) to a DataType, as the JAX package's `from_name` does."""
    t = name.strip().lower()
    if t in _NAME_TO_DTYPE:
        return _NAME_TO_DTYPE[t]
    if t.startswith("decimal"):
        inner = t[len("decimal"):].strip()
        if not inner:
            return DecimalType(10, 0)
        if inner.startswith("(") and inner.endswith(")"):
            p, _, s = inner[1:-1].partition(",")
            return DecimalType(int(p), int(s or 0))
    raise ValueError(f"unknown type name {name!r}")
