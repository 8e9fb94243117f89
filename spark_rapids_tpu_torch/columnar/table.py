"""Schema and device table: an ordered set of equal-length Columns."""
from __future__ import annotations

from typing import List, Sequence

import torch

from . import dtypes as dt
from .column import Column, tree_to_flat

__all__ = ["Field", "Schema", "Table"]


class Field:
    def __init__(self, name: str, dtype: dt.DataType, nullable: bool = True):
        self.name = name
        self.dtype = dtype
        self.nullable = nullable

    def __repr__(self):
        return f"{self.name}:{self.dtype}"

    def __eq__(self, other):
        return (isinstance(other, Field) and other.name == self.name
                and other.dtype == self.dtype)


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __getitem__(self, i):
        return self.fields[i]

    def __len__(self):
        return len(self.fields)

    def __repr__(self):
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"

    def __eq__(self, other):
        return isinstance(other, Schema) and other.fields == self.fields

    def to_arrow(self):
        import pyarrow as pa
        return pa.schema([(f.name, dt.to_arrow(f.dtype))
                          for f in self.fields])

    @staticmethod
    def from_arrow(schema) -> "Schema":
        return Schema([Field(f.name, dt.from_arrow(f.type), f.nullable)
                       for f in schema])


class Table:
    """Immutable set of columns sharing one length."""

    def __init__(self, names: Sequence[str], columns: Sequence[Column]):
        assert len(names) == len(columns)
        self.names = list(names)
        self.columns = list(columns)

    @property
    def num_rows(self) -> int:
        return self.columns[0].length if self.columns else 0

    @staticmethod
    def from_arrow(at, device: torch.device) -> "Table":
        """Decode a pyarrow Table or RecordBatch on the host and move every
        buffer of every column to `device` in one copy."""
        from ..exec.batch import to_device
        names = list(at.schema.names)
        host = [Column.host_from_arrow(at.column(i))
                for i in range(len(names))]
        flat = [a for dtype, _, b in host for a in tree_to_flat(dtype, b)]
        dev = iter(to_device(flat, device))
        cols = [Column.from_buffers(dtype, n, dev) for dtype, n, _ in host]
        return Table(names, cols)
