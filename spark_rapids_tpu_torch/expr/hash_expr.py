"""The hash expressions: hash (Spark's murmur3 row hash, seed 42,
int32), xxhash64 (seed 42, int64) and hive_hash (int32), the port's
copy of the JAX package's `expr/hash_expr.py` over `ops/hash.py`. None
of them is ever null. might_contain probes a bloom_filter_agg payload
(`expr/aggregates.py` `BloomFilterAggregate`) with the same
`bloom_positions`.
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar import dtypes as dt
from ..ops.hash import (bloom_positions, hive_hash_row_hash,
                        murmur3_row_hash, to_signed32, xxhash64_row_hash)
from ..ops.kernel_utils import CV
from .expressions import Expression

__all__ = ["Murmur3Hash", "XxHash64", "HiveHash",
           "BloomFilterMightContain"]


class BloomFilterMightContain(Expression):
    """might_contain(filter, value): membership probe against a
    bloom_filter_agg result (JAX `expr/hash_expr.py:19`; reference:
    GpuBloomFilterMightContain.scala). The filter must be FOLDABLE (a
    binary literal, like Spark's scalar-subquery result): its bit vector
    unpacks once at bind and goes to the batch's device on first use; a
    row might be in the set when all k positions are set. A null value
    gives null."""

    def __init__(self, filter_expr: Expression, value: Expression):
        self.filter_expr = filter_expr
        self.value = value
        self.children = [filter_expr, value]

    def bind(self, schema):
        from .aggregates import parse_bloom_filter
        from .expressions import Literal, UnsupportedExpr
        f = self.filter_expr.bind(schema)
        v = self.value.bind(schema)
        if not isinstance(f, Literal) or not isinstance(f.value, bytes):
            raise UnsupportedExpr(
                "might_contain requires a foldable binary filter "
                "(collect bloom_filter_agg first)")
        b = BloomFilterMightContain(f, v)
        b._k, b._m, bits = parse_bloom_filter(f.value)
        b._bits = {"cpu": torch.from_numpy(bits)}
        b.dtype = dt.BOOL
        return b

    def _bits_on(self, device):
        key = str(device)
        if key not in self._bits:
            self._bits[key] = self._bits["cpu"].to(device)
        return self._bits[key]

    def emit(self, ctx):
        cv = self.value.emit(ctx)
        bits = self._bits_on(cv.validity.device)
        hit = torch.ones_like(cv.validity)
        for pos in bloom_positions(cv, self.value.dtype, self._k, self._m):
            hit = hit & bits[pos.clamp(0, self._m - 1)]
        return CV(hit, cv.validity)

    def __repr__(self):
        return f"might_contain(<filter>, {self.value})"


class _RowHash(Expression):
    out_type = dt.INT32

    def __init__(self, children: List[Expression], seed: int = 42):
        self.children = list(children)
        self.seed = seed

    def bind(self, schema):
        b = type(self)([c.bind(schema) for c in self.children], self.seed)
        b.dtype = self.out_type
        return b

    def _hash(self, cvs, dtypes):
        raise NotImplementedError

    def emit(self, ctx):
        cvs = [c.emit(ctx) for c in self.children]
        h = self._hash(cvs, [c.dtype for c in self.children])
        return CV(h, torch.ones(ctx.capacity, dtype=torch.bool,
                                device=ctx.device))

    def __repr__(self):
        return f"{self.fn}(" + ", ".join(map(repr, self.children)) + ")"


class Murmur3Hash(_RowHash):
    fn = "hash"

    def _hash(self, cvs, dtypes):
        return to_signed32(murmur3_row_hash(cvs, dtypes, self.seed))


class XxHash64(_RowHash):
    """xxhash64(cols...): Spark's 64-bit row hash."""
    fn = "xxhash64"
    out_type = dt.INT64

    def _hash(self, cvs, dtypes):
        return xxhash64_row_hash(cvs, dtypes, self.seed)


class HiveHash(_RowHash):
    """hive_hash(cols...): Hive's 31-polynomial row hashCode, nulls
    contributing 0 (Hive-bucketed table writes)."""
    fn = "hive_hash"

    def __init__(self, children: List[Expression], seed: int = 0):
        super().__init__(children, seed)

    def _hash(self, cvs, dtypes):
        return hive_hash_row_hash(cvs, dtypes)
