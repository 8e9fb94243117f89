"""The hash expressions: hash (Spark's murmur3 row hash, seed 42,
int32), xxhash64 (seed 42, int64) and hive_hash (int32), the port's
copy of the JAX package's `expr/hash_expr.py` over `ops/hash.py`. None
of them is ever null. might_contain waits for the bloom filter
(ROADMAP A.9) and raises NotPorted.
"""
from __future__ import annotations

from typing import List

import torch

from ..columnar import dtypes as dt
from ..errors import NotPorted
from ..ops.hash import (hive_hash_row_hash, murmur3_row_hash, to_signed32,
                        xxhash64_row_hash)
from ..ops.kernel_utils import CV
from .expressions import Expression

__all__ = ["Murmur3Hash", "XxHash64", "HiveHash",
           "BloomFilterMightContain"]


class BloomFilterMightContain(Expression):
    def __init__(self, filter_expr: Expression, value: Expression):
        raise NotPorted("might_contain (the bloom filter, ROADMAP A.9)")


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
