"""Columnar Python UDFs — the RapidsUDF / CPU-bridge analog, the port of
the JAX package's `expr/udf.py`.

The reference has two escape hatches: RapidsUDF.evaluateColumnar (user
supplies a columnar kernel, reference: sql-plugin-api/.../RapidsUDF.java:22)
and GpuCpuBridgeExpression (copy to host, evaluate on CPU, copy back —
reference: GpuCpuBridgeExpression.scala). Here both collapse into one
mechanism: `PyUDF` wraps a numpy-vectorized Python function. Where the
JAX package emits a `jax.pure_callback` inside the traced program, the
port makes a plain host call per batch: one D2H copy of the child
columns (`exec/batch.py` `to_host`, counted in `utils/transfer.syncs`),
`fn` over their numpy buffers, and one H2D copy of the result onto the
batch's device. Null-safe by default (null in -> null out, fn sees raw
buffers: a null slot's value is whatever the buffer holds).

The JAX limits hold exactly: the return type is fixed-width, a string
child raises UnsupportedExpr, and a decimal child reaches `fn` as its
unscaled integers (the column's data buffer, as the JAX `cv.data`).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..columnar import dtypes as dt
from ..ops.kernel_utils import CV
from .expressions import Expression, UnsupportedExpr

__all__ = ["PyUDF", "udf", "df_udf"]


class PyUDF(Expression):
    def __init__(self, fn: Callable, return_type: dt.DataType,
                 children: Sequence[Expression], null_safe: bool = True):
        self.fn = fn
        self.return_type = return_type
        self.children = list(children)
        self.null_safe = null_safe
        if return_type.is_variable_width or return_type.is_nested:
            raise UnsupportedExpr("PyUDF round-1 returns fixed-width types")

    @property
    def name(self):
        return getattr(self.fn, "__name__", "udf")

    def bind(self, schema):
        b = PyUDF(self.fn, self.return_type,
                  [c.bind(schema) for c in self.children], self.null_safe)
        b.dtype = self.return_type
        return b

    def emit(self, ctx):
        from ..exec.batch import to_device, to_host
        cvs = [c.emit(ctx) for c in self.children]
        for cv in cvs:
            if cv.offsets is not None:
                raise UnsupportedExpr("PyUDF over strings round-1")
        cap = ctx.capacity
        np_dt = self.return_type.np_dtype
        # the buffers of a CUDA batch are views of one pinned staging
        # buffer: fn reads them in place
        host = to_host([cv.data for cv in cvs])
        out = np.ascontiguousarray(self.fn(*host), dtype=np_dt)
        if out.shape != (cap,):
            raise ValueError(f"udf {self.name} returned shape "
                             f"{out.shape}, expected ({cap},)")
        data = to_device([out], ctx.device)[0]
        valid = torch.ones(cap, dtype=torch.bool, device=ctx.device)
        if self.null_safe:
            for cv in cvs:
                valid = valid & cv.validity
        return CV(data, valid)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.children))})"


def udf(fn: Callable, return_type: dt.DataType, null_safe: bool = True,
        compile: bool = True):  # noqa: A002
    """Wrap a numpy-vectorized function as a columnar UDF factory:

        doubled = udf(lambda x: x * 2, dtypes.INT64)
        df.select(doubled(col("a")))

    When `compile` is true the udf-compiler (expr/udf_compiler.py, the
    reference's udf-compiler/ analog) first tries to translate the Python
    source into a native expression tree: the UDF then runs as device
    expressions instead of a host call. A CompileError (source outside
    the supported subset) falls back to `PyUDF`, the host call, exactly
    as in the JAX package: a choice between two evaluations of the same
    function on the session's device, not a fallback to another device.
    """
    def factory(*cols):
        from ..functions import _to_expr
        exprs = [_to_expr(c) for c in cols]
        if compile:
            from .expressions import Cast
            from .udf_compiler import CompileError, compile_udf
            try:
                compiled = compile_udf(fn, exprs)
                return Cast(compiled, return_type)
            except CompileError:
                pass
        return PyUDF(fn, return_type, exprs, null_safe)
    factory.__name__ = getattr(fn, "__name__", "udf")
    return factory


def df_udf(fn: Callable):
    """Dataframe-function UDF (reference: sql-plugin-api functions.scala
    df_udf — UDFs expressed as Column->Column functions, expanded inline
    at plan time). `fn` receives expression objects and returns one:

        within = df_udf(lambda a, b: (a - b).cast("double") / b)
        df.select(within(col("x"), col("y")).alias("r"))
    """
    def factory(*cols):
        from ..functions import _to_expr
        return fn(*[_to_expr(c) for c in cols])
    factory.__name__ = getattr(fn, "__name__", "df_udf")
    return factory
