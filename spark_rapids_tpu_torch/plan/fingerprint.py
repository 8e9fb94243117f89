"""Structural fingerprints of expression trees and plan config objects.

The port's copy of the JAX package's `runtime/program_cache.py`
`expr_fp` / `exprs_fp`, the identity the calibration table
(`plan/stats.py`) and the exchange-reuse pass (`plan/reuse.py`) key on.
It recurses into the port's own classes (module `spark_rapids_tpu_torch`):
an object it cannot see into falls back to `("id", id(obj))`, which is
correct (never falsely shared) but never shared either, so a fingerprint
that stopped recursing would make every reuse and calibration lookup
miss without failing.
"""
from __future__ import annotations

import re
from typing import Iterable, Optional

__all__ = ["expr_fp", "exprs_fp"]

_SCALARS = (bool, int, float, bytes, type(None))

# the join-rename machinery (session.py) gensyms hidden key columns from
# a process-global counter (`__join_r<N>_x`): two identical fresh query
# trees carry different counters in otherwise identical bound
# expressions. Post-binding, column names are cosmetic (emit works on
# ordinals), so the fingerprint normalizes the counter away.
_GENSYM_RE = re.compile(r"__join_r\d+_")

_PACKAGE = "spark_rapids_tpu_torch"


def expr_fp(obj, _memo: Optional[dict] = None):
    """Structural fingerprint of a bound expression tree (or any plan
    config object): class name and scalar attributes, preorder, so two
    semantically identical trees built by different DataFrames collide.
    Unhashable or callable values fall back to `("id", id(v))`."""
    if isinstance(obj, str):
        return _GENSYM_RE.sub("__join_r?_", obj)
    if isinstance(obj, _SCALARS):
        return obj
    if _memo is None:
        _memo = {}
    oid = id(obj)
    if oid in _memo:
        return _memo[oid]
    if isinstance(obj, (list, tuple)):
        return ("seq",) + tuple(expr_fp(x, _memo) for x in obj)
    if isinstance(obj, (set, frozenset)):
        return ("set",) + tuple(sorted(
            (repr(expr_fp(x, _memo)) for x in obj)))
    if isinstance(obj, dict):
        return ("map",) + tuple(sorted(
            ((str(k), expr_fp(v, _memo)) for k, v in obj.items())))
    mod = type(obj).__module__ or ""
    if mod.startswith(_PACKAGE) and hasattr(obj, "__dict__") \
            and not callable(obj):
        _memo[oid] = ("cyc", type(obj).__qualname__)  # cycle guard
        parts: list = [type(obj).__qualname__]
        for k, v in sorted(vars(obj).items()):
            # an operator's id and the `_*_cache` memos (planning another
            # query sets them lazily on shared plan nodes) would split
            # the key per instance
            if (k.startswith("_") and k.endswith("_cache")) \
                    or k == "_op_id":
                continue
            parts.append((k, expr_fp(v, _memo)))
        fp = tuple(parts)
        _memo[oid] = fp
        return fp
    if callable(obj):
        return ("id", oid)
    try:
        hash(obj)
    except TypeError:
        return ("id", oid)
    # hashable foreign value (numpy scalar, Decimal, date, dtype...)
    return obj


def exprs_fp(exprs: Iterable) -> tuple:
    return tuple(expr_fp(e) for e in exprs)
