"""Elementwise ops with Spark SQL semantics, on CVs of torch tensors.

The ported subset of the JAX package's `ops/elementwise.py`:
  - null propagation: the result is null if any input is null (except
    Kleene and/or)
  - integral overflow wraps (Java semantics; torch integers wrap likewise)
  - float NaN: NaN == NaN is true and NaN orders above every value
"""
from __future__ import annotations

import torch

from .kernel_utils import CV, and_validity

__all__ = ["add", "sub", "mul", "eq", "ne", "lt", "le", "gt", "ge",
           "eq_null_safe", "logical_and", "logical_or", "logical_not"]


def add(a: CV, b: CV) -> CV:
    return CV(a.data + b.data, and_validity(a, b))


def sub(a: CV, b: CV) -> CV:
    return CV(a.data - b.data, and_validity(a, b))


def mul(a: CV, b: CV) -> CV:
    return CV(a.data * b.data, and_validity(a, b))


def _nan_safe_eq(x, y):
    if x.is_floating_point():
        return (x == y) | (torch.isnan(x) & torch.isnan(y))
    return x == y


def _nan_lt(x, y):
    if x.is_floating_point():
        return (x < y) | (~torch.isnan(x) & torch.isnan(y))
    return x < y


def eq(a: CV, b: CV) -> CV:
    return CV(_nan_safe_eq(a.data, b.data), and_validity(a, b))


def ne(a: CV, b: CV) -> CV:
    return CV(~_nan_safe_eq(a.data, b.data), and_validity(a, b))


def lt(a: CV, b: CV) -> CV:
    return CV(_nan_lt(a.data, b.data), and_validity(a, b))


def le(a: CV, b: CV) -> CV:
    return CV(_nan_lt(a.data, b.data) | _nan_safe_eq(a.data, b.data),
              and_validity(a, b))


def gt(a: CV, b: CV) -> CV:
    return CV(_nan_lt(b.data, a.data), and_validity(a, b))


def ge(a: CV, b: CV) -> CV:
    return CV(_nan_lt(b.data, a.data) | _nan_safe_eq(a.data, b.data),
              and_validity(a, b))


def eq_null_safe(a: CV, b: CV) -> CV:
    """<=>: null <=> null is true; never returns null."""
    both_null = ~a.validity & ~b.validity
    both_valid = a.validity & b.validity
    out = both_null | (both_valid & _nan_safe_eq(a.data, b.data))
    return CV(out, torch.ones_like(out))


# ----------------------------------------------------------------------
# Boolean (Kleene three-valued logic)
# ----------------------------------------------------------------------
def logical_and(a: CV, b: CV) -> CV:
    ad, bd = a.data.bool(), b.data.bool()
    out = (a.validity & ad) & (b.validity & bd)
    valid = ((a.validity & ~ad) | (b.validity & ~bd)
             | (a.validity & b.validity))
    return CV(out, valid)


def logical_or(a: CV, b: CV) -> CV:
    at = a.validity & a.data.bool()
    bt = b.validity & b.data.bool()
    out = at | bt
    return CV(out, out | (a.validity & b.validity))


def logical_not(a: CV) -> CV:
    return CV(~a.data.bool(), a.validity)
