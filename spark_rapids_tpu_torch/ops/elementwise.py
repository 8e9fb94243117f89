"""Elementwise ops with Spark SQL semantics, on CVs of torch tensors.

The ported subset of the JAX package's `ops/elementwise.py`:
  - null propagation: the result is null if any input is null (except
    Kleene and/or)
  - divide / remainder by zero (-0.0 too) -> null (non-ANSI Spark)
  - integral overflow wraps (Java semantics; torch integers wrap likewise)
  - float NaN: NaN == NaN is true and NaN orders above every value
"""
from __future__ import annotations

import torch

from .kernel_utils import CV, and_validity

__all__ = ["add", "sub", "mul", "divide", "int_divide", "remainder",
           "pmod", "negate", "abs_", "eq", "ne", "lt", "le", "gt", "ge",
           "eq_null_safe", "logical_and", "logical_or", "logical_not",
           "is_null", "is_not_null", "is_nan"]


def add(a: CV, b: CV) -> CV:
    return CV(a.data + b.data, and_validity(a, b))


def sub(a: CV, b: CV) -> CV:
    return CV(a.data - b.data, and_validity(a, b))


def mul(a: CV, b: CV) -> CV:
    return CV(a.data * b.data, and_validity(a, b))


def divide(a: CV, b: CV) -> CV:
    """Spark `/` of two floating columns (the expression casts every
    other pair to double or divides decimals exactly)."""
    zero = b.data == 0
    safe = torch.where(zero, torch.ones_like(b.data), b.data)
    return CV(a.data / safe, and_validity(a, b) & ~zero)


def remainder(a: CV, b: CV) -> CV:
    """Spark `%`: the sign follows the dividend (Java); a float's
    remainder is a - trunc(a / b) * b, as the JAX package computes it.
    x % -1 is 0 without dividing (the minimum integer over -1 would
    trap)."""
    zero = b.data == 0
    if a.data.is_floating_point():
        safe = torch.where(zero, torch.ones_like(b.data), b.data)
        r = a.data - torch.trunc(a.data / safe) * safe
    else:
        # over 1 instead of 0 or -1: the remainder is 0 either way
        safe = torch.where(zero | (b.data == -1), torch.ones_like(b.data),
                           b.data)
        r = a.data - torch.div(a.data, safe, rounding_mode="trunc") * safe
    return CV(torch.where(zero, torch.zeros_like(r), r),
              and_validity(a, b) & ~zero)


def _java_div(a, b):
    """Integer a / b truncated toward zero (Java), b != 0. A divisor of
    -1 negates (wrapping, so the minimum integer over -1 is itself, as in
    Java and XLA) without dividing: torch's division of the minimum
    integer by -1 traps on the CPU and is undefined on CUDA."""
    minus1 = b == -1
    safe = torch.where(minus1, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    return torch.where(minus1, -a, q)


def int_divide(a: CV, b: CV) -> CV:
    """Spark `div`: integral division truncated toward zero; a divisor of
    0 gives null."""
    zero = b.data == 0
    safe = torch.where(zero, torch.ones_like(b.data), b.data)
    return CV(_java_div(a.data, safe), and_validity(a, b) & ~zero)


def pmod(a: CV, b: CV) -> CV:
    """Spark pmod as the JAX package computes it: m = a mod b with the
    divisor's sign (jnp.mod, torch.remainder), then m + |b| where m < 0;
    a divisor of 0 gives null. An integer divisor of -1 gives 0 without
    dividing (the minimum integer over -1 would trap)."""
    zero = b.data == 0
    if a.data.is_floating_point():
        safe = torch.where(zero, torch.ones_like(b.data), b.data)
    else:
        safe = torch.where(zero | (b.data == -1), torch.ones_like(b.data),
                           b.data)
    m = torch.remainder(a.data, safe)
    m = torch.where(m < 0, m + torch.abs(safe), m)
    return CV(m, and_validity(a, b) & ~zero)


def negate(a: CV) -> CV:
    return CV(-a.data, a.validity)


def abs_(a: CV) -> CV:
    return CV(torch.abs(a.data), a.validity)


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


# ----------------------------------------------------------------------
# Null predicates
# ----------------------------------------------------------------------
def is_null(a: CV) -> CV:
    out = ~a.validity
    return CV(out, torch.ones_like(out))


def is_not_null(a: CV) -> CV:
    return CV(a.validity.clone(), torch.ones_like(a.validity))


def is_nan(a: CV) -> CV:
    if a.data.is_floating_point():
        return CV(torch.isnan(a.data), a.validity)
    return CV(torch.zeros_like(a.validity), a.validity)
