"""CAST from a string column in the port against the JAX package on
the CPU: to boolean, every integer width, float, double, decimal64,
decimal128, date and timestamp, over padded, signed, exponent, malformed
and out-of-range strings (`torch_cast_cases.column("string")`); and the
casts that render strings, whose sources `test_torch_casts.py` holds.
Exact: a string parses to the JAX package's bits (the double parse
included: each digit step one fused multiply-add and correctly rounded
powers of ten, as XLA's CPU compile computes them); the `Cast` pairs
the JAX package refuses, the port refuses alike.
"""
from torch_cast_cases import check_matrix, check_refused


def test_cast_from_string():
    check_matrix("string")


def test_refused_from_string():
    check_refused("string")
