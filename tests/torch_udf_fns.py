"""Module-level (picklable) functions for the UDF and pandas-exec tests
of the port (`test_torch_udf.py`, `test_torch_python_exec.py`,
`test_torch_profiler.py`). A spawned python worker imports this module
to unpickle them, so it imports numpy and pandas only: never JAX, torch
or a test module.

The UDF bodies are plain functions, one to a source statement, because
the UDF compiler reads their source (`inspect.getsource`)."""
import math

import numpy as np
import pandas as pd

K = 7


# ---- UDF bodies (the compiler's subset, and outside it) ---------------
def arith(a, b):
    return a * 2 + b - 1


def clamped(a, b):
    return a if a > b else b


def abs_plus_one(a):
    return abs(a) + 1


def root(b):
    return math.sqrt(b)


def plus_k(a):
    return a + K


def chain_compare(a, b):
    return 0 < a <= b


def null_or_neg(a):
    return -a if a is not None else 0


def mixed(a, b):
    return max(a, b) - min(a, b) if (a > 0) and not (b > 10) else a % 3


def weird(a):
    return np.square(a)  # numpy call: outside the subset


def upper(s):
    return s.upper()


def loopy(a):
    t = 0
    for _ in range(3):
        t += a
    return t


def two_statements(a):
    b = a + 1
    return b


def power(a):
    return a ** 2


def floordiv(a):
    return a // 2


def keyword(a):
    return round(a, ndigits=1)


def is_true(a):
    return a is True  # `is` against a constant other than None


def unresolved(a):
    return a + NOT_DEFINED  # noqa: F821


def not_constant(a):
    return a + np.pi * 0 + len(K_LIST)


K_LIST = [1, 2]


def boom(a):
    raise ValueError("udf says no")


def decimal_cents(a):
    return a // 100


def scaled_sum(a, b):
    return a * 0.5 + b


# ---- pandas transforms ------------------------------------------------
def double_and_tag(pdf: pd.DataFrame) -> pd.DataFrame:
    return pd.DataFrame({"k": pdf["k"], "v2": pdf["v"] * 2.0,
                         "tag": ["x" + str(int(k)) for k in pdf["k"]]})


def drop_all(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf.iloc[0:0]


def pandas_boom(pdf: pd.DataFrame) -> pd.DataFrame:
    raise ValueError("python says no")


def top2_by_v(g: pd.DataFrame) -> pd.DataFrame:
    """The two largest v of a group (ties by w)."""
    return g.sort_values(["v", "w"], ascending=False).head(2)


def group_size(g: pd.DataFrame) -> pd.DataFrame:
    return pd.DataFrame({"k": [g["k"].iloc[0]], "n": [len(g)],
                         "s": [float(g["v"].sum())]})


def median_of(s: pd.Series) -> float:
    return float(s.median())


def count_of(s: pd.Series) -> int:
    return int(s.count())


def spread(a: pd.Series, b: pd.Series) -> float:
    return float((a - b).max())


def cogroup_counts(left: pd.DataFrame, right: pd.DataFrame):
    key = left["k"].iloc[0] if len(left) else right["k2"].iloc[0]
    return pd.DataFrame({"k": [key], "nl": [len(left)], "nr": [len(right)],
                         "sl": [float(left["v"].sum())],
                         "sr": [float(right["u"].sum())]})


def identity(pdf: pd.DataFrame) -> pd.DataFrame:
    return pdf
