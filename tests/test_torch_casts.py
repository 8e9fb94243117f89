"""CAST in the port against the JAX package on the CPU: every (from, to)
pair over boolean, the integers, float, double, decimal64, decimal128,
string, date and timestamp, named by type strings ("bigint",
"decimal(30,4)"), over seeded columns with nulls, the types' extremes,
NaN, +-infinity and -0.0, malformed and padded strings, dates before
1970 and past 2038 and timestamps before the epoch.

Every pair the JAX `Cast` accepts runs through both packages; each
result is exact, but a double computed by a division by a power of ten
(from a decimal or a timestamp: XLA multiplies by the reciprocal, the
port divides, ROADMAP C.3), which may be one unit in the last place
off. Where the JAX package cannot return the result (`REFERENCE_BREAKS`:
its output conversion or its device path fails, ROADMAP C.2 and C.17),
the port is held to Python's decimal arithmetic instead. Every pair the
JAX `Cast` refuses, the port refuses with the same UnsupportedExpr.
"""
import datetime as dtm
import decimal

import pyarrow as pa
import pytest

import spark_rapids_tpu.columnar.dtypes as jdt
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.columnar.dtypes as pdt
import spark_rapids_tpu_torch.functions as PF
from torch_cast_cases import TYPES, check_matrix, check_refused
from torch_parity import assert_same_column, project

#: the string source runs in test_torch_cast_strings.py (its JAX compiles
#: take most of the time: a file of its own runs beside this one)
SOURCES = [t for t in TYPES if t != "string"]


@pytest.mark.parametrize("fr", SOURCES)
def test_cast_matrix(fr):
    check_matrix(fr)


@pytest.mark.parametrize("fr", SOURCES)
def test_refused_pairs_refused_alike(fr):
    check_refused(fr)


NAMES = ["boolean", "bool", "byte", "tinyint", "short", "smallint", "int",
         "integer", "long", "bigint", "float", "real", "double", "string",
         "binary", "date", "timestamp", " BigInt ", "decimal",
         "decimal(10,2)", "DECIMAL(38, 10)", "decimal(5)"]


def test_type_names_resolve_alike():
    for name in NAMES:
        j, p = jdt.from_name(name), pdt.from_name(name)
        assert (type(j).__name__, getattr(j, "precision", None),
                getattr(j, "scale", None)) == \
            (type(p).__name__, getattr(p, "precision", None),
             getattr(p, "scale", None)), name
    for bad in ("varchar", "decimal(", "map<int,int>"):
        with pytest.raises(ValueError):
            pdt.from_name(bad)


def test_literals_and_null_casts():
    """Timestamp and decimal128 literals, and NULL cast to each type (to
    a decimal128 against None alone: the JAX cast of NULL emits one
    int64 where [n, 2] words are due, ROADMAP C.17)."""
    data = {"k": pa.array([1, 2, 3])}
    lits = [dtm.datetime(2001, 2, 3, 4, 5, 6, 7),
            dtm.datetime(1950, 1, 1, tzinfo=dtm.timezone.utc),
            decimal.Decimal("-12345678901234567890.123"),
            decimal.Decimal("9" * 38)]
    to_types = [t for t in TYPES if t != "decimal(30,4)"]
    jt, ptab = project(data, lambda F: [F.lit(v) for v in lits]
                       + [F.lit(None).cast(to) for to in to_types])
    for i in range(jt.num_columns):
        assert_same_column(jt.column(i), ptab.column(i), f"literal {i}")
    s = pt.TpuSession({}, device="cpu")
    out = s.create_dataframe(data).select(
        PF.lit(None).cast("decimal(30,4)").alias("n")).to_arrow()
    assert out.column(0).type == pa.decimal128(30, 4)
    assert out.column(0).to_pylist() == [None] * 3


def test_string_renderings_size_from_the_bound_without_host_reads():
    """A cast to a string sizes its byte buffer from the JAX package's
    bound (20 bytes a row for an integer, 22 for a scaled decimal, 10
    for a date, 26 for a timestamp, 5 for a boolean) and reads nothing
    back from the device on the way (`utils/transfer.syncs`)."""
    import torch

    from spark_rapids_tpu_torch.ops import cast_strings as cs
    from spark_rapids_tpu_torch.ops.kernel_utils import CV
    from spark_rapids_tpu_torch.utils import transfer
    n = 33
    valid = torch.ones(n, dtype=torch.bool)
    x = torch.arange(-16, 17, dtype=torch.int64) * 987654321
    before = transfer.syncs
    cases = [(cs.int_to_string(CV(x, valid)), 20),
             (cs.decimal_to_string(CV(x, valid), 3), 22),
             (cs.date_to_string(CV(x.to(torch.int32) % 50000, valid)), 10),
             (cs.timestamp_to_string(CV(x * 1000, valid)), 26),
             (cs.bool_to_string(CV(x > 0, valid)), 5)]
    assert transfer.syncs == before
    for out, width in cases:
        assert out.data.shape[0] == n * width
        assert int(out.offsets[-1]) <= n * width
