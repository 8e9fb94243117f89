"""MIN, MAX and DISTINCT of the PyTorch port (on the CPU) against the JAX
package.

One Arrow table of random columns with about 10 % nulls (int32, int64,
a date, doubles and floats holding NaN, -0.0, 0.0 and infinities,
decimal(12,2) and decimal(30,4) near both signs) and a group key whose
groups include one with every value null, one with every double NaN and
one where -0.0 and 0.0 tie; the aggregates run ungrouped, grouped in one
batch (a complete aggregate) and grouped over 256-row batches (partial
-> exchange -> final, the decimal128 states through the exchange), and
over an empty input. The results must be equal to the JAX package's,
the doubles bit for bit (NaN and the sign of zero included): a min over
only NaN is +Infinity, a max with a NaN is NaN, -0.0 orders below 0.0.
The JAX package cannot hand back a grouped min or max of a date or a
decimal (the identity its null or padded rows hold fails its Arrow
conversion: ROADMAP C), so those are held to an exact Python reference
instead.
DISTINCT (and dropDuplicates) on string, int, date and decimal columns
with nulls, in one batch and over many. A min over strings is refused
in both packages.
"""
import decimal
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.expr import expressions as jx
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.expr import expressions as px
from spark_rapids_tpu_torch.expr.aggregates import float_key, key_float

D = decimal.Decimal
N = 3000
SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 256}

JAX = types.SimpleNamespace(col=jx.col, lit=jx.lit, F=JF)
PORT = types.SimpleNamespace(col=px.col, lit=px.lit, F=PF)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(11)
    k = rng.integers(0, 30, N).astype(np.int64)

    def nulls():
        m = rng.random(N) < 0.1
        return m | (k == 0)         # group 0: every value null
    f = rng.normal(size=N) * 50
    f[rng.random(N) < 0.05] = np.nan
    f[rng.random(N) < 0.03] = np.inf
    f[rng.random(N) < 0.03] = -np.inf
    f[k == 1] = np.nan              # group 1: only NaN
    f[k == 2] = np.where(rng.random((k == 2).sum()) < 0.5, -0.0, 0.0)
    big = [int(v) * 10**12 + int(w) for v, w in zip(
        rng.integers(-10**14, 10**14, N), rng.integers(0, 10**12, N))]
    return pa.table({
        "k": pa.array(k),
        "i": pa.array(rng.integers(-10**6, 10**6, N).astype(np.int32),
                      mask=nulls()),
        "j": pa.array(rng.integers(-2**62, 2**62, N), mask=nulls()),
        "day": pa.array(rng.integers(0, 20000, N).astype(np.int32),
                        mask=nulls()).cast(pa.date32()),
        "f": pa.array(f, mask=nulls()),
        "h": pa.array(f.astype(np.float32), mask=nulls()),
        "d": pa.array([D(int(v)).scaleb(-2) for v in
                       rng.integers(-10**11, 10**11, N)],
                      pa.decimal128(12, 2), mask=nulls()),
        "e": pa.array([D(v).scaleb(-4) for v in big],
                      pa.decimal128(30, 4), mask=nulls()),
        "s": pa.array(np.array(["x", "yy", "", "zzz"])[
            rng.integers(0, 4, N)], mask=nulls())})


COLUMNS = ("i", "j", "day", "f", "h", "d", "e")
#: the columns whose grouped min and max the JAX package hands back
GROUPED_COLUMNS = ("i", "j", "f", "h")


def _aggs(E, columns=COLUMNS):
    return [E.F.min(c).alias(f"min_{c}") for c in columns] + \
        [E.F.max(c).alias(f"max_{c}") for c in columns]


def _values(at):
    """Rows as tuples, doubles as their bits (NaN and -0.0 exact)."""
    cols = []
    for name in at.column_names:
        col = at.column(name).combine_chunks()
        if pa.types.is_floating(col.type):
            width = {32: np.int32, 64: np.int64}[col.type.bit_width]
            bits = col.fill_null(0).to_numpy().view(width)
            cols.append([int(b) if v else None for b, v in zip(
                bits, col.is_valid().to_numpy(zero_copy_only=False))])
        else:
            cols.append(col.to_pylist())
    return list(zip(*cols))


def _both(table, build, conf=None):
    got = build(PORT, pt.TpuSession(dict(conf or {}), device="cpu")
                .create_dataframe(table)).to_arrow()
    exp = build(JAX, st.TpuSession(dict(conf or {}))
                .create_dataframe(table)).to_arrow()
    assert got.schema == exp.schema
    return got, exp


@pytest.mark.parametrize("conf", [{}, SMALL], ids=["one_batch", "batches"])
def test_ungrouped_min_max_equals_jax(table, conf):
    got, exp = _both(table, lambda E, df: df.agg(*_aggs(E)), conf)
    assert _values(got) == _values(exp)


@pytest.mark.parametrize("conf", [{}, SMALL],
                         ids=["complete", "partial_final"])
def test_grouped_min_max_equals_jax(table, conf):
    got, exp = _both(table, lambda E, df: df.group_by("k").agg(
        *_aggs(E, GROUPED_COLUMNS)).sort("k"), conf)
    assert _values(got) == _values(exp)
    rows = {r[0]: r for r in got.to_pylist() for r in [tuple(r.values())]}
    names = got.column_names
    assert all(v is None for v in rows[0][1:])          # all null
    nan_group = dict(zip(names, rows[1]))
    assert nan_group["min_f"] == float("inf")            # min over NaN
    assert np.isnan(nan_group["max_f"])
    zero_group = dict(zip(names, rows[2]))
    assert str(zero_group["min_f"]) == "-0.0"
    assert str(zero_group["max_f"]) == "0.0"


@pytest.mark.parametrize("conf", [{}, SMALL],
                         ids=["complete", "partial_final"])
def test_grouped_date_and_decimal_min_max(table, conf):
    """Against an exact Python reference: per group, the least and the
    greatest valid value, None where every value is null."""
    got = pt.TpuSession(dict(conf), device="cpu").create_dataframe(table) \
        .group_by("k").agg(*_aggs(PORT, ("day", "d", "e"))).sort("k") \
        .to_arrow()
    ks = table.column("k").to_pylist()
    for c in ("day", "d", "e"):
        vals = table.column(c).to_pylist()
        groups = {}
        for k, v in zip(ks, vals):
            groups.setdefault(k, [])
            if v is not None:
                groups[k].append(v)
        keys = sorted(groups)
        assert got.column("k").to_pylist() == keys
        assert got.column(f"min_{c}").to_pylist() == [
            min(groups[k]) if groups[k] else None for k in keys]
        assert got.column(f"max_{c}").to_pylist() == [
            max(groups[k]) if groups[k] else None for k in keys]


def test_min_max_mixed_with_sum_and_count(table):
    """min/max states beside sum/count states through partial ->
    final, with a string key."""
    got, exp = _both(table, lambda E, df: df.group_by("s").agg(
        E.F.max("j").alias("a"), E.F.sum("d").alias("b"),
        E.F.min("h").alias("c"), E.F.count("*").alias("n"),
        E.F.min("f").alias("m")).sort("s"), SMALL)
    assert _values(got) == _values(exp)


def test_min_max_over_empty_input(table):
    got, exp = _both(table, lambda E, df: df.filter(
        E.col("k") < 0).agg(*_aggs(E, GROUPED_COLUMNS)))
    assert _values(got) == _values(exp)
    got = pt.TpuSession(device="cpu").create_dataframe(table).filter(
        px.col("k") < 0).agg(*_aggs(PORT)).to_arrow()
    assert got.num_rows == 1 and all(v is None for v in _values(got)[0])
    got, exp = _both(table, lambda E, df: df.filter(
        E.col("k") < 0).group_by("k").agg(*_aggs(E, GROUPED_COLUMNS)))
    assert got.num_rows == 0 and got.schema == exp.schema


def test_min_over_strings_is_refused_in_both(table):
    with pytest.raises(jx.UnsupportedExpr):
        st.TpuSession().create_dataframe(table).agg(
            JF.min("s").alias("m")).to_arrow()
    with pytest.raises(px.UnsupportedExpr):
        pt.TpuSession(device="cpu").create_dataframe(table).agg(
            PF.min("s").alias("m")).to_arrow()


def test_float_key_orders_like_the_reference():
    """-inf < negatives < -0.0 < 0.0 < positives < inf < NaN, and back."""
    x = torch.tensor([float("-inf"), -3.5, -1e-300, -0.0, 0.0, 1e-300,
                      2.0, float("inf"), float("nan")], dtype=torch.float64)
    k = float_key(x)
    assert torch.all(k[1:] > k[:-1])
    back = key_float(k, torch.float64)
    assert torch.equal(back[:-1].view(torch.int64), x[:-1].view(torch.int64))
    assert torch.isnan(back[-1])
    y = torch.tensor([float("-inf"), -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0,
                      float("inf"), float("nan")], dtype=torch.float32)
    assert torch.all(float_key(y)[1:] > float_key(y)[:-1])


@pytest.mark.parametrize("conf", [{}, SMALL], ids=["one_batch", "batches"])
@pytest.mark.parametrize("cols", [("s",), ("s", "i"), ("k", "day", "d")])
def test_distinct_equals_jax(table, conf, cols):
    got, exp = _both(table, lambda E, df: df.select(*cols).distinct()
                     .sort(*cols), conf)
    assert got.num_rows > 1 and got.equals(exp)


def test_drop_duplicates_is_distinct(table):
    df = pt.TpuSession(dict(SMALL), device="cpu").create_dataframe(table)
    a = df.select("s", "k").dropDuplicates().sort("s", "k").to_arrow()
    b = df.select("s", "k").distinct().sort("s", "k").to_arrow()
    assert a.equals(b) and a.num_rows == len(set(zip(
        table.column("s").to_pylist(), table.column("k").to_pylist())))
