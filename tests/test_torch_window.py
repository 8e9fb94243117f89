"""Window functions of the PyTorch port (on the CPU) against the JAX
package: a twin of every test of `tests/test_window.py`, under the same
name, over the same seeded inputs. Each runs its query through both
packages and requires the port's rows to equal the JAX package's exactly
(the doubles here are ranks, fractions of counts and integer-valued
sums below 2^53, where the JAX prefix sums are exact), and holds them to
the test's Python reference too. Rows are compared as sorted lists:
Spark promises no output order, and tied rows are indistinguishable.
"""
import types
from collections import Counter, defaultdict

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.window as JW
from spark_rapids_tpu.expr.expressions import col as jcol
from spark_rapids_tpu.plan.logical import SortOrder as JSortOrder
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.window as PW
from spark_rapids_tpu_torch.expr.expressions import col as pcol
from spark_rapids_tpu_torch.plan.logical import SortOrder as PSortOrder

from data_gen import IntegerGen, StringGen, gen_arrow_table
from torch_parity import JAX_CONF

JAX = types.SimpleNamespace(W=JW, col=jcol, SortOrder=JSortOrder)
PORT = types.SimpleNamespace(W=PW, col=pcol, SortOrder=PSortOrder)
#: the JAX tests' session conf
CONF = {"spark.rapids.tpu.sql.batchSizeRows": 4096}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run_both(data, make, conf=None):
    """(JAX table, port table) of `make(df, pkg)` over `data`."""
    conf = {**CONF, **(conf or {})}
    js = st.TpuSession({**JAX_CONF, **conf})
    ps = pt.TpuSession(conf, device="cpu")
    return (make(js.create_dataframe(data), JAX).to_arrow(),
            make(ps.create_dataframe(data), PORT).to_arrow())


def _key(r):
    return tuple((v is None, v) for v in r)


def rows(at):
    """The rows of a table, sorted (nulls last)."""
    return sorted(zip(*[at.column(i).to_pylist()
                        for i in range(at.num_columns)]), key=_key)


def assert_same_rows(jt, ptab):
    assert jt.schema.types == ptab.schema.types, (jt.schema, ptab.schema)
    assert jt.column_names == ptab.column_names
    assert rows(jt) == rows(ptab)


def _groups(at, kcol):
    g = defaultdict(list)
    for r in zip(*[at.column(i).to_pylist() for i in range(at.num_columns)]):
        g[r[kcol]].append(r)
    return g


def test_row_number_rank():
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=5, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=20, nullable=False))],
                         600, 70)

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("v")
        return df.select("k", "v", p.W.row_number().over(w).alias("rn"),
                         p.W.rank().over(w).alias("rk"),
                         p.W.dense_rank().over(w).alias("dr"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = []
    for k, rs in _groups(at, 0).items():
        vs = sorted(r[1] for r in rs)
        first = {v: vs.index(v) + 1 for v in vs}
        dense = {v: i + 1 for i, v in enumerate(sorted(set(vs)))}
        exp += [(k, v, i + 1, first[v], dense[v]) for i, v in enumerate(vs)]
    assert rows(ptab) == sorted(exp, key=_key)


def test_running_and_total_sum():
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=4, nullable=False)),
                          ("o", IntegerGen(lo=0, hi=10**6, nullable=False)),
                          ("v", IntegerGen(lo=-100, hi=100))], 500, 71)

    def q(df, p):
        W = p.W
        w = W.Window.partition_by("k").order_by("o")
        wt = w.rows_between(W.Window.unboundedPreceding,
                            W.Window.unboundedFollowing)
        v = p.col("v")
        return df.select("k", "o", "v", W.win_sum(v).over(w).alias("run"),
                         W.win_sum(v).over(wt).alias("tot"),
                         W.win_count(v).over(w).alias("cnt"),
                         W.win_min(v).over(w).alias("rmin"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = []
    for k, rs in _groups(at, 0).items():
        tot = [r[2] for r in rs if r[2] is not None]
        for k_, o, v in rs:
            vals = [r[2] for r in rs if r[1] <= o and r[2] is not None]
            exp.append((k_, o, v, sum(vals) if vals else None,
                        sum(tot) if tot else None, len(vals),
                        min(vals) if vals else None))
    assert rows(ptab) == sorted(exp, key=_key)


def test_lag_lead():
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=3, nullable=False)),
                          ("o", IntegerGen(lo=0, hi=10**6, nullable=False)),
                          ("v", IntegerGen(nullable=False))], 300, 72)

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select("k", "o", p.W.lag(p.col("v")).over(w).alias("lg"),
                         p.W.lead(p.col("v"), 2).over(w).alias("ld"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = []
    for k, rs in _groups(at, 0).items():
        rs = sorted(rs, key=lambda r: r[1])
        for i, (k_, o, _) in enumerate(rs):
            exp.append((k_, o, rs[i - 1][2] if i else None,
                        rs[i + 2][2] if i + 2 < len(rs) else None))
    assert rows(ptab) == sorted(exp, key=_key)


def test_sliding_frame_sum():
    at = gen_arrow_table([("o", IntegerGen(lo=0, hi=10**7, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=100, nullable=False))],
                         200, 73)

    def q(df, p):
        w = p.W.Window.order_by("o").rows_between(-2, 2)
        return df.select("o", p.W.win_sum(p.col("v")).over(w).alias("s"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    rs = sorted(zip(at.column(0).to_pylist(), at.column(1).to_pylist()))
    exp = [(o, sum(r[1] for r in rs[max(0, i - 2):i + 3]))
           for i, (o, _) in enumerate(rs)]
    assert rows(ptab) == sorted(exp)


def test_window_string_partition_keys():
    at = gen_arrow_table([("k", StringGen(max_len=6, charset="ab")),
                          ("v", IntegerGen(nullable=False))], 400, 75)

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("v")
        return df.select("k", "v", p.W.row_number().over(w).alias("rn"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    groups = defaultdict(list)
    for k, v in zip(at.column(0).to_pylist(), at.column(1).to_pylist()):
        groups[k].append(v)
    exp = [(k, v, i + 1) for k, vs in groups.items()
           for i, v in enumerate(sorted(vs))]
    assert rows(ptab) == sorted(exp, key=_key)


def test_default_frame_includes_peers():
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=4, nullable=False)),
                          ("o", IntegerGen(lo=0, hi=8, nullable=False)),
                          ("v", IntegerGen(lo=-50, hi=50, nullable=False))],
                         400, 76)

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select("k", "o", "v",
                         p.W.win_sum(p.col("v")).over(w).alias("s"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = [(k_, o, v, sum(r[2] for r in rs if r[1] <= o))
           for rs in _groups(at, 0).values() for k_, o, v in rs]
    assert rows(ptab) == sorted(exp)


def test_bounded_minmax_rows_frame():
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=3, nullable=False)),
                          ("o", IntegerGen(lo=0, hi=10**6, nullable=False)),
                          ("v", IntegerGen(lo=-100, hi=100))], 500, 77)

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o").rows_between(-3, 2)
        return df.select("k", "o", "v",
                         p.W.win_min(p.col("v")).over(w).alias("mn"),
                         p.W.win_max(p.col("v")).over(w).alias("mx"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = []
    for rs in _groups(at, 0).values():
        rs = sorted(rs, key=lambda r: r[1])
        for i, (k_, o, v) in enumerate(rs):
            vals = [r[2] for r in rs[max(0, i - 3):i + 3] if r[2] is not None]
            exp.append((k_, o, v, min(vals) if vals else None,
                        max(vals) if vals else None))
    assert rows(ptab) == sorted(exp, key=_key)


def test_range_frame_sum_minmax():
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=3, nullable=False)),
                          ("o", IntegerGen(lo=0, hi=30, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=100, nullable=False))],
                         400, 78)

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o").range_between(-5, 5)
        return df.select("k", "o", "v",
                         p.W.win_sum(p.col("v")).over(w).alias("s"),
                         p.W.win_max(p.col("v")).over(w).alias("mx"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = []
    for rs in _groups(at, 0).values():
        for k_, o, v in rs:
            fr = [r[2] for r in rs if o - 5 <= r[1] <= o + 5]
            exp.append((k_, o, v, sum(fr), max(fr)))
    assert rows(ptab) == sorted(exp)


def test_range_frame_descending():
    at = gen_arrow_table([("o", IntegerGen(lo=0, hi=50, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=100, nullable=False))],
                         300, 79)

    def q(df, p):
        w = p.W.Window.order_by(p.SortOrder(p.col("o"), ascending=False)) \
            .range_between(-5, 5)
        return df.select("o", "v", p.W.win_sum(p.col("v")).over(w).alias("s"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    rs = list(zip(at.column(0).to_pylist(), at.column(1).to_pylist()))
    exp = [(o, v, sum(r[1] for r in rs if o - 5 <= r[0] <= o + 5))
           for o, v in rs]
    assert rows(ptab) == sorted(exp)


def test_ranking_extras():
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=4, nullable=False)),
                          ("o", IntegerGen(lo=0, hi=10, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=100, nullable=False))],
                         350, 80)

    def q(df, p):
        w = p.W.Window.partition_by("k").order_by("o")
        return df.select("k", "o", p.W.percent_rank().over(w).alias("pr"),
                         p.W.cume_dist().over(w).alias("cd"),
                         p.W.ntile(3).over(w).alias("nt"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = []
    for rs in _groups(at, 0).values():
        rs = sorted(rs, key=lambda r: r[1])
        cnt = len(rs)
        for i, (k_, o, _) in enumerate(rs):
            rk = sum(1 for r in rs if r[1] < o) + 1
            pe = max(j for j, r in enumerate(rs) if r[1] == o)
            qq, rem = divmod(cnt, 3)
            big = rem * (qq + 1)
            nt = (i // (qq + 1) if i < big
                  else rem + (i - big) // qq if qq else 0) + 1
            exp.append((k_, o, (rk - 1) / (cnt - 1) if cnt > 1 else 0.0,
                        (pe + 1) / cnt, nt))
    assert rows(ptab) == sorted(exp)


def test_value_functions():
    rng = np.random.default_rng(81)
    n = 300
    at = pa.table({"k": rng.integers(0, 4, n),
                   "o": rng.permutation(n).astype(np.int64),
                   "v": rng.integers(0, 100, n)})

    def q(df, p):
        W = p.W
        w = W.Window.partition_by("k").order_by("o")
        wr = w.rows_between(-2, 1)
        v = p.col("v")
        return df.select("k", "o", W.first_value(v).over(wr).alias("fv"),
                         W.last_value(v).over(w).alias("lv"),
                         W.nth_value(v, 3).over(wr).alias("nv"))
    jt, ptab = run_both(at, q)
    assert_same_rows(jt, ptab)
    exp = []
    for rs in _groups(at, 0).values():
        rs = sorted(rs, key=lambda r: r[1])
        for i, (k_, o, _) in enumerate(rs):
            lo, hi = max(0, i - 2), min(len(rs) - 1, i + 1)
            exp.append((k_, o, rs[lo][2], rs[i][2],
                        rs[lo + 2][2] if lo + 2 <= hi else None))
    assert rows(ptab) == sorted(exp, key=_key)


def test_multiple_window_specs_one_select():
    at = gen_arrow_table([("a", IntegerGen(lo=0, hi=4, nullable=False)),
                          ("b", IntegerGen(lo=0, hi=4, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=100, nullable=False))],
                         300, 82)

    def q(df, p):
        wa = p.W.Window.partition_by("a").order_by("v", "b")
        wb = p.W.Window.partition_by("b").order_by("v", "a")
        return df.select("a", "b", "v",
                         p.W.row_number().over(wa).alias("ra"),
                         p.W.row_number().over(wb).alias("rb"))
    jt, ptab = run_both(at, q)
    assert jt.schema.types == ptab.schema.types
    # duplicate (a, b, v) rows pair ra with rb in any order: compare the
    # multisets of (a, b, v, ra) and (a, b, v, rb) apart
    for i in (3, 4):
        for t in (jt, ptab):
            assert t.num_rows == at.num_rows
        got = [Counter(zip(*[t.column(c).to_pylist() for c in (0, 1, 2, i)]))
               for t in (jt, ptab)]
        assert got[0] == got[1]
    src = list(zip(*[at.column(i).to_pylist() for i in range(3)]))
    exp = Counter()
    for a in {r[0] for r in src}:
        grp = sorted([r for r in src if r[0] == a], key=lambda r: (r[2], r[1]))
        exp.update(r + (i + 1,) for i, r in enumerate(grp))
    assert Counter(zip(*[ptab.column(c).to_pylist()
                         for c in (0, 1, 2, 3)])) == exp


def _chunk_data_running():
    rng = np.random.default_rng(41)
    n = 20_000
    return {"k": pa.array(rng.integers(0, 50, n).astype(np.int64)),
            "o": pa.array(rng.integers(0, 10_000, n).astype(np.int64)),
            "v": pa.array(rng.integers(-100, 100, n).astype(np.int64))}


def test_chunked_running_windows_match_incore():
    """Forced small chunk and sort budgets make a real chunk stream: its
    rows equal the in-core path's and the JAX package's."""
    data = _chunk_data_running()

    def q(df, p):
        W = p.W
        w = W.Window.partition_by("k").order_by("o")
        v = p.col("v")
        return df.select(p.col("k"), p.col("o"), v,
                         W.row_number().over(w).alias("rn"),
                         W.rank().over(w).alias("rk"),
                         W.dense_rank().over(w).alias("dr"),
                         W.win_sum(v).over(w).alias("rs"),
                         W.win_min(v).over(w).alias("rm"),
                         W.win_count(v).over(w).alias("rc"))
    j_in, p_in = run_both(data, q)
    j_ch, p_ch = run_both(data, q, {
        "spark.rapids.tpu.sql.window.chunkRows": 2048,
        "spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes": 64 << 10})
    assert rows(p_ch) == rows(p_in) == rows(j_in) == rows(j_ch)


def test_chunked_window_ties_and_nulls():
    """Order-key ties across chunk edges (the peer-group holdback) and
    null partition keys."""
    rng = np.random.default_rng(42)
    n = 8000
    keys = [None if i % 13 == 0 else int(k)
            for i, k in enumerate(rng.integers(0, 4, n))]
    data = {"k": pa.array(keys, pa.int64()),
            "o": pa.array(rng.integers(0, 6, n).astype(np.int64)),
            "v": pa.array(rng.integers(0, 50, n).astype(np.int64))}

    def q(df, p):
        W = p.W
        w = W.Window.partition_by("k").order_by("o")
        return df.select(p.col("k"), p.col("o"), p.col("v"),
                         W.rank().over(w).alias("rk"),
                         W.dense_rank().over(w).alias("dr"),
                         W.win_sum(p.col("v")).over(w).alias("rs"))
    j_in, p_in = run_both(data, q)
    j_ch, p_ch = run_both(data, q, {
        "spark.rapids.tpu.sql.batchSizeRows": 1024,
        "spark.rapids.tpu.sql.window.chunkRows": 1024,
        "spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes": 16 << 10})
    assert rows(p_ch) == rows(p_in) == rows(j_in) == rows(j_ch)


def test_with_column_and_the_functions_module():
    """`with_column` routes a window expression through `select`, and
    the functions modules' window names (pyspark's `F.rank`, `F.lag`
    ...) build the same expressions in both packages."""
    import spark_rapids_tpu.functions as JF
    import spark_rapids_tpu_torch.functions as PF
    at = gen_arrow_table([("k", IntegerGen(lo=0, hi=6, nullable=False)),
                          ("o", IntegerGen(lo=0, hi=10 ** 6,
                                           nullable=False)),
                          ("v", IntegerGen(lo=-50, hi=50))], 400, 83)

    def q(df, p):
        F = JF if p is JAX else PF
        w = p.W.Window.partition_by("k").order_by("o")
        return df.with_column("r", F.rank().over(w)) \
            .with_column("lg", F.lag("v", 2, 0).over(w)) \
            .with_column("nv", F.nth_value("v", 3).over(w)) \
            .with_column("cd", F.cume_dist().over(w))
    jt, ptab = run_both(at, q)
    assert ptab.column_names == ["k", "o", "v", "r", "lg", "nv", "cd"]
    assert_same_rows(jt, ptab)


def test_window_binds_refuse_what_the_reference_refuses():
    """A ranking function without ORDER BY and an aggregate over strings
    are refused at bind (UnsupportedExpr), in both packages."""
    from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JU
    from spark_rapids_tpu_torch.expr.expressions import UnsupportedExpr as PU
    at = pa.table({"k": [1, 2], "s": ["a", "b"]})
    for pkg, sess, err in ((JAX, st.TpuSession(JAX_CONF), JU),
                           (PORT, pt.TpuSession({}, device="cpu"), PU)):
        df = sess.create_dataframe(at)
        with pytest.raises(err):
            df.select(pkg.W.rank().over(pkg.W.Window.partition_by("k")))
        with pytest.raises(err):
            df.select(pkg.W.win_max(pkg.col("s")).over(
                pkg.W.Window.partition_by("k")))


def test_every_name_of_the_jax_window_module():
    """The port's `window.py` has every public name of the JAX module,
    the frame constants with the same meaning."""
    names = set(JW.__all__) | {
        n for n in dir(JW) if not n.startswith("_")
        and getattr(getattr(JW, n), "__module__", None) == JW.__name__}
    missing = sorted(n for n in names if not hasattr(PW, n))
    assert not missing, missing
    assert PW.CURRENT_ROW == JW.CURRENT_ROW == 0
    assert set(JW.__all__) == set(PW.__all__)
    assert PW.Window.unboundedPreceding is PW.UNBOUNDED
