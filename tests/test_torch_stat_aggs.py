"""first / last, variance / stddev, approx_count_distinct and
percentile_approx in the PyTorch port (on the CPU) against the JAX
package, the cases of its `tests/test_aggregate.py:140-204` and
`tests/test_distinct_percentile.py`, and plain Python.

Each aggregate runs grouped and ungrouped, on one input partition
(complete) and on many (partial -> exchange -> final, the states on the
wire), with nulls, an empty input, an all-null group and the
cancellation case (values near 1e9 differing by one). One run goes under
the memory runtime's constrained conf (a 256 KiB device budget and a
merge bound far below the groups), where the final aggregate parks its
partial states in the spill store and splits them into hash buckets:
every state column of the new aggregates must ride that split.

Tolerances, against the JAX package on the same input:
  - first / last (value and null), counts, the HLL registers and
    approx_count_distinct's estimate: exact (the registers are the JAX
    package's words bit for bit, so the estimate is too);
  - variance and stddev: a relative 1e-12 (both sum the same squares,
    in another order);
  - percentile_approx: a relative 1e-9 of the JAX package's value (the
    same centroids from float sums in another order), and the value's
    rank within 0.05 of the asked percentage (the JAX suite's bound;
    the t-digest's worst bucket error is about pi / (2C) = 0.012 at the
    median for C = 128).
Against Python: the sample variance within a relative 1e-9.
"""
import math
import statistics

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.expr import aggregates as jagg
from spark_rapids_tpu.ops.kernel_utils import CV as JCV
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.expr import aggregates as pagg
from spark_rapids_tpu_torch.ops.kernel_utils import CV

N = 3000
MANY = {"spark.rapids.tpu.sql.batchSizeRows": 256}
VAR_RTOL = 1e-12
TDIGEST_RTOL = 1e-9


def _table(seed=1, n=N):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 9, n)
    x = rng.standard_normal(n) * 100
    xv = rng.random(n) > 0.1
    xv[k == 8] = False                          # an all-null group
    i = rng.integers(0, 400, n)
    iv = rng.random(n) > 0.05
    return pa.table({
        "k": pa.array(k.astype(np.int32)),
        "x": pa.array(x, mask=~xv),
        "i": pa.array(i.astype(np.int64), mask=~iv),
        "d": pa.array([int(v) * 7 for v in i], pa.decimal128(12, 2)),
        "s": pa.array([f"s{v % 53}" for v in i])})


def _aggs(F, accuracy=2000):
    # the JAX side compiles one program a state width: its comparisons
    # keep the sketches narrow (rsd 0.1 is 16 state columns, accuracy
    # 2000 is 82); the default widths run in test_against_python
    return [F.first("i").alias("f"), F.last("i").alias("l"),
            F.first("i", True).alias("fi"), F.last("x", True).alias("lx"),
            F.first("d").alias("fd"),
            F.stddev("x").alias("sd"), F.variance("x").alias("var"),
            F.stddev_samp("d").alias("sdd"), F.var_samp("i").alias("vi"),
            F.approx_count_distinct("i").alias("acd"),
            F.approx_count_distinct("s", 0.1).alias("acds"),
            F.percentile_approx("x", 0.5, accuracy).alias("pa"),
            F.percentile_approx("i", 0.9, 500).alias("pa9")]


APPROX = {"sd", "var", "sdd", "vi", "pa", "pa9"}


def _run(sess, F, at, grouped, accuracy=2000):
    df = sess.create_dataframe(at)
    aggs = _aggs(F, accuracy)
    q = df.group_by("k").agg(*aggs) if grouped else df.agg(*aggs)
    out = q.to_arrow()
    return out.sort_by("k") if grouped else out


def _assert_equal_jax(got, want):
    assert got.column_names == want.column_names
    for c in got.column_names:
        a, b = got.column(c).to_pylist(), want.column(c).to_pylist()
        if c not in APPROX:
            assert a == b, c
            continue
        assert [x is None for x in a] == [x is None for x in b], c
        tol = VAR_RTOL if c in ("sd", "var", "sdd", "vi") else TDIGEST_RTOL
        for x, y in zip(a, b):
            if x is not None:
                assert math.isclose(x, y, rel_tol=tol, abs_tol=1e-300), \
                    (c, x, y)


@pytest.mark.parametrize("conf", [{}, MANY], ids=["complete", "partial"])
@pytest.mark.parametrize("grouped", [True, False])
def test_new_aggregates_equal_jax(conf, grouped):
    at = _table()
    got = _run(pt.TpuSession(dict(conf), device="cpu"), PF, at, grouped)
    want = _run(st.TpuSession(dict(conf)), JF, at, grouped)
    _assert_equal_jax(got, want)
    if grouped:
        # the all-null group: first / last of x null, no variance
        row = got.filter(pa.compute.equal(got.column("k"), 8))
        assert row.column("lx").to_pylist() == [None]
        assert row.column("sd").to_pylist() == [None]
        assert row.column("pa").to_pylist() == [None]


def test_against_python():
    at = _table(seed=4)
    out = _run(pt.TpuSession(dict(MANY), device="cpu"), PF, at, True,
               accuracy=10000)
    ks = at.column("k").to_pylist()
    xs, ii = at.column("x").to_pylist(), at.column("i").to_pylist()
    got = {r["k"]: r for r in out.to_pylist()}
    for k in set(ks):
        xv = [x for kk, x in zip(ks, xs) if kk == k and x is not None]
        iv = [v for kk, v in zip(ks, ii) if kk == k]
        r = got[k]
        assert r["f"] == iv[0] and r["l"] == iv[-1]
        assert r["fi"] == next(v for v in iv if v is not None)
        if len(xv) > 1:
            assert math.isclose(r["var"], statistics.variance(xv),
                                rel_tol=1e-9)
            assert math.isclose(r["sd"], statistics.stdev(xv),
                                rel_tol=1e-9)
            srt = np.sort(xv)
            rank = np.searchsorted(srt, r["pa"]) / len(srt)
            assert abs(rank - 0.5) < 0.05
        exact = len({v for v in iv if v is not None})
        assert abs(r["acd"] - exact) <= 4 * 0.05 * exact


def test_hll_registers_are_the_jax_words():
    rng = np.random.default_rng(7)
    n = 5000
    h = rng.integers(0, 2**32, n)
    valid = rng.random(n) > 0.1
    mask = rng.random(n) > 0.05
    seg = rng.integers(0, 37, n)
    for rsd in (0.05, 0.02, 0.3):
        p = pagg.ApproxCountDistinct(None, rsd)
        j = jagg.ApproxCountDistinct(None, rsd)
        assert (p.p, p.m, p.W) == (j.p, j.m, j.W)
        got = p.g_update(CV(torch.from_numpy(h), torch.from_numpy(valid)),
                         torch.from_numpy(mask), torch.from_numpy(seg), 37)
        want = j.g_update(JCV(jnp.asarray(h.astype(np.int64))
                              .astype(jnp.int32), jnp.asarray(valid)),
                          jnp.asarray(mask), jnp.asarray(seg), 37)
        assert len(got) == len(want) == p.W
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
        # ungrouped: one (W,) vector, merged bytewise
        s1 = p.update(CV(torch.from_numpy(h[:2000]),
                         torch.from_numpy(valid[:2000])),
                      torch.from_numpy(mask[:2000]))
        s2 = p.update(CV(torch.from_numpy(h[2000:]),
                         torch.from_numpy(valid[2000:])),
                      torch.from_numpy(mask[2000:]))
        whole = p.update(CV(torch.from_numpy(h), torch.from_numpy(valid)),
                         torch.from_numpy(mask))
        assert torch.equal(p.merge(s1, s2)[0], whole[0])
        jw = j.update(JCV(jnp.asarray(h.astype(np.int64)).astype(jnp.int32),
                          jnp.asarray(valid)), jnp.asarray(mask))
        assert np.array_equal(whole[0].numpy(), np.asarray(jw[0]))
        assert int(p.finalize(whole)[0]) == int(j.finalize(jw)[0])


def test_empty_input():
    at = _table().slice(0, 0)
    for grouped in (True, False):
        got = _run(pt.TpuSession(device="cpu"), PF, at, grouped)
        want = _run(st.TpuSession(), JF, at, grouped)
        assert got.num_rows == want.num_rows == (0 if grouped else 1)
        _assert_equal_jax(got, want)


def test_variance_no_catastrophic_cancellation():
    n = 2000
    vals = [10**9 + (i % 2) for i in range(n)]
    at = pa.table({"v": pa.array(vals, pa.int64()),
                   "k": pa.array([i % 3 for i in range(n)])})
    exp = statistics.variance(vals)
    got = pt.TpuSession(device="cpu").create_dataframe(at).agg(
        PF.variance("v").alias("v")).to_arrow().column(0).to_pylist()[0]
    assert abs(got - exp) < 1e-6, (got, exp)
    out = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 128},
                        device="cpu").create_dataframe(at).group_by(
        "k").agg(PF.variance("v").alias("vr")).to_arrow()
    for k, vr in zip(out.column(0).to_pylist(), out.column(1).to_pylist()):
        gvals = [v for i, v in enumerate(vals) if i % 3 == k]
        assert abs(vr - statistics.variance(gvals)) < 1e-6
    one = pt.TpuSession(device="cpu").create_dataframe({"v": [5]})
    assert one.agg(PF.stddev("v").alias("s")).to_arrow().to_pydict() \
        == {"s": [None]}


def test_grouped_first_last_across_partials():
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 64},
                      device="cpu")
    n = 500
    ks = [i % 5 for i in range(n)]
    vs = [None if i % 7 == 0 else i for i in range(n)]
    out = s.create_dataframe({"k": pa.array(ks, pa.int32()),
                              "v": pa.array(vs, pa.int64())}).group_by(
        "k").agg(PF.first("v").alias("f"), PF.last("v").alias("l"),
                 PF.first("v", ignorenulls=True).alias("fn")).to_arrow()
    got = {k: (f, l, fn) for k, f, l, fn in zip(
        *[out.column(i).to_pylist() for i in range(4)])}
    for k in range(5):
        vals = [v for kk, v in zip(ks, vs) if kk == k]
        nn = [v for v in vals if v is not None]
        assert got[k] == (vals[0], vals[-1], nn[0] if nn else None)


def test_custom_states_ride_the_bucket_split(tmp_path):
    """Every key distinct over a 256 KiB budget and a 2048-row merge
    bound: the partial states park, spill and split into hash buckets
    in the final aggregate, and every state column comes through."""
    n = 12000
    rng = np.random.default_rng(97)
    keys = rng.permutation(n // 2).repeat(2).astype(np.int64)
    x = rng.standard_normal(n)
    i = rng.integers(0, 50, n)
    at = pa.table({"k": pa.array(keys), "x": pa.array(x),
                   "i": pa.array(i.astype(np.int64))})

    def aggs(F):
        return (F.first("i").alias("f"), F.last("i").alias("l"),
                F.variance("x").alias("v"),
                F.approx_count_distinct("i").alias("a"),
                F.percentile_approx("x", 0.5, 800).alias("p"))

    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
            "spark.rapids.tpu.sql.agg.maxMergeRows": 2048,
            "spark.rapids.tpu.memory.tpu.poolBytes": 256 << 10,
            "spark.rapids.tpu.memory.host.spillStorageSize": 128 << 10,
            "spark.rapids.tpu.memory.spill.dir": str(tmp_path)}
    s = pt.TpuSession(conf, device="cpu")
    q = s.create_dataframe(at).group_by("k").agg(*aggs(PF))
    got = q.to_arrow().sort_by("k")
    assert sum(m.get("numBucketSplits", 0)
               for m in q.last_metrics().values()) >= 1
    assert s.spill_store.open_handles == 0
    assert s.device_manager.reserved == 0
    want = st.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024}) \
        .create_dataframe(at).group_by("k").agg(*aggs(JF)).to_arrow() \
        .sort_by("k")
    for c in ("k", "f", "l", "a"):
        assert got.column(c).equals(want.column(c)), c
    np.testing.assert_allclose(got.column("v").to_numpy(),
                               want.column("v").to_numpy(), rtol=VAR_RTOL)
    np.testing.assert_allclose(got.column("p").to_numpy(),
                               want.column("p").to_numpy(),
                               rtol=TDIGEST_RTOL)
    # each key's two rows: first and last in scan order
    order = {}
    for k, v in zip(keys.tolist(), i.tolist()):
        order.setdefault(k, []).append(v)
    assert got.column("f").to_pylist() == [order[k][0] for k in
                                           sorted(order)]
    assert got.column("l").to_pylist() == [order[k][-1] for k in
                                           sorted(order)]
