"""Shared helpers of the scalar-surface parity tests (`test_torch_*`):
run one projection through the JAX package and through the port on the
CPU, over the same Arrow columns, and compare the outputs column by
column.

Both sides run with the host fallback and degrade-to-host off, so what
is compared is each package's device path (jnp under XLA's CPU compile,
torch ops), never a host interpreter. Exact equality is the rule; a double may be given
a budget in units in the last place (ulps) where a test says why.
"""
import numpy as np
import pyarrow as pa

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF

JAX_CONF = {"spark.rapids.tpu.sql.allowCpuFallback": False,
            "spark.rapids.tpu.sql.exec.degradeToHost.enabled": False}

I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def sessions(conf=None):
    conf = dict(conf or {})
    return st.TpuSession({**JAX_CONF, **conf}), \
        pt.TpuSession({**JAX_CONF, **conf}, device="cpu")


def project(data, make, conf=None):
    """(JAX table, port table) of `select` over `data`: `make(F)` gives
    the list of expressions, built once from each package's functions
    module, each aliased c0, c1, ..."""
    js, ps = sessions(conf)
    outs = []
    for s, F in ((js, JF), (ps, PF)):
        exprs = [e.alias(f"c{i}") for i, e in enumerate(make(F))]
        outs.append(s.create_dataframe(data).select(*exprs).to_arrow())
    return outs


def ulps(a, b) -> np.ndarray:
    """Distance in units in the last place between float64 arrays (NaN
    against NaN is 0; NaN against a number, or values of opposite sign,
    a very large number)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ia = a.view(np.int64)
    ib = b.view(np.int64)
    # map the bits to a monotone integer line
    ia = np.where(ia < 0, np.int64(-2 ** 63) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2 ** 63) - ib, ib)
    with np.errstate(over="ignore"):
        d = np.abs(ia.astype(np.float64) - ib.astype(np.float64))
    both_nan = np.isnan(a) & np.isnan(b)
    return np.where(both_nan, 0.0, np.where(np.isnan(a) | np.isnan(b),
                                            np.inf, d))


def assert_same_column(jcol, pcol, what, max_ulps=0):
    """The port's column equals the JAX column: the same type and nulls,
    and equal values (a double within `max_ulps`)."""
    assert jcol.type == pcol.type, (what, jcol.type, pcol.type)
    if pa.types.is_timestamp(jcol.type) or pa.types.is_date(jcol.type):
        # as integers: a value past Python's datetime range still compares
        ity = pa.int64() if pa.types.is_timestamp(jcol.type) else pa.int32()
        jcol, pcol = jcol.cast(ity), pcol.cast(ity)
    jv, pv = jcol.to_pylist(), pcol.to_pylist()
    assert [v is None for v in jv] == [v is None for v in pv], what
    if pa.types.is_floating(jcol.type):
        keep = [i for i, v in enumerate(jv) if v is not None]
        a = np.array([jv[i] for i in keep], np.float64)
        b = np.array([pv[i] for i in keep], np.float64)
        d = ulps(a, b)
        bad = np.flatnonzero(d > max_ulps)
        assert not len(bad), (what, [(a[i], b[i], d[i]) for i in bad[:5]])
        # the sign of a zero counts too where the values must be exact
        if max_ulps == 0:
            num = ~np.isnan(a)
            assert (np.signbit(a) == np.signbit(b))[num].all(), what
    else:
        assert jv == pv, (what, [(i, x, y) for i, (x, y) in
                                 enumerate(zip(jv, pv)) if x != y][:5])


def assert_same(jt, pt_, what, max_ulps=None):
    """Every column of two tables equal (`max_ulps` maps a column name to
    its double budget; absent means exact)."""
    assert jt.column_names == pt_.column_names, what
    for name in jt.column_names:
        assert_same_column(jt.column(name), pt_.column(name),
                           f"{what}: {name}", (max_ulps or {}).get(name, 0))
