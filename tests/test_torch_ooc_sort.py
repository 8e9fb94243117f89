"""The out-of-core sort of the PyTorch port (on the CPU) against the JAX
package and the port's own in-core sort: `tests/test_join_sort.py:194-211`
with `sql.sort.outOfCore.thresholdBytes` at 10,000 bytes, so 5,000 rows
range-exchange into ordered partitions that sort one at a time
(`oocRangePartitions` > 0), and the range exchange's ordering
(`tests/test_memory_shuffle.py:153`). Also a leading key with nulls
(partition 0), a double key with NaN and -0.0 (NaN greatest), a string
payload, and the leading orders that stay in core (descending, nulls
last, a string key). Every result must equal the JAX package's Arrow
table and the in-core sort's, row for row: exact.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu.plan.logical import SortOrder as JSortOrder
from spark_rapids_tpu.expr.expressions import col as jcol
from spark_rapids_tpu_torch.exec.base import ExecContext
from spark_rapids_tpu_torch.exec.exchange import RangeShuffleExchangeExec
from spark_rapids_tpu_torch.exec.nodes import _batch_to_arrow
from spark_rapids_tpu_torch.expr.expressions import col
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.plan.planner import Planner

OOC = {"spark.rapids.tpu.sql.batchSizeRows": 512,
       "spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes": 10_000}
IN_CORE = dict(OOC, **{"spark.rapids.tpu.sql.sort.outOfCore.enabled":
                       False})


def _data(n=5000, seed=150):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 10**6, n)),
        "v": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.1),
        "s": pa.array([f"p{int(x)}" for x in rng.integers(0, 999, n)]),
    })


def _port(at, conf, *orders):
    s = pt.TpuSession(dict(conf), device="cpu")
    q = s.create_dataframe(at).sort(*orders)
    out = q.to_arrow()
    ooc = sum(v.get("oocRangePartitions", 0)
              for v in q.last_metrics().values())
    assert s.spill_store.open_handles == 0
    assert s.device_manager.reserved == 0
    return out, ooc


def _jax(at, conf, *orders):
    s = st.TpuSession(dict(conf))
    return s.create_dataframe(at).sort(*orders).to_arrow()


def test_out_of_core_sort_matches_jax_and_in_core():
    at = _data()
    got, ooc = _port(at, OOC, SortOrder(col("k"), True), "v", "s")
    assert ooc > 0
    assert got.column("k").to_pylist() == sorted(at.column("k").to_pylist())
    inc, ooc_in = _port(at, IN_CORE, SortOrder(col("k"), True), "v", "s")
    assert ooc_in == 0 and got.equals(inc)
    exp = _jax(at, OOC, JSortOrder(jcol("k"), ascending=True), "v", "s")
    assert got.equals(exp)


def test_jax_shape_two_columns():
    """The JAX suite's own case: one int key, one nullable payload."""
    rng = np.random.default_rng(150)
    at = pa.table({"k": pa.array(rng.integers(0, 10**6, 5000)),
                   "v": pa.array(rng.integers(-10**6, 10**6, 5000))})
    got, ooc = _port(at, OOC, "k", "v")
    assert ooc == 2 * at.nbytes // 10_000 + 1 or ooc > 0
    assert got.equals(_jax(at, OOC, "k", "v"))
    assert got.equals(at.sort_by([("k", "ascending"), ("v", "ascending")]))


def test_null_leading_keys_go_first():
    rng = np.random.default_rng(3)
    n = 4000
    at = pa.table({"k": pa.array(rng.integers(0, 500, n),
                                 mask=rng.random(n) < 0.2),
                   "i": pa.array(np.arange(n))})
    got, ooc = _port(at, OOC, "k", "i")
    assert ooc > 0
    inc, _ = _port(at, IN_CORE, "k", "i")
    assert got.equals(inc)
    ks = got.column("k").to_pylist()
    nulls = ks.count(None)
    assert ks[:nulls] == [None] * nulls and None not in ks[nulls:]


def test_double_key_with_nan_and_signed_zero():
    rng = np.random.default_rng(4)
    n = 4000
    d = rng.standard_normal(n)
    d[::17] = np.nan
    d[1::19] = -0.0
    d[2::23] = 0.0
    d[3::29] = np.inf
    at = pa.table({"d": pa.array(d), "i": pa.array(np.arange(n))})
    got, ooc = _port(at, OOC, "d", "i")
    assert ooc > 0
    inc, _ = _port(at, IN_CORE, "d", "i")
    exp = _jax(at, IN_CORE, "d", "i")
    for other in (inc, exp):       # NaN != NaN under Table.equals
        assert got.column("i").equals(other.column("i"))
        a, b = (t.column("d").to_numpy() for t in (got, other))
        assert a.view(np.int64).tolist() == b.view(np.int64).tolist()
    d_sorted = got.column("d").to_numpy()
    nans = int(np.isnan(d).sum())
    assert np.isnan(d_sorted[-nans:]).all() and nans > 100


@pytest.mark.parametrize("order", ["desc", "nulls_last", "string"])
def test_ineligible_leading_orders_stay_in_core(order):
    at = _data(3000, 9)
    if order == "desc":
        orders = (SortOrder(col("k"), False), "s")
        jorders = (JSortOrder(jcol("k"), ascending=False), "s")
    elif order == "nulls_last":
        orders = (SortOrder(col("v"), True, nulls_first=False), "k", "s")
        jorders = (JSortOrder(jcol("v"), ascending=True,
                              nulls_first=False), "k", "s")
    else:
        orders = ("s", "k", "v")
        jorders = orders
    got, ooc = _port(at, OOC, *orders)
    assert ooc == 0
    assert got.equals(_jax(at, OOC, *jorders))


def test_range_partition_ordering():
    """RangeShuffleExchangeExec alone: every row kept, and the key
    ranges of the partitions disjoint and ascending."""
    rng = np.random.default_rng(140)
    at = pa.table({"k": pa.array(rng.integers(0, 10**6, 3000)),
                   "v": pa.array(rng.integers(0, 9, 3000),
                                 mask=rng.random(3000) < 0.1)})
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 512},
                      device="cpu")
    df = s.create_dataframe(at)
    child = Planner(s.conf).plan(df._plan)
    ctx = ExecContext(s.conf, torch.device("cpu"), session=s)
    keys = [col("k").bind(child.schema)]
    ex = RangeShuffleExchangeExec(child, 4, keys, child.schema)
    parts = []
    for pid in range(4):
        rows = []
        for b in ex.execute_partition(ctx, pid):
            rows += _batch_to_arrow(b).column("k").to_pylist()
        parts.append(rows)
    assert sorted(x for p in parts for x in p) == \
        sorted(at.column("k").to_pylist())
    nonempty = [p for p in parts if p]
    assert len(nonempty) == 4
    for a, b in zip(nonempty, nonempty[1:]):
        assert max(a) <= min(b)


def test_range_exchange_refuses_string_keys():
    s = pt.TpuSession({}, device="cpu")
    df = s.create_dataframe(pa.table({"s": ["a", "b"]}))
    child = Planner(s.conf).plan(df._plan)
    with pytest.raises(ValueError):
        RangeShuffleExchangeExec(child, 2, [col("s").bind(child.schema)],
                                 child.schema)
