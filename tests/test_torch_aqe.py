"""Adaptive execution in the port (`exec/aqe.py`, `plan/aqe.py`, the
exchange's stage API) against the JAX package.

- `AqeShufflePlan.groups()` of both packages on the same partition-size
  vectors (stub exchanges) must give equal task groups and equal decision
  records: empty partitions, coalescing off, a skewed stream beside its
  build, splitting disallowed, one partition.
- Coalescing, the skew split and join demotion each fire on small data
  with thresholds set to force them (the shapes of the JAX suite's
  `tests/test_aqe.py` and `tests/test_aqe_replan.py:70-125`); the rows
  must be byte-identical to the same query with adaptive execution off
  and to the JAX package's.
- `read_slice` covers a reduce partition exactly once for any slice
  count; each rule's gate turns that rule off alone; a demoted join is
  the plan `last_plan()` shows and a second action plans afresh; a stage
  that fails to materialize fails the query.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.exec.aqe import AqeShufflePlan as JPlan
from spark_rapids_tpu.expr.expressions import col as jcol
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.exec.aqe import AqeShufflePlan as PPlan
from spark_rapids_tpu_torch.expr.expressions import col as pcol
from spark_rapids_tpu_torch.plan import aqe as paqe

AQE_OFF = {"spark.rapids.tpu.sql.adaptive.enabled": False}
SMALL = {
    "spark.rapids.tpu.sql.batchSizeRows": 512,
    "spark.rapids.tpu.sql.shuffle.partitions": 8,
    "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes": 4096,
    "spark.rapids.tpu.sql.adaptive.skewJoin."
    "skewedPartitionThresholdInBytes": 4096,
    "spark.rapids.tpu.sql.adaptive.skewJoin.skewedPartitionFactor": 2,
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------
# groups() parity on stub exchanges
# ----------------------------------------------------------------------
class _Stub:
    def __init__(self, sizes):
        self.sizes = list(sizes)

    def num_partitions(self, ctx):
        return len(self.sizes)

    def stage_stats(self, ctx):
        return self.sizes


#: name -> (stream sizes, build sizes or None, target, factor, min bytes,
#: allow_split, allow_coalesce)
GROUP_CASES = {
    "coalesce_and_split": ([100, 200, 900000, 50], None, 4096, 2, 8192,
                           True, True),
    "all_empty": ([0] * 8, None, 4096, 5, 8192, True, True),
    "some_empty": ([0, 5000, 0, 0, 3000, 0, 0, 9000], None, 4096, 5, 8192,
                   True, True),
    "coalesce_off": ([100, 200, 300, 50, 70], None, 4096, 5, 8192, True,
                     False),
    "skewed_stream": ([1000, 1200, 64000, 900, 1100, 0, 800, 1000],
                      [50000, 40000, 3000, 60000, 100, 0, 200, 300], 8192,
                      5, 16384, True, True),
    "big_build_only": ([1000, 1200, 900, 1100],
                       [500000, 100, 100, 100], 8192, 2, 4096, True, True),
    "split_disallowed": ([100, 200, 900000, 50], None, 4096, 2, 8192,
                         False, True),
    "one_partition": ([123456], None, 4096, 2, 8192, True, True),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_groups_equal_jax(case):
    stream, build, target, factor, mn, split, coalesce = GROUP_CASES[case]
    out = []
    for cls in (JPlan, PPlan):
        exs = [_Stub(stream)] + ([_Stub(build)] if build else [])
        plan = cls(exs, target_bytes=target, skew_factor=factor,
                   skew_min_bytes=mn, allow_split=split,
                   allow_coalesce=coalesce)
        out.append((plan.groups(None), plan.decision))
    (jg, jd), (pg, pd) = out
    # the JAX record also names its exchanges' lore ids (the port has
    # none): every other field must agree
    assert jd.pop("exchange_lores") == [None] * (2 if build else 1)
    assert pg == jg and pd == jd
    seen = [t for g in pg for t in g]
    assert len(seen) == len(set(seen))
    assert {rp for rp, _, _ in seen} == set(range(len(stream)))
    if case == "coalesce_off":
        assert pd["partitions_after"] == pd["partitions_before"]
    if case in ("coalesce_and_split", "skewed_stream"):
        assert pd["split_slices"] > 1
    if case in ("split_disallowed", "big_build_only"):
        assert pd["split_slices"] == 0


# ----------------------------------------------------------------------
# each rule fires, rows byte-identical to adaptive off and to JAX
# ----------------------------------------------------------------------
def _demotion_query(s, F, col, n=40_000):
    """A shuffled join whose build the planner overestimates (a point
    filter on a 5000-key dimension) but which materializes as one row."""
    big = s.create_dataframe({"k": pa.array([i % 5000 for i in range(n)]),
                              "v": pa.array([float(i) for i in range(n)])})
    dim = s.create_dataframe({"k": pa.array(list(range(5000))),
                              "w": pa.array([float(i)
                                             for i in range(5000)])})
    sel = dim.filter(col("k") == 17)
    return big.join(sel, on=["k"]).select("k", "v", "w").sort("v")


def _skew_query(s, F, col, n=30_000):
    """90 % of the stream rows on one key; a build too big to
    broadcast."""
    k = [0] * (n * 9 // 10) + [i % 500 + 1 for i in range(n // 10)]
    big = s.create_dataframe({"k": pa.array(k),
                              "v": pa.array([float(i) for i in range(n)])})
    dim = s.create_dataframe({"k": pa.array(list(range(501))),
                              "w": pa.array([float(i)
                                             for i in range(501)])})
    return big.join(dim, on=["k"]).select("k", "v", "w").sort("v")


def _coalesce_query(s, F, col, n=20_000):
    """64 reduce partitions over 7 keys: most come out empty, the rest
    far below the advisory size."""
    df = s.create_dataframe({"k": pa.array([i % 7 for i in range(n)]),
                             "v": pa.array([float(i) for i in range(n)])})
    return df.group_by("k").agg(F.sum("v").alias("sv"),
                                F.count("v").alias("c")).sort("k")


RULES = {
    "demotion": (_demotion_query, "demotions",
                 {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 8192}),
    "skew_split": (_skew_query, "skew_splits",
                   {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}),
    "coalesce": (_coalesce_query, "coalesced_partitions",
                 {"spark.rapids.tpu.sql.shuffle.partitions": 64}),
}


def _port(query, conf):
    s = pt.TpuSession(dict(SMALL, **conf), device="cpu")
    q = query(s, PF, pcol)
    return q, q.to_arrow()


@pytest.mark.parametrize("rule", list(RULES))
def test_rule_fires_rows_equal_off_and_jax(rule):
    query, counter, extra = RULES[rule]
    before = paqe.aqe_stats()[counter]
    q, got = _port(query, extra)
    assert paqe.aqe_stats()[counter] > before
    _, off = _port(query, dict(extra, **AQE_OFF))
    assert got.combine_chunks().equals(off.combine_chunks())
    want = query(st.TpuSession(dict(SMALL, **extra)), JF, jcol).to_arrow()
    assert got.combine_chunks().equals(want.combine_chunks())
    decisions = q.last_aqe_decisions()
    if rule == "demotion":
        (d,) = [d for d in decisions
                if d["rule"] == "demote_broadcast_join"]
        assert 0 < d["build_bytes"] <= d["threshold"] == 8192
    elif rule == "skew_split":
        (d,) = decisions
        assert d["skewed_partitions"] == 1 and d["split_slices"] > 1
        reader = q.last_plan()
        while type(reader).__name__ != "AQEShuffleReadExec":
            reader = reader.children[0]
        assert q.last_metrics()[reader._op_id]["aqeSkewSplits"] == \
            d["split_slices"]
    else:
        (d,) = decisions
        assert d["partitions_before"] == 64 and d["partitions_after"] < 8


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti",
                                 "full"])
def test_skew_join_matches_the_oracle(how):
    """The JAX suite's skew-join shapes: split where the join allows it,
    whole partitions under a full join; each against Python."""
    rng = np.random.default_rng(11)
    n = 4000
    k = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 64, n))
    v = rng.integers(0, 1000, n)
    s = pt.TpuSession(dict(SMALL, **{
        "spark.rapids.tpu.sql.batchSizeRows": 256,
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
        "spark.rapids.tpu.sql.adaptive.skewJoin."
        "skewedPartitionThresholdInBytes": 8192}), device="cpu")
    left = s.create_dataframe({"k": pa.array(k), "v": pa.array(v)})
    rk = np.arange(0, 64, 2, dtype=np.int64)
    right = s.create_dataframe({"k": pa.array(rk), "w": pa.array(rk * 100)})
    q = left.join(right, on=["k"], how=how)
    out = q.to_arrow().to_pylist()
    (d,) = q.last_aqe_decisions()
    assert (d["split_slices"] > 1) == (how != "full")
    rset = set(int(x) for x in rk)
    pairs = [(int(a), int(b)) for a, b in zip(k, v)]
    if how == "inner":
        exp = sorted((a, b, a * 100) for a, b in pairs if a in rset)
        got = sorted((r["k"], r["v"], r["w"]) for r in out)
    elif how == "left":
        exp = sorted((a, b, a * 100 if a in rset else None)
                     for a, b in pairs)
        got = sorted((r["k"], r["v"], r["w"]) for r in out)
    elif how in ("left_semi", "left_anti"):
        keep = how == "left_semi"
        exp = sorted((a, b) for a, b in pairs if (a in rset) == keep)
        got = sorted((r["k"], r["v"]) for r in out)
    else:
        lk = set(a for a, _ in pairs)
        exp = sorted(((a, b, a * 100 if a in rset else None)
                      for a, b in pairs), key=lambda t: (t[0], t[1])) + \
            sorted((int(x), None, int(x) * 100) for x in rk
                   if int(x) not in lk)
        got = sorted(((r["k"], r["v"], r["w"]) for r in out
                      if r["v"] is not None), key=lambda t: (t[0], t[1])) \
            + sorted((r["k"], r["v"], r["w"]) for r in out
                     if r["v"] is None)
    assert got == exp


# ----------------------------------------------------------------------
# the exchange's stage API
# ----------------------------------------------------------------------
def test_read_slice_covers_a_partition_exactly():
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec.nodes import (InMemoryScanExec,
                                                   _batch_to_arrow)
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.expr.expressions import BoundRef
    from spark_rapids_tpu_torch.columnar.table import Schema
    at = pa.table({"k": pa.array(np.zeros(3000, np.int64)),
                   "v": pa.array(np.arange(3000, dtype=np.int64)),
                   "s": pa.array([f"r{i}" for i in range(3000)])})
    schema = Schema.from_arrow(at.schema)
    conf = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 256},
                         device="cpu").conf
    ctx = ExecContext(conf, torch.device("cpu"))
    ex = ShuffleExchangeExec(InMemoryScanExec(at, schema), 4,
                             [BoundRef(0, schema[0].dtype, "k")], schema)
    stats = ex.stage_stats(ctx)
    (rp,) = [i for i, b in enumerate(stats) if b]
    m = ctx.metrics[ex._op_id]
    assert m["shuffleBytesWritten"] == sum(stats) == \
        m["shufflePartitionBytesMax"] > 0
    assert m["shufflePartitionBytesMin"] == 0
    for nchunks in (1, 2, 3, 5, 12, 40):
        parts = [ex.read_slice(ctx, rp, c, nchunks)
                 for c in range(nchunks)]
        rows = [r for p in parts if p is not None
                for r in _batch_to_arrow(p).to_pylist()]
        assert sorted(r["v"] for r in rows) == list(range(3000))
        assert all(r["s"] == f"r{r['v']}" for r in rows)
        if 1 < nchunks <= 12:
            assert sum(p is not None for p in parts) > 1
    assert all(ex.read_slice(ctx, i) is None
               for i in range(4) if i != rp)


# ----------------------------------------------------------------------
# gates, the plan that ran, failures
# ----------------------------------------------------------------------
GATES = {
    "spark.rapids.tpu.sql.adaptive.joinDemotion.enabled":
        (_demotion_query, "demotions",
         {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 8192}),
    "spark.rapids.tpu.sql.adaptive.skewJoin.enabled":
        (_skew_query, "skew_splits",
         {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}),
    "spark.rapids.tpu.sql.adaptive.coalescePartitions.enabled":
        (_coalesce_query, "coalesced_partitions",
         {"spark.rapids.tpu.sql.shuffle.partitions": 64}),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_rule_gate_turns_its_rule_off_alone(gate):
    query, counter, extra = GATES[gate]
    before = paqe.aqe_stats()
    q, got = _port(query, dict(extra, **{gate: False}))
    after = paqe.aqe_stats()
    assert after[counter] == before[counter]
    _, on = _port(query, extra)
    assert got.combine_chunks().equals(on.combine_chunks())
    reads = [d for d in q.last_aqe_decisions()
             if d["rule"] == "shuffle_read"]
    assert reads        # the stage driver still ran the other rules


def test_demoted_plan_is_the_plan_that_ran_and_actions_replan():
    s = pt.TpuSession(dict(SMALL, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 8192}),
        device="cpu")
    q = _demotion_query(s, PF, pcol, n=8000)
    q.to_arrow()
    first = q.last_plan()

    def join_of(root):
        node = root
        while type(node).__name__ != "HashJoinExec":
            node = node.children[0]
        return node
    j = join_of(first)
    assert not j.per_partition
    assert type(j.children[1]).__name__ == "BroadcastExchangeExec"
    assert type(j.children[1].children[0]).__name__ == \
        "ShuffleExchangeExec"
    assert type(j.children[0]).__name__ != "AQEShuffleReadExec"
    # a fresh plan of the same DataFrame is shuffled until its driver
    # runs
    root, _ = q.physical_plan()
    assert join_of(root).per_partition
    q.to_arrow()
    assert q.last_plan() is not first
    assert not join_of(q.last_plan()).per_partition


def test_a_stage_that_fails_fails_the_query(monkeypatch):
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec

    def boom(self, batch):
        raise RuntimeError("map side failed")
    monkeypatch.setattr(ShuffleExchangeExec, "_map_batch", boom)
    s = pt.TpuSession(SMALL, device="cpu")
    with pytest.raises(RuntimeError, match="map side failed"):
        _coalesce_query(s, PF, pcol, n=2000).to_arrow()


def test_adaptive_off_plans_no_reader():
    q, _ = _port(_coalesce_query, AQE_OFF)
    assert q.last_aqe_decisions() == []
    stack = [q.last_plan()]
    while stack:
        node = stack.pop()
        assert type(node).__name__ != "AQEShuffleReadExec"
        stack.extend(node.children)
