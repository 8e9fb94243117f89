"""The runtime bloom filter of a shuffled join (`exec/runtime_filter.py`,
`plan/planner.py` `_maybe_bloom_prefilter`) against the JAX package:
under `sql.join.bloomFilter.enabled` the same joins plan a
RuntimeBloomFilterExec over their stream side, the rows equal the JAX
package's and the conf off's, under every adaptive rule too; the build
runs once; the map pool ends. The shuffle is forced as the JAX tests
force it (`autoBroadcastJoinThreshold` = 1)."""
import threading

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.exec.runtime_filter import (
    RuntimeBloomFilterExec as JBloom)
from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.exec.runtime_filter import (
    RuntimeBloomFilterExec, SharedBuildExec)

ON = "spark.rapids.tpu.sql.join.bloomFilter.enabled"
BASE = {"spark.rapids.tpu.sql.batchSizeRows": 2048,
        "spark.rapids.tpu.sql.shuffle.partitions": 4,
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 1}


def _data(seed=3, n=30_000, dim=200):
    rng = np.random.default_rng(seed)
    fact = pa.table({"k": rng.integers(0, 50_000, n).astype(np.int64),
                     "v": rng.normal(0, 1, n)})
    dk = (np.arange(dim) * 13).astype(np.int64)
    return fact, pa.table({"k": dk, "d": dk * 2})


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _rows(at):
    cols = [at.column(i).to_pylist() for i in range(at.num_columns)]
    return sorted(zip(*cols), key=repr)


def _join(s, fact, dim, how, on=("k",)):
    return s.create_dataframe(fact).join(s.create_dataframe(dim),
                                         on=list(on), how=how)


def _port(conf):
    return pt.TpuSession(conf, device="cpu")


def _stream_rows_mapped(q) -> int:
    """Rows the stream side's exchange took in (the bloom filter's
    output), from the host pieces of the plan that ran."""
    for node in _walk(q.last_plan()):
        if isinstance(node, ShuffleExchangeExec) and isinstance(
                node.children[0], RuntimeBloomFilterExec):
            return sum(p[1] for subs in node._pieces for p in subs)
    raise AssertionError("no exchange over the bloom filter")


@pytest.mark.parametrize("how", ["inner", "left_semi", "right"])
def test_on_and_off_equal_jax(how):
    fact, dim = _data()
    got = {}
    for flag in (False, True):
        conf = {**BASE, ON: flag}
        jq = _join(st.TpuSession(conf), fact, dim, how)
        pq = _join(_port(conf), fact, dim, how)
        got[("jax", flag)] = _rows(jq.to_arrow())
        got[("port", flag)] = _rows(pq.to_arrow())
        blooms = [n for n in _walk(pq.physical_plan()[0])
                  if isinstance(n, RuntimeBloomFilterExec)]
        assert len(blooms) == int(flag)
        jroot, _ = jq._execute()
        assert sum(isinstance(n, JBloom) for n in _walk(jroot)) == int(flag)
        if flag:
            assert blooms[0].num_bits == 2048      # 200 rows * 8 bits
            # ~200 of 50,000 key values live: most stream rows drop
            kept = _stream_rows_mapped(pq)
            assert kept < 0.1 * fact.num_rows
            m = pq.last_metrics()
            assert any("bloomBuildTime" in v and "bloomProbeTime" in v
                       for v in m.values())
    want = got[("jax", False)]
    assert want and all(v == want for v in got.values())


#: joins the JAX rules leave unfiltered, each as (how, keys, tables)
def _refused(case):
    fact, dim = _data()
    if case in ("left", "full", "left_anti"):
        return case, ("k",), fact, dim, {}
    if case == "two_keys":
        f = fact.append_column("j", pa.array(np.zeros(fact.num_rows,
                                                      np.int64)))
        d = dim.append_column("j", pa.array(np.zeros(dim.num_rows,
                                                     np.int64)))
        return "inner", ("k", "j"), f, d, {}
    if case == "mismatched_dtypes":
        d = dim.set_column(0, "k", dim.column("k").cast(pa.int32()))
        return "inner", ("k",), fact, d, {}
    return "inner", ("k",), fact, dim, {
        "spark.rapids.tpu.sql.join.bloomFilter.maxBuildRows": 199}


@pytest.mark.parametrize("case", ["left", "full", "left_anti", "two_keys",
                                  "mismatched_dtypes", "over_max_rows"])
def test_no_filter_where_the_jax_rules_refuse(case):
    how, keys, fact, dim, extra = _refused(case)
    conf = {**BASE, ON: True, **extra}
    proot, _ = _join(_port(conf), fact, dim, how, keys).physical_plan()
    jroot, _ = _join(st.TpuSession(conf), fact, dim, how, keys)._execute()
    assert not any(isinstance(n, RuntimeBloomFilterExec)
                   for n in _walk(proot))
    assert not any(isinstance(n, JBloom) for n in _walk(jroot))


def test_an_empty_build_masks_everything():
    """A build whose filter keeps no row (the estimate keeps its upper
    bound, so the join stays shuffled; -1 turns broadcast and demotion
    off): the filter is empty, and no stream row reaches the
    exchange."""
    fact, dim = _data()
    conf = {**BASE, ON: True,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    out = []
    for s, F in ((_port(conf), PF), (st.TpuSession(conf), JF)):
        d = s.create_dataframe(dim).filter(F.col("d") < 0)
        q = s.create_dataframe(fact).join(d, on=["k"], how="inner")
        out.append(q.to_arrow().num_rows)
        if F is PF:
            assert _stream_rows_mapped(q) == 0
    assert out == [0, 0]


def test_the_build_runs_once(monkeypatch):
    """An aggregated build (not scan-shaped) is eligible, and its subtree
    runs once a partition though the filter and the build exchange both
    read it (SharedBuildExec); its parked batches close with the run."""
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    fact, dim = _data()
    raw = pa.table({"k": np.repeat(dim.column("k").to_numpy(), 3),
                    "x": np.arange(dim.num_rows * 3)})
    s = _port({**BASE, ON: True})
    built = s.create_dataframe(raw).group_by("k").agg(
        PF.count("*").alias("c"))
    q = s.create_dataframe(fact).join(built, on=["k"], how="inner")
    root, ctx = q.physical_plan()
    shares = [n for n in _walk(root) if isinstance(n, SharedBuildExec)]
    assert shares and any(isinstance(n, RuntimeBloomFilterExec)
                          for n in _walk(root))
    calls = {"n": 0}
    orig = HashAggregateExec.execute_partition

    def counting(self, ctx, pid):
        calls["n"] += 1
        yield from orig(self, ctx, pid)

    monkeypatch.setattr(HashAggregateExec, "execute_partition", counting)
    open_before = s.spill_store.open_handles
    got = sorted(r[0] for r in q.collect())
    live = set(dim.column("k").to_pylist())
    assert got == sorted(k for k in fact.column("k").to_pylist()
                         if k in live)
    assert calls["n"] == shares[0].num_partitions(ctx)
    assert s.spill_store.open_handles == open_before


ADAPTIVE = {
    # coalescing: many tiny reduce partitions merge
    "coalesce": ({"spark.rapids.tpu.sql.shuffle.partitions": 16,
                  "spark.rapids.tpu.sql.adaptive."
                  "advisoryPartitionSizeInBytes": 1 << 20},
                 "shuffle_read"),
    # a skewed stream partition splits into slices
    "skew_split": ({"spark.rapids.tpu.sql.adaptive."
                    "advisoryPartitionSizeInBytes": 4096,
                    "spark.rapids.tpu.sql.adaptive.skewJoin."
                    "skewedPartitionFactor": 2,
                    "spark.rapids.tpu.sql.adaptive.skewJoin."
                    "skewedPartitionThresholdInBytes": 1024},
                   "shuffle_read"),
    # the filtered build is small at run time: the join is demoted
    # (the estimate, 200 rows of 17 bytes, is over the threshold)
    "demotion": ({"spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                  3000}, "demote_broadcast_join"),
}


@pytest.mark.parametrize("rule", sorted(ADAPTIVE))
def test_adaptive_rules_keep_the_mask_sound(rule):
    """Coalescing, a skew split and a demotion to broadcast: the conf on
    and off give the same rows, and the same as the JAX package's."""
    extra, kind = ADAPTIVE[rule]
    fact, dim = _data()
    if rule == "skew_split":
        k = fact.column("k").to_numpy().copy()
        k[::2] = 13                     # half the stream on one live key
        fact = fact.set_column(0, "k", pa.array(k))
    out = {}
    for flag in (False, True):
        conf = {**BASE, **extra, ON: flag}
        for name, s, F in (("jax", st.TpuSession(conf), JF),
                           ("port", _port(conf), PF)):
            d = s.create_dataframe(dim)
            if rule == "demotion":
                d = d.filter(F.col("d") < 2000)
            q = s.create_dataframe(fact).join(d, on=["k"], how="inner")
            out[(name, flag)] = _rows(q.to_arrow())
            if name == "port":
                decisions = [d_["rule"] for d_ in q.last_aqe_decisions()]
                assert kind in decisions, (rule, flag, decisions)
                if rule == "skew_split":
                    assert any(d_.get("split_slices", 0) > 0
                               for d_ in q.last_aqe_decisions())
                blooms = [n for n in _walk(q.last_plan())
                          if isinstance(n, RuntimeBloomFilterExec)]
                assert len(blooms) == int(flag)
    want = out[("jax", False)]
    assert want and all(v == want for v in out.values()), rule


def test_the_map_pool_ends_with_equal_rows():
    """The stream exchange on four map workers: the filter builds on a
    worker that holds a permit while the others wait on its lock, under
    one permit too; the join ends, with the serial rows."""
    fact, dim = _data()
    rows = {}

    def run(label, conf):
        rows[label] = _rows(_join(_port(conf), fact, dim,
                                  "inner").to_arrow())

    for label, extra in (("serial", {"spark.rapids.tpu.sql.exec.exchange."
                                     "mapThreads": 1}),
                         ("pool", {"spark.rapids.tpu.sql.exec.exchange."
                                   "mapThreads": 4}),
                         ("pool_one_permit",
                          {"spark.rapids.tpu.sql.exec.exchange."
                           "mapThreads": 4,
                           "spark.rapids.tpu.sql.concurrentTpuTasks": 1})):
        t = threading.Thread(target=run, args=(label, {**BASE, ON: True,
                                                       **extra}),
                             daemon=True)
        t.start()
        t.join(120)
        assert not t.is_alive(), f"{label}: the join did not end"
    assert rows["serial"] and rows["pool"] == rows["serial"] \
        == rows["pool_one_permit"]
