"""The DataFrame surface of the PyTorch port (on the CPU) against the
JAX package: `schema`, `union` (types that match, and that do not),
`count`, `to_pydict`, `GroupedData.count`, `cache` / `uncache` (the plan
reads a `CachedScanExec`, a small cache takes the whole-input
aggregate, and `uncache` frees the batches) and `explain` (ALL names
the plan's nodes; VALIDATE and ANALYZE name the ROADMAP items that port
them). Results are exact; grouped rows compare sorted by their key.
"""
import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.exec.nodes import CachedScanExec, \
    InMemoryScanExec
from torch_parity import sessions

SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 64}


def _table(n=300, seed=4):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
        "s": pa.array([f"s{x}" for x in rng.integers(0, 5, n)]),
        "a": pa.array([[int(x)] * int(x % 3) for x in
                       rng.integers(0, 9, n)], pa.list_(pa.int64()))})


def _nodes(root):
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children)
    return out


def test_schema_count_to_pydict():
    js, ps = sessions(SMALL)
    at = _table()
    jd, pd_ = js.create_dataframe(at), ps.create_dataframe(at)
    assert [(f.name, repr(f.dtype)) for f in pd_.schema.fields] == \
        [(f.name, repr(f.dtype)) for f in jd.schema.fields]
    assert pd_.count() == jd.count() == at.num_rows
    q = lambda d, F: d.filter(F.col("v") > 10).select("k", "v", "a")
    assert q(pd_, PF).to_pydict() == q(jd, JF).to_pydict()
    assert q(pd_, PF).count() == q(jd, JF).count()


def test_union_matching_and_mismatched_schemas():
    js, ps = sessions(SMALL)
    at = _table()
    for s, F in ((js, JF), (ps, PF)):
        d = s.create_dataframe(at)
        # a mismatch of types is refused; names need not match
        with pytest.raises(ValueError, match="UNION"):
            d.select("k").union(d.select("s"))
    outs = []
    for s, F in ((js, JF), (ps, PF)):
        d = s.create_dataframe(at)
        u = d.filter(F.col("v") > 0).union(
            d.filter(F.col("v") < -40).select(
                F.col("k").alias("kk"), "v", "s", "a"))
        outs.append((u.to_arrow(), u.count(), u.columns))
    (jt, jc, jn), (pt_, pc, pn) = outs
    assert pn == jn == ["k", "v", "s", "a"]
    assert pc == jc == pt_.num_rows
    assert pt_.to_pylist() == jt.to_pylist()


def test_grouped_count():
    js, ps = sessions(SMALL)
    at = _table()
    got = ps.create_dataframe(at).group_by("k").count().to_arrow()
    want = js.create_dataframe(at).group_by("k").count().to_arrow()
    assert got.column_names == want.column_names == ["k", "count"]
    assert got.sort_by("k").to_pylist() == want.sort_by("k").to_pylist()


def test_cache_uncache():
    import torch
    js, ps = sessions(SMALL)
    at = _table()
    d = ps.create_dataframe(at).filter(PF.col("v") >= 0)
    c = d.cache()
    root, _ = c.physical_plan()
    assert isinstance(root, CachedScanExec)
    batches = root.batches
    assert len(batches) > 1 and all(
        b.device == torch.device("cpu") for b in batches)
    # the same results as the uncached query and as the JAX package
    q = lambda x, F: x.group_by("k").agg(F.sum("v").alias("sv"),
                                         F.count("*").alias("c"))
    want = q(js.create_dataframe(at).filter(JF.col("v") >= 0),
             JF).to_arrow().sort_by("k")
    for _ in range(2):
        got = q(c, PF)
        assert got.to_arrow().sort_by("k").to_pylist() == want.to_pylist()
    # a small cache takes the whole-input aggregate: no exchange
    nodes = _nodes(got.physical_plan()[0])
    assert any(isinstance(n, CachedScanExec) for n in nodes)
    assert not any(isinstance(n, (ShuffleExchangeExec, InMemoryScanExec))
                   for n in nodes)
    agg = [n for n in nodes if isinstance(n, HashAggregateExec)]
    assert len(agg) == 1 and agg[0].mode == "complete"
    # the uncached plan of the same query splits into partial / final
    assert any(isinstance(n, ShuffleExchangeExec)
               for n in _nodes(q(d, PF).physical_plan()[0]))
    assert c.count() == d.count()
    assert "CachedScanExec" in c.explain()
    # uncache frees the batches of every plan over the cache; the next
    # action plans the cached DataFrame's own plan again
    c.uncache()
    assert batches == [] and root.batches == []
    assert c.count() == d.count()
    assert not any(isinstance(n, CachedScanExec)
                   for n in _nodes(c.physical_plan()[0]))
    assert q(c, PF).to_arrow().sort_by("k").to_pylist() == \
        want.to_pylist()


@pytest.mark.parametrize("fallback", ["off", "on"])
def test_explain_modes(fallback):
    """ALL, NOT_ON_TPU and VALIDATE with the host fallback off (the
    parity sessions) and on (the default): a plan that runs on the
    device reads the same either way, and its VALIDATE equals the JAX
    package's, lore ids included (both number the converted tree before
    any fusion), but for the JAX fused stages (ROADMAP A.11). ANALYZE
    runs the query and names every node of the tree that ran."""
    import re
    conf = dict(SMALL)
    if fallback == "on":
        conf["spark.rapids.tpu.sql.allowCpuFallback"] = True
    js, ps = sessions(conf)
    d = ps.create_dataframe(_table()).group_by("k").agg(
        PF.sum("v").alias("sv"))
    text = d.explain()
    lines = text.splitlines()
    assert lines[0].startswith("* [loreId=1] Aggregate[")
    assert any("InMemoryScan[rows=300]" in ln for ln in lines)
    assert "== Physical Plan ==" in lines
    assert any("HashAggregateExec" in ln for ln in lines)
    assert d.explain("NOT_ON_TPU") == ""
    audit = d.explain("VALIDATE").splitlines()
    assert audit[0] == "== PLAN AUDIT =="
    assert audit[-1] == "-- no findings: plan runs fully on TPU --"
    jd = js.create_dataframe(_table()).group_by("k").agg(
        JF.sum("v").alias("sv"))
    want = jd.explain("VALIDATE")
    want = want.split("\n-- fused stages --")[0].splitlines()
    assert audit == want
    assert re.search(r" \[loreId=1\] ", audit[1])
    text = d.explain("ANALYZE").splitlines()
    assert text[0] == "== EXPLAIN ANALYZE =="
    assert text[1].startswith("[loreId=1] HashAggregateExec[")
    assert any(re.match(r"\s+\[loreId=\d+\] InMemoryScanExec  rows=300 ",
                        ln) for ln in text)
