"""The pandas execs (`exec/python_exec.py`, ROADMAP A.12) against the JAX
package and pandas: mapInPandas, applyInPandas, the aggregate in pandas,
cogroup, and `to_torch` against the JAX `to_jax`.

Inputs are numpy-made (seeded) columns. The pandas functions live in
`torch_udf_fns.py`, which imports numpy and pandas only, so a spawned
worker imports neither JAX nor a test module. Rows are exact: the
doubles summed in a worker are small integers, so any order of the
additions gives the same bits; a double summed on the device after a
worker is held within a relative 1e-9 where stated. Each JAX query runs
once and closes its pool (`_jax_rows`): the JAX pools live until their
plan is released, and their workers hold the JAX package's process-wide
slots."""
import contextlib
import io
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
import torch
import torch_udf_fns as fns
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.exec import python_exec as pe

#: a few partitions on each side
CONF = {"spark.rapids.tpu.sql.batchSizeRows": 512,
        "spark.rapids.tpu.sql.shuffle.partitions": 2,
        "spark.rapids.tpu.sql.allowCpuFallback": False,
        "spark.rapids.tpu.sql.exec.degradeToHost.enabled": False}
#: one worker a pool on the port's side (every worker spawned costs a
#: second or more). The JAX side keeps its default: the first conf a
#: process shows the JAX package sizes its process-wide slot bound, and
#: the JAX `tests/test_python_exec.py`, whose pools are never released,
#: needs more than one slot when it runs after this file in a process
PORT_CONF = {"spark.rapids.tpu.python.concurrentPythonWorkers": 1}


def _jax_rows(df):
    """The JAX query's rows, its pool closed after."""
    try:
        return df.to_arrow()
    finally:
        root = getattr(df, "_last_root", None)
        if root is not None:
            root.release()


def _sessions(conf=None):
    c = {**CONF, **(conf or {})}
    return st.TpuSession(c), pt.TpuSession({**c, **PORT_CONF},
                                           device="cpu")


def _data(n=3000, seed=12):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 9, n)),
                     "v": pa.array(rng.integers(-50, 50, n)
                                   .astype(np.float64)),
                     "w": pa.array(rng.integers(0, 1000, n))})


def _sorted(at, *keys):
    return at.sort_by([(k, "ascending") for k in keys]).to_pylist()


def test_map_in_pandas_equals_jax_and_pandas():
    at = _data()
    js, ps = _sessions()
    schema = {"j": [("k", jdt.INT64), ("v2", jdt.FLOAT64),
                    ("tag", jdt.STRING)],
              "p": [("k", pdt.INT64), ("v2", pdt.FLOAT64),
                    ("tag", pdt.STRING)]}
    j = _jax_rows(js.create_dataframe(at).map_in_pandas(
        fns.double_and_tag, schema["j"]))
    q = ps.create_dataframe(at).map_in_pandas(fns.double_and_tag,
                                              schema["p"])
    p = q.to_arrow()
    assert p.equals(j)
    want = fns.double_and_tag(at.to_pandas())
    assert p.to_pandas().equals(want)
    m = [v for k, v in q.last_metrics().items()
         if k.startswith("ArrowEvalPythonExec")][0]
    assert m["pythonEvalTime"] > 0 and m["numOutputRows"] == 3000
    assert m["numOutputBatches"] == 6          # one a 512-row batch
    # the device ops downstream run on the worker's output: a double
    # sum a tag, within a relative 1e-9 of pandas (sums reorder)
    got = q.filter(PF.col("v2") > 0).group_by("tag").agg(
        PF.sum(PF.col("v2")).alias("s")).to_arrow().to_pylist()
    exp = want[want["v2"] > 0].groupby("tag")["v2"].sum()
    assert {r["tag"] for r in got} == set(exp.index)
    for r in got:
        assert r["s"] == pytest.approx(exp[r["tag"]], rel=1e-9)


def test_map_in_pandas_empty_result_and_error_raise_as_jax():
    at = _data(n=300)
    js, ps = _sessions()
    out = ps.create_dataframe(at).map_in_pandas(
        fns.drop_all, [("k", pdt.INT64), ("v", pdt.FLOAT64),
                       ("w", pdt.INT64)]).to_arrow()
    assert out.num_rows == 0 and out.column_names == ["k", "v", "w"]
    msgs = []
    for s, dt in ((js, jdt), (ps, pdt)):
        q = s.create_dataframe(at).map_in_pandas(
            fns.pandas_boom, [("k", dt.INT64)])
        with pytest.raises(RuntimeError) as e:
            _jax_rows(q) if s is js else q.to_arrow()
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] == \
        "python worker failed: ValueError: python says no"


def test_apply_in_pandas_equals_jax_and_pandas():
    at = _data(seed=13)
    js, ps = _sessions()
    cols = [("k", "INT64"), ("v", "FLOAT64"), ("w", "INT64")]
    outs = []
    for s, dt in ((js, jdt), (ps, pdt)):
        q = s.create_dataframe(at).group_by("k").apply_in_pandas(
            fns.top2_by_v, [(n, getattr(dt, t)) for n, t in cols])
        outs.append(_jax_rows(q) if s is js else q.to_arrow())
    pdf = at.to_pandas()
    want = pd.concat([fns.top2_by_v(g) for _, g in pdf.groupby("k")])
    assert _sorted(outs[1], "k", "v", "w") == _sorted(outs[0], "k", "v",
                                                      "w")
    assert _sorted(outs[1], "k", "v", "w") == _sorted(
        pa.Table.from_pandas(want, preserve_index=False), "k", "v", "w")


def test_agg_in_pandas_equals_jax_and_pandas():
    at = _data(seed=14)
    js, ps = _sessions()
    outs = []
    for s, dt in ((js, jdt), (ps, pdt)):
        q = s.create_dataframe(at).group_by("k").agg_in_pandas(
            _types={"n": dt.INT64}, med=(fns.median_of, "v"),
            n=(fns.count_of, "v"), sp=(fns.spread, "v", "w"))
        outs.append(_jax_rows(q) if s is js else q.to_arrow())
    assert outs[1].column_names == ["k", "med", "n", "sp"]
    assert _sorted(outs[1], "k") == _sorted(outs[0], "k")
    pdf = at.to_pandas()
    want = [{"k": k, "med": float(g["v"].median()), "n": len(g),
             "sp": float((g["v"] - g["w"]).max())}
            for k, g in pdf.groupby("k")]
    assert _sorted(outs[1], "k") == want


def test_cogroup_equals_jax_and_pandas():
    at = _data(n=2000, seed=15)
    rng = np.random.default_rng(16)
    right = pa.table({"k2": pa.array(rng.integers(3, 12, 500)),
                      "u": pa.array(rng.integers(0, 9, 500)
                                    .astype(np.float64))})
    js, ps = _sessions()
    outs = []
    for s, dt in ((js, jdt), (ps, pdt)):
        q = s.create_dataframe(at).group_by("k").cogroup(
            s.create_dataframe(right).group_by("k2")).apply_in_pandas(
            fns.cogroup_counts, [("k", dt.INT64), ("nl", dt.INT64),
                                 ("nr", dt.INT64), ("sl", dt.FLOAT64),
                                 ("sr", dt.FLOAT64)])
        outs.append(_jax_rows(q) if s is js else q.to_arrow())
    assert _sorted(outs[1], "k") == _sorted(outs[0], "k")
    lp, rp = at.to_pandas(), right.to_pandas()
    want = []
    for k in sorted(set(lp["k"]) | set(rp["k2"])):
        lg, rg = lp[lp["k"] == k], rp[rp["k2"] == k]
        want.append({"k": k, "nl": len(lg), "nr": len(rg),
                     "sl": float(lg["v"].sum()),
                     "sr": float(rg["u"].sum())})
    assert _sorted(outs[1], "k") == want


def test_grouped_partitions_chunk_at_group_boundaries():
    """Under a small `python.groupedChunkBytes` a partition ships in
    several chunks, each of whole groups: the rows equal the unchunked
    run's, and no group is split (one output row a group)."""
    at = _data(n=4000, seed=17)
    _, ps = _sessions()
    schema = [("k", pdt.INT64), ("n", pdt.INT64), ("s", pdt.FLOAT64)]
    whole = ps.create_dataframe(at).group_by("k").apply_in_pandas(
        fns.group_size, schema)
    base = whole.to_arrow()
    small = pt.TpuSession({**CONF, **PORT_CONF,
                           "spark.rapids.tpu.python.groupedChunkBytes":
                           4096}, device="cpu")
    q = small.create_dataframe(at).group_by("k").apply_in_pandas(
        fns.group_size, schema)
    got = q.to_arrow()
    assert _sorted(got, "k") == _sorted(base, "k")
    assert got.num_rows == 9                     # one row a group
    chunks = sum(v.get("numGroupChunks", 0)
                 for v in q.last_metrics().values())
    whole_chunks = sum(v.get("numGroupChunks", 0)
                       for v in whole.last_metrics().values())
    assert whole_chunks == 2                     # one a partition
    assert chunks > whole_chunks


def test_worker_pool_bounded_and_reused():
    t = pa.table({"k": pa.array([1, 2]), "v": pa.array([1.0, 2.0])})
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    blob = sink.getvalue().to_pybytes()
    pool = pe.PythonWorkerPool(fns.double_and_tag, max_workers=2)
    results = []

    def go():
        results.append(pool.run(blob))

    threads = [threading.Thread(target=go) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert len(results) == 8
    assert 1 <= pool._spawned <= 2             # the bound held
    pool.close()
    assert pool._spawned == 0
    # in a query: one pool for the exec, its one worker (PORT_CONF)
    # serving every batch, and closed when the action ends
    _, ps = _sessions()
    df = ps.create_dataframe(_data(n=1600))
    schema = [("k", pdt.INT64), ("v", pdt.FLOAT64), ("w", pdt.INT64)]
    spawned = pe.pool_stats()["spawned"]
    q = df.map_in_pandas(fns.identity, schema)
    out = q.to_arrow()
    assert sum(m.get("numOutputBatches", 0)
               for m in q.last_metrics().values()) == 4
    assert pe.pool_stats()["spawned"] == spawned + 1
    assert pe.pool_stats()["pools"] == 0
    assert out.equals(df.to_arrow())
    stats = pe.pool_stats()
    assert stats["slotsUsed"] <= stats["slotsBound"]


def test_a_grouped_worker_error_raises_and_frees_its_slot():
    _, ps = _sessions()
    before = pe.pool_stats()["slotsUsed"]
    with pytest.raises(RuntimeError, match="python says no"):
        ps.create_dataframe(_data(n=100)).group_by("k").apply_in_pandas(
            fns.pandas_boom, [("k", pdt.INT64)]).to_arrow()
    assert pe.pool_stats()["slotsUsed"] <= before


def test_python_exec_output_lies_on_the_session_device():
    _, ps = _sessions()
    q = ps.create_dataframe(_data(n=200)).map_in_pandas(
        fns.identity, [("k", pdt.INT64), ("v", pdt.FLOAT64),
                       ("w", pdt.INT64)])
    root, ctx = q.physical_plan()
    try:
        for b in root.execute_all(ctx):
            assert all(t.device == ps.device for c in b.table.columns
                       for t in c.buffers())
    finally:
        ctx.close()


def test_audit_verdicts_of_the_pandas_nodes_equal_jax():
    at = _data(n=50)
    texts = []
    for s, dt in zip(_sessions(), (jdt, pdt)):
        df = s.create_dataframe(at)
        qs = [df.map_in_pandas(fns.identity, [("k", dt.INT64)]),
              df.group_by("k").apply_in_pandas(fns.identity,
                                               [("k", dt.INT64)]),
              df.group_by("k").cogroup(df.group_by("k")).apply_in_pandas(
                  fns.cogroup_counts, [("k", dt.INT64)])]
        with contextlib.redirect_stdout(io.StringIO()):
            texts.append([q.explain("VALIDATE") for q in qs])
    for j, p in zip(*texts):
        j = j.split("\n-- fused stages --")[0]
        assert p == j
        assert "will_fallback [loreId=1]" in p and "python_exec: rows " \
            "cross to a pooled python worker process" in p


def test_to_torch_equals_to_jax():
    at = _data(seed=6)
    js, ps = _sessions()
    j = js.create_dataframe(at).filter(JF.col("v") > 0).to_jax()
    p = ps.create_dataframe(at).filter(PF.col("v") > 0).to_torch()
    assert set(p) == set(j) == {"k", "v", "w"}
    for name in j:
        assert isinstance(p[name][0], torch.Tensor)
        assert p[name][0].device == ps.device
        assert np.array_equal(p[name][0].numpy(), np.asarray(j[name][0]))
        assert np.array_equal(p[name][1].numpy(), np.asarray(j[name][1]))
    keep = at.column("v").to_numpy() > 0
    assert p["w"][0].tolist() == at.column("w").to_numpy()[keep].tolist()
    empty = ps.create_dataframe(at).filter(PF.col("v") > 1e9).to_torch()
    assert [len(d) for d, _ in empty.values()] == [0, 0, 0]
    strings = {"s": pa.array(["a"])}
    for s in (js, ps):
        export = s.create_dataframe(strings)
        with pytest.raises(TypeError, match="fixed-width columns; s is "):
            export.to_jax() if s is js else export.to_torch()


def test_ml_handoff_to_torch_trains():
    """The XGBoost-ETL analog (JAX `test_ml_handoff_to_jax`): ETL on
    the engine, then `to_torch()` hands the features to a torch
    training loop with no Arrow round trip; the loss falls."""
    rng = np.random.default_rng(5)
    n = 8000
    x1, x2 = rng.normal(0, 1, n), rng.normal(0, 1, n)
    label = (2.0 * x1 - 1.5 * x2 + rng.normal(0, 0.3, n) > 0) \
        .astype(np.int64)
    _, ps = _sessions({"spark.rapids.tpu.sql.batchSizeRows": 4096})
    df = ps.create_dataframe({"x1": pa.array(x1), "x2": pa.array(x2),
                              "y": pa.array(label),
                              "junk": pa.array(["z"] * n)})
    feat = df.filter(PF.col("x1").isNotNull()).select(
        PF.col("x1"), PF.col("x2"), (PF.col("x1") * PF.col("x2"))
        .alias("x3"), PF.col("y"))
    h = feat.to_torch()
    X = torch.stack([h["x1"][0], h["x2"][0], h["x3"][0]], dim=1)
    y = h["y"][0].to(torch.float64)
    assert X.device == ps.device and X.shape == (n, 3)
    w = torch.zeros(3, dtype=torch.float64, requires_grad=True)

    def loss():
        p = torch.sigmoid(X @ w)
        return -torch.mean(y * torch.log(p + 1e-7)
                           + (1 - y) * torch.log(1 - p + 1e-7))

    l0 = float(loss().detach())
    for _ in range(60):
        lv = loss()
        (g,) = torch.autograd.grad(lv, w)
        with torch.no_grad():
            w -= 0.5 * g
    l1 = float(loss().detach())
    assert l1 < l0 * 0.6
    acc = float(((X @ w > 0) == (y > 0.5)).double().mean())
    assert acc > 0.85
