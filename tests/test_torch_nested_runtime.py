"""Nested columns through the PyTorch port's runtime (on the CPU),
against the JAX package where it runs the same query:
  - a hash exchange with several partitions, on the pooled map
    (`sql.exec.exchange.mapThreads` 4);
  - a broadcast join and a shuffled join carrying list, struct and map
    payloads on both sides;
  - the coalescing of many small Parquet files, and union;
  - the spill store: a nested batch to host and to disk and back, byte
    for byte, and the OOM split of a nested batch;
  - `read.parquet` of a file written with a list and a struct column,
    on the host decode and with the device decode on (which refuses the
    nested chunks and leaves them to the host);
  - collect_list and collect_set over several partitions, of strings
    through the exchange;
  - percentile and percentile_approx over a list of percentages.
Exact, but percentile_approx within a relative 1e-9. Rows whose order
the query does not define compare as multisets.
"""
import math
import os
from collections import Counter

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.columnar.table import Table
from spark_rapids_tpu_torch.exec.batch import DeviceBatch
from spark_rapids_tpu_torch.exec.coalesce import CoalesceBatchesExec
from spark_rapids_tpu_torch.exec.nodes import _batch_to_arrow
from spark_rapids_tpu_torch.memory import retry
from spark_rapids_tpu_torch.memory.device import DeviceManager
from spark_rapids_tpu_torch.memory.diagnostics import assert_no_leaks
from spark_rapids_tpu_torch.memory.spill import SpillStore
from torch_parity import sessions

CPU = torch.device("cpu")
POOLED = {"spark.rapids.tpu.sql.batchSizeRows": 128,
          "spark.rapids.tpu.sql.exec.exchange.mapThreads": 4}


def nested_table(n=400, seed=11):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 25, n)
    lists = [None if rng.random() < 0.1 else
             [int(x) for x in rng.integers(-9, 9, rng.integers(0, 5))]
             for _ in range(n)]
    strs = [None if rng.random() < 0.1 else
            [f"w{x}" * int(x % 3 + 1) for x in rng.integers(0, 9,
                                                           rng.integers(0, 4))]
            for _ in range(n)]
    structs = [None if rng.random() < 0.1 else
               {"x": int(a), "y": None if a % 4 == 0 else f"y{a}",
                "z": [int(a)] * int(a % 3)}
               for a in rng.integers(0, 50, n)]
    maps = [None if rng.random() < 0.1 else
            [(f"m{j}", int(v)) for j, v in enumerate(
                rng.integers(0, 99, rng.integers(0, 3)))]
            for _ in range(n)]
    return pa.table({
        "k": pa.array(k.astype(np.int64)),
        "v": pa.array(rng.integers(0, 1000, n).astype(np.int32)),
        "l": pa.array(lists, pa.list_(pa.int64())),
        "ls": pa.array(strs, pa.list_(pa.string())),
        "st": pa.array(structs, pa.struct([("x", pa.int64()),
                                           ("y", pa.string()),
                                           ("z", pa.list_(pa.int64()))])),
        "m": pa.array(maps, pa.map_(pa.string(), pa.int64()))})


def _multiset(at):
    return Counter(repr(r) for r in at.to_pylist())


def test_hash_exchange_pooled_map():
    at = nested_table()
    js, ps = sessions(POOLED)
    q = lambda d, F: d.repartition(8, "k")
    got = q(ps.create_dataframe(at), PF).to_arrow()
    want = q(js.create_dataframe(at), JF).to_arrow()
    assert got.schema.types == want.schema.types == at.schema.types
    # the same partitions in the same order: the same rows in order
    assert got.to_pylist() == want.to_pylist()
    assert _multiset(got) == _multiset(at)
    # and a round-robin repartition
    got = ps.create_dataframe(at).repartition(5).to_arrow()
    assert _multiset(got) == _multiset(at)


def _join_reference(left, right, how):
    """Rows of `left` joined with `right` on k, in plain Python."""
    rk = right.column_names
    by_k = {}
    for r in right.to_pylist():
        by_k.setdefault(r["k"], []).append(r)
    out, hit = [], set()
    none_r = {c: None for c in rk if c != "k"}
    for lr in left.to_pylist():
        ms = by_k.get(lr["k"], [])
        for m in ms:
            hit.add(id(m))
            out.append({**lr, **{c: m[c] for c in rk if c != "k"}})
        if not ms and how in ("left", "full"):
            out.append({**lr, **none_r})
    if how == "full":
        none_l = {c: None for c in left.column_names}
        for ms in by_k.values():
            for m in ms:
                if id(m) not in hit:
                    out.append({**none_l, **m})
    return Counter(repr(r) for r in out)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("topology", ["broadcast", "shuffled"])
def test_join_payloads(topology, how):
    """The JAX package's shuffled join cannot return a map payload
    (its Arrow conversion meets null keys, ROADMAP C.19): there the map
    columns leave the comparison with it, and every column is held to a
    plain Python join."""
    at = nested_table()
    right = nested_table(n=60, seed=12).rename_columns(
        ["k", "v2", "l2", "ls2", "st2", "m2"])
    conf = dict(POOLED)
    if topology == "shuffled":
        conf["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"] = -1
    js, ps = sessions(conf)
    got = ps.create_dataframe(at).join(ps.create_dataframe(right),
                                       on=["k"], how=how).to_arrow()
    assert _multiset(got) == _join_reference(at, right, how)
    if topology == "shuffled":
        at, right = at.drop(["m"]), right.drop(["m2"])
        got = got.drop(["m", "m2"])
    want = js.create_dataframe(at).join(js.create_dataframe(right),
                                        on=["k"], how=how).to_arrow()
    assert got.schema.types == want.schema.types
    assert _multiset(got) == _multiset(want)


def test_coalesce_and_union(tmp_path):
    at = nested_table(n=240)
    paths = []
    for i in range(6):
        p = str(tmp_path / f"part{i}.parquet")
        pq.write_table(at.slice(40 * i, 40), p)
        paths.append(p)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1000,
            "spark.rapids.tpu.sql.format.parquet.reader.type":
                "MULTITHREADED"}
    js, ps = sessions(conf)
    d = ps.read.parquet(*paths)
    root, _ = d.physical_plan()
    assert isinstance(root, CoalesceBatchesExec)
    got = d.to_arrow()
    assert got.to_pylist() == at.to_pylist()
    assert got.to_pylist() == js.read.parquet(*paths).to_arrow().to_pylist()
    u = d.union(ps.create_dataframe(at.slice(0, 50)))
    wu = js.read.parquet(*paths).union(js.create_dataframe(at.slice(0, 50)))
    assert u.to_arrow().to_pylist() == wu.to_arrow().to_pylist()
    assert u.count() == 290


def test_spill_to_host_and_disk(tmp_path):
    at = nested_table(n=300)
    dm = DeviceManager(budget_bytes=1 << 30)
    store = SpillStore(dm, spill_dir=str(tmp_path), host_limit=0)
    b = DeviceBatch(Table.from_arrow(at, CPU))
    before = [t.clone() for c in b.table.columns for t in c.buffers()]
    h = store.add_batch(b)
    assert h.spill_to_host() == b.nbytes and h.state == "host"
    b1 = h.materialize()
    assert _batch_to_arrow(b1).equals(at)
    assert h.spill_to_disk() == b.nbytes and h.state == "disk"
    assert os.listdir(tmp_path) == [f"spill-{h.id}.bin"]
    b2 = h.materialize()
    assert os.listdir(tmp_path) == []
    after = [t for c in b2.table.columns for t in c.buffers()]
    assert len(after) == len(before)
    for x, y in zip(before, after):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert _batch_to_arrow(b2).equals(at)
    h.close()
    assert_no_leaks(store)


def test_oom_split_of_a_nested_batch():
    at = nested_table(n=301)
    b = DeviceBatch(Table.from_arrow(at, CPU))
    halves = retry.split_batch_in_half(b)
    got = pa.concat_tables([_batch_to_arrow(h) for h in halves])
    assert got.equals(at)


@pytest.mark.parametrize("device_decode", [False, True])
def test_read_parquet_list_and_struct(tmp_path, device_decode):
    at = nested_table(n=500).select(["k", "v", "l", "st", "ls"])
    p = str(tmp_path / "nested.parquet")
    pq.write_table(at, p, row_group_size=128)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 200}
    if device_decode:
        conf["spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled"] = \
            True
    js, ps = sessions(conf)
    d = ps.read.parquet(p)
    got = d.to_arrow()
    assert got.to_pylist() == at.to_pylist()
    assert got.to_pylist() == js.read.parquet(p).to_arrow().to_pylist()
    if device_decode:
        m = {k: v for ms in d.last_metrics().values()
             for k, v in ms.items()}
        # k and v on the device; the nested columns' chunks are not
        # eligible, so the host decode reads them
        assert m.get("deviceDecodedChunks", 0) > 0
    # a query over the nested columns read back
    q = lambda x, F: x.select(F.col("k"), F.size(F.col("l")).alias("n"),
                              F.col("st").getField("y").alias("y"))
    assert q(d, PF).to_arrow().to_pylist() == \
        q(js.read.parquet(p), JF).to_arrow().to_pylist()


@pytest.mark.parametrize("parts", ["one", "many"])
def test_collect_over_partitions(parts):
    rng = np.random.default_rng(7)
    n = 900
    at = pa.table({"k": pa.array(rng.integers(0, 13, n)),
                   "v": pa.array(rng.integers(0, 30, n),
                                 mask=rng.random(n) < 0.1),
                   "t": pa.array([f"t{x % 7}" for x in
                                  rng.integers(0, 50, n)])})
    conf = POOLED if parts == "many" else {}
    js, ps = sessions(conf)
    q = lambda d, F: d.group_by("k").agg(
        F.collect_list(F.col("v")).alias("cl"),
        F.collect_set(F.col("v")).alias("cs"),
        F.collect_list(F.col("t")).alias("ct"),
        F.collect_set(F.col("t")).alias("cst"),
        F.count("*").alias("c"))
    got = q(ps.create_dataframe(at), PF).to_arrow().sort_by("k")
    want = q(js.create_dataframe(at), JF).to_arrow().sort_by("k")
    assert got.schema.types == want.schema.types
    assert got.to_pylist() == want.to_pylist()
    # ungrouped too: one list of every value
    u = lambda d, F: d.agg(F.collect_list(F.col("t")).alias("all"),
                           F.collect_set(F.col("v")).alias("vs"))
    assert u(ps.create_dataframe(at), PF).to_arrow().to_pylist() == \
        u(js.create_dataframe(at), JF).to_arrow().to_pylist()


@pytest.mark.parametrize("parts", ["one", "many"])
def test_percentiles_over_a_list(parts):
    rng = np.random.default_rng(8)
    n = 700
    at = pa.table({"k": pa.array(rng.integers(0, 6, n)),
                   "x": pa.array(rng.standard_normal(n) * 100,
                                 mask=rng.random(n) < 0.1)})
    conf = POOLED if parts == "many" else {}
    js, ps = sessions(conf)
    q = lambda d, F: d.group_by("k").agg(
        F.percentile("x", [0.0, 0.25, 0.5, 0.9, 1.0]).alias("p"),
        F.percentile_approx("x", [0.1, 0.5, 0.99]).alias("pa"))
    got = q(ps.create_dataframe(at), PF).to_arrow().sort_by("k")
    want = q(js.create_dataframe(at), JF).to_arrow().sort_by("k")
    assert got.schema.types == want.schema.types
    assert got.column("p").to_pylist() == want.column("p").to_pylist()
    for a, b in zip(got.column("pa").to_pylist(),
                    want.column("pa").to_pylist()):
        assert len(a) == len(b) == 3
        assert all(math.isclose(x, y, rel_tol=1e-9) for x, y in zip(a, b))
    u = lambda d, F: d.agg(F.percentile("x", [0.5, 0.75]).alias("p"))
    assert u(ps.create_dataframe(at), PF).to_arrow().to_pylist() == \
        u(js.create_dataframe(at), JF).to_arrow().to_pylist()
