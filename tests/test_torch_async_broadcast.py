"""The async broadcast build in the port (`exec/broadcast.py`, its trigger
in `exec/join.py`).

- A broadcast join gives the same rows with
  `sql.exec.exchange.asyncBroadcast.enabled` on and off; on, the build
  runs on a build-pool thread and `broadcastBuildOverlapMs` is recorded.
- Past `broadcastTimeoutSecs` the waiting thread counts
  `broadcastTimeoutFallbacks` and joins the running build under the
  instance lock: the build's child runs once, never twice at once.
- An exception raised in the build reaches the caller, through
  `await_build` and through a query; it is not rebuilt quietly.
- A build whose subtree holds another broadcast join runs that nested
  build inline on its pool thread: no wait on its own pool, no timeout.
- The process counters that a build thread and its consumer raise at
  once (`utils/transfer.syncs`, the partition kernel's launches) lose
  no increment: a query counts the same with the build on its pool
  thread as without.
"""
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.columnar.table import Schema
from spark_rapids_tpu_torch.exec import broadcast as pb
from spark_rapids_tpu_torch.exec.base import ExecContext, TpuExec
from spark_rapids_tpu_torch.exec.broadcast import BroadcastExchangeExec
from spark_rapids_tpu_torch.exec.nodes import InMemoryScanExec
from spark_rapids_tpu_torch.ops import partition_kernels as pk
from spark_rapids_tpu_torch.utils import transfer

ASYNC_OFF = {"spark.rapids.tpu.sql.exec.exchange.asyncBroadcast.enabled":
             False}
CONF = {"spark.rapids.tpu.sql.batchSizeRows": 1000}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tables(seed=3):
    rng = np.random.default_rng(seed)
    fact = pa.table({"k": pa.array(rng.integers(0, 500, 6000)),
                     "v": pa.array(np.arange(6000))})
    dim = pa.table({"k": pa.array(np.arange(500)),
                    "w": pa.array(rng.integers(0, 50, 500))})
    sub = pa.table({"w": pa.array(np.arange(50)),
                    "x": pa.array(np.arange(50) * 7)})
    return fact, dim, sub


def _rows(at):
    cols = sorted(at.column_names)
    return sorted(map(tuple, at.select(cols).to_pylist()))


def _nodes(root, name):
    out, stack = [], [root]
    while stack:
        node = stack.pop()
        if type(node).__name__ == name:
            out.append(node)
        stack.extend(node.children)
    return out


def test_async_on_and_off_give_equal_rows():
    fact, dim, _ = _tables()
    outs = {}
    for name, extra in (("on", {}), ("off", ASYNC_OFF)):
        s = pt.TpuSession(dict(CONF, **extra), device="cpu")
        q = s.create_dataframe(fact).join(s.create_dataframe(dim), on=["k"])
        outs[name] = q.to_arrow()
        (b,) = _nodes(q.last_plan(), "BroadcastExchangeExec")
        m = q.last_metrics()[b._op_id]
        assert ("broadcastBuildOverlapMs" in m) == (name == "on")
        assert m.get("broadcastTimeoutFallbacks", 0) == 0
    assert outs["on"].num_rows == 6000
    assert _rows(outs["on"]) == _rows(outs["off"])


class _Slow(TpuExec):
    """A build child whose one partition sleeps, then yields a batch (or
    raises); counts its executions and the threads that ran it."""

    def __init__(self, at, sleep=0.0, error=None):
        super().__init__([], Schema.from_arrow(at.schema))
        self.scan = InMemoryScanExec(at, self.schema)
        self.sleep, self.error = sleep, error
        self.runs, self.threads = 0, []

    def execute_partition(self, ctx, pid):
        self.runs += 1
        self.threads.append(threading.current_thread().name)
        time.sleep(self.sleep)
        if self.error is not None:
            raise self.error
        yield from self.scan.execute_partition(ctx, pid)


def _ctx():
    return ExecContext(pt.TpuSession(CONF, device="cpu").conf,
                       torch.device("cpu"))


def test_timeout_joins_the_running_build_and_counts_it():
    _, dim, _ = _tables()
    child = _Slow(dim, sleep=0.3)
    b = BroadcastExchangeExec(child, child.schema)
    ctx = _ctx()
    b.submit_build(ctx)
    time.sleep(0.05)                 # the pool thread is inside the build
    batches = b.await_build(ctx, 0.01)
    assert child.runs == 1 and child.threads[0].startswith(
        pb.BUILD_POOL_PREFIX)
    assert sum(x.num_rows for x in batches) == 500
    m = ctx.metrics[b._op_id]
    assert m["broadcastTimeoutFallbacks"] == 1
    # served again without a build
    assert list(b.execute_partition(ctx, 0)) == batches
    assert child.runs == 1


def test_timeout_runs_a_build_that_has_not_started():
    """Every pool worker busy: the timed-out build is cancelled on the
    pool and runs on the waiting thread, once."""
    _, dim, _ = _tables()
    blockers = [_Slow(dim, sleep=0.4) for _ in range(4)]
    ctx = _ctx()
    held = [BroadcastExchangeExec(c, c.schema) for c in blockers]
    for h in held:
        h.submit_build(ctx)
    child = _Slow(dim)
    b = BroadcastExchangeExec(child, child.schema)
    batches = b.await_build(ctx, 0.01)
    assert sum(x.num_rows for x in batches) == 500
    assert ctx.metrics[b._op_id]["broadcastTimeoutFallbacks"] == 1
    for h in held:
        h.await_build(ctx, 0)
    assert child.runs == 1
    assert not child.threads[0].startswith(pb.BUILD_POOL_PREFIX)


def test_an_error_in_the_build_reaches_the_caller():
    _, dim, _ = _tables()
    child = _Slow(dim, error=ValueError("build side failed"))
    b = BroadcastExchangeExec(child, child.schema)
    with pytest.raises(ValueError, match="build side failed"):
        b.await_build(_ctx(), 30.0)
    assert child.runs == 1


def test_an_error_in_the_build_fails_the_query(monkeypatch):
    fact, dim, _ = _tables()
    orig = BroadcastExchangeExec._materialize

    def failing(self, ctx):
        if pb.on_build_pool():
            raise RuntimeError("async build failed")
        return orig(self, ctx)
    monkeypatch.setattr(BroadcastExchangeExec, "_materialize", failing)
    s = pt.TpuSession(CONF, device="cpu")
    q = s.create_dataframe(fact).join(s.create_dataframe(dim), on=["k"])
    with pytest.raises(RuntimeError, match="async build failed"):
        q.to_arrow()


def test_a_nested_build_runs_inline_without_deadlock():
    fact, dim, sub = _tables()
    conf = dict(CONF, **{
        "spark.rapids.tpu.sql.exec.exchange.broadcastTimeoutSecs": 60.0,
        "spark.rapids.tpu.sql.optimizer.joinReorder.enabled": False})
    outs = {}
    for name, extra in (("on", {}), ("off", ASYNC_OFF)):
        s = pt.TpuSession(dict(conf, **extra), device="cpu")
        inner = s.create_dataframe(dim).join(s.create_dataframe(sub),
                                             on=["w"])
        q = s.create_dataframe(fact).join(inner, on=["k"])
        t0 = time.perf_counter()
        outs[name] = q.to_arrow()
        assert time.perf_counter() - t0 < 30
        bs = _nodes(q.last_plan(), "BroadcastExchangeExec")
        assert len(bs) == 2
        mets = [q.last_metrics().get(b._op_id, {}) for b in bs]
        assert all(m.get("broadcastTimeoutFallbacks", 0) == 0
                   for m in mets)
        if name == "on":
            # the outer build went to the pool; the nested one ran
            # inline on that pool thread, so it recorded no overlap
            assert sorted("broadcastBuildOverlapMs" in m
                          for m in mets) == [False, True]
    assert outs["on"].num_rows == 6000
    assert _rows(outs["on"]) == _rows(outs["off"])


def test_concurrent_consumers_build_and_map_once():
    """Sixteen threads under a shortened switch interval share one
    broadcast build and one exchange's map phase: whatever the
    interleaving, the build's child runs once and the map side maps
    each input batch once."""
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.expr.expressions import BoundRef
    fact, dim, _ = _tables()
    child = _Slow(dim, sleep=0.01)
    b = BroadcastExchangeExec(child, child.schema)
    schema = Schema.from_arrow(fact.schema)
    ex = ShuffleExchangeExec(InMemoryScanExec(fact, schema), 4,
                             [BoundRef(0, schema[0].dtype, "k")], schema)
    ctx = _ctx()
    errors, rows = [], []

    def work(i):
        try:
            if i % 3 == 0:
                rows.append(sum(x.num_rows for x in b.await_build(ctx, 30)))
            elif i % 3 == 1:
                rows.append(sum(x.num_rows
                                for x in b.execute_partition(ctx, 0)))
            else:
                ex.stage_stats(ctx)
                ex.read_slice(ctx, i % 4)
        except BaseException as e:     # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert child.runs == 1 and set(rows) == {500}
    m = ctx.metrics[ex._op_id]
    assert m["mapBatches"] == m["mapPartitionsExecuted"] == 6


def test_on_build_pool_names_the_pool_threads():
    assert not pb.on_build_pool()
    assert pb._build_pool().submit(pb.on_build_pool).result(10)


def _exchanging_join(session):
    """Both sides of a broadcast join exchange on an int32 key (the
    adaptive driver off, so the build's exchange maps on the build
    thread while the stream's maps on the consumer's)."""
    rng = np.random.default_rng(11)
    fact = pa.table({"k": pa.array(rng.integers(0, 400, 6000), pa.int32()),
                     "v": pa.array(np.arange(6000))})
    dim = pa.table({"k": pa.array(rng.integers(0, 400, 3000), pa.int32()),
                    "w": pa.array(rng.integers(0, 50, 3000))})
    stream = session.create_dataframe(fact).group_by("k").agg(
        F.sum("v").alias("v"))
    build = session.create_dataframe(dim).group_by("k").agg(
        F.max("w").alias("w"))
    return stream.join(build, on=["k"])


def _counted_runs(device, turns=3):
    """Per conf, the rows and the (syncs, launches) of `turns` runs,
    under a switch interval short enough to interleave the threads."""
    conf = dict(CONF, **{"spark.rapids.tpu.sql.adaptive.enabled": False,
                         "spark.rapids.tpu.sql.batchSizeRows": 500})
    got = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for name, extra in (("on", {}), ("off", ASYNC_OFF)):
            s = pt.TpuSession(dict(conf, **extra), device=device)
            counts, rows = [], []
            for _ in range(turns):
                q = _exchanging_join(s)
                transfer.syncs = pk.launches = 0
                rows.append(_rows(q.to_arrow()))
                counts.append((transfer.syncs, pk.launches))
                (b,) = _nodes(q.last_plan(), "BroadcastExchangeExec")
                assert (("broadcastBuildOverlapMs" in
                         q.last_metrics()[b._op_id]) == (name == "on"))
            got[name] = rows, counts
    finally:
        sys.setswitchinterval(old)
    return got


def test_syncs_of_a_build_and_its_stream_add_up_exactly():
    got = _counted_runs("cpu")
    (rows_on, on), (rows_off, off) = got["on"], got["off"]
    assert rows_on == rows_off and len(rows_on[0]) > 0
    assert on[0][0] > 0 and set(on) == set(off) == {off[0]}


def test_the_sync_count_loses_no_increment_across_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        transfer.syncs = 0
        threads = [threading.Thread(
            target=lambda: [transfer.note_sync() for _ in range(5000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert transfer.syncs == 8 * 5000


@pytest.mark.cuda
def test_launches_of_a_build_and_its_stream_add_up_exactly():
    """On the card both threads launch the partition kernel: the count
    with the build on its pool thread equals the count without."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = _counted_runs(None)
    (rows_on, on), (rows_off, off) = got["on"], got["off"]
    assert rows_on == rows_off
    assert on[0][1] > 0 and set(on) == set(off) == {off[0]}


@pytest.mark.cuda
def test_the_build_runs_on_the_submitting_threads_stream():
    """On the card the build thread enqueues on the stream current where
    the join submitted it: its kernels are ordered before the probe's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fact, dim, _ = _tables()
    seen = []
    orig = BroadcastExchangeExec._materialize

    def spy(self, ctx):
        seen.append(torch.cuda.current_stream().cuda_stream)
        return orig(self, ctx)
    BroadcastExchangeExec._materialize = spy
    try:
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            s = pt.TpuSession(CONF)
            q = s.create_dataframe(fact).join(s.create_dataframe(dim),
                                              on=["k"])
            got = q.to_arrow()
    finally:
        BroadcastExchangeExec._materialize = orig
    assert seen and set(seen) == {side.cuda_stream}
    off = pt.TpuSession(dict(CONF, **ASYNC_OFF))
    want = off.create_dataframe(fact).join(off.create_dataframe(dim),
                                           on=["k"]).to_arrow()
    assert _rows(got) == _rows(want)
