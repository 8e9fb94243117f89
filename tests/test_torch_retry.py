"""Per-operator OOM retry of the PyTorch port (on the CPU) against the JAX
package: `tests/test_memory_shuffle.py:189-250`. The OOM is injected on
the first call(s) by monkeypatch, in the port (`torch.OutOfMemoryError`,
or the analytic `BudgetExceeded`) and in the JAX package
(`RESOURCE_EXHAUSTED`) alike: the join's probe splits its stream batch,
the exchange's map pass splits its batch, the aggregate's first pass
splits its batch, and the exchange's reduce and the sort's parking retry
unsplit. Each result must equal the JAX package's under the same
injection, and the uninjected run's: exact.
"""
import threading

import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu.exec.exchange import ShuffleExchangeExec as JExchange
from spark_rapids_tpu.exec.join import HashJoinExec as JJoin
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.exec.join import HashJoinExec
from spark_rapids_tpu_torch.memory import retry
from spark_rapids_tpu_torch.memory.device import BudgetExceeded
from spark_rapids_tpu_torch.memory.spill import SpillStore

OOMS = {"cuda": lambda: __import__("torch").OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 1.00 GiB"),
        "budget": lambda: BudgetExceeded("injected")}


def _join_tables(n=1000):
    l_ = {"k": pa.array([i % 40 for i in range(n)], pa.int64()),
          "a": pa.array(list(range(n)), pa.int64()),
          "s": pa.array([f"v{i}" for i in range(n)])}
    r = {"k": pa.array(list(range(40)), pa.int64()),
         "b": pa.array([i * 2 for i in range(40)], pa.int64())}
    return l_, r


def _rows(at):
    return sorted(zip(*[c.to_pylist() for c in at.columns]))


@pytest.mark.parametrize("oom", list(OOMS))
@pytest.mark.parametrize("how", ["inner", "right"])
def test_join_probe_retry_splits_stream(monkeypatch, oom, how):
    l_, r = _join_tables()
    s = pt.TpuSession({}, device="cpu")
    want = _rows(s.create_dataframe(l_).join(s.create_dataframe(r),
                                             on=["k"], how=how).to_arrow())
    orig = HashJoinExec._probe_batch
    state = {"fired": 0}

    def flaky(self, ctx, batch, *a, **kw):
        if state["fired"] < 2 and batch.capacity > 256:
            state["fired"] += 1
            raise OOMS[oom]()
        return orig(self, ctx, batch, *a, **kw)

    monkeypatch.setattr(HashJoinExec, "_probe_batch", flaky)
    retry.reset_retry_stats()
    q = s.create_dataframe(l_).join(s.create_dataframe(r), on=["k"],
                                    how=how)
    got = _rows(q.to_arrow())
    assert state["fired"] == 2 and got == want
    assert retry.retry_stats()["splits"] == 2
    stream = sum(v.get("streamBatches", 0) for k, v in
                 q.last_metrics().items() if k.startswith("HashJoin"))
    assert stream == 1          # one stream batch, probed in three parts

    jorig = JJoin._probe_batch
    jstate = {"fired": 0}

    def jflaky(self, ctx, m, batch, *a, **kw):
        if jstate["fired"] < 2 and batch.capacity > 256:
            jstate["fired"] += 1
            raise RuntimeError("RESOURCE_EXHAUSTED: injected")
        yield from jorig(self, ctx, m, batch, *a, **kw)

    monkeypatch.setattr(JJoin, "_probe_batch", jflaky)
    js = st.TpuSession({})
    assert _rows(js.create_dataframe(l_).join(js.create_dataframe(r),
                                              on=["k"], how=how)
                 .to_arrow()) == got
    assert jstate["fired"] == 2


@pytest.mark.parametrize("oom", list(OOMS))
def test_exchange_map_retry_splits(monkeypatch, oom):
    n = 2000
    data = {"k": pa.array([i % 900 for i in range(n)], pa.int64()),
            "v": pa.array(list(range(n)), pa.int64())}
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 512,
            "spark.rapids.tpu.sql.adaptive.enabled": False}
    orig = ShuffleExchangeExec._map_batch
    # The map runs on a pool: record each worker thread's capacities, and
    # which thread met the injected OOM.
    state = {"fired": 0, "batches": {}, "raiser": None}
    lock = threading.Lock()

    def flaky(self, batch):
        tid = threading.get_ident()
        with lock:
            state["batches"].setdefault(tid, []).append(batch.capacity)
            fire = state["fired"] < 1 and batch.capacity > 256
            if fire:
                state["fired"] += 1
                state["raiser"] = tid
        if fire:
            raise OOMS[oom]()
        return orig(self, batch)

    monkeypatch.setattr(ShuffleExchangeExec, "_map_batch", flaky)
    s = pt.TpuSession(conf, device="cpu")
    q = s.create_dataframe(data).group_by("k").agg(F.sum("v").alias("s"))
    out = q.to_arrow()
    got = dict(zip(out.column(0).to_pylist(), out.column(1).to_pylist()))
    want = {}
    for i in range(n):
        want[i % 900] = want.get(i % 900, 0) + i
    assert got == want and state["fired"] == 1
    seq = state["batches"][state["raiser"]]
    first = seq[0]
    assert seq[1:3] == [first // 2, first - first // 2]

    jorig = JExchange._run_map
    jstate = {"fired": 0}

    def jflaky(self, cvs, mask):
        if jstate["fired"] < 1 and mask.shape[0] > 256:
            jstate["fired"] += 1
            raise RuntimeError("RESOURCE_EXHAUSTED: injected")
        return jorig(self, cvs, mask)

    monkeypatch.setattr(JExchange, "_run_map", jflaky)
    js = st.TpuSession(conf)
    jout = js.create_dataframe(data).group_by("k").agg(
        JF.sum("v").alias("s")).to_arrow()
    assert dict(zip(jout.column(0).to_pylist(),
                    jout.column(1).to_pylist())) == got
    assert jstate["fired"] == 1


def test_aggregate_update_retry_splits(monkeypatch):
    n = 3000
    data = {"k": pa.array([f"g{i % 50}" for i in range(n)]),
            "v": pa.array(list(range(n)), pa.int64())}
    s = pt.TpuSession({}, device="cpu")
    want = s.create_dataframe(data).group_by("k").agg(
        F.sum("v").alias("s")).to_arrow().sort_by("k")
    orig = HashAggregateExec._update_one
    state = {"fired": 0}

    def flaky(self, ctx, batch, *a):
        if state["fired"] < 3 and batch.capacity > 400:
            state["fired"] += 1
            raise OOMS["cuda"]()
        return orig(self, ctx, batch, *a)

    monkeypatch.setattr(HashAggregateExec, "_update_one", flaky)
    q = s.create_dataframe(data).group_by("k").agg(F.sum("v").alias("s"))
    assert q.to_arrow().sort_by("k").equals(want)
    assert state["fired"] == 3
    inputs = sum(v.get("inputBatches", 0) for v in q.last_metrics().values())
    assert inputs == 1
    js = st.TpuSession({})
    assert js.create_dataframe(data).group_by("k").agg(
        JF.sum("v").alias("s")).to_arrow().sort_by("k").equals(want)


def test_reduce_and_parking_retry_unsplit(monkeypatch):
    """The exchange's reduce copy and the sort's parking: an OOM retries
    the same call (spill hooks first), no split."""
    n = 2000
    data = {"k": pa.array([(i * 37) % 1000 for i in range(n)], pa.int64()),
            "v": pa.array([f"x{i}" for i in range(n)])}
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 256}
    s = pt.TpuSession(conf, device="cpu")
    want = s.create_dataframe(data).repartition(4, "k").sort(
        "k", "v").to_arrow()
    from spark_rapids_tpu_torch.exec import exchange as ex_mod
    orig_dev = ex_mod.to_device
    orig_add = SpillStore.add_batch
    state = {"dev": 0, "add": 0}

    def flaky_dev(*a, **kw):
        if state["dev"] < 2:
            state["dev"] += 1
            raise OOMS["cuda"]()
        return orig_dev(*a, **kw)

    def flaky_add(self, *a, **kw):
        if state["add"] < 1:
            state["add"] += 1
            raise OOMS["budget"]()
        return orig_add(self, *a, **kw)

    monkeypatch.setattr(ex_mod, "to_device", flaky_dev)
    monkeypatch.setattr(SpillStore, "add_batch", flaky_add)
    retry.reset_retry_stats()
    got = s.create_dataframe(data).repartition(4, "k").sort(
        "k", "v").to_arrow()
    assert got.equals(want)
    st_ = retry.retry_stats()
    assert st_["retries"] == 3 and st_["splits"] == 0
    # the third failure of one call is past retry_no_split's two retries
    state["dev"] = -1
    monkeypatch.setattr(ex_mod, "to_device", lambda *a, **kw: (
        _ for _ in ()).throw(OOMS["cuda"]()))
    with pytest.raises(__import__("torch").OutOfMemoryError):
        s.create_dataframe(data).repartition(4, "k").to_arrow()
