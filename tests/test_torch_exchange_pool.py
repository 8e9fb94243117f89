"""The multithreaded exchange map side of the PyTorch port (on the CPU)
against its serial map side and the JAX package.

The port's `exec/exchange_pool.py` and `ShuffleExchangeExec._run_map`
follow the JAX package's (`tests/test_exchange_pipeline.py:40-110` holds
the reference to the same cases): `sql.exec.exchange.mapThreads` = 1
maps serially, 4 on a pool; each worker fills pieces for its own map
partition and they merge in map-partition order, so the output is
byte-identical, in the same order, whatever order the workers finish
in. Cases:
  - `resolve_map_threads`: the conf's value, clamped to the partition
    count, 0 = auto; the port's and the JAX package's agree;
  - chained repartitions over nulls, strings and a double (1 thread
    against 4: equal Arrow tables, order included; and equal to the
    JAX package's), mostly empty partitions, a grouped count and a
    double sum (bit-equal at 1 and 4 threads), a range exchange;
  - a worker's failure propagates, stops the other workers and leaves
    no pieces;
  - `sql.concurrentTpuTasks` = 1 with chained exchanges: the collect
    task holds the only permit while its iterator materializes the map
    side, and the pool must finish (`PermitRider`), under a timeout.
Tolerance: exact.
"""
import threading

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.exec.exchange_pool import (PermitRider,
                                                       resolve_map_threads)
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore

THREADS = "spark.rapids.tpu.sql.exec.exchange.mapThreads"
BASE = {"spark.rapids.tpu.sql.batchSizeRows": 256,
        "spark.rapids.tpu.sql.shuffle.partitions": 4}


def _mixed_table(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array([None if i % 17 == 0 else int(x) for i, x in
                       enumerate(rng.integers(0, 12, n))],
                      type=pa.int64()),
        "v": pa.array(rng.normal(0, 1, n)),
        "s": pa.array([None if i % 23 == 0 else f"s{i % 41}"
                       for i in range(n)]),
    })


def _port(threads, **extra):
    return pt.TpuSession({**BASE, THREADS: threads, **extra}, device="cpu")


def _shuffled(sess, at, F):
    # two chained exchanges: the second one's child has 6 map partitions,
    # so its map side fans out across the workers
    return (sess.create_dataframe(at).repartition(6)
            .repartition(5, F.col("k")).to_arrow())


class _Ctx:
    def __init__(self, conf):
        self.conf = conf


def test_map_threads_conf_resolution():
    from spark_rapids_tpu.config import TpuConf as JConf
    from spark_rapids_tpu.exec.exchange_pool import \
        resolve_map_threads as jresolve
    for conf, nparts in (({THREADS: 3}, 10), ({THREADS: 3}, 2),
                         ({THREADS: 1}, 64), ({THREADS: 0}, 64),
                         ({}, 64), ({}, 1), ({THREADS: 8}, 0)):
        got = resolve_map_threads(_Ctx(TpuConf(conf)), nparts)
        assert got == jresolve(_Ctx(JConf(conf)), nparts), (conf, nparts)
    assert resolve_map_threads(_Ctx(TpuConf({THREADS: 3})), 10) == 3
    assert resolve_map_threads(_Ctx(TpuConf({THREADS: 3})), 2) == 2
    assert resolve_map_threads(_Ctx(TpuConf({})), 64) >= 1


def test_parallel_map_byte_identical_to_serial_and_jax():
    at = _mixed_table()
    serial = _shuffled(_port(1), at, PF)
    parallel = _shuffled(_port(4), at, PF)
    assert serial.schema == parallel.schema
    assert serial.equals(parallel)              # byte-identical, in order
    jax = _shuffled(st.TpuSession({**BASE, THREADS: 4}), at, JF)
    assert parallel.equals(jax)


def test_parallel_map_metrics():
    at = _mixed_table()
    q = _port(4).create_dataframe(at).repartition(6).repartition(
        5, PF.col("k"))
    q.to_arrow()
    ex = [m for k, m in q.last_metrics().items()
          if k.startswith("ShuffleExchangeExec")]
    assert len(ex) == 2
    assert sorted(m["mapPartitionsExecuted"] for m in ex) == [6, 8]
    assert all("mapPoolWaitMs" in m and m["mapPoolWaitMs"] >= 0
               for m in ex)
    assert sum(m["mapBatches"] for m in ex) >= 14


def test_parallel_map_empty_partitions_parity():
    """Two distinct keys into 8 partitions: most reduce (and then map)
    partitions are empty, and empty slots must not shift the output."""
    at = pa.table({"k": pa.array([1, 2] * 300, type=pa.int64()),
                   "v": pa.array(range(600), type=pa.int64())})

    def run(threads):
        return (_port(threads).create_dataframe(at)
                .repartition(8, PF.col("k"))
                .repartition(3, PF.col("k")).to_arrow())

    assert run(1).equals(run(4))


def test_parallel_map_grouped_count_and_double_sum_bit_equal():
    at = _mixed_table(1500, seed=9)

    def run(threads):
        df = _port(threads).create_dataframe(at).repartition(6)
        return (df.group_by("k").agg(PF.count(PF.col("v")).alias("c"),
                                     PF.sum(PF.col("v")).alias("sv"))
                .to_arrow().sort_by("k"))

    one, four = run(1), run(4)
    assert one.column("c").equals(four.column("c"))
    assert np.array_equal(
        one.column("sv").to_numpy().view(np.int64),
        four.column("sv").to_numpy().view(np.int64))
    jax = (st.TpuSession({**BASE, THREADS: 4}).create_dataframe(at)
           .repartition(6).group_by("k")
           .agg(JF.count(JF.col("v")).alias("c"),
                JF.sum(JF.col("v")).alias("sv")).to_arrow().sort_by("k"))
    assert one.column("c").equals(jax.column("c"))
    np.testing.assert_allclose(one.column("sv").to_numpy(),
                               jax.column("sv").to_numpy(), rtol=1e-12)


def test_range_exchange_takes_the_pool():
    """The out-of-core sort's range exchange is a ShuffleExchangeExec: at
    4 threads its map side runs on the pool and sorts as at 1."""
    rng = np.random.default_rng(4)
    at = pa.table({"a": pa.array(rng.integers(0, 1000, 3000)),
                   "b": pa.array(rng.normal(0, 1, 3000))})
    conf = {"spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes": 4096}

    def run(threads):
        q = _port(threads, **conf).create_dataframe(at).sort("a", "b")
        return q.to_arrow(), q.last_metrics()

    (one, _), (four, m4) = run(1), run(4)
    assert one.equals(four)
    assert any(v.get("oocRangePartitions", 0) > 0 for v in m4.values())
    assert any("mapPoolWaitMs" in v for k, v in m4.items()
               if k.startswith("RangeShuffleExchangeExec"))


def test_worker_failure_propagates_and_leaves_no_pieces(monkeypatch):
    """The outer exchange's second map pass fails on a pool worker: the
    exception reaches the caller, the stop event ends the other workers,
    and the exchange holds no pieces (its inner exchange finished before
    and keeps its own). The next action plans afresh and succeeds."""
    at = _mixed_table()
    q = _port(4).create_dataframe(at).repartition(6).repartition(
        5, PF.col("k"))
    root, ctx = q.physical_plan()
    exchanges = []

    def walk(node):
        if isinstance(node, ShuffleExchangeExec):
            exchanges.append(node)
        for c in node.children:
            walk(c)

    walk(root)
    outer, inner = exchanges
    inner.stage_stats(ctx)
    calls = []
    real = ShuffleExchangeExec._map_batch

    def failing(self, batch):
        if self is outer:
            calls.append(threading.current_thread().name)
            if len(calls) == 2:
                raise ValueError("injected map failure")
        return real(self, batch)

    monkeypatch.setattr(ShuffleExchangeExec, "_map_batch", failing)
    with pytest.raises(ValueError, match="injected map failure"):
        outer.stage_stats(ctx)
    assert outer._pieces is None and outer._pstats is None
    assert inner._pieces is not None
    assert all(n.startswith("tpu-exch-map") for n in calls)
    monkeypatch.setattr(ShuffleExchangeExec, "_map_batch", real)
    assert q.to_arrow().equals(_shuffled(_port(1), at, PF))


def test_one_permit_with_chained_exchanges_finishes():
    """The collect task holds the session's only permit while its
    iterator materializes the outer exchange, whose map workers
    materialize the inner one: without the ride on the caller's permit
    the workers would wait for it forever."""
    at = _mixed_table(3000, seed=5)
    want = _shuffled(_port(1), at, PF)
    sess = _port(4, **{"spark.rapids.tpu.sql.concurrentTpuTasks": 1})
    out, errors = [], []

    def run():
        try:
            q = sess.create_dataframe(at).repartition(6).repartition(
                5, PF.col("k"))
            out.append((q.to_arrow(), q.last_metrics()))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the pooled map side deadlocked on 1 permit"
    assert not errors, errors
    got, metrics = out[0]
    assert got.equals(want)
    assert sess.semaphore.debug_state()["available"] == 1
    root = [m for k, m in metrics.items() if "semaphorePeakHeld" in m]
    assert root and root[0]["semaphorePeakHeld"] <= 1


def test_permit_rider_bounds_real_permits():
    """Riders never take more real permits than the semaphore has, one
    worker rides the caller's permit at a time, and every step is
    admitted."""
    sem = TpuSemaphore(2)
    sem.acquire()                   # the caller's permit
    rider = PermitRider(sem)
    active, peak, lock = [0], [0], threading.Lock()

    def worker():
        for _ in range(20):
            with rider.step():
                with lock:
                    active[0] += 1
                    peak[0] = max(peak[0], active[0])
                threading.Event().wait(0.001)
                with lock:
                    active[0] -= 1

    ts = [threading.Thread(target=worker) for _ in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert 1 <= peak[0] <= 2        # the ride plus the one free permit
    assert sem.debug_state()["available"] == 1
    assert rider.debug_state()["riding"] is None
    assert rider.waited_secs >= 0
    sem.release()


def test_permit_rider_runs_a_pressured_step_alone():
    """A step that catches an OOM retries only once every other step in
    flight has ended, and no step starts until it is done: the retry
    meets the device as the serial map side would. The others go on
    stepping afterwards."""
    import torch
    from spark_rapids_tpu_torch.memory import retry
    sem = TpuSemaphore(4)
    sem.acquire()                   # the caller's permit
    rider = PermitRider(sem)
    active, lock = [0], threading.Lock()
    beside_retry, started = [], threading.Event()

    def attempt(first=[True]):
        with lock:
            if not first[0]:
                beside_retry.append(active[0])
        if first[0]:
            first[0] = False
            started.wait(5)
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return "ok"

    def step(fn):
        with rider.step():
            with lock:
                active[0] += 1
            try:
                return fn()
            finally:
                with lock:
                    active[0] -= 1

    def pressured():
        return step(lambda: retry.retry_no_split(attempt))

    def other():
        for _ in range(30):
            step(lambda: (started.set(),
                          threading.Event().wait(0.002)))

    retry.reset_retry_stats()
    got = []
    ts = [threading.Thread(target=other) for _ in range(3)]
    ts.append(threading.Thread(target=lambda: got.append(pressured())))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert got == ["ok"]
    assert beside_retry == [1]      # itself only
    assert rider.alone_steps == 1
    assert rider.debug_state()["alone"] is None
    assert retry.retry_stats()["ooms"] == 1
    assert sem.debug_state()["available"] == 3
    sem.release()


def test_a_step_that_fails_alone_lets_the_waiting_steps_go_first():
    """Y's upload fails while X holds its batch and then waits to run
    alone; X fails too and queues behind Y. Y, alone, fails again while
    X still holds its batch: Y lets X retry first, and Y's last attempt
    then fits. Without that, Y's retries would all meet X's batch."""
    import time

    import torch
    from spark_rapids_tpu_torch.memory import retry
    sem = TpuSemaphore(4)
    sem.acquire()
    rider = PermitRider(sem)
    x_holds, x_ready = [False], threading.Event()
    log, errors = [], []

    def oom():
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    def x_attempt(first=[True]):
        if first[0]:
            first[0] = False
            t0 = time.monotonic()   # until Y waits to run alone
            while not rider._queue and time.monotonic() - t0 < 5:
                time.sleep(0.001)
            oom()
        log.append("x")

    def y_attempt():
        if x_holds[0]:
            log.append("y-oom")
            oom()
        log.append("y")

    def x():
        try:
            with rider.step():
                x_holds[0] = True
                x_ready.set()
                retry.retry_no_split(x_attempt)
                x_holds[0] = False
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def y():
        x_ready.wait(5)
        try:
            with rider.step():
                retry.retry_no_split(y_attempt)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    ts = [threading.Thread(target=x), threading.Thread(target=y)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert log == ["y-oom", "y-oom", "x", "y"]
    assert rider.alone_steps == 2
    assert rider.debug_state()["alone"] is None
    sem.release()


def test_an_oom_in_a_pooled_upload_retries_alone(monkeypatch):
    """A pooled map worker's scan upload meets an OOM (two workers copy
    their batches to the device at once under a cap): the copy recovers
    and runs again once it runs alone, where it used to escape every
    retry scope, and the exchange's output equals the serial map's."""
    import torch
    from spark_rapids_tpu_torch.columnar.table import Table
    from spark_rapids_tpu_torch.memory import retry
    at = _mixed_table(4000, seed=9)
    want = (_port(1).create_dataframe(at).repartition(5, PF.col("k"))
            .to_arrow())
    real, hits = Table.from_arrow, []

    def flaky(at_, device=None):
        name = threading.current_thread().name
        if name.startswith("tpu-exch-map") and name not in hits \
                and len(hits) < 2:
            hits.append(name)           # two workers, once each
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(at_, device)

    monkeypatch.setattr(Table, "from_arrow", staticmethod(flaky))
    retry.reset_retry_stats()
    q = _port(4).create_dataframe(at).repartition(5, PF.col("k"))
    assert q.to_arrow().equals(want)
    assert len(hits) == 2 and retry.retry_stats()["ooms"] == 2
    m = [v for k, v in q.last_metrics().items()
         if k.startswith("ShuffleExchangeExec")]
    assert m[0]["mapPoolAloneSteps"] == 2


def test_a_worker_between_steps_holds_no_batch_of_a_done_partition(
        monkeypatch):
    """Each map partition of an in-memory scan is one batch: when a
    worker asks for its next step, the tables it uploaded for earlier
    partitions are gone (the child's generators, whose frames held the
    last batch, are exhausted inside the step), so a worker waiting
    behind one that retries alone holds no device memory."""
    import contextlib
    import gc
    import weakref
    from spark_rapids_tpu_torch.columnar.table import Table
    at = _mixed_table(3000, seed=4)
    want = (_port(1).create_dataframe(at).select("k", "v")
            .repartition(5, PF.col("k")).to_arrow())
    real_from, real_step = Table.from_arrow, PermitRider.step
    made, held = {}, []

    def tracked(at_, device=None):
        t = real_from(at_, device)
        made.setdefault(threading.get_ident(), []).append(weakref.ref(t))
        return t

    @contextlib.contextmanager
    def checked(self):
        gc.collect()
        held.extend(r for r in made.get(threading.get_ident(), [])
                    if r() is not None)
        with real_step(self):
            yield

    monkeypatch.setattr(Table, "from_arrow", staticmethod(tracked))
    monkeypatch.setattr(PermitRider, "step", checked)
    got = (_port(4).create_dataframe(at).select("k", "v")
           .repartition(5, PF.col("k")).to_arrow())
    assert got.equals(want)
    assert sum(map(len, made.values())) == 12
    assert held == []



def test_pooled_final_aggregates_wait_for_each_others_budget(tmp_path):
    """Map workers of the outer aggregate's exchange each run the inner
    aggregate's final merge, every partition's partial bigger than the
    64 KiB device budget: a worker whose reservation cannot fit while
    another worker holds its partial waits for that release, where it
    used to raise BudgetExceeded. The result equals the unconstrained
    run's."""
    from spark_rapids_tpu_torch.workloads import tpch
    li = tpch.gen_lineitem(0.02, 7, full=True)

    def run(**conf):
        s = _port(4, **{"spark.rapids.tpu.sql.batchSizeRows": 4096,
                        **conf})
        q = (s.create_dataframe(li).group_by("l_orderkey")
             .agg(PF.sum("l_quantity").alias("q"))
             .group_by("q").agg(PF.count("*").alias("n")))
        return q.to_arrow().sort_by("q"), s

    want, _ = run()
    got, s = run(**{"spark.rapids.tpu.memory.tpu.poolBytes": 64 << 10,
                    "spark.rapids.tpu.sql.agg.maxMergeRows": 1024,
                    "spark.rapids.tpu.memory.host.spillStorageSize":
                    64 << 10,
                    "spark.rapids.tpu.memory.spill.dir": str(tmp_path)})
    assert got.equals(want)
    assert s.spill_store.metrics["spillToHost"] > 0
    assert s.spill_store.open_handles == 0
    assert s.device_manager.reserved == 0
