"""The port's lock-order witness (`runtime/lockdep.py`): cycle formation
and pool self-waits caught live, thread dumps attributed, and zero
findings across a parallel chained-exchange run with the witness on (the
conftest's `SRTPU_LOCKDEP=1` turns the port's witness on too). Each test
mirrors one of the JAX package's `tests/test_lockdep.py`; the chained
exchange run and TPC-H Q4 give the JAX package's rows. With the witness
off, `lock()` is a plain `threading.Lock` and the note hooks do nothing
(the witness's cost is read on the card, `chip_smoke.py` `witnesses`)."""
import concurrent.futures as cf
import threading

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.runtime import ledger, lockdep, racedep


def test_witness_enabled_for_suite():
    # the conftest env gate armed the port's witness at import
    assert lockdep.enabled()
    assert lockdep.witness().report()["enabled"] is True


# ---------------------------------------------------------------------
# constructed live findings (local Witness instances: the process
# witness must stay finding-free for the whole suite)
# ---------------------------------------------------------------------
def test_live_pool_self_wait_caught_from_worker():
    """A bounded-pool worker blocks on a future of its own pool: the
    witness reports it from inside the worker, before the wait can park
    the pool behind itself."""
    from spark_rapids_tpu_torch.exec.broadcast import BUILD_POOL_PREFIX
    w = lockdep.Witness(raise_on_finding=True)
    with cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=BUILD_POOL_PREFIX) as pool:

        def nested_build():
            return "built"

        def outer_build():
            inner = pool.submit(nested_build)   # queued behind ourselves
            w.check_pool_wait(BUILD_POOL_PREFIX)
            return inner.result()               # pragma: no cover

        fut = pool.submit(outer_build)
        with pytest.raises(lockdep.PoolSelfWait, match=BUILD_POOL_PREFIX):
            fut.result(timeout=30)
    assert w.findings and w.findings[0]["kind"] == "pool-self-wait"


def test_await_build_checks_the_pool_wait(monkeypatch):
    """`BroadcastExchangeExec.await_build` guards its wait: called from a
    build worker it raises before blocking."""
    from spark_rapids_tpu_torch.exec import broadcast
    w = lockdep.Witness(raise_on_finding=True)
    monkeypatch.setattr(lockdep, "_WITNESS", w)
    node = broadcast.BroadcastExchangeExec.__new__(
        broadcast.BroadcastExchangeExec)
    node.submit_build = lambda ctx: None
    seen = []

    def worker():
        try:
            node.await_build(None, 0)
        except lockdep.PoolSelfWait as e:
            seen.append(e)

    t = threading.Thread(target=worker,
                         name=broadcast.BUILD_POOL_PREFIX + "_0")
    t.start()
    t.join(30)
    assert len(seen) == 1 and w.findings[0]["kind"] == "pool-self-wait"


def test_live_order_inversion_across_two_threads():
    """ABBA: thread 1 establishes A -> B; thread 2 acquiring A under B
    closes the cycle and raises at formation."""
    w = lockdep.Witness(raise_on_finding=True)
    seen = []

    def t1():
        w.acquired("A")
        w.acquired("B")
        w.released("B")
        w.released("A")

    def t2():
        w.acquired("B")
        try:
            w.acquired("A")
        except lockdep.LockOrderViolation as e:
            seen.append(e)

    th1 = threading.Thread(target=t1, name="tpu-test-t1")
    th1.start()
    th1.join()
    th2 = threading.Thread(target=t2, name="tpu-test-t2")
    th2.start()
    th2.join()
    assert len(seen) == 1
    assert "A -> B" in str(seen[0]) or "B -> A" in str(seen[0])
    assert w.findings[0]["kind"] == "lock-order-cycle"
    assert w.findings[0]["thread"] == "tpu-test-t2"


def test_same_class_nesting_is_benign():
    """Chained exchanges re-enter the same class lock (child
    materialization under the parent's): no self edge, no finding."""
    w = lockdep.Witness(raise_on_finding=True)
    w.acquired("ShuffleExchangeExec._lock")
    w.acquired("ShuffleExchangeExec._lock")
    w.released("ShuffleExchangeExec._lock")
    w.released("ShuffleExchangeExec._lock")
    assert w.findings == []


def test_consistent_order_never_raises():
    w = lockdep.Witness(raise_on_finding=True)

    def worker():
        for _ in range(50):
            w.acquired("A")
            w.acquired("B")
            w.acquired("C")
            for k in ("C", "B", "A"):
                w.released(k)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert w.findings == []
    assert w.report()["orderEdges"] >= 2


def test_dump_attributes_held_resources_by_thread_name():
    w = lockdep.Witness(raise_on_finding=False)
    ready = threading.Event()
    release = threading.Event()

    def holder():
        w.acquired("SpillStore._lock")
        ready.set()
        release.wait(timeout=30)
        w.released("SpillStore._lock")

    t = threading.Thread(target=holder, name="tpu-test-holder",
                         daemon=True)
    t.start()
    assert ready.wait(timeout=30)
    d = w.dump()
    rows = {r["thread"]: r for r in d["threads"]}
    assert rows["tpu-test-holder"]["held"] == ["SpillStore._lock"]
    # held threads sort first so the culprit leads the report
    assert d["threads"][0]["held"]
    text = lockdep.format_dump(d)
    assert "tpu-test-holder: held=[SpillStore._lock]" in text
    release.set()
    t.join()


def test_attach_dump_folds_threads_into_the_message():
    from spark_rapids_tpu_torch.memory.device import BudgetExceeded
    e = BudgetExceeded("need 10 bytes")
    d = lockdep.attach_dump(e)       # the process witness is on
    assert d is not None and e.lockdep_dump is d
    assert "lockdep threads:" in str(e)
    # idempotent: a second attach must not stack another dump
    assert lockdep.attach_dump(e) is None


def test_semaphore_debug_state_tracks_holders():
    from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
    sem = TpuSemaphore(permits=2)
    assert sem.debug_state()["available"] == 2
    sem.acquire()
    st_ = sem.debug_state()
    me = threading.current_thread().name
    assert st_["available"] == 1 and st_["holders"] == {me: 1}
    assert "TpuSemaphore.permit" in lockdep.witness().held_keys()
    sem.release()
    assert sem.debug_state()["holders"] == {}
    assert "TpuSemaphore.permit" not in lockdep.witness().held_keys()


def test_port_locks_are_class_keyed_witness_locks():
    """Under the witness the port's per-instance locks carry the JAX
    package's class keys, and a Condition over a wrapped lock keeps the
    held stack right across `wait` (no `_release_save`)."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.base import ExecContext
    import torch
    ctx = ExecContext(TpuConf(), torch.device("cpu"))
    assert isinstance(ctx._lock, lockdep._WitnessLock)
    assert ctx._lock.name == "MetricSet._lock"
    assert not hasattr(lockdep._WitnessLock, "_release_save")
    lk = lockdep.lock("tpu-test.cond")
    cond = threading.Condition(lk)
    with cond:
        assert "tpu-test.cond" in lockdep.witness().held_keys()
        cond.wait(timeout=0.01)
        assert "tpu-test.cond" in lockdep.witness().held_keys()
    assert "tpu-test.cond" not in lockdep.witness().held_keys()


def test_disabled_hooks_cost_one_none_check(monkeypatch):
    """With every witness off, `lock()` / `rlock()` hand out plain
    threading primitives and the note hooks are no-ops (the enabled
    cost is measured on the card, not asserted here)."""
    monkeypatch.setattr(lockdep, "_WITNESS", None)
    monkeypatch.setattr(racedep, "_WITNESS", None)
    monkeypatch.setattr(ledger, "_LEDGER", None)
    assert type(lockdep.lock("x")) is type(threading.Lock())
    assert type(lockdep.rlock("x")) is type(threading.RLock())
    assert lockdep.note_acquired("x") is None
    assert lockdep.note_released("x") is None
    assert lockdep.check_pool_wait("tpu") is None
    assert racedep.note_access("s", "k", write=True) is None
    assert racedep.note_lock("x") is None and racedep.note_unlock("x") \
        is None
    assert ledger.note_acquire("permit") is None
    assert ledger.note_release("permit") is None
    assert ledger.note_query_end("q") is None
    assert lockdep.attach_dump(RuntimeError("x")) is None
    assert ledger.attach_dump(RuntimeError("x")) is None


# ---------------------------------------------------------------------
# the payoff: real parallel chained-exchange queries under the witness
# ---------------------------------------------------------------------
CONF = {"spark.rapids.tpu.sql.batchSizeRows": 256,
        "spark.rapids.tpu.sql.shuffle.partitions": 4,
        "spark.rapids.tpu.sql.exec.exchange.mapThreads": 4}


def _chained(s, F):
    rng = np.random.default_rng(7)
    at = pa.table({
        "k": pa.array(rng.integers(0, 12, 2000), type=pa.int64()),
        "v": pa.array(rng.integers(-1000, 1000, 2000), type=pa.int64()),
    })
    return (s.create_dataframe(at).repartition(6)
            .repartition(5, F.col("k"))
            .group_by(F.col("k")).agg(F.sum(F.col("v")).alias("sv"))
            .sort("k"))


def test_parallel_exchange_run_zero_findings():
    """Chained exchanges, a pooled map side, a collect over many
    partitions, run with the witness raising at formation: zero
    findings, the order graph saw the engine's locks, the JAX rows."""
    w = lockdep.witness()
    before = len(w.findings)
    out = _chained(pt.TpuSession(CONF, device="cpu"), PF).to_arrow()
    assert out.equals(_chained(st.TpuSession(CONF), JF).to_arrow())
    assert out.num_rows == 12
    assert len(w.findings) == before
    rep = w.report()
    assert rep["findings"] == len(w.findings)
    assert rep["acquires"] > 0 and rep["resources"] >= 2
    # the map workers' admission came before the exchanges' locks
    admitted = {a for a, b in w._edges
                if b == "ShuffleExchangeExec._lock"}
    assert admitted & {"PermitRider.ride", "TpuSemaphore.permit"}


def test_tpch_q4_under_the_witnesses_equals_jax():
    """TPC-H Q4 at scale 0.01 (a semi join over chained exchanges) with
    the three witnesses on: the JAX rows, no lock-order, ledger or race
    finding."""
    from spark_rapids_tpu.workloads import tpch as jtpch
    from spark_rapids_tpu.workloads import tpch_queries as jq
    from spark_rapids_tpu_torch.workloads import tpch, tpch_queries
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 4096,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    lw, lg, rw = lockdep.witness(), ledger.ledger(), racedep.witness()
    f0 = (len(lw.findings), len(lg.findings), len(rw.findings))
    ps = pt.TpuSession(conf, device="cpu")
    t = {k: ps.create_dataframe(v) for k, v in
         tpch.gen_all(0.01, 11).items()}
    out = tpch_queries.q4(t).to_arrow()
    js = st.TpuSession(conf)
    jt = {k: js.create_dataframe(v) for k, v in
          jtpch.gen_all(0.01, 11).items()}
    assert out.equals(jq.q4(jt).to_arrow())
    assert (len(lw.findings), len(lg.findings), len(rw.findings)) == f0
    assert lg.report()["balanceOk"]


_C5_JAX = """
import jax
jax.config.update("jax_platforms", "cpu")
import spark_rapids_tpu as st
from spark_rapids_tpu.runtime import lockdep
from spark_rapids_tpu.workloads import tpch, tpch_queries
s = st.TpuSession(%r)
t = {k: s.create_dataframe(v) for k, v in tpch.gen_all(0.01, 11).items()}
for n in (11, 15):
    try:
        getattr(tpch_queries, f"q{n}")(t).to_arrow()
        print(n, "ok")
    except lockdep.LockOrderViolation:
        print(n, "LockOrderViolation")
"""
SHUFFLED = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.sql.batchSizeRows": 4096}


def test_reference_cycle_c5_reproduced_and_absent_in_the_port():
    """ROADMAP C.5 on the same input: TPC-H Q11 then Q15 on the shuffled
    plan at scale 0.01. In a fresh JAX interpreter with its witness
    raising, Q15 forms BroadcastExchangeExec._lock ->
    ShuffleExchangeExec._lock -> BroadcastExchangeExec._lock (a build
    holds its lock while it runs an exchange's map, Q15's exchange holds
    its lock while its cross join collects a broadcast). The port runs a
    stage's materialization outside its instance lock: the same two
    queries under the raising witness form no such edge."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    r = subprocess.run([sys.executable, "-c", _C5_JAX % SHUFFLED],
                       capture_output=True, text=True,
                       cwd=Path(__file__).resolve().parents[1],
                       env=dict(os.environ, SRTPU_LOCKDEP="1",
                                SRTPU_LOCKDEP_RAISE="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["11", "ok", "15", "LockOrderViolation"]
    from spark_rapids_tpu_torch.workloads import tpch, tpch_queries
    w = lockdep.witness()
    before = len(w.findings)
    ps = pt.TpuSession(SHUFFLED, device="cpu")
    t = {k: ps.create_dataframe(v)
         for k, v in tpch.gen_all(0.01, 11).items()}
    outs = [getattr(tpch_queries, f"q{n}")(t).to_arrow() for n in (11, 15)]
    assert len(w.findings) == before
    nested = {(a, b) for a, b in w._edges
              if {a, b} <= {"ShuffleExchangeExec._lock",
                            "BroadcastExchangeExec._lock"}}
    assert nested == set()
    # the row counts of test_torch_tpch_q11_15_16_21_22.py, which holds
    # the rows to the JAX package's (each JAX query in an interpreter of
    # its own there: C.5)
    assert [o.num_rows for o in outs] == [157, 1]


def test_stage_handoff_builds_once_under_contention():
    """The exchange's map side and the broadcast's build run outside
    their instance locks, handed to one thread at a time: under more
    threads than cores and a shortened switch interval, a build that
    fails is run again by one waiter, and then never again; every other
    thread returns the one result, and every thread ends."""
    import sys
    import time

    import torch

    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.base import ExecContext, Once
    from spark_rapids_tpu_torch.exec.broadcast import BroadcastExchangeExec
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    ctx = ExecContext(TpuConf(), torch.device("cpu"))
    calls = {"map": 0, "build": 0}

    ex = ShuffleExchangeExec.__new__(ShuffleExchangeExec)
    ex._lock = lockdep.rlock("ShuffleExchangeExec._lock")
    ex._map_out = Once(ex._lock)

    def run_map(ctx):
        calls["map"] += 1
        time.sleep(0.01)
        if calls["map"] == 1:
            raise RuntimeError("the first map fails")
        return [["piece"]], [7]

    ex._run_map = run_map

    class Child:
        def num_partitions(self, ctx):
            return 1

        def execute_partition(self, ctx, pid):
            calls["build"] += 1
            time.sleep(0.01)
            if calls["build"] == 1:
                raise RuntimeError("the first build fails")
            yield "batch"

    bx = BroadcastExchangeExec.__new__(BroadcastExchangeExec)
    bx.children = [Child()]
    bx._op_id = "BroadcastExchangeExec@test"
    bx._lock = lockdep.rlock("BroadcastExchangeExec._lock")
    bx._batches = Once(bx._lock)

    results, errors = [], []

    def worker(i):
        try:
            if i % 2:
                ex._ensure_shuffled(ctx)
                results.append(("map", ex._pieces))
            else:
                results.append(("build", bx._materialize(ctx)))
        except RuntimeError as e:
            errors.append(str(e))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in ts)
    assert calls == {"map": 2, "build": 2}
    assert sorted(errors) == ["the first build fails", "the first map fails"]
    assert len(results) == 30
    assert all(r == ("map", [["piece"]]) or r == ("build", ["batch"])
               for r in results)
    assert "ShuffleExchangeExec._lock" not in lockdep.witness().held_keys()


def test_release_during_the_map_side_is_not_undone():
    """An exchange released while its map side runs keeps no pieces: the
    running map returns to its own caller and publishes nothing, and the
    next caller runs the map side again."""
    from spark_rapids_tpu_torch.exec.base import Once
    from spark_rapids_tpu_torch.exec.exchange import ShuffleExchangeExec
    ex = ShuffleExchangeExec.__new__(ShuffleExchangeExec)
    ex.children = []
    ex._lock = lockdep.rlock("ShuffleExchangeExec._lock")
    ex._map_out = Once(ex._lock)
    calls = []

    def run_map(ctx):
        calls.append(1)
        if len(calls) == 1:
            ex.release()            # a release while the map side runs
        return [["piece"]], [len(calls)]

    ex._run_map = run_map
    assert ex.stage_stats(None) == [1]
    assert ex._pieces is None
    assert ex.stage_stats(None) == [2]
    assert ex._pieces == [["piece"]]
    assert ex.stage_stats(None) == [2] and len(calls) == 2
