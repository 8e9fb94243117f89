"""The memory runtime of the PyTorch port (on the CPU) against the JAX
package's: the spill store's round trip device -> host -> disk, budget
pressure, split-and-retry under an injected `BudgetExceeded` and an
injected `torch.OutOfMemoryError`, a split's string rows, the
semaphore's priority and bound, `is_oom_error` on the same messages, and
the host budget's pressure hooks cascading spills to disk. The shapes
are those of the JAX suite's `tests/test_memory_shuffle.py:30-118` and
`tests/test_host_budget.py`.

A spilled batch must come back byte for byte: every buffer of every
column (fixed width, validity, string offsets and bytes, decimal128
`[n, 2]` limbs) and the row mask; its rows must equal the JAX package's
round trip of the same Arrow table. Tolerance: exact.
"""
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.table import Table as JTable
from spark_rapids_tpu.exec.batch import DeviceBatch as JBatch
from spark_rapids_tpu.memory import retry as jretry
from spark_rapids_tpu.memory.device import BudgetExceeded as JBudget
from spark_rapids_tpu.memory.device import DeviceManager as JDM
from spark_rapids_tpu.memory.spill import SpillStore as JStore
from spark_rapids_tpu_torch.columnar.table import Table
from spark_rapids_tpu_torch.exec.batch import DeviceBatch
from spark_rapids_tpu_torch.exec.nodes import _batch_to_arrow
from spark_rapids_tpu_torch.memory import retry
from spark_rapids_tpu_torch.memory.device import (BudgetExceeded,
                                                  DeviceManager,
                                                  device_manager)
from spark_rapids_tpu_torch.memory.diagnostics import (assert_no_leaks,
                                                       leak_report)
from spark_rapids_tpu_torch.memory.host import (HostBudgetExceeded,
                                                HostMemoryManager)
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.spill import SpillStore

CPU = torch.device("cpu")


def _arrow(n=500, seed=0):
    """Fixed width, double, string and decimal128 columns, with nulls."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    ints = rng.integers(-10**12, 10**12, n)
    return pa.table({
        "a": pa.array(ints, mask=~valid),
        "d": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.1),
        "s": pa.array([None if i % 13 == 0 else f"row{i}" * (i % 4)
                       for i in range(n)]),
        "m": pa.array([None if i % 7 == 0 else (int(x) * 10**14 + i)
                       for i, x in enumerate(ints)],
                      pa.decimal128(38, 2)).cast(pa.decimal128(38, 2)),
    })


def _batch(at):
    return DeviceBatch(Table.from_arrow(at, CPU))


def _buffers(batch):
    return [t.clone() for c in batch.table.columns for t in c.buffers()] \
        + [batch.row_mask.clone()]


def _same_bytes(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                           y.contiguous().reshape(-1).view(torch.uint8))


def _jax_roundtrip(at, tmp_path):
    store = JStore(JDM(budget_bytes=1 << 30), spill_dir=str(tmp_path),
                   host_limit=0)
    h = store.add_batch(JBatch(JTable.from_arrow(at)))
    h.spill_to_host()
    h.spill_to_disk(str(tmp_path))
    out = h.materialize().table.to_arrow()
    h.close()
    return out


def test_spill_roundtrip_device_host_disk(tmp_path):
    at = _arrow()
    dm = DeviceManager(budget_bytes=1 << 30)
    store = SpillStore(dm, spill_dir=str(tmp_path), host_limit=0)
    b = _batch(at)
    assert b.table.columns[3].data.shape == (500, 2)   # decimal128 limbs
    before = _buffers(b)
    h = store.add_batch(b)
    assert dm.reserved == b.nbytes
    assert h.spill_to_host() == b.nbytes
    assert h.state == "host" and dm.reserved == 0
    assert h.spill_to_disk() == b.nbytes
    assert h.state == "disk"
    assert os.listdir(tmp_path) == [f"spill-{h.id}.bin"]
    b2 = h.materialize()
    assert h.state == "device" and dm.reserved == b.nbytes
    assert os.listdir(tmp_path) == []
    _same_bytes(before, _buffers(b2))
    got = _batch_to_arrow(b2)
    assert got.equals(at)
    assert got.equals(_jax_roundtrip(at, tmp_path))
    h.close()
    assert_no_leaks(store)


def test_string_halves_roundtrip_with_shared_bytes(tmp_path):
    """A split half's string column is a view of its rows' bytes in the
    shared buffer, offsets rebased: the spill copies it as it is."""
    at = _arrow(301, 5)
    store = SpillStore(DeviceManager(budget_bytes=1 << 30),
                       spill_dir=str(tmp_path))
    b = _batch(at)
    whole = b.table.columns[2]
    halves = retry.split_batch_in_half(b)
    for half in halves:
        s = half.table.columns[2]
        assert int(s.offsets[0]) == 0
        assert s.data.untyped_storage().data_ptr() == \
            whole.data.untyped_storage().data_ptr()
    assert sum(h.table.columns[2].data.shape[0] for h in halves) == \
        whole.data.shape[0]
    got = []
    for half in halves:
        before = _buffers(half)
        h = store.add_batch(half)
        h.spill_to_disk()
        b = h.materialize()
        _same_bytes(before, _buffers(b))
        got.append(_batch_to_arrow(b))
        h.close()
    assert pa.concat_tables(got).equals(at)
    assert_no_leaks(store)


def test_budget_pressure_triggers_spill(tmp_path):
    b1 = _batch(_arrow(4096, 1))
    size = b1.nbytes
    dm = DeviceManager(budget_bytes=int(size * 1.5))
    store = SpillStore(dm, spill_dir=str(tmp_path))
    h1 = store.add_batch(b1)
    h2 = store.add_batch(_batch(_arrow(4096, 2)))  # fits once h1 spills
    assert (h1.state, h2.state) == ("host", "device")
    assert store.metrics["spillToHost"] == 1
    # the JAX package's store takes the same steps
    jdm = JDM(budget_bytes=int(size * 1.5))
    jstore = JStore(jdm, spill_dir=str(tmp_path))
    j1 = jstore.add_batch(JBatch(JTable.from_arrow(_arrow(4096, 1))))
    j2 = jstore.add_batch(JBatch(JTable.from_arrow(_arrow(4096, 2))))
    assert (j1.state, j2.state) == (h1.state, h2.state)
    h2.pin()
    with pytest.raises(BudgetExceeded):    # h2 cannot go: still short
        dm.reserve(size * 10)
    h2.unpin()
    dm.reserve(size * 10)     # h2 spills; alone, any size is admitted
    assert h2.state == "host" and dm.reserved == size * 10
    dm.release(size * 10)
    for h in (h1, h2, j1, j2):
        h.close()
    assert dm.reserved == 0


def test_a_batch_over_the_whole_budget_parks_alone(tmp_path):
    """With nothing else reserved, one reservation of any size is
    admitted (the host budget's rule): a batch bigger than the budget
    parks, the next one spills it and parks in turn, and both come back
    byte for byte."""
    ats = [_arrow(2000, s) for s in (7, 8)]
    dm = DeviceManager(budget_bytes=_batch(ats[0]).nbytes // 3)
    store = SpillStore(dm, spill_dir=str(tmp_path))
    h1 = store.add_batch(_batch(ats[0]))
    assert dm.reserved > dm.budget
    h2 = store.add_batch(_batch(ats[1]))
    assert (h1.state, h2.state) == ("host", "device")
    h2.pin()
    with pytest.raises(BudgetExceeded):   # h2's reservation stays
        dm.reserve(1 << 20)
    h2.unpin()
    for h, at in zip((h1, h2), ats):
        assert _batch_to_arrow(h.materialize()).equals(at)
        h.close()
    assert dm.reserved == 0


def test_pinned_handle_does_not_spill(tmp_path):
    b = _batch(_arrow(1000, 3))
    dm = DeviceManager(budget_bytes=int(b.nbytes * 1.5))
    store = SpillStore(dm, spill_dir=str(tmp_path))
    h = store.add_batch(b)
    h.pin()
    with pytest.raises(BudgetExceeded):
        store.add_batch(_batch(_arrow(1000, 4)))
    h.unpin()
    h2 = store.add_batch(_batch(_arrow(1000, 4)))
    assert h.state == "host"
    for x in (h, h2):
        x.close()
    assert leak_report(store)["openHandles"] == 0


def _sum_of(batch):
    cv = batch.cvs()[0]
    return int(torch.where(batch.row_mask & cv.validity, cv.data, 0).sum())


@pytest.mark.parametrize("oom", ["budget", "cuda", "cuda_launch"])
def test_split_and_retry_oom_injection(oom):
    """Every sub-batch over 1024 rows fails: with_retry splits 4096 rows
    into four, and their sums add up to the whole's, as in the JAX
    package (where the injected error is RESOURCE_EXHAUSTED)."""
    at = pa.table({"a": np.arange(4096) % 100, "s": [f"row{i}" for i in
                                                     range(4096)]})
    b = _batch(at)
    err = {"budget": lambda: BudgetExceeded("need 1 byte"),
           "cuda": lambda: torch.OutOfMemoryError(
               "CUDA out of memory. Tried to allocate 2.00 GiB"),
           "cuda_launch": lambda: RuntimeError(
               "CUDA error: out of memory\nCUDA kernel errors might be "
               "asynchronously reported")}[oom]
    calls = {"n": 0}

    def fn(batch):
        calls["n"] += 1
        if batch.capacity > 1024:
            raise err()
        return _sum_of(batch)

    retry.reset_retry_stats()
    parts = list(retry.with_retry(b, fn))
    assert sum(parts) == _sum_of(b) and len(parts) == 4
    assert calls["n"] == 7
    assert retry.retry_stats() == {"ooms": 3, "splits": 3, "retries": 0}

    jcalls = {"n": 0}

    def jfn(batch):
        jcalls["n"] += 1
        if batch.capacity > 1024:
            raise RuntimeError("RESOURCE_EXHAUSTED: injected OOM")
        return int(np.asarray(batch.table.columns[0].data)[
            np.asarray(batch.row_mask)].sum())

    jparts = list(jretry.with_retry(JBatch(JTable.from_arrow(at)), jfn))
    assert jparts == parts and jcalls["n"] == calls["n"]


def test_retry_gives_up_past_max_splits():
    b = _batch(pa.table({"a": np.arange(64)}))

    def fn(batch):
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(retry.OutOfCoreError):
        list(retry.with_retry(b, fn, max_splits=2))


def test_retry_no_split_spills_between_attempts(tmp_path):
    b = _batch(_arrow(1000, 6))
    dm = DeviceManager(budget_bytes=b.nbytes * 4)
    store = SpillStore(dm, spill_dir=str(tmp_path))
    h = store.add_batch(b)
    state = {"n": 0}

    def fn():
        state["n"] += 1
        if state["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return "done"

    retry.reset_retry_stats()
    assert retry.retry_no_split(fn, dm=dm) == "done"
    assert h.state == "host"         # the spill hooks ran before the retry
    assert retry.retry_stats()["retries"] == 1
    with pytest.raises(ValueError):
        retry.retry_no_split(lambda: (_ for _ in ()).throw(
            ValueError("not an OOM")), dm=dm)
    h.close()


@pytest.mark.parametrize("n", [512, 513, 7])
def test_split_preserves_string_rows(n):
    at = pa.table({"s": [f"row{i}" for i in range(n)],
                   "d": pa.array(np.arange(n) * 1.5)})
    left, right = retry.split_batch_in_half(_batch(at))
    assert (left.capacity, right.capacity) == (n // 2, n - n // 2)
    got = pa.concat_tables([_batch_to_arrow(left), _batch_to_arrow(right)])
    assert got.equals(at)
    jl, jr = jretry.split_batch_in_half(JBatch(JTable.from_arrow(
        pa.table({"s": [f"row{i}" for i in range(512)]}))))
    want = (jl.table.to_arrow().column("s").to_pylist()[:jl.num_rows]
            + jr.table.to_arrow().column("s").to_pylist()[:jr.num_rows])
    assert want == [f"row{i}" for i in range(512)]


def test_semaphore_bound():
    sem = TpuSemaphore(2)
    running, peak = [], []
    lock = threading.Lock()

    def task(i):
        with sem.hold(priority=i):
            with lock:
                running.append(i)
                peak.append(len(running))
            time.sleep(0.01)
            with lock:
                running.remove(i)

    threads = [threading.Thread(target=task, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert max(peak) <= 2 and sem.metrics["peakHeld"] <= 2
    assert sem.metrics["acquires"] == 6
    assert sem.debug_state()["available"] == 2


def test_semaphore_grants_in_priority_order():
    sem = TpuSemaphore(1)
    sem.acquire()
    order, started = [], []

    def waiter(p):
        started.append(p)
        sem.acquire(priority=p)
        order.append(p)
        sem.release()

    threads = []
    for p in (5, -3, 0, 9):
        t = threading.Thread(target=waiter, args=(p,))
        t.start()
        threads.append(t)
        while sem.debug_state()["waiters"] < len(threads):
            time.sleep(0.001)
    assert not sem.try_acquire()      # never steals from a waiter
    sem.release()
    for t in threads:
        t.join()
    assert order == [-3, 0, 5, 9]


def test_semaphore_cancel_token_abandons_the_slot():
    sem = TpuSemaphore(1)
    sem.acquire()

    class Token:
        def check(self):
            raise TimeoutError("cancelled")

    with pytest.raises(TimeoutError):
        sem.acquire(token=Token())
    sem.release()
    assert sem.try_acquire()
    sem.release()


_MESSAGES = [
    ("RuntimeError", "RESOURCE_EXHAUSTED: Out of memory allocating"),
    ("RuntimeError", "CUDA error: out of memory\nCUDA kernel errors"),
    ("MemoryError", "Out of memory while growing the heap"),
    ("ValueError", "bad row\nthe row says: out of memory"),
    ("ValueError", "x" * 300 + " out of memory"),
    ("KeyError", "l_orderkey"),
    ("RuntimeError", "CUDA error: an illegal memory access"),
]


@pytest.mark.parametrize("kind,msg", _MESSAGES)
def test_is_oom_error_agrees_with_jax(kind, msg):
    e = {"RuntimeError": RuntimeError, "MemoryError": MemoryError,
         "ValueError": ValueError, "KeyError": KeyError}[kind](msg)
    assert retry.is_oom_error(e) == jretry.is_oom_error(e)


def test_is_oom_error_typed():
    assert retry.is_oom_error(torch.OutOfMemoryError("anything"))
    assert retry.is_oom_error(BudgetExceeded("x"))
    assert jretry.is_oom_error(JBudget("x"))
    assert not retry.is_oom_error(ValueError("fine\nout of memory"))


def test_host_reserve_release_and_always_admit_one():
    hm = HostMemoryManager(1000)
    hm.reserve(800)
    with pytest.raises(HostBudgetExceeded):
        hm.reserve(300)
    hm.release(800)
    hm.reserve(5000)       # a single oversized reservation is admitted
    hm.release(5000)
    assert hm.reserved == 0
    hm.force_reserve(2000)
    assert not hm.try_reserve(1)
    hm.release(2000)


def test_host_pressure_hook_frees_room():
    hm = HostMemoryManager(1000)
    state = {"held": 900}
    hm.reserve(900)

    def hook(need):
        freed, state["held"] = state["held"], 0
        if freed:
            hm.release(freed)
        return freed

    hm.register_pressure_hook(hook)
    hm.reserve(500)
    assert hm.metrics == {"pressureCalls": 1, "pressureFreed": 900}


def test_spill_overcommit_cascades_to_disk(tmp_path):
    """Device pressure demotes batches to host memory; a small host
    budget sends the overflow to disk through the pressure hook, and
    every handle comes back byte for byte."""
    ats = [_arrow(2000, s) for s in range(8)]
    size = _batch(ats[0]).nbytes
    dm = DeviceManager(budget_bytes=size * 2 + 1)
    hm = HostMemoryManager(size * 2 + 1)
    store = SpillStore(dm, spill_dir=str(tmp_path), host_mgr=hm)
    handles, befores = [], []
    for at in ats:
        b = _batch(at)
        befores.append(_buffers(b))
        handles.append(store.add_batch(b))
    m = store.metrics
    assert m["spillToHost"] > 0 and m["spillToDisk"] > 0, m
    assert hm.metrics["pressureCalls"] > 0
    assert hm.reserved <= size * 2 + 1
    assert len(os.listdir(tmp_path)) == sum(h.state == "disk"
                                            for h in handles)
    for h, before, at in zip(handles, befores, ats):
        b = h.materialize()
        _same_bytes(before, _buffers(b))
        h.close()
    assert os.listdir(tmp_path) == []
    assert hm.reserved == 0 and dm.reserved == 0


def test_host_limit_cascades_to_disk(tmp_path):
    """memory.host.spillStorageSize: past it, the device hook sends the
    host tier on to disk (the JAX store's cascade)."""
    ats = [_arrow(1000, s) for s in range(6)]
    size = _batch(ats[0]).nbytes
    dm = DeviceManager(budget_bytes=size + 1)
    store = SpillStore(dm, spill_dir=str(tmp_path), host_limit=size * 2)
    handles = [store.add_batch(_batch(at)) for at in ats]
    states = [h.state for h in handles]
    assert states.count("device") == 1 and states.count("disk") > 0
    for h, at in zip(handles, ats):
        assert _batch_to_arrow(h.materialize()).equals(at)
        h.close()
    assert os.listdir(tmp_path) == [] and dm.reserved == 0


def test_device_manager_budget_from_conf():
    from spark_rapids_tpu_torch.config import TpuConf
    conf = TpuConf({"spark.rapids.tpu.memory.tpu.poolBytes": 12345})
    dm = device_manager(conf, CPU)
    assert dm.budget == 12345 and device_manager(conf, CPU) is dm
    frac = TpuConf({"spark.rapids.tpu.memory.tpu.allocFraction": 0.5})
    from spark_rapids_tpu_torch.memory.device import CPU_DEFAULT_BYTES
    assert device_manager(frac, CPU).budget == CPU_DEFAULT_BYTES // 2


def test_conf_keys_and_defaults_equal_jax():
    import spark_rapids_tpu.config as jc
    import spark_rapids_tpu_torch.config as pc
    for name in ("CONCURRENT_TASKS", "HBM_POOL_FRACTION", "HBM_POOL_BYTES",
                 "HOST_SPILL_LIMIT", "OOM_MAX_RETRIES", "SORT_OOC_ENABLED",
                 "SORT_OOC_THRESHOLD", "AGG_MAX_MERGE_ROWS",
                 "JOIN_BUILD_BUDGET", "SPILL_DIR"):
        p, j = getattr(pc, name), getattr(jc, name)
        assert p.key == j.key
        if name != "SPILL_DIR":
            assert p.default == j.default, name
    assert os.path.basename(pc.SPILL_DIR.default) == \
        os.path.basename(jc.SPILL_DIR.default)


def test_store_and_budget_under_concurrent_tasks(tmp_path):
    """Eight threads (more than this machine's cores) each park two
    batches at a time against a budget of nine and a host tier of four,
    send some to disk, bring them back and close them, at a 1 us switch
    interval: every batch comes back byte for byte, and the reservation,
    the host budget and the handle count all return to 0 (a lost update
    in any of them would not). A handle is pinned only while one thread
    adds or materializes it, so eight pinned at most always leave room
    for the ninth."""
    import sys
    ats = [_arrow(300, s) for s in range(4)]
    size = _batch(ats[0]).nbytes
    dm = DeviceManager(budget_bytes=size * 9)
    hm = HostMemoryManager(size * 4)
    store = SpillStore(dm, spill_dir=str(tmp_path), host_mgr=hm)
    errors = []

    def task(i):
        try:
            for r in range(4):
                pair = [ats[(i + r + k) % len(ats)] for k in (0, 1)]
                parked = []
                for k, at in enumerate(pair):
                    b = _batch(at)
                    parked.append((_buffers(b),
                                   store.add_batch(b, priority=k)))
                if r % 2:
                    parked[0][1].spill_to_disk()
                for before, h in parked:
                    _same_bytes(before, _buffers(h.materialize()))
                    h.close()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=task, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert (dm.reserved, hm.reserved, store.open_handles) == (0, 0, 0)
    assert os.listdir(tmp_path) == []
    assert store.metrics["spillToHost"] > 0
    assert store.metrics["spillToDisk"] > 0


def test_retry_scope_and_watermarks():
    from spark_rapids_tpu_torch.memory import diagnostics
    seen = []
    b = _batch(pa.table({"a": np.arange(8)}))
    list(retry.with_retry(b, lambda x: seen.append(
        diagnostics.in_retry_scope())))
    assert seen == [True] and not diagnostics.in_retry_scope()
    diagnostics.reset_watermarks()
    dm = DeviceManager(budget_bytes=1000)
    dm.reserve(700)
    dm.release(700)
    dm.reserve(300)
    assert diagnostics.watermarks_snapshot()["devicePeakBytes"] == 700
    hm = HostMemoryManager(0)
    hm.reserve(123)
    assert diagnostics.watermarks_snapshot()["hostPeakBytes"] >= 123


def test_reserve_retries_when_a_release_races_the_shortfall_check():
    """The interleaving of ROADMAP C.13, forced: a budget of 10 holds a
    spillable 5 and a 4; `reserve(2)` fails its first `try_reserve`,
    another task then releases the 4, so the shortfall check reads no
    shortfall and skips the hook, and a third task takes 4 again just
    before the next `try_reserve`. The pass freed nothing only because
    it never asked the hook: `reserve` must try again, spill the 5 and
    succeed."""
    dm = DeviceManager(budget_bytes=10)
    spillable = [5]
    hook_calls = []

    def hook(needed):
        hook_calls.append(needed)
        freed, spillable[0] = spillable[0], 0
        dm.release(freed)
        return freed

    dm.register_spill_hook(hook)
    dm.reserve(5)
    dm.reserve(4)
    real = dm.try_reserve
    calls = []

    def racing(nbytes):
        calls.append(nbytes)
        if len(calls) == 2:
            assert real(4)          # a third task takes the room
        ok = real(nbytes)
        if len(calls) == 1:
            dm.release(4)           # another task releases its 4
        return ok

    dm.try_reserve = racing
    dm.reserve(2)
    assert hook_calls == [1]
    assert spillable == [0]
    assert dm.reserved == 4 + 2


def test_reservations_that_wait_for_each_other_raise_at_once():
    """Two tasks each hold bytes and each ask for more than is left:
    neither can release while it waits, so the second to ask must raise
    at once (its task then drops its bytes and the first is admitted),
    not after the whole wait. Bytes charged to a thread that has exited
    have no live owner to release them: a reservation does not wait for
    them either."""
    dm = DeviceManager(budget_bytes=10)
    start = threading.Barrier(2)
    done, refused = [], []

    def task():
        dm.reserve(4)
        start.wait()
        try:
            dm.reserve(5)
            done.append(True)
            dm.release(5)
        except BudgetExceeded:
            refused.append(True)
        dm.release(4)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=task) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert time.perf_counter() - t0 < 5
    assert refused and len(done) + len(refused) == 2
    assert dm.reserved == 0
    gone = threading.Thread(target=lambda: dm.reserve(6))
    gone.start()
    gone.join()
    t0 = time.perf_counter()
    with pytest.raises(BudgetExceeded):
        dm.reserve(6)
    assert time.perf_counter() - t0 < 5


def test_reserve_waits_for_another_threads_release():
    """Two tasks each need more than the whole budget (two map workers
    each merging a partition): the second waits for the first's release
    and is then admitted alone; the same thread, holding the bytes
    itself, is refused at once."""
    dm = DeviceManager(budget_bytes=10)
    dm.reserve(15)                      # admitted alone
    got, t0 = [], time.perf_counter()

    def other():
        dm.reserve(12)
        got.append(time.perf_counter() - t0)

    t = threading.Thread(target=other)
    t.start()
    time.sleep(0.2)
    assert not got                      # still waiting for the release
    dm.release(15)
    t.join(timeout=30)
    assert got and got[0] >= 0.2
    assert dm.reserved == 12
    dm2 = DeviceManager(budget_bytes=10)
    dm2.reserve(8)
    t0 = time.perf_counter()
    with pytest.raises(BudgetExceeded):
        dm2.reserve(5)
    assert time.perf_counter() - t0 < 5
