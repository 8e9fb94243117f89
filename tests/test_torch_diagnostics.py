"""The port's allocation diagnostics (`memory/diagnostics.py`): the
retry scope and its coverage report (reference:
AllocationRetryCoverageTracker.scala), per-query attribution of device
and host bytes and spill pressure, the watermarks snapshot, and the leak
check (Plugin.scala:625). Each test mirrors one of the JAX package's
`tests/test_diagnostics.py` where the port has the function; the port's
`leak_report` takes the store (ROADMAP C.44), and the public names
equal the JAX module's."""
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.memory.diagnostics as jdiag
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.memory import diagnostics as diag
from spark_rapids_tpu_torch.service.query_manager import (_query_scope,
                                                          current_query_id)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset():
    diag.reset_coverage()
    diag.reset_query_attribution()
    yield
    diag.enable_retry_coverage(False)
    diag.reset_coverage()
    diag.reset_query_attribution()


def test_every_public_function_of_the_jax_module():
    assert set(jdiag.__all__) <= set(diag.__all__)
    for name in jdiag.__all__:
        assert callable(getattr(diag, name)), name


def test_retry_scope_nesting():
    assert not diag.in_retry_scope()
    with diag.retry_scope():
        assert diag.in_retry_scope()
        with diag.retry_scope():
            assert diag.in_retry_scope()
        assert diag.in_retry_scope()
    assert not diag.in_retry_scope()


def test_coverage_off_records_nothing():
    from spark_rapids_tpu_torch.memory.device import DeviceManager
    dm = DeviceManager(1 << 20, device=CPU)
    dm.reserve(64)
    dm.release(64)
    assert diag.coverage_report() == {}


def test_memory_hungry_operators_allocate_under_retry():
    """The operators that park state (aggregate partials, sort handles,
    join piles) reserve device memory inside a retry scope: reservations
    outside it die on OOM instead of spilling. The report names engine
    call sites, never memory internals."""
    rng = np.random.default_rng(3)
    n = 30_000
    s = pt.TpuSession({
        "spark.rapids.tpu.memory.retryCoverage.enabled": "true",
        "spark.rapids.tpu.sql.batchSizeRows": 2048,
        # force the spillable paths: a tiny sort threshold
        "spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes": 64 << 10,
    }, device="cpu")
    df = s.create_dataframe({
        "k": pa.array(rng.integers(0, 100, n)),
        "v": pa.array(rng.normal(0, 1, n))})
    out = df.group_by("k").agg(F.sum(F.col("v")).alias("s")) \
        .sort("k").to_arrow()
    assert out.num_rows == 100
    rep = diag.coverage_report()
    assert rep, "coverage tracking recorded nothing"
    covered = sum(v["covered"] for v in rep.values())
    assert covered > 0, rep
    assert all("/memory/" not in site for site in rep)
    assert all(site.startswith("exec/") for site in rep), rep


def test_session_conf_turns_coverage_off_again():
    pt.TpuSession({"spark.rapids.tpu.memory.retryCoverage.enabled": True},
                  device="cpu")
    assert diag._enabled
    pt.TpuSession(device="cpu")
    assert not diag._enabled


# ---------------------------------------------------------------------
# per-query attribution
# ---------------------------------------------------------------------
def test_attribution_follows_the_query_scope():
    from spark_rapids_tpu_torch.memory.device import DeviceManager
    from spark_rapids_tpu_torch.memory.host import HostMemoryManager
    dm = DeviceManager(1 << 20, device=CPU)
    hm = HostMemoryManager(1 << 20)
    dm.reserve(100)                      # no scope: nobody's
    with _query_scope("q-a"):
        assert current_query_id() == "q-a"
        dm.reserve(300)
        hm.reserve(50)
        with _query_scope("q-b"):
            dm.reserve(7)
        dm.release(200)
        hm.release(50)
    assert current_query_id() is None
    assert diag.query_attribution("q-a") == {
        "deviceBytes": 100, "devicePeakBytes": 300, "hostBytes": 0,
        "hostPeakBytes": 50, "spillPressureBytes": 0}
    assert diag.query_attribution("q-b")["devicePeakBytes"] == 7
    assert set(diag.query_attribution()) == {"q-a", "q-b"}
    diag.reset_query_attribution("q-a")
    assert diag.query_attribution("q-a") == {}
    assert set(diag.query_attribution()) == {"q-b"}


def test_attribution_of_spill_pressure_and_the_snapshot(tmp_path):
    """A reservation that spills another handle charges the pressure to
    the query that asked; the snapshot carries the current query's
    record and the spill stores' counters."""
    s = pt.TpuSession({
        "spark.rapids.tpu.memory.tpu.poolBytes": 256 << 10,
        "spark.rapids.tpu.memory.spill.dir": str(tmp_path)}, device="cpu")
    store = s.spill_store
    from spark_rapids_tpu_torch.columnar.table import Table
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    at = pa.table({"x": pa.array(np.arange(20_000), pa.int64())})
    with _query_scope("q-spill"):
        h1 = store.add_batch(DeviceBatch(Table.from_arrow(at, CPU)))
        h2 = store.add_batch(DeviceBatch(Table.from_arrow(at, CPU)))
        snap = diag.watermarks_snapshot()
    rec = diag.query_attribution("q-spill")
    assert rec["spillPressureBytes"] > 0
    assert rec["devicePeakBytes"] >= h1.nbytes
    assert snap["queryAttribution"] == rec
    assert snap["spill"]["spillToHost"] >= 1
    assert snap["devicePeakBytes"] > 0
    assert "hostPressure" in snap
    h1.close()
    h2.close()
    assert diag.leak_report(store)["openHandles"] == 0


def test_real_query_attributes_its_reservations():
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024,
                       "spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes":
                       16 << 10}, device="cpu")
    n = 20_000
    df = s.create_dataframe({"k": pa.array(np.arange(n)[::-1].copy()),
                             "v": pa.array(np.arange(n) * 3)})
    seen = []
    orig = diag.record_query_bytes

    def spy(kind, delta):
        seen.append((current_query_id(), kind, delta))
        return orig(kind, delta)

    import spark_rapids_tpu_torch.memory.diagnostics as mod
    mod.record_query_bytes = spy
    try:
        out = df.sort("k").to_arrow()
    finally:
        mod.record_query_bytes = orig
    assert out.column("k").to_pylist() == list(range(n))
    qids = {q for q, kind, _ in seen if kind == "device"}
    assert len(qids) == 1 and None not in qids
    (qid,) = qids
    rec = diag.query_attribution(qid)
    assert rec["devicePeakBytes"] > 0 and rec["deviceBytes"] == 0


# ---------------------------------------------------------------------
# leak checking
# ---------------------------------------------------------------------
def test_leak_report_and_assert(tmp_path):
    from spark_rapids_tpu_torch.columnar.table import Table
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    from spark_rapids_tpu_torch.memory.device import DeviceManager
    from spark_rapids_tpu_torch.memory.spill import SpillStore
    store = SpillStore(DeviceManager(1 << 30, device=CPU),
                       spill_dir=str(tmp_path))
    base = diag.leak_report(store)["openHandles"]
    at = pa.table({"x": pa.array(np.arange(4), pa.int64())})
    h = store.add_batch(DeviceBatch(Table.from_arrow(at, CPU)))
    rep = diag.leak_report(store)
    assert rep["openHandles"] == base + 1
    assert rep["deviceReservedBytes"] == h.nbytes
    with pytest.raises(AssertionError, match="resource leak"):
        diag.assert_no_leaks(store)
    h.close()
    assert diag.leak_report(store)["openHandles"] == base
    diag.assert_no_leaks(store)
