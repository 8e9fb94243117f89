"""The port's data-race witness (`runtime/racedep.py`): the Eraser state
machine catches a real two-thread lockset collapse and stays silent on
lock-guarded sharing; lockdep-wrapped locks feed its per-thread
locksets; seeded schedule perturbation leaves query results
byte-identical; and TPC-H runs of the port at scale 0.01 report zero
findings with the rows of the JAX package (the conftest's
`SRTPU_RACEDEP=1`, record-only, turns the port's witness on too). Each
test mirrors one of the JAX package's `tests/test_racedep.py`; its
wall-ratio gate is read on the card instead (`chip_smoke.py`
`witnesses`), and `test_torch_lockdep.py` checks the hooks' disabled
cost."""
import sys
import threading

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.runtime import ledger, lockdep, racedep
from spark_rapids_tpu_torch.runtime.racedep import DataRaceDetected, Witness


def test_suite_witness_enabled_record_only():
    """The conftest arms the witness for the whole suite, record-only;
    whatever ran before in this process left it clean: the live-engine
    race gate."""
    assert racedep.enabled()
    w = racedep.witness()
    assert not w.raise_on_race
    assert w.findings == [], w.findings


# ---------------------------------------------------------------------
# Eraser state machine units (local Witness; the global stays untouched)
# ---------------------------------------------------------------------
def _run_threads(*fns):
    errs = []

    def wrap(fn):
        def go():
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        return go

    ts = [threading.Thread(target=wrap(fn), name=f"race-t{i}")
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return errs


def test_two_thread_unlocked_collapse_raises():
    w = Witness(raise_on_race=True)
    gate = threading.Barrier(2)

    def writer():
        gate.wait()
        for _ in range(50):
            w.access("tbl", "k", write=True)

    errs = _run_threads(writer, writer)
    assert any(isinstance(e, DataRaceDetected) for e in errs), errs
    assert w.findings and w.findings[0]["kind"] == "lockset-collapse"
    assert w.findings[0]["structure"] == "tbl"


def test_lock_guarded_sharing_is_clean():
    w = Witness(raise_on_race=True)
    mu = threading.Lock()
    gate = threading.Barrier(2)

    def writer():
        gate.wait()
        for _ in range(50):
            with mu:
                w.lock_acquired("tbl._mu")
                try:
                    w.access("tbl", "k", write=True)
                finally:
                    w.lock_released("tbl._mu")

    assert _run_threads(writer, writer) == []
    assert w.findings == []
    rep = w.report()
    assert rep["shared"] == 1 and rep["findings"] == 0


def test_single_thread_exclusive_phase_never_reports():
    w = Witness(raise_on_race=True)
    for _ in range(100):
        w.access("tbl", "k", write=True)
    assert w.findings == []
    assert w.report()["shared"] == 0


def test_read_only_sharing_is_clean():
    # shared but never modified after hand-off: immutable after publish
    w = Witness(raise_on_race=True)

    def reader():
        for _ in range(50):
            w.access("tbl", "k", write=False)

    assert _run_threads(reader, reader) == []
    assert w.findings == []


def test_record_only_mode_collects_without_raising():
    w = Witness(raise_on_race=False)

    def writer():
        for _ in range(50):
            w.access("tbl", "k", write=True)

    assert _run_threads(writer, writer) == []
    assert len(w.findings) == 1
    f = w.findings[0]
    assert f["history"] and all(len(h) == 3 for h in f["history"])


def test_var_table_cap_folds_to_star():
    w = Witness(raise_on_race=True)
    for i in range(racedep._VARS_CAP + 10):
        w.access("tbl", str(i), write=True)
    rep = w.report()
    assert rep["tracked"] <= racedep._VARS_CAP + 1
    assert ("tbl", "*") in w._vars


def test_lockdep_wrapped_lock_feeds_lockset():
    """A lockdep.lock() made while racedep is on reports its acquire and
    release into racedep's thread-local lockset."""
    w = racedep.witness()
    assert w is not None
    mu = lockdep.lock("test_racedep.feeds")
    with mu:
        assert "test_racedep.feeds" in w.held_keys()
    assert "test_racedep.feeds" not in w.held_keys()


def test_metric_store_writes_hold_the_metric_lock(monkeypatch):
    """The port's instrumented structures: a metric written from two
    threads shares its slot under `MetricSet._lock`, and a telemetry
    registry access under `telemetry._LOCK`: no collapse (a fresh
    witness, whose slot table no earlier test filled)."""
    import torch

    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.profiler import telemetry
    w = Witness(raise_on_race=True)
    monkeypatch.setattr(racedep, "_WITNESS", w)
    base = 0
    ctx = ExecContext(TpuConf(), torch.device("cpu"))

    def bump():
        for _ in range(20):
            ctx.add_metric("Op@test", "opTime", 1.0)
            telemetry.counter("test_racedep_counter").inc()

    assert _run_threads(bump, bump) == []
    assert ctx.metrics["Op@test"]["opTime"] == 40.0
    slot = w._vars[("MetricSet._values", "Op@test.opTime")]
    assert slot.shared and slot.lockset == {"MetricSet._lock"}
    reg = w._vars[("telemetry.registry", "test_racedep_counter")]
    assert reg.shared and "telemetry._LOCK" in reg.lockset
    assert len(w.findings) == base


# ---------------------------------------------------------------------
# schedule perturbation
# ---------------------------------------------------------------------
def test_perturb_restore_switch_interval():
    w = Witness(raise_on_race=True)
    orig = sys.getswitchinterval()
    w.perturb(seed=7, yield_prob=1.0, switch_interval=1e-5)
    try:
        assert sys.getswitchinterval() == pytest.approx(1e-5)
        assert w.report()["perturbed"]
        w.access("tbl", "k", write=True)   # yields, still records
        assert w.accesses == 1
    finally:
        w.restore()
    assert sys.getswitchinterval() == pytest.approx(orig)
    assert not w.report()["perturbed"]


def test_perturbed_queries_byte_identical():
    """Two threads re-running q3- and q6-shaped queries under seeded
    yields and a microsecond switch interval: byte-identical results,
    no witnessed collapse, balanced ledgers."""
    n = 20_000
    at = pa.table({
        "k": pa.array(np.arange(n) % 40, type=pa.int64()),
        "v": pa.array(np.random.default_rng(3).normal(0, 1, n)),
        "w": pa.array(np.random.default_rng(4).uniform(0, 2, n)),
    })
    sess = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 8192,
                          "spark.rapids.tpu.sql.shuffle.partitions": 4},
                         device="cpu")
    df = sess.create_dataframe(at)

    def q3():
        return (df.filter(F.col("w") > 1.0)
                  .group_by(F.col("k"))
                  .agg(F.sum(F.col("v")).alias("sv"))
                  .sort(F.col("k")).to_arrow())

    def q6():
        return (df.filter((F.col("w") > 0.5) & (F.col("w") < 1.5))
                  .agg(F.sum(F.col("v") * F.col("w"))
                       .alias("rev")).to_arrow())

    serial = {"q3": q3(), "q6": q6()}
    w = racedep.witness()
    base = len(w.findings)
    lg0 = ledger.ledger().report()["findings"]
    mismatched = []

    def stream(i):
        for qn, fn in (("q3", q3), ("q6", q6)):
            out = fn()
            if not out.equals(serial[qn]):
                mismatched.append((i, qn))

    racedep.perturb(seed=1234, yield_prob=0.2)
    try:
        errs = _run_threads(lambda: stream(0), lambda: stream(1))
    finally:
        racedep.restore()
    assert errs == [], errs
    assert mismatched == []
    assert len(w.findings) == base, w.findings[base:]
    assert ledger.ledger().report()["findings"] == lg0


# ---------------------------------------------------------------------
# conf plumbing
# ---------------------------------------------------------------------
def test_maybe_enable_from_conf_no_op_when_armed():
    # the suite witness is already on; the conf enable is idempotent and
    # does not flip record-only into raising
    w = racedep.witness()
    pt.TpuSession({"spark.rapids.tpu.sql.debug.racedep.enabled": True},
                  device="cpu")
    assert racedep.witness() is w
    assert not w.raise_on_race


def test_conf_enables_the_witnesses_when_off(monkeypatch):
    """A session's `sql.debug.*` keys turn each witness on, raise mode by
    default, and wrap the locks made after it."""
    monkeypatch.setattr(lockdep, "_WITNESS", None)
    monkeypatch.setattr(racedep, "_WITNESS", None)
    monkeypatch.setattr(ledger, "_LEDGER", None)
    assert type(lockdep.lock("x")) is type(threading.Lock())
    pt.TpuSession({"spark.rapids.tpu.sql.debug.lockdep.enabled": True,
                   "spark.rapids.tpu.sql.debug.ledger.enabled": True,
                   "spark.rapids.tpu.sql.debug.racedep.enabled": True,
                   "spark.rapids.tpu.sql.debug.racedep.raiseOnRace":
                   False}, device="cpu")
    assert lockdep.witness().raise_on_finding
    assert ledger.ledger().raise_on_finding
    assert not racedep.witness().raise_on_race
    assert isinstance(lockdep.lock("x"), lockdep._WitnessLock)


# ---------------------------------------------------------------------
# the payoff: TPC-H through the port with the witnesses on
# ---------------------------------------------------------------------
TPCH_CONF = {"spark.rapids.tpu.sql.batchSizeRows": 4096,
             "spark.rapids.tpu.sql.exec.exchange.mapThreads": 4}


@pytest.mark.parametrize("n", [6, 4, 3])
def test_tpch_race_report_has_no_findings(n):
    """TPC-H Q6, Q4 and Q3 at scale 0.01 through the port, with the three
    witnesses on: racedep's report shows shared slots and zero findings,
    lockdep and the ledger none either, and the rows equal the JAX
    package's."""
    from spark_rapids_tpu.workloads import tpch as jtpch
    from spark_rapids_tpu_torch.workloads import tpch
    rw, lw, lg = racedep.witness(), lockdep.witness(), ledger.ledger()
    f0 = (len(rw.findings), len(lw.findings), len(lg.findings))
    ps = pt.TpuSession(TPCH_CONF, device="cpu")
    t = {k: ps.create_dataframe(v)
         for k, v in tpch.gen_all(0.01, 11).items()}
    out = tpch.queries()[n](t).to_arrow()
    rep = rw.report()
    assert rep["findings"] == 0 and rep["tracked"] > 0
    assert rep["shared"] > 0
    assert (len(rw.findings), len(lw.findings), len(lg.findings)) == f0
    js = st.TpuSession(TPCH_CONF)
    jt = {k: js.create_dataframe(v)
          for k, v in jtpch.gen_all(0.01, 11).items()}
    ref = jtpch.queries()[n](jt).to_arrow()
    if n == 3:     # a limit over ties: compare as sets
        key = [c for c in ref.column_names]
        out, ref = out.sort_by([(c, "ascending") for c in key]), \
            ref.sort_by([(c, "ascending") for c in key])
    assert out.equals(ref)
