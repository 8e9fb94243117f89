"""Deterministic fault injection (`runtime/faults.py`) in the port and the
recovery paths it exercises: the plan grammar, seeded determinism, the
conservative transient and OOM classifiers, bounded backoff and graceful
device -> host degradation. Each test mirrors one of the JAX package's
`tests/test_faults.py`; where both packages take the same input, the
port is held to the JAX package: the same plan over the same call
sequence gives the same injection trace, the same bad fields are
refused, the classifiers agree, backoff lists are equal and a degraded
query gives the JAX package's rows. The service-level retry (four JAX
tests) waits for the query manager (ROADMAP A.15)."""
import os
import subprocess
import sys
import time

import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.memory.retry import is_oom_error as j_is_oom
from spark_rapids_tpu.runtime import faults as jfaults
from spark_rapids_tpu.runtime.backoff import backoff_delays as j_backoff
from spark_rapids_tpu_torch.memory.retry import is_oom_error
from spark_rapids_tpu_torch.runtime import faults
from spark_rapids_tpu_torch.runtime.backoff import backoff_delays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (faults, jfaults):
        f.clear_plan()
        f.reset_recovery_stats()
    yield
    for f in (faults, jfaults):
        f.clear_plan()
        f.reset_recovery_stats()


def _drive(mod, spec, calls):
    """Install `spec` in `mod` and make `calls` ((point, kwargs) pairs),
    swallowing injected raises; the injection trace and counts."""
    mod.install_plan(spec)
    raised = []
    for point, kw in calls:
        try:
            mod.hit(point, **kw)
            raised.append(None)
        except Exception as e:  # noqa: BLE001 - compared below
            raised.append(type(e).__name__)
    return mod.injection_trace(), mod.injection_counts(), raised


# ----------------------------------------------------------------------
# plan grammar + injection mechanics
# ----------------------------------------------------------------------
def test_nth_rule_fires_on_exactly_the_nth_call():
    assert faults.install_plan("p.x:nth=3:raise=Boom") == 1
    faults.hit("p.x")
    faults.hit("p.x")
    with pytest.raises(faults.InjectedFault, match="Boom"):
        faults.hit("p.x")
    # nth= implies times=1: the 4th, 5th... calls pass clean
    faults.hit("p.x")
    faults.hit("p.x")
    assert faults.injection_counts() == {"injected": 1, "raise": 1}
    assert faults.injection_trace() == [
        {"point": "p.x", "call": 3, "action": "raise", "arg": "Boom"}]


def test_times_widens_an_nth_rule_and_caps_a_prob_rule():
    faults.install_plan("p.x:prob=1.0:times=2:raise=Boom")
    for _ in range(2):
        with pytest.raises(faults.InjectedFault):
            faults.hit("p.x")
    faults.hit("p.x")                      # cap reached: clean
    assert faults.injection_counts()["injected"] == 2


def test_prob_seed_is_deterministic_across_reinstalls():
    spec = "p.x:prob=0.4:seed=11:raise=Boom"
    calls = [("p.x", {})] * 50
    first, second = _drive(faults, spec, calls), _drive(faults, spec, calls)
    assert first[0] and first == second
    # a different seed produces a different schedule
    assert _drive(faults, "p.x:prob=0.4:seed=12:raise=Boom",
                  calls)[0] != first[0]


PLANS = [
    "p.x:nth=3:raise=Boom",
    "p.x:prob=0.4:seed=11:raise=Boom",
    "p.x:prob=0.3:seed=7:times=4:raise=RESOURCE_EXHAUSTED;p.y:nth=2:delay=1",
    "p.x:op=FilterExec:raise=Boom;p.y:query=q-7:raise=Boom",
    "device.dispatch:op=ProjectExec:nth=2:raise=InjectedFault,"
    "exchange.map:nth=3:raise=RESOURCE_EXHAUSTED",
    "spill.write:prob=0.5:seed=3:raise=FetchFailed;"
    "xla.compile:bg=1:raise=ExecutorLost",
]


@pytest.mark.parametrize("spec", PLANS)
def test_same_plan_gives_the_jax_injection_trace(spec):
    """The same plan over the same call sequence: the same trace, counts
    and exception class at every call, in both packages."""
    ops = ("FilterExec", "ProjectExec", None)
    qids = ("q-3", "dist-q-7-1", None)
    points = ("p.x", "p.y", "device.dispatch", "exchange.map",
              "spill.write", "xla.compile")
    calls = [(points[i % len(points)],
              {"op": ops[i % 3], "query_id": qids[(i // 3) % 3],
               "background": bool(i % 5 == 0)})
             for i in range(120)]
    mine = _drive(faults, spec, calls)
    ref = _drive(jfaults, spec, calls)
    assert mine[0] == ref[0] and mine[1] == ref[1]
    assert mine[2] == ref[2]
    assert mine[0], "the plan never injected"


def test_query_and_op_selectors():
    faults.install_plan("p.x:op=FilterExec:raise=Boom;"
                        "p.y:query=q-7:raise=Boom")
    faults.hit("p.x", op="ProjectExec")          # op mismatch: clean
    with pytest.raises(faults.InjectedFault):
        faults.hit("p.x", op="FilterExec")
    faults.hit("p.y", query_id="q-3")            # query mismatch: clean
    with pytest.raises(faults.InjectedFault):
        faults.hit("p.y", query_id="dist-q-7-1")


def test_delay_action_sleeps_then_continues():
    faults.install_plan("p.x:nth=1:delay=60")
    t0 = time.perf_counter()
    faults.hit("p.x")                            # no raise
    assert time.perf_counter() - t0 >= 0.055
    assert faults.injection_counts() == {"injected": 1, "delay": 1}


def test_kill_action_parses_without_firing():
    faults.install_plan("executor.task:nth=99:kill")
    assert faults._rules[0].action == "kill"
    faults.hit("executor.task")                  # call 1 != 99: survives


def test_raise_named_maps_to_structured_exceptions():
    faults.install_plan("a.b:nth=1:raise=FetchFailed;"
                        "c.d:nth=1:raise=ExecutorLost;"
                        "e.f:nth=1:raise=RESOURCE_EXHAUSTED")
    with pytest.raises(faults.FetchFailed):
        faults.hit("a.b")
    with pytest.raises(faults.ExecutorLostError):
        faults.hit("c.d")
    with pytest.raises(faults.InjectedFault,
                       match="^RESOURCE_EXHAUSTED"):
        faults.hit("e.f")


@pytest.mark.parametrize("spec", ["p.x:wat=1", "p.x:badfield", "p.x:nth",
                                  "p.x:nth=x", "p.x:prob=high",
                                  "p.x:bg=yes", "p.x:times=1.5"])
def test_bad_rule_fields_rejected_as_in_jax(spec):
    with pytest.raises(ValueError) as mine:
        faults.install_plan(spec)
    with pytest.raises(ValueError) as ref:
        jfaults.install_plan(spec)
    assert str(mine.value) == str(ref.value)
    assert not faults.ACTIVE


def test_every_jax_point_name_is_accepted():
    assert faults.POINTS == jfaults.POINTS and len(faults.POINTS) == 9
    faults.install_plan(";".join(f"{p}:nth=1:delay=0"
                                 for p in faults.POINTS))
    for p in faults.POINTS:
        faults.hit(p)
    assert faults.injection_counts() == {"injected": 9, "delay": 9}


def test_clear_plan_disables_the_active_guard():
    faults.install_plan("p.x:nth=1:raise=Boom")
    assert faults.ACTIVE
    faults.clear_plan()
    assert not faults.ACTIVE
    assert faults.current_plan() is None
    assert faults.injection_trace() == []


def test_install_from_conf_is_idempotent_by_spec():
    from spark_rapids_tpu_torch.config import TpuConf
    conf = TpuConf({"spark.rapids.tpu.sql.debug.faults.plan":
                    "p.x:nth=5:raise=Boom"})
    faults.install_from_conf(conf)
    faults.hit("p.x")
    faults.hit("p.x")
    # adopting the same spec again (another session over the same conf)
    # must not reset mid-query call counters
    faults.install_from_conf(conf)
    assert faults._calls["p.x"] == 2


def test_session_installs_the_conf_plan():
    pt.TpuSession({"spark.rapids.tpu.sql.debug.faults.plan":
                   "p.x:nth=2:raise=Boom"}, device="cpu")
    assert faults.current_plan() == "p.x:nth=2:raise=Boom"


def test_env_plan_activates_at_import(tmp_path):
    r = subprocess.run(
        [sys.executable, "-c",
         "from spark_rapids_tpu_torch.runtime import faults; "
         "print(faults.ACTIVE, faults.current_plan())"],
        capture_output=True, text=True, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO,
             "SRTPU_FAULTS": "p.x:nth=1:raise=Boom",
             "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "True p.x:nth=1:raise=Boom"


# ----------------------------------------------------------------------
# bounded exponential backoff + jitter
# ----------------------------------------------------------------------
def test_backoff_deterministic_bounded_and_capped():
    a = backoff_delays(6, 100.0, max_ms=800.0, seed=3)
    b = backoff_delays(6, 100.0, max_ms=800.0, seed=3)
    assert a == b and len(a) == 6
    for k, d in enumerate(a):
        cap = min(100.0 * 2 ** k, 800.0) / 1000.0
        assert cap * 0.5 <= d < cap
    assert backoff_delays(6, 100.0, max_ms=800.0, seed=4) != a


@pytest.mark.parametrize("args", [(6, 100.0, 800.0, 3), (0, 5.0, 10.0, 1),
                                  (12, 7.5, 10_000.0, None),
                                  (9, 250.0, 1000.0, 42)])
def test_backoff_equals_jax(args):
    n, base, cap, seed = args
    mine = backoff_delays(n, base, max_ms=cap, seed=seed)
    if seed is None:        # unseeded: only the shape and bounds agree
        assert len(mine) == n
        return
    assert mine == j_backoff(n, base, max_ms=cap, seed=seed)


# ----------------------------------------------------------------------
# OOM classification (memory/retry.py): head-only, typed first
# ----------------------------------------------------------------------
def test_is_oom_budget_exceeded_and_status_heads():
    from spark_rapids_tpu_torch.memory.device import BudgetExceeded
    assert is_oom_error(BudgetExceeded("over budget"))
    assert is_oom_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert is_oom_error(RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate"))
    assert is_oom_error(RuntimeError("Out of memory allocating 8GiB"))
    assert not is_oom_error(ValueError("bad plan"))


def _classified():
    """Exceptions both packages see alike: (exception, what it is)."""
    return [
        RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying"),
        RuntimeError("Out of memory allocating 8GiB"),
        RuntimeError("out of memory (lowercase wording)"),
        RuntimeError("CUDA error: out of memory"),
        ValueError("bad plan"),
        ValueError("cannot parse row\npayload: 'RESOURCE_EXHAUSTED: x'"),
        ValueError("x" * 300 + " RESOURCE_EXHAUSTED"),
        RuntimeError("INTERNAL: something broke"),
        MemoryError("host"),
        KeyError("RESOURCE_EXHAUSTED"),
    ]


@pytest.mark.parametrize("i", range(10))
def test_is_oom_classifies_as_jax(i):
    e = _classified()[i]
    assert is_oom_error(e) == j_is_oom(e), e


def test_is_oom_matches_only_the_message_head():
    # user data quoting an OOM-looking string past the first line, or
    # past the head-size cut on one line, is not an OOM
    assert not is_oom_error(ValueError(
        "cannot parse row\npayload: 'RESOURCE_EXHAUSTED: fake'"))
    assert not is_oom_error(ValueError(
        "x" * 300 + " RESOURCE_EXHAUSTED"))


def test_injected_resource_exhausted_routes_through_both_classifiers():
    for mod, oom in ((faults, is_oom_error), (jfaults, j_is_oom)):
        mod.install_plan("p.x:nth=1:raise=RESOURCE_EXHAUSTED")
        with pytest.raises(mod.InjectedFault) as ei:
            mod.hit("p.x")
        assert oom(ei.value)


# ----------------------------------------------------------------------
# transient classification: conservative by contract
# ----------------------------------------------------------------------
def _transient_cases(mod):
    fetch = (mod.FetchFailed if hasattr(mod, "FetchFailed") else
             __import__("spark_rapids_tpu.cluster.blocks",
                        fromlist=["FetchFailed"]).FetchFailed)
    lost = (mod.ExecutorLostError if hasattr(mod, "ExecutorLostError")
            else __import__("spark_rapids_tpu.cluster.driver",
                            fromlist=["x"]).ExecutorLostError)
    return [mod.InjectedFault("boom"), fetch("mapper gone"), lost("lost"),
            ConnectionResetError("reset"), ConnectionRefusedError("no"),
            KeyboardInterrupt(), SystemExit(), GeneratorExit(),
            ValueError("bad expression"), TypeError("bad plan"),
            RuntimeError("arbitrary"),
            RuntimeError("RESOURCE_EXHAUSTED: oom")]


def test_is_transient_error_per_class_equals_jax():
    mine = [faults.is_transient_error(e) for e in _transient_cases(faults)]
    ref = [jfaults.is_transient_error(e)
           for e in _transient_cases(jfaults)]
    assert mine == ref
    assert mine == [True] * 5 + [False] * 7


# ----------------------------------------------------------------------
# graceful device -> host degradation
# ----------------------------------------------------------------------
_DATA = {"id": list(range(3000)), "v": [i % 97 for i in range(3000)]}
_NOCACHE = {"spark.rapids.tpu.sql.resultCache.enabled": "false"}


def _q(s, F):
    return (s.create_dataframe(pa.table(_DATA))
            .filter(F.col("v") > 10)
            .select((F.col("id") * 2).alias("x"), F.col("v")))


def _session(pkg, conf):
    if pkg is st:
        return st.TpuSession({**_NOCACHE, **conf})
    return pt.TpuSession(conf, device="cpu")


def test_degradation_recovers_the_jax_rows():
    plan = {"spark.rapids.tpu.sql.debug.faults.plan":
            "device.dispatch:prob=1.0:seed=5:raise=InternalError",
            "spark.rapids.tpu.sql.batchSizeRows": 1024}
    ref = _q(st.TpuSession(_NOCACHE), JF).to_arrow()
    jout = _q(_session(st, plan), JF).to_arrow()
    jfaults.clear_plan()
    df = _q(_session(pt, plan), PF)
    out = df.to_arrow()
    assert out.equals(jout) and out.equals(ref)
    assert faults.injection_counts()["injected"] >= 1
    assert faults.recovery_stats()["degradations"] >= 1
    degraded = sum(v.get("degradedToHost", 0)
                   for v in df.last_metrics().values())
    assert degraded >= 1


def test_degradation_by_op_and_nth_equals_jax():
    """One ProjectExec dispatch failure (the chip phase's plan): the
    projection's rows equal the JAX package's degraded rows, and exactly
    one batch recovers on the host."""
    conf = {"spark.rapids.tpu.sql.debug.faults.plan":
            "device.dispatch:op=ProjectExec:nth=2:raise=InjectedFault",
            "spark.rapids.tpu.sql.batchSizeRows": 512,
            # a lone ProjectExec on both sides (the port has no fusion)
            "spark.rapids.tpu.sql.exec.stageFusion.enabled": False}

    def proj(s, F):
        return s.create_dataframe(pa.table(_DATA)).select(
            (F.col("id") * 3 + F.col("v")).alias("w"), F.col("v"))

    jout = proj(_session(st, conf), JF).to_arrow()
    jinj = jfaults.injection_counts()
    jfaults.clear_plan()
    df = proj(_session(pt, conf), PF)
    out = df.to_arrow()
    assert out.equals(jout)
    assert faults.injection_counts() == jinj == {"injected": 1,
                                                  "raise": 1}
    assert faults.recovery_stats() == {"degradations": 1}
    from spark_rapids_tpu_torch.exec import degrade
    assert degrade.degradations() == 1


def test_degradation_pins_after_threshold_and_logs_event(tmp_path):
    import glob
    import json
    s = pt.TpuSession({
        "spark.rapids.tpu.sql.debug.faults.plan":
            "device.dispatch:prob=1.0:seed=5:raise=InternalError",
        "spark.rapids.tpu.sql.batchSizeRows": 512,
        "spark.rapids.tpu.sql.eventLog.enabled": "true",
        "spark.rapids.tpu.sql.eventLog.dir": str(tmp_path)}, device="cpu")
    _q(s, PF).to_arrow()
    evs = []
    for p in glob.glob(str(tmp_path / "*")):
        with open(p) as f:
            evs += [json.loads(line) for line in f]
    dg = [e for e in evs if e.get("event") == "degrade_to_host"]
    assert dg, "degrade_to_host event missing from the query log"
    assert dg[0]["failures"] >= 2        # pinned at FAILURE_THRESHOLD


def test_degradation_gate_off_propagates():
    s = pt.TpuSession({
        "spark.rapids.tpu.sql.debug.faults.plan":
            "device.dispatch:prob=1.0:seed=5:raise=InternalError",
        "spark.rapids.tpu.sql.exec.degradeToHost.enabled": "false"},
        device="cpu")
    with pytest.raises(faults.InjectedFault):
        _q(s, PF).to_arrow()
    assert "degradations" not in faults.recovery_stats()


def test_degradation_never_claims_oom():
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec import degrade
    from spark_rapids_tpu_torch.exec.base import ExecContext

    class _Node:
        _op_id = "X@1"

    ctx = ExecContext(TpuConf(), torch.device("cpu"), planning=True)
    assert not degrade.should_degrade(
        ctx, _Node(), faults.InjectedFault("RESOURCE_EXHAUSTED: dev"))
    assert ctx.device_failures == {}     # not counted as a failure
    assert faults.recovery_stats() == {}


def test_exchange_map_injection_splits_the_batch():
    """An injected RESOURCE_EXHAUSTED inside the map pass (with_retry's
    callable) takes the split path: one OOM, one split, the JAX rows."""
    from spark_rapids_tpu_torch.memory import retry
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 512,
            "spark.rapids.tpu.sql.exec.exchange.mapThreads": 1}

    def grouped(s, F):
        return (s.create_dataframe(pa.table(_DATA)).repartition(4, "v")
                .group_by("v").agg(F.sum("id").alias("s")).sort("v"))

    ref = grouped(st.TpuSession({**_NOCACHE, **conf}), JF).to_arrow()
    retry.reset_retry_stats()
    s = pt.TpuSession({**conf, "spark.rapids.tpu.sql.debug.faults.plan":
                       "exchange.map:nth=3:raise=RESOURCE_EXHAUSTED"},
                      device="cpu")
    out = grouped(s, PF).to_arrow()
    assert out.equals(ref)
    assert faults.injection_trace() == [
        {"point": "exchange.map", "call": 3, "action": "raise",
         "arg": "RESOURCE_EXHAUSTED"}]
    stats = retry.retry_stats()
    assert stats["ooms"] == 1 and stats["splits"] == 1


def test_spill_write_point_fires_in_the_disk_write(tmp_path):
    from spark_rapids_tpu_torch.columnar.table import Table
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    from spark_rapids_tpu_torch.memory.device import DeviceManager
    from spark_rapids_tpu_torch.memory.spill import SpillStore
    cpu = torch.device("cpu")
    dm = DeviceManager(1 << 30, device=cpu)
    store = SpillStore(dm, spill_dir=str(tmp_path))
    at = pa.table({"x": pa.array(range(64), pa.int64())})
    h = store.add_batch(DeviceBatch(Table.from_arrow(at, cpu)))
    faults.install_plan("spill.write:nth=1:raise=IOErrorLike")
    with pytest.raises(faults.InjectedFault, match="^IOErrorLike"):
        h.spill_to_disk()
    assert h.state == "device" and not os.listdir(tmp_path)
    assert h.spill_to_disk() == h.nbytes       # the next write lands
    h.close()
    assert store.open_handles == 0


def test_same_seed_replays_identical_injection_trace():
    """The same plan and seed over a full query give the same trace. The
    port runs a root's partitions on a pool, whose order varies from run
    to run: one map thread under a repartition keeps the dispatch order
    fixed, as the JAX package's serial loop does."""
    spec = "device.dispatch:prob=0.3:seed=21:raise=InternalError"
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 512,
            "spark.rapids.tpu.sql.exec.exchange.mapThreads": 1}

    def run_once():
        faults.install_plan(spec)
        out = _q(pt.TpuSession(conf, device="cpu"), PF).repartition(1) \
            .to_arrow()
        return out, faults.injection_trace()

    out1, trace1 = run_once()
    out2, trace2 = run_once()
    assert trace1, "plan never injected: prob/seed changed?"
    assert trace1 == trace2
    assert out1.equals(out2)


@pytest.mark.parametrize("rows", [2526, 1263, 4097, 17, 16, 9])
def test_split_halves_keep_the_vector_alignment(rows):
    """An injected OOM splits whichever map batch it meets: each half's
    int32 key and validity views start as aligned as the whole, so the
    partition kernel takes its vector variant on both (ROADMAP C.45),
    and the halves hold the batch's rows in order."""
    from spark_rapids_tpu_torch.columnar.table import Table
    from spark_rapids_tpu_torch.exec.batch import DeviceBatch
    from spark_rapids_tpu_torch.exec.nodes import _batch_to_arrow
    from spark_rapids_tpu_torch.memory import retry
    from spark_rapids_tpu_torch.ops import partition_kernels as pk
    at = pa.table({"k": pa.array(range(rows), pa.int32()),
                   "s": [f"r{i}" for i in range(rows)]})
    b = DeviceBatch(Table.from_arrow(at, torch.device("cpu")))
    halves = retry.split_batch_in_half(b)
    assert pa.concat_tables([_batch_to_arrow(h) for h in halves]) \
        .equals(at)
    out = torch.empty(rows, dtype=torch.int32)
    whole = pk.variant(b.table.columns[0].data.data_ptr(),
                       b.table.columns[0].validity.data_ptr(),
                       out.data_ptr())
    assert whole == "vector"
    for h in halves:
        c = h.table.columns[0]
        got = pk.variant(c.data.data_ptr(), c.validity.data_ptr(),
                         out.data_ptr())
        # below 2 * SPLIT_ALIGN_ROWS rows the middle cannot keep it
        assert got == "vector" or rows < 2 * retry.SPLIT_ALIGN_ROWS
    assert halves[0].capacity % retry.SPLIT_ALIGN_ROWS == 0 \
        or rows < 2 * retry.SPLIT_ALIGN_ROWS
