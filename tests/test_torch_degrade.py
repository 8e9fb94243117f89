"""Degrade-to-host (`exec/degrade.py`): a FilterExec or ProjectExec whose
device evaluation raises recovers the batch on the host interpreter;
after two failures the node is pinned to the host for the query and a
`degrade_to_host` event is queued. An OOM, a CUDA runtime error and the
conf gate off propagate. The recovered rows equal the JAX package's
answer to the same query over the same Arrow table."""
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.exec import degrade
from spark_rapids_tpu_torch.exec.nodes import FilterExec, ProjectExec

CONF = {"spark.rapids.tpu.sql.batchSizeRows": 64,
        "spark.rapids.tpu.sql.concurrentTpuTasks": 1}
ROWS = 640                       # ten batches, one partition each


def _table():
    rng = np.random.default_rng(11)
    return pa.table({
        "k": pa.array(rng.integers(-2**31, 2**31, ROWS), pa.int32(),
                      mask=rng.random(ROWS) < 0.1),
        "v": pa.array(rng.normal(0, 10, ROWS)),
        "s": pa.array([f"w{i % 13}" for i in range(ROWS)])})


QUERIES = {
    FilterExec: lambda F, df: df.filter((F.col("k") < -2**30)
                                        | (F.col("v") > 5.0)),
    ProjectExec: lambda F, df: df.select(
        (F.col("k") * 7919 + 1).alias("w"), (F.col("v") * 2).alias("v2"),
        F.upper(F.col("s")).alias("u")),
}


class _Inject:
    """The first `n` device evaluations of `cls` (its `fusable_stage`
    function) raise `exc`."""

    def __init__(self, monkeypatch, cls, n, exc):
        self.left = n
        self.lock = threading.Lock()
        orig = cls.fusable_stage
        inj = self

        def fusable_stage(node):
            fn = orig(node)

            def wrapped(cvs, mask):
                with inj.lock:
                    fire = inj.left > 0
                    inj.left -= fire
                if fire:
                    raise exc
                return fn(cvs, mask)
            return wrapped
        monkeypatch.setattr(cls, "fusable_stage", fusable_stage)


def _jax_rows(cls):
    return QUERIES[cls](JF, st.TpuSession(CONF).create_dataframe(
        _table())).to_arrow()


def _port(cls, conf=None):
    s = pt.TpuSession({**CONF, **(conf or {})}, device="cpu")
    return QUERIES[cls](PF, s.create_dataframe(_table()))


def _metric(q, cls, name):
    return sum(v.get(name, 0) for k, v in q.last_metrics().items()
               if k.startswith(cls.__name__ + "@"))


@pytest.mark.parametrize("cls", [FilterExec, ProjectExec])
def test_one_injected_failure_recovers_on_the_host(monkeypatch, cls):
    degrade.reset_degradations()
    _Inject(monkeypatch, cls, 1, RuntimeError("injected kernel fault"))
    q = _port(cls)
    got = q.to_arrow()
    assert got.equals(_jax_rows(cls))
    assert _metric(q, cls, "degradedToHost") == 1
    assert _metric(q, cls, "hostEvalTime") > 0
    assert q.last_events() == []
    assert degrade.degradations() == 1


@pytest.mark.parametrize("cls", [FilterExec, ProjectExec])
def test_threshold_pins_the_node_to_the_host(monkeypatch, cls):
    degrade.reset_degradations()
    _Inject(monkeypatch, cls, degrade.FAILURE_THRESHOLD,
            ValueError("injected kernel fault"))
    q = _port(cls)
    got = q.to_arrow()
    assert got.equals(_jax_rows(cls))
    # pinned at the second failure: every batch from the first failure
    # on ran on the host
    assert _metric(q, cls, "degradedToHost") == ROWS // 64
    ev = q.last_events()
    assert len(ev) == 1 and ev[0]["event"] == "degrade_to_host"
    assert ev[0]["op"] == cls.__name__ and ev[0]["failures"] == 2
    assert degrade.degradations() == degrade.FAILURE_THRESHOLD


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA driver error: unspecified launch failure"),
], ids=["oom", "cuda_error", "cuda_driver_error"])
@pytest.mark.parametrize("cls", [FilterExec, ProjectExec])
def test_oom_and_cuda_errors_propagate(monkeypatch, cls, exc):
    degrade.reset_degradations()
    _Inject(monkeypatch, cls, 1, exc)
    with pytest.raises(type(exc)):
        _port(cls).to_arrow()
    assert degrade.degradations() == 0


def test_accelerator_error_is_a_cuda_runtime_error():
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert degrade.is_cuda_runtime_error(accel("illegal address"))
    assert not degrade.is_cuda_runtime_error(RuntimeError("shape mismatch"))
    assert not degrade.is_cuda_runtime_error(ValueError("CUDA error: x"))


@pytest.mark.parametrize("cls", [FilterExec, ProjectExec])
def test_conf_off_propagates(monkeypatch, cls):
    degrade.reset_degradations()
    _Inject(monkeypatch, cls, 1, RuntimeError("injected kernel fault"))
    q = _port(cls, {"spark.rapids.tpu.sql.exec.degradeToHost.enabled":
                    False})
    with pytest.raises(RuntimeError, match="injected"):
        q.to_arrow()
    assert degrade.degradations() == 0
