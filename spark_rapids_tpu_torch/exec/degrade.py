"""Graceful device->host degradation for device failures.

The port's copy of the JAX package's `exec/degrade.py`. A ProjectExec or
FilterExec whose device evaluation raises (a kernel fault, an injected
error) re-evaluates the FAILED batch on the host interpreter (the
`exec/host_fallback.py` path) under `sql.exec.degradeToHost.enabled`,
and after `FAILURE_THRESHOLD` device failures on the same operator stops
dispatching to the device for the rest of the query. Each recovered
batch counts in the operator's `degradedToHost` metric; the moment an
operator pins to the host a `degrade_to_host` event is queued on the
ExecContext (`DataFrame.last_events()` returns them).

Two errors always propagate: an OOM belongs to split-and-retry
(`memory/retry.py`), as in the JAX package, and a CUDA runtime error
(`torch.AcceleratorError`, or a RuntimeError of the CUDA runtime) leaves
the context unusable, so a host re-run would read the batch through a
broken context (ROADMAP C.27). Each degradation counts as
`note_recovery("degradations")` in `runtime/faults.py`, as in the JAX
package; `degradations()` reads that counter.
"""
from __future__ import annotations

import torch

from ..runtime.faults import note_recovery, recovery_stats, \
    reset_recovery_stats

__all__ = ["should_degrade", "host_filter_batch", "host_project_batch",
           "is_cuda_runtime_error", "degradations", "reset_degradations",
           "FAILURE_THRESHOLD"]

#: device failures on the same operator before it stops trying the
#: device at all for this query
FAILURE_THRESHOLD = 2

# the heads of the CUDA runtime's and driver's error messages
_CUDA_MARKERS = ("CUDA error", "CUDA driver error", "cuda runtime error",
                 "device-side assert")


def degradations() -> int:
    """Batches recovered on the host since the last reset, process-wide
    (`recovery_stats()["degradations"]`)."""
    return recovery_stats().get("degradations", 0)


def reset_degradations():
    """Zero the process's recovery counters (`runtime/faults.py`), of
    which the port keeps only `degradations` until ROADMAP A.15."""
    reset_recovery_stats()


def is_cuda_runtime_error(e: BaseException) -> bool:
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    if not isinstance(e, RuntimeError):
        return False
    head = str(e).split("\n", 1)[0]
    return any(m in head for m in _CUDA_MARKERS)


def should_degrade(ctx, node, e: BaseException) -> bool:
    """Classify one device failure of `node`. True: the caller recovers
    this batch on the host path; False: the error propagates (an OOM, a
    CUDA runtime error, or the conf gate off)."""
    from ..config import DEGRADE_TO_HOST
    from ..memory.retry import is_oom_error
    if is_oom_error(e) or is_cuda_runtime_error(e):
        return False
    if not bool(ctx.conf.get(DEGRADE_TO_HOST)):
        return False
    op_id = node._op_id
    with ctx._lock:
        n = ctx.device_failures.get(op_id, 0) + 1
        ctx.device_failures[op_id] = n
        pin = n >= FAILURE_THRESHOLD and op_id not in ctx.degraded
        if pin:
            # pinned to the host for the rest of the query
            ctx.degraded[op_id] = True
            ctx.pending_events.append({
                "event": "degrade_to_host", "op": type(node).__name__,
                "op_id": op_id, "failures": n, "error": repr(e)})
    if pin:
        # a zero-length marker span: the decision is instant, its cost
        # (the host re-execution) shows as compute, but the trace says
        # the query crossed onto the recovery path
        from ..profiler import tracing
        with tracing.span("degrade.to_host", "degrade", ctx,
                          op=type(node).__name__, failures=n):
            pass
    note_recovery("degradations")
    return True


def host_filter_batch(node, batch, device):
    """A FilterExec's bound condition over one batch on the host; None
    when no row survives."""
    from .host_fallback import host_filter
    return host_filter(node.bound, batch, device)


def host_project_batch(node, batch, device):
    """A ProjectExec's bound expressions over one batch on the host."""
    from .host_fallback import host_project
    return host_project(node.bound, node.schema, batch, device)
