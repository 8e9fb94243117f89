"""Deterministic, seeded fault injection for the engine's own failure
paths.

The port of the JAX package's `runtime/faults.py`. The reference ships a
CUDA fault-injection tool (spark-rapids-jni) so the plugin's OOM-retry
and recovery machinery is exercised, not hoped for. Same idea here:
named fault points are instrumented in the engine, and a fault PLAN
selects which calls fail and how. The plan accepts all nine point names
of the JAX package (`block.fetch`, `rpc.send`, `executor.task`,
`device.dispatch`, `exchange.map`, `spill.write`, `xla.compile`,
`mesh.collective`, `peer.fetch`); the port fires three of them:

- `device.dispatch` in ProjectExec and FilterExec (exec/nodes.py), op=
  the node's class: a failure there degrades the batch to the host
  (exec/degrade.py, counted `degradations`);
- `exchange.map` inside the exchange's map pass, under `with_retry`
  (exec/exchange.py): an injected RESOURCE_EXHAUSTED splits the batch;
- `spill.write` in the spill store's disk write (memory/spill.py).

The other six stay parsed and inert until their modules come (the
program cache, ROADMAP A.11; the mesh, A.14; cluster and fleet, A.15).

Plan grammar (conf `spark.rapids.tpu.sql.debug.faults.plan` or env
`SRTPU_FAULTS`), rules separated by `;`:

    point[:selector]*[:action]

    selectors   nth=N       fire on exactly the Nth call of the point
                            (1-based; implies times=1 unless overridden)
                prob=P      fire each call with probability P, drawn
                            from this rule's own seeded PRNG
                seed=S      PRNG seed for prob= (default 0: the same
                            plan always injects the same failures)
                times=K     stop after K injections from this rule
                query=SUB   only calls whose query_id contains SUB
                op=NAME     only calls whose operator class == NAME
                bg=0|1      only the sync (0) or background (1) path
    actions     raise=NAME  raise a typed error: FetchFailed and
                            ExecutorLost map to this module's
                            structured exceptions; anything else raises
                            InjectedFault with NAME as the message head
                            (so `raise=RESOURCE_EXHAUSTED` routes
                            through the OOM classifier)
                delay=MS    sleep MS milliseconds, then continue
                kill        os._exit(1)

    exchange.map:nth=3:raise=RESOURCE_EXHAUSTED
    device.dispatch:op=ProjectExec:nth=2:raise=InjectedFault

Determinism: per-rule `random.Random(seed)` plus per-point call
counters, both under one lock; `injection_trace()` returns the ordered
(point, call, action) list, so a test can assert that the same plan and
seed reproduce the identical trace. A conf-carried plan activates in
`TpuSession.__init__` through `install_from_conf`.

Zero overhead disabled: every call site guards with the module-level
bool `if faults.ACTIVE: faults.hit(...)`.
"""
from __future__ import annotations

import os
import threading
import time
from random import Random
from typing import Dict, List, Optional

__all__ = ["ACTIVE", "POINTS", "InjectedFault", "FetchFailed",
           "ExecutorLostError", "install_plan",
           "clear_plan", "install_from_conf", "hit", "injection_trace",
           "injection_counts", "current_plan", "is_transient_error",
           "note_recovery", "recovery_stats", "reset_recovery_stats"]

#: the zero-overhead guard: call sites read this bool and skip hit()
#: entirely when no plan is installed
ACTIVE = False

#: the fault-point inventory of the JAX package, every name accepted
POINTS = ("block.fetch", "device.dispatch", "executor.task",
          "spill.write", "xla.compile", "exchange.map", "rpc.send",
          "mesh.collective", "peer.fetch")

_lock = threading.Lock()
_spec: Optional[str] = None
_rules: List["_Rule"] = []
_calls: Dict[str, int] = {}          # point -> total calls observed
_trace: List[dict] = []              # ordered injections (determinism)
_counts: Dict[str, int] = {}         # action kind -> injections


class FetchFailed(RuntimeError):
    """A peer block fetch failed (the JAX package's `cluster/blocks.py`
    exception, kept here until the cluster layer comes, ROADMAP A.15):
    transient, so a retry path absorbs it."""

    def __init__(self, msg: str, addr=None, shuffle_id: str = None,
                 transient: bool = True):
        super().__init__(msg)
        self.addr = tuple(addr) if addr else None
        self.shuffle_id = shuffle_id
        self.transient = transient


class ExecutorLostError(RuntimeError):
    """An executor died (the JAX package's `cluster/driver.py`
    exception, kept here until the cluster layer comes)."""


class InjectedFault(RuntimeError):
    """An error raised by the fault-injection harness (classified
    transient by `is_transient_error` — recovery paths must absorb
    it)."""

    def __init__(self, msg: str, point: str = None):
        super().__init__(msg)
        self.point = point


class _Rule:
    __slots__ = ("point", "nth", "prob", "seed", "times", "query", "op",
                 "action", "arg", "bg", "_rng", "_fired")

    def __init__(self, point: str):
        self.point = point
        self.bg: Optional[bool] = None  # None matches either path
        self.nth: Optional[int] = None
        self.prob: Optional[float] = None
        self.seed: int = 0
        self.times: Optional[int] = None
        self.query: Optional[str] = None
        self.op: Optional[str] = None
        self.action: str = "raise"
        self.arg: Optional[str] = None
        self._rng: Optional[Random] = None
        self._fired: int = 0


def _parse_rule(text: str) -> _Rule:
    fields = [f.strip() for f in text.split(":") if f.strip()]
    if not fields:
        raise ValueError(f"empty fault rule in {text!r}")
    r = _Rule(fields[0])
    for f in fields[1:]:
        if f == "kill":
            r.action = "kill"
            continue
        if "=" not in f:
            raise ValueError(f"bad fault rule field {f!r} (rule {text!r})")
        k, v = f.split("=", 1)
        if k == "nth":
            r.nth = int(v)
        elif k == "prob":
            r.prob = float(v)
        elif k == "seed":
            r.seed = int(v)
        elif k == "times":
            r.times = int(v)
        elif k == "query":
            r.query = v
        elif k == "op":
            r.op = v
        elif k == "bg":
            # background-path selector: bg=1 matches only compile-pool
            # prewarms, bg=0 only the sync dispatch path (xla.compile)
            r.bg = bool(int(v))
        elif k == "raise":
            r.action, r.arg = "raise", v
        elif k == "delay":
            r.action, r.arg = "delay", v
        else:
            raise ValueError(f"unknown fault rule field {k!r} "
                             f"(rule {text!r})")
    # an nth= rule is a single shot unless an explicit times= widens it
    if r.nth is not None and r.times is None:
        r.times = 1
    r._rng = Random(r.seed)
    return r


def install_plan(spec: str) -> int:
    """Parse and install a fault plan, resetting counters, PRNGs and
    the injection trace (same plan ⇒ same injections). Returns the
    number of rules installed."""
    global ACTIVE, _spec
    rules = [_parse_rule(part)
             for part in spec.replace(",", ";").split(";")
             if part.strip()]
    with _lock:
        _rules[:] = rules
        _spec = spec
        _calls.clear()
        _trace.clear()
        _counts.clear()
        ACTIVE = bool(rules)
    return len(rules)


def clear_plan() -> None:
    global ACTIVE, _spec
    with _lock:
        _rules.clear()
        _spec = None
        _calls.clear()
        _trace.clear()
        _counts.clear()
        ACTIVE = False


def current_plan() -> Optional[str]:
    with _lock:
        return _spec


def install_from_conf(conf) -> None:
    """Adopt a conf-carried plan (`sql.debug.faults.plan`). Idempotent
    by spec equality, so another session built over the same conf does
    not reset mid-query call counters."""
    try:
        from ..config import FAULTS_PLAN
        spec = conf.get(FAULTS_PLAN)
    except Exception:
        return
    if spec and spec != current_plan():
        install_plan(spec)


def hit(point: str, query_id: str = None, op: str = None,
        background: bool = False) -> None:
    """The fault point entry: count this call, match it against the
    installed rules, and perform the first matching rule's action.
    Call sites guard with `if faults.ACTIVE:` so this never runs while
    injection is disabled. `background=True` marks the compile pool's
    prewarm path (rules select it with bg=1)."""
    with _lock:
        _calls[point] = call = _calls.get(point, 0) + 1
        fired = None
        for r in _rules:
            if r.point != point:
                continue
            if r.times is not None and r._fired >= r.times:
                continue
            if r.query is not None and (query_id is None
                                        or r.query not in query_id):
                continue
            if r.op is not None and r.op != op:
                continue
            if r.bg is not None and r.bg != bool(background):
                continue
            if r.nth is not None:
                if call != r.nth:
                    continue
            elif r.prob is not None:
                if r._rng.random() >= r.prob:
                    continue
            r._fired += 1
            _counts["injected"] = _counts.get("injected", 0) + 1
            _counts[r.action] = _counts.get(r.action, 0) + 1
            _trace.append({"point": point, "call": call,
                           "action": r.action, "arg": r.arg})
            fired = r
            break
    if fired is None:
        return
    if fired.action == "delay":
        time.sleep(float(fired.arg) / 1000.0)
        return
    if fired.action == "kill":
        os._exit(1)
    _raise_named(fired.arg or "InjectedFault", point)


def _raise_named(name: str, point: str) -> None:
    if name == "FetchFailed":
        raise FetchFailed(f"injected fault at {point}")
    if name == "ExecutorLost":
        raise ExecutorLostError(f"injected fault at {point}")
    # the name leads the message HEAD so classifier routing works
    # (raise=RESOURCE_EXHAUSTED is seen as OOM by memory/retry.py)
    raise InjectedFault(f"{name}: injected fault at {point}", point=point)


def injection_trace() -> List[dict]:
    """Ordered record of every injection since install_plan() — the
    determinism witness (same plan + seed ⇒ identical trace)."""
    with _lock:
        return [dict(t) for t in _trace]


def injection_counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


# -- transient-error classification (service-level retry) ---------------

def is_transient_error(e: BaseException) -> bool:
    """True when a query failure is worth a transparent re-admission:
    injected faults, shuffle fetch failures, executor loss, connection
    resets. Conservative by contract: cancellation, deadline,
    KeyboardInterrupt and user or plan errors are never transient: a
    retry there would override an explicit decision or fail again the
    same way. The service-level retry that reads it comes with the
    query manager (ROADMAP A.15)."""
    if isinstance(e, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return False
    try:
        from ..service.query_manager import QueryCancelled
        if isinstance(e, QueryCancelled):   # QueryTimedOut subclasses it
            return False
    except ImportError:      # the port has no cancellation yet (A.15)
        pass
    if isinstance(e, (InjectedFault, FetchFailed, ExecutorLostError)):
        return True
    return isinstance(e, ConnectionError)


# -- recovery accounting -----------------------------------------------

_recovery_lock = threading.Lock()
_recovery: Dict[str, int] = {}


def note_recovery(kind: str, n: int = 1) -> None:
    """Count one recovery-path activation (`regenerations`,
    `query_retries`, `fetch_retries`, `rpc_retries`, `degradations`).
    Cheap and unconditional — recovery paths are rare by definition."""
    with _recovery_lock:
        _recovery[kind] = _recovery.get(kind, 0) + n


def recovery_stats() -> Dict[str, int]:
    with _recovery_lock:
        return dict(_recovery)


def reset_recovery_stats() -> None:
    with _recovery_lock:
        _recovery.clear()


# env activation: one SRTPU_FAULTS= covers the whole process
_env_spec = os.environ.get("SRTPU_FAULTS")
if _env_spec:
    install_plan(_env_spec)
del _env_spec
