"""Runtime lockdep witness: observe real lock orderings, catch cycles.

The port of the JAX package's `runtime/lockdep.py`. It watches the
orderings the engine actually takes. Modeled on the Linux kernel's
lockdep: resources are keyed by CLASS (``ShuffleExchangeExec._lock``,
``TpuSemaphore.permit``), not instance, so one observed ordering
validates every instance pair. Each thread keeps a held stack;
acquiring B while holding A inserts the order edge A -> B into a
process-global graph, and an insertion that closes a cycle is reported
(and raised) at formation time, long before the interleaving that would
actually deadlock.

Three deadlock classes are covered:

- lock-order cycles: edge insertion runs a reachability check; a
  B ->* A path plus the new A -> B edge is a cycle. Same-class edges
  (chained exchanges nesting `ShuffleExchangeExec._lock` inside itself
  through child materialization) are benign nesting and skipped, which
  also means a true same-class ABBA between two instances is not
  witnessed.
- pool self-wait: `check_pool_wait(prefix)` guards a Future.result on
  a bounded pool; called from a worker of that same pool it reports
  the wait cycle instead of letting the bounded pool park every worker
  behind itself.
- attribution: `dump()` snapshots every live thread with its held
  resources and current frame; budget exhaustion attaches it
  (`attach_dump`) beside the resource ledger's holders.

Enablement: env ``SRTPU_LOCKDEP=1`` before the engine imports (locks
are wrapped at creation; ``SRTPU_LOCKDEP_RAISE=0`` records without
raising), or conf ``spark.rapids.tpu.sql.debug.lockdep.enabled`` at
session construction, which wraps only the locks made after it.
Disabled, `lock()` / `rlock()` return plain threading primitives and
the note hooks are one None-check. Enabled, the acquire fast path is a
thread-local list append plus one set-membership probe; the graph mutex
is only taken for never-seen edges.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional

from . import racedep

__all__ = ["LockOrderViolation", "PoolSelfWait", "Witness", "witness",
           "enabled", "enable", "disable", "lock", "rlock",
           "note_acquired", "note_released", "check_pool_wait",
           "attach_dump", "format_dump"]

_ENV = "SRTPU_LOCKDEP"


class LockOrderViolation(RuntimeError):
    """A lock acquisition closed a cycle in the global order graph."""


class PoolSelfWait(RuntimeError):
    """A bounded pool worker blocked on a future of its own pool."""


class Witness:
    """Process-global acquisition-order graph + per-thread held stacks."""

    def __init__(self, raise_on_finding: bool = True):
        self.raise_on_finding = raise_on_finding
        self._mu = threading.Lock()     # guards graph mutation only;
        # NEVER held while touching an engine lock (the witness must
        # not itself create orderings)
        self._succ: Dict[str, set] = {}
        self._edges: set = set()        # {(a, b)} fast membership probe
        self._tls = threading.local()
        # ident -> (thread name, held list) — live view for dump();
        # entries are the same list objects the TLS mutates
        self._held_by: Dict[int, tuple] = {}
        self.findings: List[dict] = []
        self.acquires = 0
        self.max_edges = 0

    # -- held tracking ------------------------------------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
            t = threading.current_thread()
            self._held_by[t.ident] = (t.name, held)
        return held

    def acquired(self, key: str):
        """Record that the current thread now holds `key`."""
        held = self._held()
        self.acquires += 1
        if held and key not in held:
            for h in held:
                if (h, key) not in self._edges:
                    self._add_edge(h, key)
        held.append(key)

    def released(self, key: str):
        held = getattr(self._tls, "held", None)
        if not held:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i] == key:
                del held[i]
                return

    def held_keys(self) -> List[str]:
        return list(getattr(self._tls, "held", None) or ())

    # -- order graph --------------------------------------------------
    def _add_edge(self, a: str, b: str):
        if a == b:
            return  # benign same-class nesting (chained exchanges)
        cycle = None
        with self._mu:
            if (a, b) in self._edges:
                return
            cycle = self._find_path(b, a)
            self._edges.add((a, b))
            self._succ.setdefault(a, set()).add(b)
            if len(self._edges) > self.max_edges:
                self.max_edges = len(self._edges)
        if cycle is not None:
            finding = {
                "kind": "lock-order-cycle",
                "edge": [a, b],
                "cycle": cycle + [b],
                "thread": threading.current_thread().name,
            }
            self.findings.append(finding)
            if self.raise_on_finding:
                raise LockOrderViolation(
                    f"lock-order cycle formed by {a} -> {b} on thread "
                    f"{finding['thread']}: existing order "
                    f"{' -> '.join(cycle + [b])}")

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src ->* dst in the order graph (caller holds _mu)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._succ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- pool self-wait ------------------------------------------------
    def check_pool_wait(self, pool_prefix: str):
        """Guard a blocking Future.result on the bounded pool whose
        workers are named `pool_prefix*`: waiting from one of its own
        workers is a wait cycle."""
        name = threading.current_thread().name
        if name.startswith(pool_prefix):
            finding = {"kind": "pool-self-wait", "pool": pool_prefix,
                       "thread": name, "held": self.held_keys()}
            self.findings.append(finding)
            if self.raise_on_finding:
                raise PoolSelfWait(
                    f"thread {name} blocking on a future of its own "
                    f"bounded pool '{pool_prefix}' — wait cycle (every "
                    f"worker can park behind itself)")

    # -- reporting -----------------------------------------------------
    def dump(self) -> dict:
        """Attributed all-threads snapshot: name, held resources,
        current frame."""
        frames = sys._current_frames()
        threads = []
        for t in threading.enumerate():
            _, held = self._held_by.get(t.ident, (t.name, ()))
            fr = frames.get(t.ident)
            at = "?"
            if fr is not None:
                at = (f"{os.path.basename(fr.f_code.co_filename)}:"
                      f"{fr.f_lineno} in {fr.f_code.co_name}")
            threads.append({"thread": t.name, "daemon": t.daemon,
                            "held": list(held), "at": at})
        threads.sort(key=lambda r: (not r["held"], r["thread"]))
        return {"threads": threads, "findings": list(self.findings),
                "edges": len(self._edges)}

    def report(self) -> dict:
        """Summary counters for the concurrency_report event."""
        nodes = set()
        for a, b in self._edges:
            nodes.add(a)
            nodes.add(b)
        return {"enabled": True, "resources": len(nodes),
                "orderEdges": len(self._edges),
                "maxOrderGraph": self.max_edges,
                "acquires": self.acquires,
                "findings": len(self.findings)}


# ---------------------------------------------------------------------
# process-global enablement
# ---------------------------------------------------------------------
_WITNESS: Optional[Witness] = None


def enabled() -> bool:
    return _WITNESS is not None


def witness() -> Optional[Witness]:
    return _WITNESS


def enable(raise_on_finding: bool = True) -> Witness:
    """Idempotent; locks created BEFORE this are not instrumented, so
    enable before importing the engine (conftest/env) for full
    coverage."""
    global _WITNESS
    if _WITNESS is None:
        _WITNESS = Witness(raise_on_finding=raise_on_finding)
    return _WITNESS


def disable():
    global _WITNESS
    _WITNESS = None


def maybe_enable_from_conf(conf):
    """Session-construction hook for sql.debug.lockdep.* confs."""
    from ..config import LOCKDEP_ENABLED, LOCKDEP_RAISE
    if conf.get(LOCKDEP_ENABLED):
        enable(raise_on_finding=bool(conf.get(LOCKDEP_RAISE)))


# ---------------------------------------------------------------------
# note hooks (semaphore permits, pool ride slots): one None-check when
# the witness is off
# ---------------------------------------------------------------------
def note_acquired(key: str):
    w = _WITNESS
    if w is not None:
        w.acquired(key)


def note_released(key: str):
    w = _WITNESS
    if w is not None:
        w.released(key)


def check_pool_wait(pool_prefix: str):
    w = _WITNESS
    if w is not None:
        w.check_pool_wait(pool_prefix)


# ---------------------------------------------------------------------
# instrumented lock factories
# ---------------------------------------------------------------------
class _WitnessLock:
    """Wraps a threading lock; usable as a Condition base (the stdlib
    Condition falls back to plain acquire/release when the lock exposes
    no _release_save, which keeps held-tracking correct across
    cond.wait: the wait releases through us, so the resource is NOT
    reported held while parked)."""

    __slots__ = ("_inner", "name")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            w = _WITNESS
            if w is not None:
                w.acquired(self.name)
            racedep.note_lock(self.name)
        return ok

    def release(self):
        w = _WITNESS
        if w is not None:
            w.released(self.name)
        racedep.note_unlock(self.name)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<WitnessLock {self.name} {self._inner!r}>"


def _wrapping() -> bool:
    """Wrap freshly created locks when EITHER witness is live: lockdep
    needs orderings, racedep (runtime/racedep.py) needs per-thread
    locksets — both ride the same acquire/release notes."""
    return _WITNESS is not None or racedep.enabled()


def lock(name: str):
    """A threading.Lock, witness-wrapped when lockdep or racedep is
    enabled."""
    inner = threading.Lock()
    return _WitnessLock(name, inner) if _wrapping() else inner


def rlock(name: str):
    """A threading.RLock, witness-wrapped when lockdep or racedep is
    enabled. Recursive re-entry appends the key again (no self edges),
    so the paired releases unwind correctly."""
    inner = threading.RLock()
    return _WitnessLock(name, inner) if _wrapping() else inner


# ---------------------------------------------------------------------
# dump formatting / exception attachment
# ---------------------------------------------------------------------
def format_dump(dump: dict, limit: int = 12) -> str:
    """Human-readable held-resource table for exception messages."""
    rows = []
    for r in dump.get("threads", ())[:limit]:
        held = ",".join(r["held"]) if r["held"] else "-"
        rows.append(f"  {r['thread']}: held=[{held}] at {r['at']}")
    extra = len(dump.get("threads", ())) - limit
    if extra > 0:
        rows.append(f"  ... {extra} more threads")
    return "\n".join(rows)


def attach_dump(exc: BaseException) -> Optional[dict]:
    """On a kill or budget exhaustion: hang the witness dump off the
    exception (read by the event log) and fold the held-resource table
    into its message. Returns the dump, or None when the witness is off or the
    exception already carries one."""
    w = _WITNESS
    if w is None or getattr(exc, "lockdep_dump", None) is not None:
        return None
    d = w.dump()
    exc.lockdep_dump = d
    try:
        text = format_dump(d)
        if text and exc.args and isinstance(exc.args[0], str):
            exc.args = (exc.args[0] + "\nlockdep threads:\n" + text,
                        ) + exc.args[1:]
    except Exception:
        pass  # attribution must never mask the kill itself
    return d


# env-gated enablement at import: wraps every lock created after this
# module loads (conftest sets the env before importing the engine)
if os.environ.get(_ENV, "").strip().lower() in ("1", "true", "yes", "on"):
    enable(raise_on_finding=os.environ.get(
        _ENV + "_RAISE", "1").strip().lower() in ("1", "true", "yes", "on"))
