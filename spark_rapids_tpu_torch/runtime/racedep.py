"""Runtime data-race witness: Eraser locksets on live shared state.

The port of the JAX package's `runtime/racedep.py`. It watches the
accesses the engine actually performs. Modeled on Eraser: each
instrumented shared structure keeps per-(structure, key) state that
starts *exclusive* to its first thread, turns *shared* when a second
thread arrives, and from then on refines a candidate lockset, the
intersection of the locks held at every access. A write to shared
state whose candidate lockset has collapsed to empty is a witnessed
race: two threads reached the same slot with no common lock, and only
scheduling ordered them.

Instrumented structures (each a `note_access` call at the access site,
one None-check when the witness is off):

- the live telemetry registry (profiler/telemetry.py)
- the operator metric store (exec/base.py `ExecContext`, the JAX
  package's `MetricSet._values`)

The JAX package's program-cache table, result-cache LRU and shuffle
map-file slots come with their modules (ROADMAP A.11, A.15).

Lockset tracking rides the lockdep factories: every lock created
through `lockdep.lock()` / `rlock()` reports acquire and release into
this module's thread-local held set (`note_lock` / `note_unlock`), so a
lockdep-wrapped lock is visible to both witnesses. Each access records
(thread, lockset); the last few per slot are kept for the finding's
message.

Schedule perturbation: `perturb(seed)` arms a seeded adversarial mode:
`sys.setswitchinterval` drops to microseconds and instrumented access
points inject `time.sleep(0)` yields chosen by a seeded RNG, so
interleavings that would need long wall clock to occur by chance happen
in one pass.

Enablement: env ``SRTPU_RACEDEP=1`` before the engine imports
(``SRTPU_RACEDEP_RAISE=0`` records without raising), or conf
``spark.rapids.tpu.sql.debug.racedep.enabled`` at session construction
(``...racedep.raiseOnRace`` picks raise or record). Disabled, every
hook is one None-check. Enabled, the access fast path is a dict probe
plus a set intersection under one mutex, on structures touched per
batch, not per row.
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["DataRaceDetected", "Witness", "witness", "enabled",
           "enable", "disable", "note_access", "note_lock",
           "note_unlock", "perturb", "restore", "maybe_enable_from_conf"]

_ENV = "SRTPU_RACEDEP"

#: per-(structure, key) states tracked before new keys fold into "*"
_VARS_CAP = 4096
#: (thread, lockset, op) samples kept per slot for finding messages
_HISTORY = 4


class DataRaceDetected(RuntimeError):
    """A write reached shared state with a collapsed lockset."""


class _VarState:
    """Eraser state machine for one (structure, key) slot."""

    __slots__ = ("owner", "shared", "modified", "lockset", "reported",
                 "history")

    def __init__(self, owner: str):
        self.owner = owner            # first thread: exclusive phase
        self.shared = False
        self.modified = False
        self.lockset: Optional[set] = None   # candidate; None = virgin
        self.reported = False
        self.history: List[tuple] = []


class Witness:
    """Process-global Eraser table + per-thread held locksets."""

    def __init__(self, raise_on_race: bool = True):
        self.raise_on_race = raise_on_race
        self._mu = threading.Lock()   # guards the var table only; never
        # held while touching an engine lock (same discipline as lockdep)
        self._vars: Dict[tuple, _VarState] = {}
        self._tls = threading.local()
        self.findings: List[dict] = []
        self.accesses = 0
        # perturbation state
        self._rng: Optional[random.Random] = None
        self._yield_prob = 0.0
        self._orig_interval: Optional[float] = None

    # -- lockset tracking ----------------------------------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    def lock_acquired(self, key: str):
        self._held().append(key)

    def lock_released(self, key: str):
        held = getattr(self._tls, "held", None)
        if not held:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i] == key:
                del held[i]
                return

    def held_keys(self) -> List[str]:
        return list(getattr(self._tls, "held", None) or ())

    # -- access recording ----------------------------------------------
    def access(self, structure: str, key: str = "", write: bool = False):
        """Record one access to (structure, key) by the current thread
        with its current lockset; raise on lockset collapse."""
        self._maybe_yield()
        tname = threading.current_thread().name
        held = frozenset(self._held())
        finding = None
        with self._mu:
            self.accesses += 1
            vk = (structure, key)
            st = self._vars.get(vk)
            if st is None:
                if len(self._vars) >= _VARS_CAP:
                    vk = (structure, "*")
                    st = self._vars.get(vk)
                if st is None:
                    st = self._vars[vk] = _VarState(tname)
            if len(st.history) >= _HISTORY:
                del st.history[0]
            st.history.append((tname, sorted(held),
                               "w" if write else "r"))
            if tname == st.owner and not st.shared:
                # exclusive phase: init writes before hand-off are fine
                st.modified = st.modified or write
            else:
                if not st.shared:
                    # second thread: sharing starts, lockset candidate
                    # initializes to THIS access's held set
                    st.shared = True
                    st.lockset = set(held)
                else:
                    st.lockset &= held
                st.modified = st.modified or write
                if st.modified and not st.lockset and not st.reported:
                    st.reported = True
                    finding = {
                        "kind": "lockset-collapse",
                        "structure": structure,
                        "key": str(key),
                        "thread": tname,
                        "write": write,
                        "history": list(st.history),
                    }
                    self.findings.append(finding)
        if finding is not None and self.raise_on_race:
            hist = "; ".join(
                f"{t}[{','.join(ls) or '-'}]{op}"
                for t, ls, op in finding["history"])
            raise DataRaceDetected(
                f"lockset collapse on {structure}[{finding['key']}]: "
                f"{'write' if write else 'read'} from thread {tname} "
                f"leaves no common lock across sharing threads "
                f"(recent accesses: {hist})")

    # -- schedule perturbation -----------------------------------------
    def perturb(self, seed: int, yield_prob: float = 0.05,
                switch_interval: float = 1e-5):
        """Arm seeded adversarial scheduling: tiny bytecode switch
        interval plus RNG-chosen yields at instrumented accesses."""
        self._rng = random.Random(seed)
        self._yield_prob = float(yield_prob)
        if self._orig_interval is None:
            self._orig_interval = sys.getswitchinterval()
        sys.setswitchinterval(switch_interval)

    def restore(self):
        self._rng = None
        self._yield_prob = 0.0
        if self._orig_interval is not None:
            sys.setswitchinterval(self._orig_interval)
            self._orig_interval = None

    def _maybe_yield(self):
        rng = self._rng
        if rng is None:
            return
        with self._mu:
            hit = rng.random() < self._yield_prob
        if hit:
            time.sleep(0)

    # -- reporting -----------------------------------------------------
    def report(self) -> dict:
        """Summary counters for the race_report event."""
        with self._mu:
            shared = sum(1 for s in self._vars.values() if s.shared)
            return {"enabled": True, "tracked": len(self._vars),
                    "shared": shared, "accesses": self.accesses,
                    "findings": len(self.findings),
                    "perturbed": self._rng is not None}


# ---------------------------------------------------------------------
# process-global enablement
# ---------------------------------------------------------------------
_WITNESS: Optional[Witness] = None


def enabled() -> bool:
    return _WITNESS is not None


def witness() -> Optional[Witness]:
    return _WITNESS


def enable(raise_on_race: bool = True) -> Witness:
    """Idempotent; locks created BEFORE this are not lockset-visible,
    so enable before importing the engine (conftest/env) for full
    coverage."""
    global _WITNESS
    if _WITNESS is None:
        _WITNESS = Witness(raise_on_race=raise_on_race)
    return _WITNESS


def disable():
    global _WITNESS
    _WITNESS = None


def maybe_enable_from_conf(conf):
    """Session-construction hook for sql.debug.racedep.* confs."""
    from ..config import RACEDEP_ENABLED, RACEDEP_RAISE
    if conf.get(RACEDEP_ENABLED):
        enable(raise_on_race=bool(conf.get(RACEDEP_RAISE)))


# ---------------------------------------------------------------------
# note hooks: one None-check when the witness is off
# ---------------------------------------------------------------------
def note_access(structure: str, key: str = "", write: bool = False):
    w = _WITNESS
    if w is not None:
        w.access(structure, key, write)


def note_lock(key: str):
    w = _WITNESS
    if w is not None:
        w.lock_acquired(key)


def note_unlock(key: str):
    w = _WITNESS
    if w is not None:
        w.lock_released(key)


def perturb(seed: int, yield_prob: float = 0.05,
            switch_interval: float = 1e-5):
    w = _WITNESS
    if w is not None:
        w.perturb(seed, yield_prob, switch_interval)


def restore():
    w = _WITNESS
    if w is not None:
        w.restore()


# env-gated enablement at import: sees every lock created after this
# module loads (conftest sets the env before importing the engine)
if os.environ.get(_ENV, "").strip().lower() in ("1", "true", "yes", "on"):
    enable(raise_on_race=os.environ.get(
        _ENV + "_RAISE", "1").strip().lower() in ("1", "true", "yes",
                                                  "on"))
