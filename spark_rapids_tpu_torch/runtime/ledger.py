"""Runtime resource ledger: balanced acquire/release witness.

The port of the JAX package's `runtime/ledger.py`. It watches the
acquisitions the engine actually makes. Resources are typed by KIND:

  device_bytes   DeviceManager reservations
  host_bytes     HostMemoryManager reservations
  staging_lease  PinnedStagingPool leases (StagingBuffer)
  spill_handle   SpillStore handles (SpillableBatchHandle)
  permit         TpuSemaphore permits
  ride           PermitRider ride slots

(the JAX package's `shuffle_pin` and `cache_charge` come with the
block store and the result cache, ROADMAP A.15) and every instrumented
acquire / release site notes its kind here. Three mechanisms turn
lifetime bugs into assertions:

- per-query balance: acquisitions are attributed to the submitting
  query (the thread's `service/query_manager.py` `_query_scope`; the
  holder registry pins an acquisition's query so a release from a
  worker thread without the scope still credits the right ledger).
  When an action ends, in every state, the session asks the ledger to
  assert the query's owner-scoped kinds are balanced. Only kinds whose
  lifetime is bounded by the query are asserted (staging_lease,
  permit, ride); parkable kinds (spill handles held in reusable
  exchange state, raw byte reservations) are tracked and reported but
  not raised on: their balance is owned by plan teardown.
- poison mode: released cached staging buffers are filled with 0xAB
  before returning to the free list, so a use-after-release reads
  deterministic garbage instead of whatever the next lease wrote.
- attribution: `dump()` snapshots outstanding holders (kind,
  acquisition site tag, named thread, owning query) and is attached to
  budget-exhaustion errors next to the lockdep thread dump.

Enablement: env ``SRTPU_LEDGER=1`` (``SRTPU_LEDGER_RAISE=0`` records
without raising, ``SRTPU_LEDGER_POISON=1`` poisons) or conf
``spark.rapids.tpu.sql.debug.ledger.enabled`` at session construction.
Disabled, the note hooks are one None-check. Enabled, each note is a
dict bump under one short-lived mutex (never held while touching an
engine lock).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

__all__ = ["ResourceLeakError", "Ledger", "ledger", "enabled", "enable",
           "disable", "poison_enabled", "note_acquire", "note_release",
           "note_query_end", "attach_dump", "format_dump",
           "STRICT_KINDS", "POISON_BYTE"]

_ENV = "SRTPU_LEDGER"

#: kinds whose lifetime is bounded by the submitting query: asserted
#: balanced at every terminal state. Parkable kinds (spill handles in
#: reusable exchange state, byte reservations) are not.
STRICT_KINDS = frozenset({"staging_lease", "permit", "ride"})

#: released staging buffers are memset to this in poison mode
POISON_BYTE = 0xAB


class ResourceLeakError(RuntimeError):
    """A query reached a terminal state with owner-scoped resources
    still outstanding (or over-released)."""


def _qid() -> Optional[str]:
    """Current query id from the query scope, lazily bound."""
    global _QID_FN
    fn = _QID_FN
    if fn is None:
        try:
            from ..service.query_manager import current_query_id as fn
        except Exception:
            return None
        _QID_FN = fn
    return fn()


_QID_FN = None


class Ledger:
    """Process-global per-kind counters + holder registry + per-query
    balance ledgers."""

    def __init__(self, raise_on_finding: bool = True,
                 poison: bool = False):
        self.raise_on_finding = raise_on_finding
        self.poison = poison
        self._mu = threading.Lock()     # guards ledger state only;
        # NEVER held while touching an engine lock
        # kind -> counter dict
        self._kinds: Dict[str, dict] = {}
        # (kind, token) -> holder record; token is the held object's
        # id() (leases) or a stable key (a handle's id), letting
        # a release on a DIFFERENT thread than the acquire credit the
        # acquiring query
        self._holders: Dict[tuple, dict] = {}
        # qid -> kind -> [count, bytes]
        self._queries: Dict[str, Dict[str, list]] = {}
        self.findings: List[dict] = []
        self.balanced_queries = 0
        self.imbalanced_queries = 0

    def _kind(self, kind: str) -> dict:
        k = self._kinds.get(kind)
        if k is None:
            k = {"acquires": 0, "releases": 0, "outstanding": 0,
                 "outstandingBytes": 0, "peakOutstanding": 0,
                 "untrackedReleases": 0}
            self._kinds[kind] = k
        return k

    # -- note hooks ----------------------------------------------------
    def acquired(self, kind: str, nbytes: int = 0, token=None,
                 tag: Optional[str] = None):
        qid = _qid()
        tname = threading.current_thread().name
        with self._mu:
            k = self._kind(kind)
            k["acquires"] += 1
            k["outstanding"] += 1
            k["outstandingBytes"] += nbytes
            if k["outstanding"] > k["peakOutstanding"]:
                k["peakOutstanding"] = k["outstanding"]
            if token is not None:
                self._holders[(kind, token)] = {
                    "kind": kind, "tag": tag or kind, "thread": tname,
                    "query": qid, "nbytes": int(nbytes)}
            if qid is not None:
                c = self._queries.setdefault(qid, {}).setdefault(
                    kind, [0, 0])
                c[0] += 1
                c[1] += nbytes

    def released(self, kind: str, nbytes: int = 0, token=None):
        qid = _qid()
        with self._mu:
            k = self._kind(kind)
            if token is not None:
                rec = self._holders.pop((kind, token), None)
                if rec is None:
                    # idempotent close / acquired before enablement:
                    # count it but do not drive outstanding negative
                    k["untrackedReleases"] += 1
                    return
                qid = rec["query"]
                nbytes = rec["nbytes"]
            k["releases"] += 1
            k["outstanding"] -= 1
            k["outstandingBytes"] -= nbytes
            if qid is not None:
                c = self._queries.setdefault(qid, {}).setdefault(
                    kind, [0, 0])
                c[0] -= 1
                c[1] -= nbytes

    # -- per-query balance ---------------------------------------------
    def query_balance(self, qid: str) -> Dict[str, int]:
        """Outstanding count per kind attributed to `qid` (unbalanced
        kinds only)."""
        with self._mu:
            q = self._queries.get(qid) or {}
            return {kind: c[0] for kind, c in q.items() if c[0] != 0}

    def query_end(self, qid: str, state=None):
        """Drop the query's ledger; assert owner-scoped kinds balanced.
        Called when the session's action ends, in every state."""
        with self._mu:
            q = self._queries.pop(qid, None)
            bad = {}
            if q:
                for kind in STRICT_KINDS:
                    c = q.get(kind)
                    if c is not None and c[0] != 0:
                        bad[kind] = c[0]
            holders = [dict(r) for r in self._holders.values()
                       if r["query"] == qid] if bad else []
        if not bad:
            self.balanced_queries += 1
            return
        self.imbalanced_queries += 1
        finding = {"kind": "query-imbalance", "query": qid,
                   "state": str(state), "counts": bad,
                   "holders": holders}
        self.findings.append(finding)
        if self.raise_on_finding:
            parts = ", ".join(f"{k}={n:+d}" for k, n in sorted(bad.items()))
            who = "; ".join(
                f"{h['tag']} on {h['thread']}" for h in holders[:6])
            raise ResourceLeakError(
                f"query {qid} reached {state} with unbalanced "
                f"resources: {parts}"
                + (f" (outstanding: {who})" if who else ""))

    # -- reporting -----------------------------------------------------
    def outstanding(self, kind: str) -> int:
        with self._mu:
            k = self._kinds.get(kind)
            return k["outstanding"] if k else 0

    def dump(self) -> dict:
        """Attributed outstanding-holders snapshot: what a budget
        exhaustion attaches next to the lockdep thread dump."""
        with self._mu:
            kinds = {k: dict(v) for k, v in self._kinds.items()}
            holders = [dict(r) for r in self._holders.values()]
        holders.sort(key=lambda r: (r["kind"], r["thread"], r["tag"]))
        return {"kinds": kinds, "holders": holders,
                "findings": list(self.findings)}

    def report(self) -> dict:
        """Summary counters for the resource_ledger event."""
        with self._mu:
            kinds = {
                k: {"acquires": v["acquires"], "releases": v["releases"],
                    "outstanding": v["outstanding"],
                    "peakOutstanding": v["peakOutstanding"]}
                for k, v in sorted(self._kinds.items())}
            strict_out = sum(
                v["outstanding"] for k, v in self._kinds.items()
                if k in STRICT_KINDS)
        return {"enabled": True, "kinds": kinds,
                "balanceOk": not self.findings and strict_out == 0,
                "balancedQueries": self.balanced_queries,
                "imbalancedQueries": self.imbalanced_queries,
                "findings": len(self.findings)}


# ---------------------------------------------------------------------
# process-global enablement
# ---------------------------------------------------------------------
_LEDGER: Optional[Ledger] = None


def enabled() -> bool:
    return _LEDGER is not None


def ledger() -> Optional[Ledger]:
    return _LEDGER


def poison_enabled() -> bool:
    lg = _LEDGER
    return lg is not None and lg.poison


def enable(raise_on_finding: bool = True, poison: bool = False) -> Ledger:
    """Idempotent; acquisitions made BEFORE this are not tracked (their
    later releases land in untrackedReleases), so enable before the
    engine runs queries (conftest/env) for exact balance."""
    global _LEDGER
    if _LEDGER is None:
        _LEDGER = Ledger(raise_on_finding=raise_on_finding,
                         poison=poison)
    elif poison:
        _LEDGER.poison = True
    return _LEDGER


def disable():
    global _LEDGER
    _LEDGER = None


def maybe_enable_from_conf(conf):
    """Session-construction hook for sql.debug.ledger.* confs."""
    from ..config import LEDGER_ENABLED, LEDGER_POISON, LEDGER_RAISE
    if conf.get(LEDGER_ENABLED):
        enable(raise_on_finding=bool(conf.get(LEDGER_RAISE)),
               poison=bool(conf.get(LEDGER_POISON)))
    elif _LEDGER is not None and conf.get(LEDGER_POISON):
        _LEDGER.poison = True


# ---------------------------------------------------------------------
# note hooks: one None-check when the ledger is off
# ---------------------------------------------------------------------
def note_acquire(kind: str, nbytes: int = 0, token=None,
                 tag: Optional[str] = None):
    lg = _LEDGER
    if lg is not None:
        lg.acquired(kind, nbytes, token, tag)


def note_release(kind: str, nbytes: int = 0, token=None):
    lg = _LEDGER
    if lg is not None:
        lg.released(kind, nbytes, token)


def note_query_end(qid: str, state=None):
    lg = _LEDGER
    if lg is not None:
        lg.query_end(qid, state)


# ---------------------------------------------------------------------
# dump formatting / exception attachment
# ---------------------------------------------------------------------
def format_dump(dump: dict, limit: int = 12) -> str:
    """Human-readable outstanding-resources table for exception text."""
    rows = []
    for kind, k in sorted(dump.get("kinds", {}).items()):
        if k.get("outstanding"):
            rows.append(f"  {kind}: outstanding={k['outstanding']} "
                        f"bytes={k['outstandingBytes']} "
                        f"peak={k['peakOutstanding']}")
    shown = 0
    for h in dump.get("holders", ()):
        if shown >= limit:
            rows.append(f"  ... {len(dump['holders']) - limit} "
                        f"more holders")
            break
        rows.append(f"  {h['kind']}: {h['tag']} thread={h['thread']} "
                    f"query={h['query'] or '-'} nbytes={h['nbytes']}")
        shown += 1
    return "\n".join(rows)


def attach_dump(exc: BaseException) -> Optional[dict]:
    """On a kill or budget exhaustion: hang the ledger dump off the
    exception (read by the event log) and fold the outstanding table
    into its message, next to lockdep's thread table. Returns the dump, or None
    when the ledger is off or the exception already carries one."""
    lg = _LEDGER
    if lg is None or getattr(exc, "ledger_dump", None) is not None:
        return None
    d = lg.dump()
    exc.ledger_dump = d
    try:
        text = format_dump(d)
        if text and exc.args and isinstance(exc.args[0], str):
            exc.args = (exc.args[0] + "\nresource ledger:\n" + text,
                        ) + exc.args[1:]
    except Exception:
        pass  # attribution must never mask the kill itself
    return d


# env-gated enablement at import (conftest sets the env before the
# engine runs its first query)
if os.environ.get(_ENV, "").strip().lower() in ("1", "true", "yes", "on"):
    enable(
        raise_on_finding=os.environ.get(
            _ENV + "_RAISE", "1").strip().lower()
        in ("1", "true", "yes", "on"),
        poison=os.environ.get(
            _ENV + "_POISON", "").strip().lower()
        in ("1", "true", "yes", "on"))
