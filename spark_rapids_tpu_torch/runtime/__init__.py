"""Process-global runtime services shared by every exec instance: the
runtime witnesses and fault injection, the port of the JAX package's
`runtime/` (its program cache, compile pool, warm pack and result
cache wait for ROADMAP A.11 and A.15).

- `lockdep.py`: the lock-order witness (class-keyed order graph, pool
  self-waits, thread dumps);
- `ledger.py`: the resource ledger (balanced acquire / release per
  query, the poison fill);
- `racedep.py`: the Eraser lockset data-race witness;
- `faults.py`: the seeded fault-injection plan and the recovery
  counters;
- `backoff.py`: bounded exponential backoff with seeded jitter.

Each witness turns on from its env variable before the engine imports
(`SRTPU_LOCKDEP`, `SRTPU_LEDGER`, `SRTPU_RACEDEP`, `SRTPU_FAULTS`) or
from the `sql.debug.*` conf keys at session construction.
"""
from . import lockdep  # noqa: F401
from . import racedep  # noqa: F401

__all__ = ["lockdep", "racedep"]
