"""Bounded exponential backoff with deterministic jitter.

One helper shared by every retry path (block fetches, driver RPC task
resends, the service-level query retry): attempt k waits
`min(base * 2^k, max) * U[0.5, 1.0)` where U comes from a seeded PRNG —
two reducers retrying the same dead mapper de-synchronize, yet a seeded
run reproduces the exact same waits (the fault-injection determinism
contract extends to the recovery timings)."""
from __future__ import annotations

from random import Random
from typing import List, Optional

__all__ = ["backoff_delays"]


def backoff_delays(attempts: int, base_ms: float,
                   max_ms: float = 10_000.0,
                   seed: Optional[int] = None) -> List[float]:
    """Return `attempts` sleep durations in SECONDS, exponentially
    grown from base_ms and capped at max_ms, each jittered into
    [50%, 100%) of its cap by a PRNG seeded with `seed`."""
    rng = Random(seed)
    out = []
    for k in range(max(attempts, 0)):
        exp = min(float(base_ms) * (2.0 ** k), float(max_ms))
        out.append(exp * (0.5 + rng.random() * 0.5) / 1000.0)
    return out
