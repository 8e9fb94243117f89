"""Launch and sync accounting: the counterpart of the JAX package's
`profiler/xla_stats.py` (the module keeps its name so a reader finds
it).

The JAX module counts XLA compiles and executable dispatches. An eager
PyTorch engine compiles no per-shape program, and the costs an action
can attribute on the card are its host waits for the device and the
launches of the repo's hand-written kernels. So `snapshot()` reads two
process-wide counts:

  host_syncs         `utils/transfer.py` `syncs`: every counted host
                     read of a device value (`fetch_ints`, `note_sync`:
                     a D2H copy, a `nonzero`)
  kernel_launches    `ops/partition_kernels.py` `launches`, with
                     `vector_launches` and `scalar_launches` per
                     variant: the CUDA partition kernel's launches (its
                     plain version on the CPU launches nothing)

The session diffs two snapshots around an action and adds the
differences to the root operator's metrics (`hostSyncs`,
`kernelLaunches`, `kernelLaunches.vector`, `kernelLaunches.scalar`, in
place of the JAX `xlaCompiles` / `xlaDispatches`); the event log's
`kernel_launches` record carries the same differences in place of the
JAX `xla_compile` record. The counts are plain ints that a measuring
script may set to 0 between actions; a difference that a reset made
negative reads as 0.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["snapshot", "delta"]


def snapshot() -> Dict[str, int]:
    """The current process-wide counts."""
    from ..ops import partition_kernels as pk
    from ..utils import transfer
    return {"host_syncs": transfer.syncs,
            "kernel_launches": pk.launches,
            "vector_launches": pk.vector_launches,
            "scalar_launches": pk.scalar_launches}


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """The counts since `before` (a `snapshot()`)."""
    now = snapshot()
    return {k: max(0, now[k] - before.get(k, 0)) for k in now}
