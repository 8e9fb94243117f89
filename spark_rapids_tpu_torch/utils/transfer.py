"""Host reads of device scalars: the port's counted syncs.

The JAX package reads data-dependent sizes on the host through
`utils/transfer.fetch_int` (string chunk counts, hash-pass leftovers,
live group counts). Each such read waits for the device. The port reads
them here, and `syncs` counts them together with the other waits
(`note_sync`: each D2H copy of `exec/batch.py` `to_host`, each
`nonzero` of a compaction); it is a plain int that whoever measures sets
to 0, so a run can report its host syncs per batch. It is raised under a
lock: an async broadcast build syncs on its pool thread while the
consumer syncs on its own.
"""
from __future__ import annotations

import threading
from typing import Sequence, Tuple

import torch

__all__ = ["fetch_int", "fetch_ints", "note_sync", "syncs"]

#: host reads of device values since the count was last set to 0
syncs = 0
_LOCK = threading.Lock()


def fetch_ints(values: Sequence[torch.Tensor]) -> Tuple[int, ...]:
    """Python ints of 0-d integer tensors, read in one copy: one sync on
    a device (counted on the CPU too, where it costs nothing, so the
    count of a run does not depend on where it ran)."""
    if not values:
        return ()
    flat = torch.stack([v.reshape(()).to(torch.int64) for v in values])
    note_sync()
    return tuple(int(x) for x in flat.tolist())


def note_sync():
    """Count one host wait for the device made elsewhere (a D2H copy, a
    `nonzero`)."""
    global syncs
    with _LOCK:
        syncs += 1


def fetch_int(value: torch.Tensor) -> int:
    return fetch_ints([value])[0]
