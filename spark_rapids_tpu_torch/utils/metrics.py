"""Operator metric levels and the `sql.metrics.sync` timer barrier, the
port of the JAX package's `utils/metrics.py` (reference:
GpuMetrics.scala:377 ESSENTIAL / MODERATE / DEBUG).

The port keeps an operator's metrics as a plain dict in its
`ExecContext` (`exec/base.py`), so the levels live in a table: a metric
takes `LEVELS[name]`, else MODERATE. The JAX package passes no level at
any call site, so every one of its metrics is MODERATE, and the table
starts empty. `sql.metrics.level` filters what `last_metrics()`, the
event log's `op_metrics` records and EXPLAIN ANALYZE show.

Timer caveat: CUDA launches are asynchronous, so by default an
operator's timer measures the host time to ENQUEUE its device work; the
execution lands on whichever later operator first waits (usually the
D2H copy at the plan root). Under `sql.metrics.sync` every timer ends
in `torch.cuda.synchronize(device)`, which waits for all the work
queued before it: per-operator execution times, at the cost of
pipelining. On the CPU the barrier does nothing (the work already ran).
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["ESSENTIAL", "MODERATE", "DEBUG", "LEVELS", "parse_level",
           "level_of", "stream_barrier", "snapshot"]

ESSENTIAL = 0
MODERATE = 1
DEBUG = 2

#: metric name -> level; a name not listed is MODERATE, as every JAX
#: metric is
LEVELS: Dict[str, int] = {}

_NAMES = {"ESSENTIAL": ESSENTIAL, "MODERATE": MODERATE, "DEBUG": DEBUG}


def parse_level(name) -> int:
    """The level of a `sql.metrics.level` value (MODERATE when unknown,
    as in the JAX `ExecContext`)."""
    return _NAMES.get(str(name).upper(), MODERATE)


def level_of(name: str) -> int:
    return LEVELS.get(name, MODERATE)


def stream_barrier(device) -> None:
    """Wait for every kernel queued on the device (the `sql.metrics.sync`
    gate); nothing on the CPU."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def snapshot(values: Dict[str, float], max_level: int = DEBUG) -> dict:
    """The metrics of one operator at or below `max_level`."""
    return {k: v for k, v in values.items() if level_of(k) <= max_level}
