"""Tracing and profiling hooks, the port of the JAX package's
`utils/trace.py` (reference: NvtxWithMetrics.scala,
docs/dev/nvtx_profiling.md, profiler.scala).

`range_annotation` opens an NVTX range (`torch.cuda.nvtx`) around a
block, so it shows by name on a CUDA profiler's timeline; without CUDA
it does nothing. `start_profile` / `stop_profile` capture a
`torch.profiler` trace of the CPU and, when present, the CUDA activity
in between, exported as a Chrome trace (`trace.json`) under the
directory given.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

import torch

__all__ = ["range_annotation", "start_profile", "stop_profile"]


@contextmanager
def range_annotation(name: str):
    """An NVTX range; nests, shows in profiler timelines."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


_active = {"dir": None, "prof": None}


def start_profile(out_dir: str) -> str:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _active["dir"], _active["prof"] = out_dir, prof
    return out_dir


def stop_profile() -> Optional[str]:
    """End the capture and write `trace.json` under its directory;
    returns the directory (None when no capture was running)."""
    if _active["dir"] is None:
        return None
    d, prof = _active["dir"], _active["prof"]
    _active["dir"] = _active["prof"] = None
    prof.__exit__(None, None, None)
    os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(os.path.join(d, "trace.json"))
    return d
