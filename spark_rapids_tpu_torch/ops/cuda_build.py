"""Build and load the port's CUDA kernels.

Each kernel is one source `csrc/<name>.cu` with plain `extern "C"`
launchers. At first use it is compiled by `nvcc` for Hopper (`sm_90a`)
into a shared library under the package's `build/` directory, named by a
hash of the source and the flags, and loaded with ctypes. Building needs the
CUDA toolkit; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["NVCC_FLAGS", "CSRC", "BUILD", "library_path", "build", "load",
           "sass"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# loaded libraries, by kernel name: a shared library loads once per
# process
_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", name),
                 shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: it comes with the CUDA toolkit "
                       f"(set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{key[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns, per name, the seconds the
    build took (0 when it was already built) and nvcc's output (its
    `-Xptxas -v` register and spill report, kept beside the library).
    Raises on a failed build."""
    started = {}
    out: Dict[str, dict] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            kept = lib.with_suffix(".log")
            out[name] = {"seconds": 0.0, "path": str(lib),
                         "log": kept.read_text() if kept.exists() else ""}
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in started.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)   # atomic: a reader never sees half a file
        out[name] = {"seconds": secs, "log": log, "path": str(lib)}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOAD_LOCK:   # an async broadcast build may be the first caller
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
    return lib


def sass(name: str) -> str:
    """The SASS of kernel `name`'s built library, as `cuobjdump -sass`
    prints it (builds it first if needed)."""
    build([name])
    r = subprocess.run([_tool("cuobjdump"), "-sass",
                        str(library_path(name))],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {name}: {r.stderr}")
    return r.stdout
