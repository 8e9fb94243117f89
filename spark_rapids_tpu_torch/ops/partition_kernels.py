"""Hash-partition ids of one int32/date key: the Hopper kernels and their
plain version.

`partition_ids_i32` replaces the JAX package's TPU kernel
`ops/pallas_kernels.py` `pallas_partition_ids_i32`: Spark
HashPartitioning, `pmod(murmur3_x86_32(key, seed 42), n)`, with a null key
hashing to 42. On a CUDA tensor it launches one of the two kernels of
`csrc/partition_ids.cu` (built at first use, see `cuda_build.py`) on the
current stream, without synchronizing: the vector kernel when the
pointers allow its 16 B loads (`variant`), else the scalar kernel; both
divide by the constant `pmod_magic(n)` computed here. On a CPU tensor it
runs `partition_ids_i32_ref`. Any other device raises: there is no
fallback.

What bounds the kernels on an H100, and what their design does about it,
is noted at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .hash import hash_int32, pmod_signed

__all__ = ["partition_ids_i32", "partition_ids_i32_ref", "pmod_magic",
           "pmod_fastmod", "variant", "launches", "vector_launches",
           "scalar_launches", "SOURCE"]

SOURCE = "spark_rapids_tpu_torch/csrc/partition_ids.cu"
_NAME = "partition_ids"
_MAX_PARTITIONS = 2**31 - 1
_U64 = 2**64

#: kernel launches since the counts were last set to 0 (plain ints): in
#: all, and of each variant
launches = 0
vector_launches = 0
scalar_launches = 0
#: the counts are raised under a lock: an async broadcast build can
#: exchange on its pool thread while the consumer exchanges on its own
_COUNT_LOCK = threading.Lock()

# ctypes launcher per variant, bound at first use
_LAUNCHERS: dict = {}


def partition_ids_i32_ref(vals: torch.Tensor, validity: torch.Tensor,
                          num_partitions: int) -> torch.Tensor:
    """The kernel's function in plain torch: int32 ids in [0, n)."""
    seed = torch.full_like(vals, 42, dtype=torch.int64)
    h = torch.where(validity, hash_int32(vals, seed), seed)
    return pmod_signed(h, num_partitions)


def pmod_magic(num_partitions: int) -> int:
    """The kernels' division constant for n: floor((2^64 - 1) / n) + 1,
    mod 2^64 (Lemire's fastmod)."""
    return ((_U64 - 1) // num_partitions + 1) % _U64


def pmod_fastmod(h: np.ndarray, num_partitions: int) -> np.ndarray:
    """pmod(h, n) of int32 hashes as the kernels compute it, step for step
    in numpy uint64 (which wraps mod 2^64 as the card does): |h| mod n =
    mulhi64(magic * |h|, n), the high word taken in 32-bit halves since
    n < 2^32, then n - r for a negative h with r != 0. For checking the
    kernels' arithmetic off the card."""
    h = np.asarray(h, np.int32)
    n = np.uint64(num_partitions)
    a = np.abs(h.astype(np.int64)).astype(np.uint64)
    low = np.uint64(pmod_magic(num_partitions)) * a
    part = (low & np.uint64(0xFFFFFFFF)) * n
    r = (((low >> np.uint64(32)) * n + (part >> np.uint64(32)))
         >> np.uint64(32)).astype(np.int64)
    return np.where((h < 0) & (r != 0), num_partitions - r, r) \
        .astype(np.int32)


def variant(keys_ptr: int, valid_ptr: int, out_ptr: int) -> str:
    """Which kernel takes buffers at these addresses: "vector" when its
    16 B key and id accesses and 4 B validity words are aligned, else
    "scalar"."""
    if keys_ptr % 16 == 0 and out_ptr % 16 == 0 and valid_ptr % 4 == 0:
        return "vector"
    return "scalar"


def _check(vals, validity, num_partitions):
    if vals.dtype is not torch.int32 or validity.dtype is not torch.bool:
        raise TypeError(f"partition_ids_i32 takes int32 keys and bool "
                        f"validity, got {vals.dtype} and {validity.dtype}")
    if vals.dim() != 1 or validity.shape != vals.shape:
        raise ValueError(f"keys {tuple(vals.shape)} and validity "
                         f"{tuple(validity.shape)} must be one 1-D length")
    if (vals.is_cuda != validity.is_cuda
            or vals.get_device() != validity.get_device()):
        raise ValueError("keys and validity lie on different devices")
    if not 1 <= num_partitions <= _MAX_PARTITIONS:
        raise ValueError(f"num_partitions must be in [1, 2^31-1], got "
                         f"{num_partitions}")


def _launcher(kind: str):
    fn = _LAUNCHERS.get(kind)
    if fn is None:
        from .cuda_build import load
        fn = getattr(load(_NAME), f"partition_ids_i32_{kind}_launch")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[kind] = fn
    return fn


def partition_ids_i32(vals: torch.Tensor, validity: torch.Tensor,
                      num_partitions: int) -> torch.Tensor:
    """int32 partition id per row of an int32/date key column."""
    global launches, vector_launches, scalar_launches
    num_partitions = int(num_partitions)
    _check(vals, validity, num_partitions)
    if not vals.is_cuda:
        if vals.device.type == "cpu":
            return partition_ids_i32_ref(vals, validity, num_partitions)
        raise RuntimeError(f"partition_ids_i32 has no kernel for device "
                           f"{vals.device}")
    if not (vals.is_contiguous() and validity.is_contiguous()):
        raise ValueError("partition_ids_i32 takes contiguous tensors")
    out = torch.empty_like(vals)
    n = vals.shape[0]
    if n == 0:
        return out
    ptrs = (vals.data_ptr(), validity.data_ptr(), out.data_ptr())
    kind = variant(*ptrs)
    dev = vals.get_device()
    # the device's current stream as a raw handle (as Triton's launcher
    # reads it); the launcher makes `dev` current around the launch
    rc = _launcher(kind)(*ptrs, n, num_partitions,
                         pmod_magic(num_partitions), dev,
                         torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"partition_ids_i32 {kind} kernel launch failed: "
                           f"cudaError {rc}")
    with _COUNT_LOCK:
        launches += 1
        if kind == "vector":
            vector_launches += 1
        else:
            scalar_launches += 1
    return out
