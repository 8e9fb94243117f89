"""spark_rapids_tpu_torch: the columnar SQL engine ported to PyTorch and
CUDA for NVIDIA Hopper.

A second package beside the JAX engine `spark_rapids_tpu`, with its
module layout and class names. Columns are torch tensors; plain tensor
code is PyTorch, and each TPU kernel of the JAX engine becomes a CUDA
kernel under `csrc/`, built with nvcc for sm_90a at first use. The port
imports nothing of the JAX engine and never imports JAX.

Ported so far: TPC-H Q6's path (in-memory and Parquet scans, filter,
projection, the exact decimal sum), TPC-H Q1's (string columns, exact
decimal128 arithmetic, the grouped hash aggregate, the sort), Q3's (the
hash join, broadcast or shuffled, and the limit), Q4, Q5, Q7, Q10, Q12,
Q18 and Q19 (IF, CASE WHEN, IN, decimal128 comparison), and the hash
exchange behind `DataFrame.repartition`, grouped aggregation and
shuffled joins. Anything else raises `NotPorted`.

    import spark_rapids_tpu_torch as st
    s = st.TpuSession()              # CUDA; TpuSession(device="cpu") on CPU
    df = s.read.parquet("lineitem/")

The session (and with it torch) loads at the first use of `TpuSession`
or `DataFrame`, so a module that needs neither (a python worker's
`exec/python_worker.py`) imports without torch.
"""
import importlib

from .errors import NotPorted

__all__ = ["TpuSession", "DataFrame", "NotPorted"]


def __getattr__(name):
    if name in ("TpuSession", "DataFrame"):
        from . import session
        return getattr(session, name)
    try:
        return importlib.import_module(f".{name}", __name__)
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
