"""TPC-H Q1 and the grouped path of the port on the card, against the
port on the CPU.

Every test here needs a CUDA device and skips without one. The module
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -q tests/test_torch_q1_cuda.py

The same lineitem table (SF 0.01, from a seed) goes through a CUDA
session and a CPU session with the same conf; the Arrow tables must be
equal (exact: every Q1 value is an integer or a decimal). Covered: Q1 +
sort in complete mode (one input partition) and in the partial ->
exchange -> final topology (many partitions, string keys); a
`group_by("l_shipdate")` whose exchange launches the partition kernel,
every launch the vector variant; the sort on string and decimal keys;
the decimal128 limb kernels with a HALF_UP down-shift and overflow.
"""
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch.ops import decimal128 as d128
from spark_rapids_tpu_torch.ops import partition_kernels as pk
from spark_rapids_tpu_torch.plan.logical import SortOrder
from spark_rapids_tpu_torch.expr.expressions import col
from spark_rapids_tpu_torch.workloads import tpch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SF = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lineitem():
    return tpch.gen_lineitem(SF, seed=7)




def _both(cuda, make, batch_rows=8192, extra=None):
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            **(extra or {})}
    gpu = make(pt.TpuSession(conf, device=cuda))
    cpu = make(pt.TpuSession(conf, device="cpu"))
    return gpu, cpu


def _plan(df):
    node, _ = df.physical_plan()
    out = []
    while node is not None:
        out.append(type(node).__name__ + (f"[{node.mode}]"
                                          if hasattr(node, "mode") else ""))
        node = node.children[0] if node.children else None
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch_rows,mode", [(8192, "partial"),
                                             (1 << 20, "complete")])
def test_q1_on_card_equals_cpu(cuda, lineitem, batch_rows, mode):
    def q1(s):
        return tpch.q1(s.create_dataframe(lineitem)).sort(
            "l_returnflag", "l_linestatus")
    gpu, cpu = _both(cuda, q1, batch_rows)
    assert f"HashAggregateExec[{mode}]" in _plan(gpu)
    got = gpu.to_arrow()
    assert got.num_rows == 6
    assert got.equals(cpu.to_arrow())


def _check_shipdate_launches(cuda, lineitem, extra, reader):
    def grouped(s):
        return s.create_dataframe(lineitem).group_by("l_shipdate").agg(
            F.sum("l_quantity").alias("q"), F.count("*").alias("c"))
    gpu, cpu = _both(cuda, grouped, extra=extra)
    assert _plan(gpu)[:3 + len(reader)] == \
        ["HashAggregateExec[final]"] + reader + [
            "ShuffleExchangeExec", "HashAggregateExec[partial]"]
    before = (pk.launches, pk.vector_launches, pk.scalar_launches)
    got = gpu.to_arrow()
    moved = (pk.launches - before[0], pk.vector_launches - before[1],
             pk.scalar_launches - before[2])
    map_batches = sum(m.get("mapBatches", 0)
                      for m in gpu.last_metrics().values())
    assert map_batches > 1
    assert moved == (map_batches, map_batches, 0)
    # a bare group_by has no defined order: compare sorted by the key
    keys = [("l_shipdate", "ascending")]
    assert got.sort_by(keys).equals(cpu.to_arrow().sort_by(keys))


@pytest.mark.cuda
def test_groupby_shipdate_launches_the_partition_kernel(cuda, lineitem):
    """The written plan (the adaptive features off)."""
    _check_shipdate_launches(cuda, lineitem, chip_smoke.WRITTEN_CONF, [])


@pytest.mark.cuda
def test_groupby_shipdate_launches_the_kernel_under_the_adaptive_reader(
        cuda, lineitem):
    """The default plan: the final stage reads the exchange through an
    adaptive reader, and the map side still launches the kernel once a
    batch."""
    _check_shipdate_launches(cuda, lineitem, None, ["AQEShuffleReadExec"])


@pytest.mark.cuda
def test_sort_on_string_and_decimal_keys(cuda, lineitem):
    def sorted_(s):
        return s.create_dataframe(lineitem.slice(0, 20000)).sort(
            SortOrder(col("l_returnflag"), ascending=False),
            SortOrder(col("l_extendedprice")), "l_orderkey")
    gpu, cpu = _both(cuda, sorted_)
    assert gpu.to_arrow().equals(cpu.to_arrow())


@pytest.mark.cuda
def test_decimal128_limb_kernels_on_card(cuda):
    rng = np.random.default_rng(3)
    n = 4096
    lo = rng.integers(-2**62, 2**62, (n, 2), dtype=np.int64)
    lo[:, 1] = np.where(lo[:, 0] < 0, -1, 0)          # 64-bit values
    big = lo.copy()
    big[:8, 1] = [2**40, -2**40, 2**62, -2**62, 0, -1, 1, 2**20]
    for a, b, shift, prec in ((lo, big, 0, 38), (big, lo, 7, 38),
                              (lo, lo, 3, 30)):
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        want = d128.dec_mul_scaled(ta, tb, shift, prec)
        got = d128.dec_mul_scaled(ta.to(cuda), tb.to(cuda), shift, prec)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    for fn in (d128.dec_add, d128.dec_sub):
        want = fn(torch.from_numpy(big), torch.from_numpy(lo))
        got = fn(torch.from_numpy(big).to(cuda),
                 torch.from_numpy(lo).to(cuda))
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    want = d128.dec_rescale(torch.from_numpy(big), 6, 2, 38)
    got = d128.dec_rescale(torch.from_numpy(big).to(cuda), 6, 2, 38)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_string_group_keys_with_nulls_and_long_values(cuda):
    rng = np.random.default_rng(5)
    words = ["", "a", "é", "日本語", "x" * 70, "x" * 70 + "y", None, "zzÿ"]
    n = 30000
    t = pa.table({"k": pa.array([words[i] for i in
                                 rng.integers(0, len(words), n)],
                                pa.string()),
                  "v": pa.array(rng.integers(-10**6, 10**6, n))})

    def grouped(s):
        return s.create_dataframe(t).group_by("k").agg(
            F.sum("v").alias("s"), F.count("*").alias("c"),
            F.avg("v").alias("a")).sort("k")
    gpu, cpu = _both(cuda, grouped)
    got = gpu.to_arrow()
    assert got.num_rows == len(words)
    assert got.equals(cpu.to_arrow())
    assert got.column("a").type == pa.float64()
