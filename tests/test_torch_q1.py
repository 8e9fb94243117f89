"""TPC-H Q1, end to end: the PyTorch port (on the CPU) against the JAX
package, the pandas oracle and an exact integer reference.

`tpch.q1(df).sort("l_returnflag", "l_linestatus")` runs over
`create_dataframe` (one input partition: the complete aggregate; many:
partial -> exchange on the two string keys -> final) and over Parquet
written as several files (MULTITHREADED: one partition per file, so the
partial / final topology, which the test asserts in the port's physical
plan). Every output must equal the JAX package's Arrow table row for
row; the values must equal `chip_smoke.q1_reference` (numpy int64 per
group, HALF_UP averages) exactly, and the float64 pandas oracle: its
sums to 1e-9 relative, its means to half a unit of the sixth decimal
(the averages are decimal(18, 6), rounded HALF_UP). `DataFrame.sort`
on string and decimal keys rides along. Tolerance: exact, but for the
float oracle.
"""
import sys
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.expr.expressions import col as jcol
from spark_rapids_tpu.plan.logical import SortOrder as JSortOrder
from spark_rapids_tpu.workloads import tpch as jtpch
from spark_rapids_tpu.workloads import tpch_oracle
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.expr.expressions import col as pcol
from spark_rapids_tpu_torch.plan.logical import SortOrder as PSortOrder
from spark_rapids_tpu_torch.utils import transfer
from spark_rapids_tpu_torch.workloads import tpch as ptpch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SF = 0.005
KEYS = ("l_returnflag", "l_linestatus")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lineitem():
    return jtpch.gen_lineitem(SF, seed=13)


def _plan(df):
    node, _ = df.physical_plan()
    out = []
    while node is not None:
        out.append(type(node).__name__ + (f"[{node.mode}]"
                                          if hasattr(node, "mode") else ""))
        node = node.children[0] if node.children else None
    return out


def _check_q1(got, exp, lineitem):
    assert got.equals(exp)
    assert got.column("l_returnflag").to_pylist() == \
        ["A", "A", "N", "N", "R", "R"]
    chip_smoke.check_q1(got, chip_smoke.q1_reference(lineitem), "port")
    oracle = tpch_oracle.q1(tpch_oracle.to_pandas({"lineitem": lineitem}))
    for c in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge"):
        np.testing.assert_allclose(
            np.asarray(got.column(c).cast("float64")),
            oracle[c].to_numpy(), rtol=1e-9)
    # the averages are decimal(18, 6), rounded HALF_UP: within half a
    # unit of the sixth place of the oracle's float mean
    for c in ("avg_qty", "avg_price", "avg_disc"):
        np.testing.assert_allclose(
            np.asarray(got.column(c).cast("float64")),
            oracle[c].to_numpy(), rtol=1e-12, atol=5e-7 + 1e-9)
    np.testing.assert_array_equal(got.column("count_order").to_numpy(),
                                  oracle["count_order"].to_numpy())


@pytest.mark.parametrize("batch_rows,mode", [(1 << 20, "complete"),
                                             (4096, "partial"),
                                             (4096, "adaptive")])
def test_q1_create_dataframe(lineitem, batch_rows, mode):
    # "partial" is the written plan, the adaptive features off;
    # "adaptive" the default, the final stage behind its reader
    conf = {"spark.rapids.tpu.sql.batchSizeRows": batch_rows,
            **(chip_smoke.WRITTEN_CONF if mode == "partial" else {})}
    pdf = ptpch.q1(pt.TpuSession(conf, device="cpu")
                   .create_dataframe(lineitem)).sort(*KEYS)
    chain = _plan(pdf)
    assert chain[0] == "SortExec"
    if mode == "complete":
        assert chain[1] == "HashAggregateExec[complete]"
    elif mode == "partial":
        assert chain[1:4] == ["HashAggregateExec[final]",
                              "ShuffleExchangeExec",
                              "HashAggregateExec[partial]"]
    else:
        assert chain[1:5] == ["HashAggregateExec[final]",
                              "AQEShuffleReadExec", "ShuffleExchangeExec",
                              "HashAggregateExec[partial]"]
    transfer.syncs = 0
    got = pdf.to_arrow()
    batches = -(-lineitem.num_rows // batch_rows)
    assert 0 < transfer.syncs <= 8 * batches + 16
    exp = jtpch.q1(st.TpuSession(dict(conf))
                   .create_dataframe(lineitem)).sort(*KEYS).to_arrow()
    _check_q1(got, exp, lineitem)


@pytest.mark.parametrize("reader,mode", [("MULTITHREADED", "partial"),
                                         ("MULTITHREADED", "adaptive"),
                                         ("AUTO", "complete")])
def test_q1_parquet(lineitem, tmp_path, reader, mode):
    per = -(-lineitem.num_rows // 5)
    for i in range(5):
        pq.write_table(lineitem.slice(i * per, per),
                       str(tmp_path / f"part-{i}.parquet"),
                       row_group_size=3000)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 4096,
            "spark.rapids.tpu.sql.format.parquet.reader.type": reader,
            **(chip_smoke.WRITTEN_CONF if mode == "partial" else {})}
    pdf = ptpch.q1(pt.TpuSession(conf, device="cpu")
                   .read.parquet(str(tmp_path))).sort(*KEYS)
    chain = _plan(pdf)
    if mode == "partial":
        assert chain[1:4] == ["HashAggregateExec[final]",
                              "ShuffleExchangeExec",
                              "HashAggregateExec[partial]"]
        assert chain[-1] == "ParquetScanExec"
    elif mode == "adaptive":
        assert chain[1:5] == ["HashAggregateExec[final]",
                              "AQEShuffleReadExec", "ShuffleExchangeExec",
                              "HashAggregateExec[partial]"]
        assert chain[-1] == "ParquetScanExec"
    else:
        assert chain[1] == "HashAggregateExec[complete]"
    got = pdf.to_arrow()
    exp = jtpch.q1(st.TpuSession(dict(conf)).read.parquet(
        str(tmp_path))).sort(*KEYS).to_arrow()
    _check_q1(got, exp, lineitem)


def test_q1_numpy_baseline_is_the_port_copy(lineitem):
    cols = [chip_smoke.unscaled(lineitem, c) for c in
            ("l_quantity", "l_extendedprice", "l_discount", "l_tax")]
    rf = chip_smoke._codes(lineitem.column("l_returnflag"))[0]
    ls = chip_smoke._codes(lineitem.column("l_linestatus"))[0]
    ship = lineitem.column("l_shipdate").to_numpy()
    args = (ship, rf.astype(np.int64), ls.astype(np.int64), *cols)
    got, exp = ptpch.q1_numpy_baseline(*args), \
        jtpch.q1_numpy_baseline(*args)
    assert sorted(got) == sorted(exp)
    for k in got:
        np.testing.assert_array_equal(got[k], exp[k])


ORDERS = {
    "string_desc_then_decimal": [("l_returnflag", False, None),
                                 ("l_extendedprice", True, None),
                                 ("l_orderkey", True, None)],
    "decimal_desc_nulls_first": [("l_tax", False, True),
                                 ("l_linestatus", True, None),
                                 ("l_orderkey", False, None)],
    "two_strings_then_date": [("l_linestatus", True, None),
                              ("l_returnflag", True, None),
                              ("l_shipdate", False, None),
                              ("l_orderkey", True, None)],
}


@pytest.mark.parametrize("name", sorted(ORDERS))
def test_sort_on_string_and_decimal_keys(lineitem, name):
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 4096}
    at = lineitem.slice(0, 12000)
    orders = ORDERS[name]
    exp = st.TpuSession(dict(conf)).create_dataframe(at).sort(
        *[JSortOrder(jcol(c), a, nf) for c, a, nf in orders]).to_arrow()
    got = pt.TpuSession(conf, device="cpu").create_dataframe(at).sort(
        *[PSortOrder(pcol(c), a, nf) for c, a, nf in orders]).to_arrow()
    assert got.equals(exp)
    assert got.num_rows == at.num_rows


def test_sort_after_filter_and_string_ascending(lineitem):
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 4096}
    at = lineitem.slice(0, 9000)
    exp = st.TpuSession(dict(conf)).create_dataframe(at).filter(
        jcol("l_shipdate") > 9000).select(
        "l_returnflag", "l_quantity", "l_orderkey").orderBy(
        "l_returnflag", "l_quantity", "l_orderkey",
        ascending=False).to_arrow()
    got = pt.TpuSession(conf, device="cpu").create_dataframe(at).filter(
        pcol("l_shipdate") > 9000).select(
        "l_returnflag", "l_quantity", "l_orderkey").orderBy(
        "l_returnflag", "l_quantity", "l_orderkey",
        ascending=False).to_arrow()
    assert got.equals(exp)
