"""TPC-H Q6 and the hash exchange, end to end: the PyTorch port (on the
CPU) against the JAX package.

Q6 runs over `create_dataframe`, over Parquet written as several small
files (AUTO picks the COALESCING reader) and over Parquet under the
MULTITHREADED reader; `repartition` runs hash (one int32 key: the
partition kernel's path; an int64 key and two keys: the murmur3 fold)
and round-robin. Every output must equal the JAX package's Arrow table
row for row; Q6 must also equal `q6_numpy_baseline` exactly and the
float64 pandas oracle to 1e-9 relative (the oracle sums in float64).
"""
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu as st
from spark_rapids_tpu.workloads import tpch as jtpch
from spark_rapids_tpu.workloads import tpch_oracle
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.exec.nodes import ParquetScanExec
from spark_rapids_tpu_torch.ops import partition_kernels
from spark_rapids_tpu_torch.workloads import tpch as ptpch

CONF = {"spark.rapids.tpu.sql.batchSizeRows": 4096}
SF = 0.005
Q6_COLS = list(ptpch.Q6_COLUMNS)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lineitem():
    return jtpch.gen_lineitem(SF, seed=11)


@pytest.fixture(scope="module")
def sessions():
    return (st.TpuSession(dict(CONF)),
            pt.TpuSession(dict(CONF), device="cpu"))


def _unscaled(at, name):
    return Column.host_from_arrow(at.column(name))[2]["data"]


def _check_q6(at_port, at_jax, lineitem):
    assert at_port.equals(at_jax)
    rev = at_port.column("revenue")[0].as_py()
    exp = ptpch.q6_numpy_baseline(
        lineitem.column("l_shipdate").to_numpy(),
        _unscaled(lineitem, "l_discount"), _unscaled(lineitem, "l_quantity"),
        _unscaled(lineitem, "l_extendedprice"))
    assert rev == decimal.Decimal(exp).scaleb(-4)
    oracle = tpch_oracle.q6(tpch_oracle.to_pandas({"lineitem": lineitem}))
    assert float(rev) == pytest.approx(float(oracle["revenue"][0]),
                                       rel=1e-9)


def test_generator_matches_jax(lineitem):
    assert ptpch.gen_lineitem(SF, seed=11).equals(lineitem)


def test_q6_create_dataframe(sessions, lineitem):
    js, ps = sessions
    _check_q6(ptpch.q6(ps.create_dataframe(lineitem)).to_arrow(),
              jtpch.q6(js.create_dataframe(lineitem)).to_arrow(), lineitem)


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory, lineitem):
    """Six small files, each in row groups of 2,000 rows."""
    d = tmp_path_factory.mktemp("lineitem")
    per = -(-lineitem.num_rows // 6)
    for i in range(6):
        pq.write_table(lineitem.slice(i * per, per),
                       str(d / f"part-{i:02d}.parquet"),
                       row_group_size=2000)
    return str(d)


def _scan_of(df):
    root, ctx = df.physical_plan()
    node = root
    while not isinstance(node, ParquetScanExec):
        node = node.children[0]
    return node, ctx


@pytest.mark.parametrize("reader", ["AUTO", "MULTITHREADED"])
def test_q6_parquet(sessions, lineitem, parquet_dir, reader):
    conf = dict(CONF)
    conf["spark.rapids.tpu.sql.format.parquet.reader.type"] = reader
    js, ps = st.TpuSession(conf), pt.TpuSession(conf, device="cpu")
    pdf = ptpch.q6(ps.read.parquet(parquet_dir))
    scan, ctx = _scan_of(pdf)
    assert scan._reader_type(ctx) == ("COALESCING" if reader == "AUTO"
                                      else "MULTITHREADED")
    _check_q6(pdf.to_arrow(),
              jtpch.q6(js.read.parquet(parquet_dir)).to_arrow(), lineitem)


def test_parquet_row_group_pruning(sessions, lineitem, tmp_path):
    """A file sorted on l_shipdate: Q6's date range skips row groups."""
    js, ps = sessions
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(lineitem.sort_by("l_shipdate"), path,
                   row_group_size=1500)
    pdf = ptpch.q6(ps.read.parquet(path))
    root, ctx = pdf.physical_plan()
    from spark_rapids_tpu_torch.exec.nodes import collect_to_arrow
    got = collect_to_arrow(root, ctx)
    skipped = sum(m.get("skippedRowGroups", 0) for m in ctx.metrics.values())
    assert skipped > 0
    exp = jtpch.q6(js.read.parquet(path)).to_arrow()
    assert got.equals(exp)


@pytest.mark.parametrize("keys", [("l_shipdate",), ("l_orderkey",),
                                  ("l_shipdate", "l_orderkey"), ()])
def test_repartition_matches_jax(sessions, lineitem, keys):
    js, ps = sessions
    cols = Q6_COLS + ["l_orderkey"]
    exp = js.create_dataframe(lineitem).select(*cols).repartition(
        16, *keys).to_arrow()
    before = partition_kernels.launches
    got = ps.create_dataframe(lineitem).select(*cols).repartition(
        16, *keys).to_arrow()
    assert partition_kernels.launches == before   # CPU: plain version
    assert got.num_rows == lineitem.num_rows
    assert got.equals(exp)


def test_q6_over_repartition(sessions, lineitem):
    js, ps = sessions
    cols = Q6_COLS + ["l_orderkey"]
    got = ptpch.q6(ps.create_dataframe(lineitem).select(*cols)
                   .repartition(16, "l_shipdate")).to_arrow()
    exp = jtpch.q6(js.create_dataframe(lineitem).select(*cols)
                   .repartition(16, "l_shipdate")).to_arrow()
    _check_q6(got, exp, lineitem)


def test_repartition_rows_land_in_their_hash_partition(sessions, lineitem):
    """Each reduce partition holds exactly the rows whose key hashes to
    it, in map order."""
    _, ps = sessions
    df = ps.create_dataframe(lineitem).select("l_shipdate", "l_orderkey")
    root, ctx = df.repartition(16, "l_shipdate").physical_plan()
    seen = 0
    for rp in range(root.num_partitions(ctx)):
        for b in root.execute_partition(ctx, rp):
            ship = b.table.columns[0]
            ids = partition_kernels.partition_ids_i32_ref(
                ship.data, ship.validity, 16)
            assert bool((ids == rp).all())
            seen += b.num_rows
    assert seen == lineitem.num_rows


def test_filter_select_with_nulls_matches_jax(sessions):
    js, ps = sessions
    rng = np.random.default_rng(5)
    n = 9000
    at = pa.table({
        "k": pa.array(rng.integers(0, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "p": jtpch.dec_from_unscaled(rng.integers(-10**11, 10**11, n),
                                     12, 2),
        "d": pa.array([None if m else decimal.Decimal(int(v)).scaleb(-2)
                       for v, m in zip(rng.integers(0, 11, n),
                                       rng.random(n) < 0.1)],
                      pa.decimal128(4, 2))})
    from spark_rapids_tpu.expr.expressions import col as jcol
    from spark_rapids_tpu_torch.expr.expressions import col as pcol

    def q(df, col):
        return (df.filter((col("k") < 40)
                          | (col("d") > decimal.Decimal("0.05")))
                .select(col("k"), (col("p") * col("d")).alias("pd"),
                        (col("p") + col("k")).alias("pk"))
                .repartition(7, "k"))
    exp = q(js.create_dataframe(at), jcol).to_arrow()
    got = q(ps.create_dataframe(at), pcol).to_arrow()
    assert got.equals(exp)


def test_unported_plan_raises(sessions, lineitem):
    mesh = pt.TpuSession({"spark.rapids.tpu.mesh.devices": 4},
                         device="cpu")
    # a grouped aggregate over a mesh plans a mesh exchange too
    with pytest.raises(pt.NotPorted, match="mesh exchange"):
        mesh.create_dataframe(lineitem).group_by("l_shipdate").agg(
            pt.functions.count("*")).to_arrow()
    with pytest.raises(pt.NotPorted, match="mesh exchange"):
        mesh.create_dataframe(lineitem).repartition(4, "l_shipdate") \
            .to_arrow()
