"""TPC-H Q6 and Q1 over Parquet in Spark's layout, with device decode:
the PyTorch port (a CPU session, the conf set explicitly) against the
JAX package (its session, the conf set).

The full lineitem table (the generator's 15 columns: TPC-H's 16 but
l_comment; SF 0.01, from a seed) is written as Spark writes it:
decimals of precision up to 18 as INT64 / INT32
(`store_decimal_as_integer`), snappy, v1 pages, dictionary encoding,
several row groups a file. A second layout shrinks the
dictionary page limit, so the wide columns switch to PLAIN mid-chunk
(the mixed-encoding fallback, as at SF10). Both results must equal the
JAX package's Arrow table, with equal device-decode counts, and the
exact references of `chip_smoke.py`; the whole table read through the
device path must equal the host path's.
"""
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
import spark_rapids_tpu as st
from spark_rapids_tpu.workloads import tpch as jtpch
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.workloads import tpch as ptpch

SF = 0.01
DECODE = "spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled"
CONF = {"spark.rapids.tpu.sql.batchSizeRows": 4096, DECODE: True}
KEYS = ("l_returnflag", "l_linestatus")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lineitem():
    return ptpch.gen_lineitem(SF, seed=7, full=True)


@pytest.fixture(scope="module", params=["spark", "dict_overflow"])
def files(request, lineitem, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    extra = ({"dictionary_pagesize_limit": 16 << 10}
             if request.param == "dict_overflow" else {})
    per = -(-lineitem.num_rows // 3)
    for i in range(3):
        pq.write_table(lineitem.slice(i * per, per),
                       str(d / f"part-{i}.parquet"), row_group_size=8000,
                       store_decimal_as_integer=True, compression="snappy",
                       data_page_version="1.0", use_dictionary=True,
                       **extra)
    return request.param, str(d)


def _decode_counts(df):
    out = {}
    for ms in df.last_metrics().values():
        for k, v in ms.items():
            if k.startswith("deviceDecode") and not k.endswith("Bytes"):
                out[k] = out.get(k, 0) + v
    return out


def _run(make, path, conf=CONF):
    jdf = make(jtpch, st.TpuSession(dict(conf)).read.parquet(path))
    pdf = make(ptpch, pt.TpuSession(dict(conf), device="cpu")
               .read.parquet(path))
    got, exp = pdf.to_arrow(), jdf.to_arrow()
    assert got.equals(exp)
    assert _decode_counts(pdf) == _decode_counts(jdf)
    return got, _decode_counts(pdf)


def test_q6(files, lineitem):
    layout, path = files
    got, counts = _run(lambda m, df: m.q6(df), path)
    assert counts["deviceDecodedChunks"] > 0
    if layout == "dict_overflow":     # l_extendedprice switches to PLAIN
        assert counts["deviceDecodeFallback.pages"] > 0
    chip_smoke.check_revenue(got, ptpch.q6_numpy_baseline(
        lineitem.column("l_shipdate").to_numpy(),
        chip_smoke.unscaled(lineitem, "l_discount"),
        chip_smoke.unscaled(lineitem, "l_quantity"),
        chip_smoke.unscaled(lineitem, "l_extendedprice")), layout)


def test_q1(files, lineitem):
    layout, path = files
    got, counts = _run(lambda m, df: m.q1(df).sort(*KEYS), path)
    assert counts["deviceDecodedChunks"] > 0
    chip_smoke.check_q1(got, chip_smoke.q1_reference(lineitem), layout)


def test_whole_table_device_equals_host(files, lineitem):
    _, path = files
    ps = pt.TpuSession(dict(CONF), device="cpu")
    dev = ps.read.parquet(path)
    host = pt.TpuSession({DECODE: False}, device="cpu").read.parquet(path)
    got = dev.to_arrow()
    assert got.equals(host.to_arrow())
    assert got.num_rows == lineitem.num_rows
    counts = _decode_counts(dev)
    # every chunk is decoded on the device or counted as a fallback:
    # every column x 3 row groups x 3 files
    assert counts["deviceDecodedChunks"] + sum(
        v for k, v in counts.items() if "Fallback" in k) \
        == lineitem.num_columns * 3 * 3
