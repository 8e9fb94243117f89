"""The port's CSV / JSON-lines / ORC / Avro scans against the JAX
package's: `session.read.csv / json / orc / avro` over the same files,
made from a seed, must give equal Arrow tables; the options, the JSON
carry across small blocks, ORC stripes, the Avro codecs, column pruning
through the optimizer, schema inference, and the bind-time snapshot
(SnapshotMismatch when a file changes under a running scan)."""
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.json as pajson
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.io import avro as javro
from spark_rapids_tpu.io.snapshot import SnapshotMismatch as JMismatch
from spark_rapids_tpu.plan import logical as JL
from spark_rapids_tpu.plan.optimizer import prune as jprune
from spark_rapids_tpu_torch.io import avro as pavro
from spark_rapids_tpu_torch.io.snapshot import SnapshotMismatch
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan.optimizer import prune as pprune
from torch_parity import assert_same

CONF = {"spark.rapids.tpu.sql.batchSizeRows": 512,
        "spark.rapids.tpu.sql.text.blockSize": 4096}


def _sessions(conf=None):
    c = {**CONF, **(conf or {})}
    return st.TpuSession(dict(c)), pt.TpuSession(dict(c), device="cpu")


@pytest.fixture(scope="module")
def data():
    n = 2500
    rng = np.random.default_rng(2)
    return pa.table({
        "k": pa.array(rng.integers(0, 10, n)),
        "v": pa.array(np.round(rng.uniform(0, 100, n), 4)),
        "s": pa.array([f"name{x}" if x % 7 else None for x in range(n)]),
    })


def _both(make, conf=None):
    """(JAX table, port table) of `make(session, functions)`."""
    js, ps = _sessions(conf)
    return make(js, JF).to_arrow(), make(ps, PF).to_arrow()


def test_csv_scan_equals_jax(data, tmp_path):
    p = str(tmp_path / "t.csv")
    pacsv.write_csv(data, p)
    j, t = _both(lambda s, F: s.read.csv(p))
    assert_same(j, t, "csv")
    # the scan reads an empty field as null
    assert t.equals(pacsv.read_csv(p, convert_options=pacsv.ConvertOptions(
        null_values=[""], strings_can_be_null=True)))
    j, t = _both(lambda s, F: s.read.csv(p).filter(F.col("k") == 3)
                 .group_by("k").agg(F.count("v").alias("c")))
    assert_same(j, t, "csv grouped")


@pytest.mark.parametrize("case", ["pipe_na", "no_header", "quote_escape"])
def test_csv_options_equal_jax(tmp_path, case):
    p = str(tmp_path / "o.csv")
    text, kw = {
        "pipe_na": ("a|b\n1|x\n2|NA\n3|z\n",
                    {"delimiter": "|", "null_value": "NA"}),
        "no_header": ("1,x\n2,\n3,z\n", {"header": False}),
        "quote_escape": ('a,b\n1,"x,y"\n2,"q\\"r"\n3,\n',
                         {"quote": '"', "escape": "\\"}),
    }[case]
    with open(p, "w") as f:
        f.write(text)
    j, t = _both(lambda s, F: s.read.csv(p, **kw))
    assert_same(j, t, case)
    assert t.num_rows == 3


def test_csv_with_a_user_schema(data, tmp_path):
    p = str(tmp_path / "t.csv")
    pacsv.write_csv(data, p)
    schema = pa.schema([("k", pa.int32()), ("v", pa.float64()),
                        ("s", pa.string())])
    j, t = _both(lambda s, F: s.read.csv(p, schema=schema))
    assert_same(j, t, "csv schema")
    assert t.schema.field("k").type == pa.int32()


def test_csv_comment_is_refused_as_in_jax(tmp_path):
    p = str(tmp_path / "c.csv")
    with open(p, "w") as f:
        f.write("a\n1\n")
    js, ps = _sessions()
    with pytest.raises(ValueError, match="comment") as je:
        js.read.csv(p, comment="#")
    with pytest.raises(ValueError, match="comment") as pe:
        ps.read.csv(p, comment="#")
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("block", [600, 1 << 20])
def test_json_lines_across_small_blocks(data, tmp_path, block):
    p = str(tmp_path / "t.json")
    with open(p, "w") as f:
        for row in data.to_pylist():
            f.write(json.dumps(row) + "\n")
    conf = {"spark.rapids.tpu.sql.text.blockSize": block}
    j, t = _both(lambda s, F: s.read.json(p), conf)
    assert_same(j, t, f"json {block}")
    assert t.equals(pajson.read_json(p))
    _, ps = _sessions(conf)
    df = ps.read.json(p).filter(PF.col("s").isNotNull())
    assert df.count() == sum(r["s"] is not None for r in data.to_pylist())


def test_json_last_line_without_newline(tmp_path):
    p = str(tmp_path / "n.json")
    with open(p, "w") as f:
        f.write('{"a": 1, "b": "x"}\n{"a": 2, "b": null}\n{"a": 3, "b": "z"}')
    j, t = _both(lambda s, F: s.read.json(p),
                 {"spark.rapids.tpu.sql.text.blockSize": 16})
    assert_same(j, t, "json tail")
    assert t.column("a").to_pylist() == [1, 2, 3]


def test_orc_stripes_equal_jax(data, tmp_path):
    p = str(tmp_path / "t.orc")
    orc.write_table(data, p, stripe_size=16 * 1024)
    assert orc.ORCFile(p).nstripes > 1
    j, t = _both(lambda s, F: s.read.orc(p))
    assert_same(j, t, "orc")
    assert t.equals(orc.read_table(p))
    _, ps = _sessions()
    df = ps.read.orc(p)
    got = df.group_by("k").agg(PF.count("v").alias("c")).to_arrow()
    want = {}
    for k in data.column("k").to_pylist():
        want[k] = want.get(k, 0) + 1
    assert dict(zip(got.column("k").to_pylist(),
                    got.column("c").to_pylist())) == want
    df.to_arrow()
    batches = sum(m.get("numOutputBatches", 0)
                  for m in df.last_metrics().values())
    assert batches == orc.ORCFile(p).nstripes


AVRO_SCHEMA = {
    "type": "record", "name": "rec", "fields": [
        {"name": "id", "type": "long"},
        {"name": "name", "type": ["null", "string"]},
        {"name": "score", "type": "double"},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "props", "type": {"type": "map", "values": "long"}},
    ]}


def _avro_records(n=500):
    rng = np.random.default_rng(4)
    return [{"id": i, "name": None if i % 11 == 0 else f"n{i}",
             "score": float(rng.uniform()),
             "tags": [f"t{j}" for j in range(i % 4)],
             "props": {"a": i, "b": i * 2}}
            for i in range(n)]


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_codecs_equal_jax(tmp_path, codec):
    recs = _avro_records()
    pp, jp = str(tmp_path / "p.avro"), str(tmp_path / "j.avro")
    pavro.write_avro(pp, AVRO_SCHEMA, recs, codec=codec, block_records=128)
    javro.write_avro(jp, AVRO_SCHEMA, recs, codec=codec, block_records=128)
    # each package reads both files: the container and the records
    for path in (pp, jp):
        for mod in (pavro, javro):
            r = mod.AvroReader(path)
            assert r.codec == codec and list(r.records()) == recs
        assert pavro.read_avro_to_arrow(path).equals(
            javro.read_avro_to_arrow(path))
    j, t = _both(lambda s, F: s.read.avro(pp).select("id", "name",
                                                     "score"))
    assert_same(j, t, f"avro {codec}")
    js, ps = _sessions()
    jg = js.read.avro(pp).group_by(JF.size(JF.col("tags")).alias("nt")) \
        .agg(JF.count("id").alias("c")).sort("nt").to_arrow()
    pg = ps.read.avro(pp).group_by(PF.size(PF.col("tags")).alias("nt")) \
        .agg(PF.count("id").alias("c")).sort("nt").to_arrow()
    assert_same(jg, pg, "avro tags")
    assert ps.read.avro(pp).filter(PF.col("name").isNotNull()).count() \
        == sum(r["name"] is not None for r in recs)


@pytest.mark.parametrize("fmt", ["csv", "json", "orc", "avro"])
def test_column_pruning_through_the_optimizer(data, tmp_path, fmt):
    p = str(tmp_path / f"t.{fmt}")
    if fmt == "csv":
        pacsv.write_csv(data, p)
    elif fmt == "json":
        with open(p, "w") as f:
            for row in data.to_pylist():
                f.write(json.dumps(row) + "\n")
    elif fmt == "orc":
        orc.write_table(data, p)
    else:
        pavro.write_avro(p, {"type": "record", "name": "r", "fields": [
            {"name": "k", "type": "long"}, {"name": "v", "type": "double"},
            {"name": "s", "type": ["null", "string"]}]}, data.to_pylist())
    js, ps = _sessions()
    jdf = getattr(js.read, fmt)(p).select(JF.col("k"))
    pdf = getattr(ps.read, fmt)(p).select(PF.col("k"))
    jscan = jprune(jdf._plan, None).children[0]
    pscan = pprune(pdf._plan, None).children[0]
    assert isinstance(jscan, JL.TextScan) and jscan.columns == ["k"]
    assert isinstance(pscan, PL.TextScan) and pscan.columns == ["k"]
    assert pscan.describe() == jscan.describe()
    assert_same(jdf.to_arrow(), pdf.to_arrow(), fmt)


@pytest.mark.parametrize("fmt", ["csv", "json", "orc", "avro"])
def test_schema_inference_equals_jax(data, tmp_path, fmt):
    p = str(tmp_path / f"t.{fmt}")
    t = data.append_column("d", pa.array(
        np.arange(data.num_rows, dtype=np.int32)))
    if fmt == "csv":
        pacsv.write_csv(t, p)
    elif fmt == "json":
        with open(p, "w") as f:
            for row in t.to_pylist():
                f.write(json.dumps(row) + "\n")
    elif fmt == "orc":
        orc.write_table(t, p)
    else:
        pavro.write_avro(p, {"type": "record", "name": "r", "fields": [
            {"name": "k", "type": "long"}, {"name": "v", "type": "double"},
            {"name": "s", "type": ["null", "string"]},
            {"name": "d", "type": "int"}]}, t.to_pylist())
    js, ps = _sessions()
    jsch = getattr(js.read, fmt)(p).schema
    psch = getattr(ps.read, fmt)(p).schema
    assert [(f.name, f.dtype.simple_name()) for f in psch.fields] == \
        [(f.name, f.dtype.simple_name()) for f in jsch.fields]


def _rewrite_parquet(p, n):
    pq.write_table(pa.table({"a": pa.array(np.arange(n, dtype=np.int64))}),
                   p)


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_a_file_changed_mid_query_raises(tmp_path, fmt):
    """Between planning and execution the file is rewritten: the port
    raises SnapshotMismatch, as the JAX Parquet scan does (the JAX text
    scans pin a snapshot but never check it: ROADMAP C.34); the next
    action reads the new file in both packages."""
    p = str(tmp_path / f"t.{fmt}")

    def write(n):
        if fmt == "parquet":
            _rewrite_parquet(p, n)
        else:
            pacsv.write_csv(pa.table({"a": pa.array(
                np.arange(n, dtype=np.int64))}), p)

    write(100)
    js, ps = _sessions()
    jdf, pdf = getattr(js.read, fmt)(p), getattr(ps.read, fmt)(p)
    assert jdf.count() == pdf.count() == 100
    jroot, jctx = jdf._execute()
    proot, pctx = pdf.physical_plan()
    write(250)
    if fmt == "parquet":
        with pytest.raises(JMismatch):
            list(jroot.execute_partition(jctx, 0))
    else:
        assert sum(b.num_rows for b in
                   jroot.execute_partition(jctx, 0)) == 250
    with pytest.raises(SnapshotMismatch):
        list(proot.execute_partition(pctx, 0))
    scan = proot
    while scan.children:
        scan = scan.children[0]
    assert pctx.metrics[scan._op_id]["scanSnapshotViolations"] == 1
    pctx.close()
    # between actions the scans' snapshots refresh
    assert jdf.count() == pdf.count() == 250
    want = pa.table({"a": pa.array(np.arange(250, dtype=np.int64))})
    assert pdf.to_arrow().equals(want)
    if fmt == "parquet":
        # the count refreshed the logical scan that jdf shares, so jdf's
        # own refresh sees no change and keeps its cached physical plan
        # with the old snapshot (ROADMAP C.35); the port plans afresh
        with pytest.raises(JMismatch):
            jdf.to_arrow()
    else:
        assert jdf.to_arrow().equals(want)
