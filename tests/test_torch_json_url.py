"""get_json_object, from_json, to_json and parse_url in the port against
the JAX package (`expr/json_exprs.py`, `ops/json_tape.py`, the host
rules of `expr/host_eval.py`, the audit's CPU-bridge verdicts):
get_json_object on its device path (fallback off on both sides) and
under `SRTPU_JSON_HOST=1` on the host, over scalar and wildcard paths,
nulls, missing fields, escapes and malformed rows; the host bridge's
from_json / to_json round trips and every parse_url part; the plan
audit's verdicts and the VALIDATE text. Exact throughout."""
import contextlib
import io
import json

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.exec.host_fallback import HostProjectExec
from spark_rapids_tpu_torch.exec.nodes import ProjectExec
from torch_parity import JAX_CONF, assert_same, project

DOCS = ['{"a": 1, "b": {"c": [5, 6, {"d": "x"}], "e": "s"}}',
        '{"b": {"c": []}}', None, "not json", "",
        '  {"b" : { "c" : [ 10 , 20 ] } }  ',
        '{"a": "line\\nbreak \\"q\\" end \\\\ \\/ \\t", "b": null}',
        '{"a": true, "b": -12.5e3}', '{"n": null}', '{"m": 1}', "{}",
        "[1, 2]", '{"a": [{"b": 7}, {"b": 8}]}', '{"a": "\\u00e9x"}',
        '{"a": {"b": 2.5}}', '{"a": 1, "a": 2}', '{"k": "a,b}c"}',
        '{"a": [1, [2, 3], {"x": [4]}]}', '{"a" 1}', '{"a": 1']
SCALAR_PATHS = ["$.a", "$.b", "$.b.c", "$.b.c[1]", "$.b.c[2].d", "$.b.e",
                "$.n", "$[0]", "$[1]", "$.a[1][0]", "$.a[2].x[0]",
                "$['a']", "$.k", "$.missing", "$.a.b"]
WILD_PATHS = ["$.a[*]", "$.a[*].b", "$.b.*", "$[*]"]
HOST = {"spark.rapids.tpu.sql.allowCpuFallback": True}
DATA = pa.table({"j": pa.array(DOCS, pa.string())})


def _json_cols(F, paths):
    return [F.get_json_object(F.col("j"), p) for p in paths]


def test_device_path_equals_jax():
    """Scalar paths bind on the device in both packages (the fallback is
    off): container results are the raw JSON spans, exact."""
    jt, ptt = project(DATA, lambda F: _json_cols(F, SCALAR_PATHS))
    assert_same(jt, ptt, "device")
    assert ptt.column("c0").to_pylist()[0] == "1"


def test_device_path_runs_on_the_device():
    q = pt.TpuSession(JAX_CONF, device="cpu").create_dataframe(DATA).select(
        PF.get_json_object(PF.col("j"), "$.b.c[1]").alias("x"))
    nodes = [type(n) for n in _walk(q.physical_plan()[0])]
    assert ProjectExec in nodes and HostProjectExec not in nodes


@pytest.mark.parametrize("paths", ["scalar", "wildcard"])
def test_host_path_equals_jax(monkeypatch, paths):
    """SRTPU_JSON_HOST=1 sends every path to the host (wildcards go
    there anyway): both packages' host rules, exact."""
    if paths == "scalar":
        monkeypatch.setenv("SRTPU_JSON_HOST", "1")
    cols = SCALAR_PATHS if paths == "scalar" else WILD_PATHS
    jt, ptt = project(DATA, lambda F: _json_cols(F, cols), HOST)
    assert_same(jt, ptt, paths)
    q = pt.TpuSession(HOST, device="cpu").create_dataframe(DATA).select(
        *_json_cols(PF, cols[:1]))
    assert HostProjectExec in [type(n) for n in
                               _walk(q.physical_plan()[0])]


def test_device_and_host_agree_on_values(monkeypatch):
    """The device path against the host path in the port, over the JAX
    package's own case (`tests/test_json_url.py`
    `test_device_json_matches_host`): equal but where a container
    renders (raw span against compact JSON, the same value)."""
    docs = ['{"a": 1, "b": {"c": [5, 6, {"d": "x"}], "e": "s"}}',
            '{"b": {"c": []}}', None, "not json", "",
            '  {"b" : { "c" : [ 10 , 20 ] } }  ',
            '{"a": "line\\nbreak \\"q\\" end", "b": null}',
            '{"a": true, "b": -12.5e3}']
    paths = ["$.a", "$.b.c[1]", "$.b.c[2].d", "$.b", "$[0].a", "$.b.e"]
    data = pa.table({"j": pa.array(docs, pa.string())})
    dev = project(data, lambda F: _json_cols(F, paths))[1]
    monkeypatch.setenv("SRTPU_JSON_HOST", "1")
    host = project(data, lambda F: _json_cols(F, paths), HOST)[1]
    for name in dev.column_names:
        for d, h in zip(dev.column(name).to_pylist(),
                        host.column(name).to_pylist()):
            if d != h:
                assert d is not None and h is not None, (name, d, h)
                assert json.loads(d) == json.loads(h), (name, d, h)


def test_device_path_over_many_rows_and_batches():
    rng = np.random.default_rng(9)
    docs, want = [], []
    for i in range(3000):
        obj = {"id": int(i), "tags": [f"t{j}" for j in range(i % 4)],
               "meta": {"score": float(rng.integers(0, 100)) / 2.0,
                        "name": f"row-{i}\t\"{i % 7}\""}}
        docs.append(json.dumps(obj) if i % 11 else None)
        want.append(None if i % 11 == 0 else obj["meta"]["name"])
    data = pa.table({"j": pa.array(docs)})
    jt, ptt = project(data, lambda F: _json_cols(
        F, ["$.meta.score", "$.meta.name", "$.tags[2]", "$.id"]),
        {"spark.rapids.tpu.sql.batchSizeRows": 512})
    assert_same(jt, ptt, "many")
    assert ptt.column("c1").to_pylist() == want


def _schema(dt):
    return dt.StructType((dt.StructField("a", dt.INT64),
                          dt.StructField("b", dt.STRING),
                          dt.StructField("c", dt.ArrayType(dt.INT64)),
                          dt.StructField("m", dt.MapType(dt.STRING,
                                                         dt.FLOAT64))))


def test_from_json_to_json_round_trip():
    docs = ['{"a": 1, "b": "x", "c": [1,2], "m": {"p": 1.5}}',
            '{"a": 9}', None, "broken", '{"a": "no", "c": 3}',
            '{"b": 7, "c": [null, 4], "m": {}}', "[]"]
    data = pa.table({"j": pa.array(docs)})
    outs = []
    for s, F, dt in ((st.TpuSession(HOST), JF, jdt),
                     (pt.TpuSession(HOST, device="cpu"), PF, pdt)):
        df = s.create_dataframe(data)
        parsed = F.from_json(F.col("j"), _schema(dt))
        outs.append(df.select(parsed.alias("s"),
                              F.to_json(parsed).alias("t")).to_arrow())
    assert outs[0].equals(outs[1])
    got = outs[1].to_pydict()
    assert got["t"][0] == '{"a":1,"b":"x","c":[1,2],"m":{"p":1.5}}'
    assert got["s"][2] is None and got["s"][3] is None
    assert got["s"][4]["a"] is None and got["s"][4]["c"] is None
    # to_json(from_json(to_json(x))) is a fixed point
    again = pt.TpuSession(HOST, device="cpu").create_dataframe(
        pa.table({"j": outs[1].column("t")})).select(
        PF.to_json(PF.from_json(PF.col("j"), _schema(pdt))).alias("t")) \
        .to_arrow()
    assert again.column("t").to_pylist() == got["t"]


URLS = ["https://user:pw@example.com:8080/p/a?x=1&y=2&y=3#frag",
        "http://spark.apache.org/path?q=hello+world&nation=7",
        None, "ftp://h/f.txt", "not a url", "http://[::1]:80/x?nation=",
        "https://host.example/a%20b?nation=FR%20A&k", "mailto:x@y.z",
        "http://h/?nation=1#n=2"]
PARTS = ("HOST", "PATH", "QUERY", "REF", "PROTOCOL", "FILE", "AUTHORITY",
         "USERINFO")


def test_parse_url_every_part_and_a_query_key():
    data = pa.table({"u": pa.array(URLS)})
    jt, ptt = project(data, lambda F: [F.parse_url(F.col("u"), p)
                                       for p in PARTS]
                      + [F.parse_url(F.col("u"), "QUERY", "nation"),
                         F.parse_url(F.col("u"), "QUERY", "y")], HOST)
    assert_same(jt, ptt, "parse_url")
    assert ptt.column("c8").to_pylist() == [None, "7", None, None, None, "",
                                            "FR%20A", None, "1"]


def test_a_json_filter_runs_on_the_device():
    docs = ['{"n": 5}', '{"n": 50}', '{"n": 2}', None, '{"m": 9}']
    data = pa.table({"j": pa.array(docs), "i": pa.array([1, 2, 3, 4, 5])})
    outs = [s.create_dataframe(data).filter(
        F.get_json_object(F.col("j"), "$.n").cast("int") > 3)
        .select("i").to_arrow() for s, F in (
            (st.TpuSession(JAX_CONF), JF),
            (pt.TpuSession(JAX_CONF, device="cpu"), PF))]
    assert outs[0].equals(outs[1])
    assert sorted(outs[1].column("i").to_pylist()) == [1, 2]


AUDIT_CASES = {
    "from_json": lambda F, dt: F.from_json(F.col("j"), _schema(dt)),
    "to_json": lambda F, dt: F.to_json(F.col("j")),
    "parse_url": lambda F, dt: F.parse_url(F.col("j"), "HOST"),
    "wildcard": lambda F, dt: F.get_json_object(F.col("j"), "$.a[*]"),
    "scalar": lambda F, dt: F.get_json_object(F.col("j"), "$.a"),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_verdicts_and_validate_text_equal_jax(case):
    texts, verdicts = [], []
    for s, F, dt in ((st.TpuSession(HOST), JF, jdt),
                     (pt.TpuSession(HOST, device="cpu"), PF, pdt)):
        q = s.create_dataframe(DATA).select(
            AUDIT_CASES[case](F, dt).alias("x"))
        with contextlib.redirect_stdout(io.StringIO()):
            # lore ids compared too: both planners number the converted
            # tree alike (pre-order, before the JAX fusion pass)
            lines = q.explain("VALIDATE").splitlines()
        if "-- fused stages --" in lines:
            lines = lines[:lines.index("-- fused stages --")]
        texts.append(lines)
        verdicts.append([ln.split(" ", 1)[0] for ln in lines
                         if ln.startswith(("will_fallback", "will_not_work",
                                           "ok"))])
    assert texts[1] == texts[0]
    want = [] if case == "scalar" else ["will_fallback"]
    assert verdicts[1] == verdicts[0] == want


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)
