"""CONTAINS, STARTSWITH, ENDSWITH, LIKE and SUBSTRING of the PyTorch port
(on the CPU) against the JAX package.

Each expression is built in both packages over one Arrow table of
strings (about 15 % nulls; the empty string, multi-byte UTF-8, the
bytes `_` and `%` as data, words that overlap a pattern, rows shorter
than it) and selected or filtered through a DataFrame; the Arrow
results must be equal (exact). Substring counts bytes, and the JAX
package cannot hand back a row cut inside a character, so substring
runs over an ASCII column. Covered: the `_` wildcard, the empty pattern
(every row matches), `%`-only patterns, LIKE without `%`, two middle
runs matched each on its own (the reference's over-match:
`docs/compatibility.md`), the prefix and suffix runs' bounds on a middle
run, binary columns; substring at each start (positive, 0, negative,
past either end) and length (None, negative, 0, short, past the end),
also through a filter and a group key. A pattern with `\\`, a
non-literal pattern and a non-string column are refused at bind in both
packages.
"""
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.expr import expressions as jx
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.expr import expressions as px
from spark_rapids_tpu_torch.ops import strings as ops_str
from spark_rapids_tpu_torch.ops.kernel_utils import CV

N = 2000
WORDS = ["", "a", "ab", "abc", "special requests", "requests special",
         "specialrequests", "special", "requests", "a_c", "a%c", "abcabc",
         "PROMO BRASS", "PROMO", "forest green", "greenforest", "é",
         "naïve café", "xx special yy requests zz", "aaaa", "abab"]

JAX = types.SimpleNamespace(col=jx.col, lit=jx.lit, F=JF)
PORT = types.SimpleNamespace(col=px.col, lit=px.lit, F=PF)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(4)
    pick = np.array(WORDS, dtype=object)[rng.integers(0, len(WORDS), N)]
    return pa.table({
        "s": pa.array(pick, pa.string(), mask=rng.random(N) < 0.15),
        "b": pa.array([w.encode() for w in pick], pa.binary()),
        "t": pa.array([w.encode("ascii", "ignore").decode() for w in pick],
                      pa.string(), mask=rng.random(N) < 0.15),
        "k": pa.array(rng.integers(0, 4, N).astype(np.int64))})


def _both(table, build, conf=None):
    """(port, JAX) Arrow results of build(E, df)."""
    got = build(PORT, pt.TpuSession(dict(conf or {}), device="cpu")
                .create_dataframe(table)).to_arrow()
    exp = build(JAX, st.TpuSession(dict(conf or {}))
                .create_dataframe(table)).to_arrow()
    return got, exp


PREDICATES = {
    "contains": lambda E: E.F.contains(E.col("s"), "ab"),
    "contains_wildcard_is_literal": lambda E: E.F.contains(E.col("s"), "_"),
    "contains_empty": lambda E: E.F.contains(E.col("s"), ""),
    "contains_long": lambda E: E.F.contains(E.col("s"), "x" * 40),
    "contains_utf8": lambda E: E.F.contains(E.col("s"), "ï"),
    "startswith": lambda E: E.F.startswith(E.col("s"), "PROMO"),
    "startswith_empty": lambda E: E.F.startswith(E.col("s"), ""),
    "endswith": lambda E: E.F.endswith(E.col("s"), "BRASS"),
    "endswith_whole": lambda E: E.F.endswith(E.col("s"), "abc"),
    "method_contains": lambda E: E.col("s").contains("green"),
    "method_startswith": lambda E: E.col("s").startswith("forest"),
    "method_endswith": lambda E: E.col("s").endswith("special"),
    "binary_contains": lambda E: E.F.contains(E.col("b"), b"ab"),
    "like_two_middles": lambda E: E.F.like(E.col("s"),
                                           "%special%requests%"),
    "like_prefix_suffix": lambda E: E.F.like(E.col("s"), "ab%c"),
    "like_prefix_middle_suffix": lambda E: E.F.like(E.col("s"),
                                                    "a%b%c"),
    "like_bounds_exclude_prefix": lambda E: E.F.like(E.col("s"),
                                                     "ab%ab%"),
    "like_no_percent": lambda E: E.F.like(E.col("s"), "abc"),
    "like_no_percent_wildcard": lambda E: E.F.like(E.col("s"), "a_c"),
    "like_empty": lambda E: E.F.like(E.col("s"), ""),
    "like_only_percent": lambda E: E.F.like(E.col("s"), "%%"),
    "like_wildcards": lambda E: E.F.like(E.col("s"), "%_e_%"),
    "like_suffix": lambda E: E.col("s").like("%special"),
    "like_prefix": lambda E: E.col("s").like("requests%"),
    "like_utf8": lambda E: E.F.like(E.col("s"), "%café"),
    "not_like": lambda E: ~E.F.like(E.col("s"), "%special%requests%"),
}


@pytest.mark.parametrize("name", list(PREDICATES))
def test_predicate_equals_jax(table, name):
    got, exp = _both(table, lambda E, df: df.select(
        E.col("k"), PREDICATES[name](E).alias("r")))
    assert got.equals(exp)


@pytest.mark.parametrize("name", ["like_two_middles", "not_like",
                                  "startswith", "contains_empty"])
def test_predicate_filter_equals_jax(table, name):
    got, exp = _both(table, lambda E, df: df.filter(PREDICATES[name](E))
                     .select(E.col("s"), E.col("k")))
    assert got.num_rows and got.equals(exp)


def test_like_middle_runs_match_each_on_its_own(table):
    """The reference's LIKE checks each middle run for containment on
    its own, so runs out of order match (docs/compatibility.md)."""
    got, _ = _both(table, lambda E, df: df.select(
        E.col("s"), E.F.like(E.col("s"), "%special%requests%").alias("r")))
    by_word = dict(zip(got.column("s").to_pylist(),
                       got.column("r").to_pylist()))
    assert by_word["requests special"] is True
    assert by_word["specialrequests"] is True
    assert by_word["special"] is False


STARTS = [-30, -5, -1, 0, 1, 2, 3, 7, 30]
LENGTHS = [None, -2, 0, 1, 3, 40]


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("start", STARTS)
def test_substring_equals_jax(table, start, length):
    got, exp = _both(table, lambda E, df: df.select(
        E.F.substring(E.col("t"), start, length).alias("sub"),
        E.col("t").substr(start, length).alias("m")))
    assert got.equals(exp)


def test_substring_under_a_filter_and_as_a_group_key(table):
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 256}
    got, exp = _both(table, lambda E, df: df.filter(
        E.F.startswith(E.col("t"), "a")).group_by(
        E.F.substring(E.col("t"), 1, 2).alias("p")).agg(
        E.F.count("*").alias("n")).sort("p"), conf)
    assert got.num_rows and got.equals(exp)


def test_substring_lengths_sum_to_the_last_offset():
    """Rows are the clipped ranges: no negative length, the offsets end
    at the sum of the lengths, and the bytes past it are zero."""
    words = [b"abcdef", b"", b"xy", b"hello world"]
    raw = b"".join(words)
    off = np.cumsum([0] + [len(w) for w in words]).astype(np.int32)
    cv = CV(torch.frombuffer(bytearray(raw), dtype=torch.uint8),
            torch.ones(len(words), dtype=torch.bool),
            torch.from_numpy(off))
    # a negative start past the front starts at the front and keeps the
    # whole length, as the JAX package does ("xy" at -3 for 2 is "xy";
    # Spark gives "x")
    for start, length, want in ((-3, 2, [b"de", b"", b"xy", b"rl"]),
                                (-20, None, words),
                                (5, 10, [b"ef", b"", b"", b"o world"]),
                                (2, -1, [b""] * 4)):
        out = ops_str.substring(cv, start, length)
        o = out.offsets.tolist()
        got = [bytes(out.data[o[i]:o[i + 1]].tolist())
               for i in range(len(words))]
        assert got == want
        assert o[-1] == sum(len(w) for w in want)
        assert not out.data[o[-1]:].any()


OFF = {"spark.rapids.tpu.sql.allowCpuFallback": False,
       "spark.rapids.tpu.sql.exec.degradeToHost.enabled": False}


@pytest.mark.parametrize("fallback", ["off", "on"])
@pytest.mark.parametrize("build", [
    lambda E: E.F.like(E.col("s"), "a\\%"),
    lambda E: E.F.contains(E.col("s"), E.col("s")),
    lambda E: E.F.startswith(E.col("k"), "a"),
])
def test_refused_like_the_jax_package(table, build, fallback):
    """The device expressions of both packages refuse these at bind.
    With the host fallback off the port refuses the query as the JAX
    package does; with it on (the default) both answer on the host
    alike: the escape and the column pattern exactly, and startswith
    over an int with the same AttributeError of the reference's host
    rule (ROADMAP C.29)."""
    with pytest.raises(jx.UnsupportedExpr):
        build(JAX).bind(st.TpuSession().create_dataframe(table)._plan.schema)
    conf = OFF if fallback == "off" else {}
    jq = st.TpuSession(dict(conf)).create_dataframe(table).select(
        build(JAX).alias("r"))
    pq = pt.TpuSession(dict(conf), device="cpu").create_dataframe(
        table).select(build(PORT).alias("r"))
    if fallback == "off":
        with pytest.raises(jx.UnsupportedExpr) as je:
            jq.to_arrow()
        with pytest.raises(px.UnsupportedExpr) as pe:
            pq.to_arrow()
        assert str(pe.value) == str(je.value)
        return
    try:
        want = jq.to_arrow()
    except AttributeError as e:
        with pytest.raises(AttributeError, match=str(e)):
            pq.to_arrow()
        return
    assert pq.to_arrow().equals(want)
