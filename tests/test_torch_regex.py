"""rlike, regexp_extract and regexp_replace in the port against the JAX
package (`expr/regex_exprs.py`, `ops/regex_exec.py`, the NFA of
`ops/regex_nfa.py`): the JAX tests' pattern lists (`tests/test_regex.py`)
with the host fallback off on both sides, exact; the patterns outside
the NFA subset refused with the fallback off and answered on the host
with it on, in both packages; Java-malformed patterns raising in both;
and the fuzz of `tests/test_regex_fuzz.py` (seeds 5, 17, 29) against
the JAX package and Python `re`."""
import contextlib
import io
import random
import re

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu.ops.regex_nfa import RegexSyntaxError as JSyntax
from spark_rapids_tpu_torch.exec.host_fallback import HostProjectExec
from spark_rapids_tpu_torch.expr.expressions import (
    UnsupportedExpr as PUnsupported)
from spark_rapids_tpu_torch.ops.regex_nfa import RegexSyntaxError as PSyntax
from torch_parity import JAX_CONF, assert_same, project, sessions

STRINGS = ["", "a", "abc", "aX9", "hello world", "2024-01-31",
           "foo=123;bar", "aaab", "xyzzy", "a1b2c3", "  pad  ",
           "CAPS and lower", "tail\n", "line1\nline2", "9" * 40,
           None, "ab" * 30, "x=;", "=1;", "foo=;",
           # past MAX_SCAN (256 bytes): a match there is missed alike
           "x" * 300 + "abc", "y" * 255 + "2024-01-31"]
DATA = pa.table({"s": pa.array(STRINGS, pa.string())})

RLIKE_PATTERNS = [r"abc", r"^a", r"[0-9]+", r"^[a-z]+$", r"\d{2}-\d{2}",
                  r"foo|bar", r"a+b", r"^\s*pad\s*$", r"l.ne", r"(ab)+",
                  r"x?y?z{2}", r"^$", r"[^a-z]", r"\w+=\d*;", r"x*",
                  r"(?:a|b)+c$"]
REPLACE_CASES = [(r"[0-9]+", "#"), (r"a", "AA"), (r"\s+", "_"), (r"ab", ""),
                 (r"l.ne", "LINE"), (r"foo|bar", "Z"), (r"x*", "-"),
                 (r"[aeiou]+", "")]
EXTRACT_CASES = [(r"[0-9]+", 0), (r"^[a-z]+", 0), (r"foo=([0-9]*);", 1),
                 (r"=(\d*);", 1), (r"(\d{4})-(\d{2})", 1), (r"l.ne", 0),
                 (r"x*", 0), (r"(\d{4})-(\d{2})", 2)]


@pytest.mark.parametrize("pat", RLIKE_PATTERNS)
def test_rlike_equals_jax(pat):
    jt, ptt = project(DATA, lambda F: [F.rlike(F.col("s"), pat),
                                       F.col("s").rlike(pat)])
    assert_same(jt, ptt, pat)


@pytest.mark.parametrize("pat,repl", REPLACE_CASES)
def test_regexp_replace_equals_jax(pat, repl):
    jt, ptt = project(DATA, lambda F: [F.regexp_replace(F.col("s"), pat,
                                                        repl)])
    assert_same(jt, ptt, (pat, repl))


@pytest.mark.parametrize("pat,idx", EXTRACT_CASES)
def test_regexp_extract_equals_jax(pat, idx):
    jt, ptt = project(DATA, lambda F: [F.regexp_extract(F.col("s"), pat,
                                                        idx)])
    assert_same(jt, ptt, (pat, idx))


def test_rlike_in_a_filter_over_batches():
    """A filter over several batches (the scan bound is each batch's
    longest row), against the JAX package and `re`."""
    js, ps = sessions({"spark.rapids.tpu.sql.batchSizeRows": 4})
    outs = [s.create_dataframe(DATA).filter(F.rlike(F.col("s"), r"^\w+$"))
            .to_arrow().column("s").to_pylist() for s, F in ((js, JF),
                                                             (ps, PF))]
    # `re` has no scan bound: a row past MAX_SCAN bytes matches there
    want = [s for s in STRINGS if s is not None and len(s) <= 256
            and re.search(r"^\w+$", s)]
    assert outs[0] == outs[1] and sorted(outs[1]) == sorted(want)


UNSUPPORTED = [r"a*?", r"\bworld", r"(a)b\1", r"a{65}b", r"a|b$", r"^a|b"]


def _host_session(pkg, fallback):
    conf = {**JAX_CONF, "spark.rapids.tpu.sql.allowCpuFallback": fallback}
    return st.TpuSession(conf) if pkg == "jax" else pt.TpuSession(
        conf, device="cpu")


@pytest.mark.parametrize("pat", UNSUPPORTED)
def test_unsupported_pattern_refused_then_answered_on_the_host(pat):
    for pkg, F, err in (("jax", JF, JUnsupported), ("port", PF,
                                                    PUnsupported)):
        with pytest.raises(err):
            _host_session(pkg, False).create_dataframe(DATA).select(
                F.rlike(F.col("s"), pat).alias("m")).to_arrow()
    outs = []
    for pkg, F in (("jax", JF), ("port", PF)):
        q = _host_session(pkg, True).create_dataframe(DATA).select(
            F.rlike(F.col("s"), pat).alias("m"),
            F.regexp_extract(F.col("s"), pat, 0).alias("e"),
            F.regexp_replace(F.col("s"), pat, "<>").alias("r"))
        outs.append(q.to_arrow())
        if pkg == "port":
            assert any(isinstance(n, HostProjectExec)
                       for n in _nodes(q.physical_plan()[0]))
    assert_same(outs[0], outs[1], pat)
    assert outs[1].column("m").to_pylist() == [
        None if s is None else bool(re.search(pat, s)) for s in STRINGS]


def test_group_references_and_dollar_groups_go_to_the_host():
    outs = []
    for pkg, F in (("jax", JF), ("port", PF)):
        outs.append(_host_session(pkg, True).create_dataframe(DATA).select(
            F.regexp_replace(F.col("s"), r"(\d+)", r"<$1>").alias("r"),
            F.regexp_replace(F.col("s"), r"a", r"\$").alias("d"),
            F.regexp_extract(F.col("s"), r"=(\d*);$", 1).alias("e"))
            .to_arrow())
    assert_same(outs[0], outs[1], "host")
    assert outs[1].column("r").to_pylist() == [
        None if s is None else re.sub(r"(\d+)", r"<\1>", s)
        for s in STRINGS]


@pytest.mark.parametrize("pat", [r"\xZZ", r"a{x}", r"a{1,2,3}", r"a{-2}",
                                 r"a{3,1}", r"(a", r"*a", r"[z-a]"])
def test_java_malformed_patterns_raise_in_both(pat):
    for s, F, err in ((_host_session("jax", True), JF, JSyntax),
                      (_host_session("port", True), PF, PSyntax)):
        with pytest.raises(err):
            s.create_dataframe(DATA).select(
                F.rlike(F.col("s"), pat).alias("m")).to_arrow()


def test_explain_names_the_host_node():
    for pkg, F in (("jax", JF), ("port", PF)):
        df = _host_session(pkg, True).create_dataframe(DATA).select(
            F.rlike(F.col("s"), r"a*?").alias("m"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            df.explain("NOT_ON_TPU")
        text = buf.getvalue()
        assert "will run on CPU because" in text, pkg
        assert "lazy quantifiers" in text, pkg


def test_step_tables_equal_the_state_loop():
    """The port's table step gives the JAX loop's bits (`_advance`: one
    OR of a state's transitions per set state) for random states."""
    import torch

    from spark_rapids_tpu_torch.ops.regex_exec import _Stepper
    from spark_rapids_tpu_torch.ops.regex_nfa import compile_nfa
    rng = np.random.default_rng(1)
    for pat in (r"(ab|cd)+e{2,4}[x-z]", r"\d{2}-\d{2}-\w+", r"a(b(c(d)?)?)?",
                r"[^a]{3,9}\s+(x|y|z)*q"):
        rx = compile_nfa(pat)
        states = rng.integers(0, 1 << rx.n_states, 4000)
        byts = rng.integers(0, 256, 4000)
        want = np.zeros(4000, np.int64)
        cls = rx.class_table[byts]
        for s in range(rx.n_states):
            on = ((states >> s) & 1).astype(bool)
            want |= np.where(on, rx.trans[s][cls].astype(np.int64), 0)
        got = _Stepper(rx, torch.device("cpu")).advance(
            torch.from_numpy(states), torch.from_numpy(byts))
        assert np.array_equal(got.numpy(), want), pat


# -- the fuzz of tests/test_regex_fuzz.py ------------------------------
_LITS = list("abcXY01 _")


def _atom(rng, depth):
    r = rng.random()
    if r < 0.35:
        return rng.choice(_LITS)
    if r < 0.5:
        return "."
    if r < 0.62:
        return rng.choice([r"\d", r"\w", r"\s", r"\D", r"\W", r"\S"])
    if r < 0.78:
        neg = "^" if rng.random() < 0.3 else ""
        members = "".join(rng.sample("abcxyz019", rng.randint(1, 3)))
        if rng.random() < 0.4:
            members += "a-f" if rng.random() < 0.5 else "0-5"
        return f"[{neg}{members}]"
    if depth > 0:
        return "(" + _seq(rng, depth - 1) + ")"
    return rng.choice(_LITS)


def _piece(rng, depth):
    a = _atom(rng, depth)
    r = rng.random()
    if r < 0.25:
        return a + rng.choice(["*", "+", "?"])
    if r < 0.32:
        m = rng.randint(1, 3)
        if rng.random() < 0.5:
            return a + f"{{{m}}}"
        return a + f"{{{m},{m + rng.randint(0, 2)}}}"
    return a


def _seq(rng, depth):
    n = rng.randint(1, 4)
    s = "".join(_piece(rng, depth) for _ in range(n))
    if depth > 0 and rng.random() < 0.25:
        s = s + "|" + _seq(rng, depth - 1)
    return s


def _pattern(rng):
    p = _seq(rng, 2)
    if rng.random() < 0.3:
        p = "^" + p
    if rng.random() < 0.3:
        p = p + "$"
    return p


def _fuzz_data(rng, n=150):
    out = []
    for _ in range(n):
        k = rng.randint(0, 8)
        out.append("".join(rng.choice("abcxyzXY019 _.") for _ in range(k)))
    out += ["", "a", "abc", "aaaa", "0x9", None]
    return out


@pytest.mark.parametrize("seed", [5, 17, 29])
def test_fuzz_equals_jax_and_re(seed):
    rng = random.Random(seed)
    data = _fuzz_data(rng)
    js, ps = sessions()
    jdf = js.create_dataframe({"t": pa.array(data, pa.string())})
    pdf = ps.create_dataframe({"t": pa.array(data, pa.string())})
    ran = 0
    for _ in range(60):
        pat = _pattern(rng)
        try:
            want = jdf.select(JF.col("t").rlike(pat).alias("m"),
                              JF.regexp_extract("t", pat, 0).alias("e"),
                              JF.regexp_replace("t", pat, "#").alias("r")) \
                .to_arrow()
        except JUnsupported:
            with pytest.raises(PUnsupported):
                pdf.select(PF.col("t").rlike(pat).alias("m")).to_arrow()
            continue
        got = pdf.select(PF.col("t").rlike(pat).alias("m"),
                         PF.regexp_extract("t", pat, 0).alias("e"),
                         PF.regexp_replace("t", pat, "#").alias("r")) \
            .to_arrow()
        assert_same(want, got, pat)
        creg = re.compile(pat)
        assert got.column("m").to_pylist() == [
            None if t is None else bool(creg.search(t)) for t in data], pat
        ran += 1
    assert ran >= 25, ran


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)
