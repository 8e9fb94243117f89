"""Python UDFs and the UDF compiler (`expr/udf.py`,
`expr/udf_compiler.py`, ROADMAP A.12) against the JAX package.

The cases of the JAX `tests/test_udf_compiler.py` and
`tests/test_udf_distinct.py` run through both packages over the same
numpy-made columns (seeded), at the parity conf (`torch_parity.py`: host
fallback and degrade-to-host off, so each package's own path answers).
Rows are exact (but a square root within one ulp, as stated where it is
compared): the compiled trees are integer arithmetic, and the host
calls run the same numpy function. The
compiled tree is also held against the host call of the same function
(`compile=False`), bit for bit."""
import contextlib
import decimal
import io

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as PF
import torch_udf_fns as fns
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr.udf import PyUDF as JPyUDF
from spark_rapids_tpu.expr.udf_compiler import CompileError as JCompileError
from spark_rapids_tpu.expr.udf_compiler import compile_udf as jcompile
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.expr.expressions import UnsupportedExpr
from spark_rapids_tpu_torch.expr.udf import PyUDF as PPyUDF
from spark_rapids_tpu_torch.expr.udf_compiler import CompileError
from spark_rapids_tpu_torch.expr.udf_compiler import compile_udf
from spark_rapids_tpu_torch.utils import transfer
from torch_parity import sessions, ulps

SMALL = {"spark.rapids.tpu.sql.batchSizeRows": 128}


def _ints(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": pa.array(rng.integers(-50, 50, n)),
            "y": pa.array(rng.integers(1, 20, n))}


def _both(data, build, conf=SMALL):
    """(JAX table, port table) of `build(F, dt)` selected over data."""
    js, ps = sessions(conf)
    outs = []
    for s, F, dt in ((js, JF, jdt), (ps, PF, pdt)):
        outs.append(s.create_dataframe(data).select(
            *[e.alias(f"c{i}") for i, e in enumerate(build(F, dt))])
            .to_arrow())
    return outs


#: (function, return type name, argument columns, numpy reference)
COMPILED = {
    "arith": (fns.arith, "INT64", ("x", "y"), lambda x, y: x * 2 + y - 1),
    "clamped": (fns.clamped, "INT64", ("x", "y"), np.maximum),
    "abs_plus_one": (fns.abs_plus_one, "INT64", ("x",),
                     lambda x: np.abs(x) + 1),
    "root": (fns.root, "FLOAT64", ("y",), np.sqrt),
    "plus_k": (fns.plus_k, "INT64", ("x",), lambda x: x + 7),
    "chain_compare": (fns.chain_compare, "BOOL", ("x", "y"),
                      lambda x, y: (0 < x) & (x <= y)),
    "null_or_neg": (fns.null_or_neg, "INT64", ("x",), lambda x: -x),
    "mixed": (fns.mixed, "INT64", ("x", "y"),
              lambda x, y: np.where((x > 0) & ~(y > 10),
                                    np.maximum(x, y) - np.minimum(x, y),
                                    np.fmod(x, 3))),
}


#: the compiled functions that numpy arrays can also run as a host call
HOST_CALLABLE = ("arith", "abs_plus_one", "plus_k")


@pytest.mark.parametrize("name", sorted(COMPILED))
def test_compiled_udf_equals_jax_numpy_and_the_host_call(name):
    fn, rt, args, ref = COMPILED[name]
    data = _ints(seed=len(name))
    # both compilers translate it (no PyUDF in either tree)
    assert not isinstance(JF.udf(fn, getattr(jdt, rt))(
        *[JF.col(a) for a in args]), JPyUDF)
    assert not isinstance(PF.udf(fn, getattr(pdt, rt))(
        *[PF.col(a) for a in args]), PPyUDF)
    j, p = _both(data, lambda F, dt: [F.udf(fn, getattr(dt, rt))(
        *[F.col(a) for a in args])])
    want = np.asarray(ref(*[data[a].to_numpy() for a in args]))
    if name == "root":
        # torch's CPU sqrt is within one ulp of the correctly rounded
        # one that numpy and XLA give (sqrt(8) one ulp low); CUDA's
        # double sqrt is correctly rounded
        assert ulps(want, p.column(0).to_numpy()).max() <= 1
        assert j.column(0).to_pylist() == want.tolist()
        return
    assert p.column(0).to_pylist() == want.tolist()
    assert p.equals(j)
    # the compiled tree against the host call of the same function,
    # where fn also runs over numpy arrays (no `if`, no math.*):
    # bit-equal
    if name in HOST_CALLABLE:
        _, host = _both(data, lambda F, dt: [F.udf(
            fn, getattr(dt, rt), compile=False)(*[F.col(a) for a in args])])
        assert host.column(0).equals(p.column(0))


def test_uncompilable_falls_back_to_the_host_call():
    data = _ints(seed=4)
    assert isinstance(PF.udf(fns.weird, pdt.INT64)(PF.col("x")), PPyUDF)
    assert isinstance(JF.udf(fns.weird, jdt.INT64)(JF.col("x")), JPyUDF)
    transfer.syncs = 0
    j, p = _both(data, lambda F, dt: [F.udf(fns.weird, dt.INT64)(
        F.col("x"))])
    assert p.equals(j)
    x = data["x"].to_numpy()
    assert p.column(0).to_pylist() == (x * x).tolist()
    # one D2H of the children a batch: 3 batches of 128 rows
    assert transfer.syncs >= 3


def test_compiled_string_method_equals_jax():
    data = {"s": pa.array(["Hello", "wOrLd", None, ""])}
    j, p = _both(data, lambda F, dt: [F.udf(fns.upper, dt.STRING)(
        F.col("s"))])
    assert p.equals(j)
    assert p.column(0).to_pylist() == ["HELLO", "WORLD", None, ""]


@pytest.mark.parametrize("fn", [
    fns.loopy, fns.two_statements, fns.power, fns.floordiv, fns.keyword,
    fns.is_true, fns.unresolved, fns.not_constant, fns.weird])
def test_compile_errors_equal_jax(fn):
    with pytest.raises(JCompileError) as je:
        jcompile(fn, [JF.col("x")])
    with pytest.raises(CompileError) as pe:
        compile_udf(fn, [PF.col("x")])
    assert str(pe.value) == str(je.value)


def test_ambiguous_lambdas_and_arity_refuse_as_jax_does():
    f, g = (lambda a: a + 1), (lambda a: a - 1)  # noqa: E731
    for comp, col, err in ((jcompile, JF.col, JCompileError),
                           (compile_udf, PF.col, CompileError)):
        with pytest.raises(err, match="ambiguous lambda source"):
            comp(f, [col("x")])
        with pytest.raises(err, match="ambiguous lambda source"):
            comp(g, [col("x")])
        with pytest.raises(err, match="arity mismatch"):
            comp(fns.arith, [col("x")])


def test_df_udf_expands_inline():
    data = _ints(seed=5)

    def rel(a, b):
        return (a - b) * 10

    j, p = _both(data, lambda F, dt: [F.df_udf(rel)(F.col("x"),
                                                   F.col("y"))])
    assert p.equals(j)
    x, y = data["x"].to_numpy(), data["y"].to_numpy()
    assert p.column(0).to_pylist() == ((x - y) * 10).tolist()


def test_host_udf_over_nullable_ints_is_null_safe():
    """The JAX `test_py_udf_columnar`: np.gcd as a host call, a null in
    either argument gives null."""
    rng = np.random.default_rng(90)
    a = rng.integers(0, 1000, 700)
    b = rng.integers(0, 1000, 700)
    na, nb = rng.random(700) < 0.1, rng.random(700) < 0.1
    data = {"a": pa.array(a.astype(np.int32), mask=na),
            "b": pa.array(b.astype(np.int32), mask=nb)}
    j, p = _both(data, lambda F, dt: [F.udf(np.gcd, dt.INT32)(
        F.col("a"), F.col("b"))])
    assert p.equals(j)
    want = [None if x or y else int(np.gcd(u, v))
            for u, v, x, y in zip(a, b, na, nb)]
    assert p.column(0).to_pylist() == want


def test_udf_composes_with_the_pipeline():
    rng = np.random.default_rng(91)
    a = rng.integers(1, 100, 500)
    outs = []
    for s, F, dt in zip(sessions(SMALL), (JF, PF), (jdt, pdt)):
        triple = F.udf(fns.weird, dt.INT64)
        outs.append(s.create_dataframe({"a": pa.array(a)}).select(
            triple(F.col("a")).alias("t")).filter(F.col("t") > 150).agg(
            F.count("*").alias("n")).collect()[0][0])
    assert outs[0] == outs[1] == int(((a * a) > 150).sum())


def test_distinct_equals_jax():
    rng = np.random.default_rng(92)
    k = rng.integers(0, 10, 2000)
    s_ = rng.choice(["a", "b", "ab", "ba", None], 2000)
    data = {"k": pa.array(k), "s": pa.array(s_.tolist())}
    outs = []
    for s, _ in zip(sessions(SMALL), (JF, PF)):
        outs.append(sorted(map(tuple, s.create_dataframe(data).distinct()
                               .to_arrow().to_pylist()),
                           key=lambda t: (t[0], str(t[1]))))
    assert outs[0] == outs[1]
    assert len(outs[1]) == len(set(zip(k.tolist(), s_.tolist())))


def test_decimal_child_reaches_fn_unscaled():
    """A decimal child arrives as its unscaled integers (the column's
    data buffer), as the JAX `cv.data` does."""
    vals = [decimal.Decimal("12.34"), decimal.Decimal("-0.99"), None,
            decimal.Decimal("100.00")]
    data = {"d": pa.array(vals, pa.decimal128(10, 2))}
    j, p = _both(data, lambda F, dt: [F.udf(
        fns.decimal_cents, dt.INT64, compile=False)(F.col("d"))])
    assert p.equals(j)
    assert p.column(0).to_pylist() == [12, -1, None, 100]


def test_string_child_and_string_return_refuse_as_jax_does():
    data = {"s": pa.array(["a", "b"])}
    js, ps = sessions(SMALL)
    msgs = []
    for s, F, dt, exc in ((js, JF, jdt, Exception),
                          (ps, PF, pdt, UnsupportedExpr)):
        with pytest.raises(exc) as e:
            s.create_dataframe(data).select(F.udf(
                fns.weird, dt.INT64, compile=False)(F.col("s")).alias(
                "r")).to_arrow()
        msgs.append(str(e.value))
        with pytest.raises(exc, match="fixed-width"):
            F.udf(fns.weird, dt.STRING, compile=False)(F.col("s"))
    assert "PyUDF over strings round-1" in msgs[0]
    assert "PyUDF over strings round-1" in msgs[1]


def test_a_failing_udf_raises():
    _, ps = sessions(SMALL)
    df = ps.create_dataframe(_ints(n=10))
    with pytest.raises(ValueError, match="udf says no"):
        df.select(PF.udf(fns.boom, pdt.INT64)(PF.col("x")).alias(
            "r")).to_arrow()


def test_host_call_output_lies_on_the_session_device():
    _, ps = sessions(SMALL)
    out = ps.create_dataframe(_ints(n=50)).select(PF.udf(
        fns.weird, pdt.INT64)(PF.col("x")).alias("r")).to_torch()
    data, valid = out["r"]
    assert data.device == ps.device and valid.device == ps.device
    assert data.dtype.is_floating_point is False and len(data) == 50


def test_audit_verdict_of_an_uncompiled_udf_equals_jax_but_the_bridge():
    """A PyUDF the compiler could not translate is will_fallback in both
    audits; the JAX reason names jax.pure_callback, the port's the host
    call (ROADMAP C)."""
    data = _ints(n=10)
    lines = []
    for s, F, dt in zip(sessions(), (JF, PF), (jdt, pdt)):
        q = s.create_dataframe(data).select(
            F.udf(fns.weird, dt.INT64)(F.col("x")).alias("r"))
        with contextlib.redirect_stdout(io.StringIO()):
            lines.append(q.explain("VALIDATE").splitlines())
    j, p = lines
    assert p[0] == j[0] == "== PLAN AUDIT =="
    head = "will_fallback [loreId=1] Project: python UDF 'weird' in " \
        "Project expr 'r' was not AST-compiled: evaluates via "
    assert any(ln.startswith(head + "jax.pure_callback") for ln in j)
    assert any(ln.startswith(head + "a host call") for ln in p)
    assert p[1].split("<--")[0] == j[1].split("<--")[0]
