"""The port's type-signature registry (`plan/typesig.py`) against the JAX
package's: the same signatures, the same audit refinements, the same
error text with its bind-site suffix, and the same supported-expressions
table."""
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu.plan import typesig as jsig
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.expr.expressions import (
    UnsupportedExpr as PUnsupported)
from spark_rapids_tpu_torch.plan import typesig as psig

OFF = {"spark.rapids.tpu.sql.allowCpuFallback": False,
       "spark.rapids.tpu.sql.exec.degradeToHost.enabled": False}


def _classes(sig):
    return sorted(c.__name__ for c in sig.classes)


#: the one registry note that differs on purpose: the JAX package runs
#: an uncompiled UDF through jax.pure_callback, the port through a host
#: call (expr/udf.py)
PYUDF_NOTE = ("AST-compiled to expressions when possible, else a host "
              "call over numpy (udf-compiler analog)")


def test_every_signature_equals_the_jax_registry():
    assert sorted(psig.SIGS) == sorted(jsig.SIGS)
    for name, (sig, desc) in jsig.SIGS.items():
        psig_, pdesc = psig.SIGS[name]
        assert _classes(psig_) == _classes(sig), name
        want = PYUDF_NOTE if name == "PyUDF" else desc
        assert (psig_.note, pdesc) == (sig.note, want), name
        assert psig_.describe() == sig.describe(), name
    assert "pure_callback" in jsig.SIGS["PyUDF"][1]


def test_audit_checks_equal_the_jax_ones():
    assert sorted(psig.AUDIT_CHECKS) == sorted(jsig.AUDIT_CHECKS)
    for name in jsig.AUDIT_CHECKS:
        for jd, pd in ((jdt.DecimalType(30, 2), pdt.DecimalType(30, 2)),
                       (jdt.DecimalType(10, 2), pdt.DecimalType(10, 2)),
                       (jdt.FLOAT64, pdt.FLOAT64)):
            assert psig.audit_check(name, pd) == jsig.audit_check(name, jd)


def test_supported_ops_table_equals_the_jax_one():
    j = jsig.generate_supported_ops().splitlines()
    p = psig.generate_supported_ops().splitlines()
    assert len(p) == len(j) == len(jsig.SIGS) + 6
    # the header names each package's own module; every row is equal
    # but PyUDF's note (PYUDF_NOTE)
    assert "spark_rapids_tpu_torch/plan/typesig.py" in p[2]
    assert p[:2] == j[:2]
    for jl, pl in zip(j[3:], p[3:]):
        if jl.startswith("PyUDF |"):
            assert pl == jl.rsplit(" | ", 1)[0] + " | " + PYUDF_NOTE
        else:
            assert pl == jl


@pytest.mark.parametrize("name,jd,pd", [
    ("IsNaN", jdt.INT64, pdt.INT64),
    ("Upper", jdt.INT32, pdt.INT32),
    ("Hour", jdt.DATE, pdt.DATE),
    ("Sum", jdt.STRING, pdt.STRING),
])
@pytest.mark.parametrize("where", ["", "Project expr 'x'"])
def test_check_error_text_equals_the_jax_text(name, jd, pd, where):
    with pytest.raises(JUnsupported) as je:
        jsig.check(name, jd, where=where)
    with pytest.raises(PUnsupported) as pe:
        psig.check(name, pd, where=where)
    assert str(pe.value) == str(je.value)
    assert psig._at(where, 7) == jsig._at(where, 7)


@pytest.mark.parametrize("build,where", [
    (lambda F: F.hash(F.col("arr")).alias("h"), "at Project expr 'h'"),
    # the binder refuses first, in both, without a site
    (lambda F: F.upper(F.col("i")).alias("u"), "upper on long"),
])
def test_check_tree_refusal_names_the_bind_site_as_jax_does(build, where):
    """With the fallback off, a refusal at a Project's bind site raises
    the same text in both packages: the registry's, with the site, where
    the binder lets the expression through to the signature."""
    data = {"arr": pa.array([[1, 2], [3]]), "i": pa.array([1, 2])}
    with pytest.raises(JUnsupported) as je:
        st.TpuSession(OFF).create_dataframe(data).select(build(JF)) \
            .to_arrow()
    with pytest.raises(PUnsupported) as pe:
        pt.TpuSession(OFF, device="cpu").create_dataframe(data).select(
            build(PF)).to_arrow()
    assert str(pe.value) == str(je.value)
    assert where in str(pe.value)


def test_aggregate_key_refusal_names_the_bind_site():
    data = {"arr": pa.array([[1, 2], [3]]), "v": pa.array([1, 2])}
    msgs = []
    for s, F, exc in ((st.TpuSession(), JF, JUnsupported),
                      (pt.TpuSession(device="cpu"), PF, PUnsupported)):
        with pytest.raises(exc) as e:
            s.create_dataframe(data).group_by(
                F.hash(F.col("arr")).alias("h")).agg(
                F.sum(F.col("v")).alias("s"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "at Aggregate key 'h'" in msgs[1]
