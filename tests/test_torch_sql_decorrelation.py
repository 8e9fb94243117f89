"""Correlated scalar-subquery decorrelation in the port's SQL frontend,
the statements of the JAX package's `tests/test_sql_decorrelation.py`
through both packages: the LEFT-join decorrelation with a COUNT-shaped
empty group read as 0, the guarded no-aggregate rejection, and the
refusal of subquery markers outside a WHERE conjunct, with the same
error text."""
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu.sql.parser import register_view as j_register
from spark_rapids_tpu_torch.expr.expressions import (
    UnsupportedExpr as PUnsupported)
from spark_rapids_tpu_torch.sql.parser import register_view as p_register

A = {"k": pa.array([1, 2, 3, 4, 5]), "av": pa.array([10, 20, 30, 40, 50])}
B = {"bk": pa.array([1, 1, 2]), "bv": pa.array([7, 8, 9])}


@pytest.fixture(scope="module")
def env():
    js, ps = st.TpuSession({}), pt.TpuSession({}, device="cpu")
    for s, reg in ((js, j_register), (ps, p_register)):
        reg(s, "a", s.create_dataframe(A))
        reg(s, "b", s.create_dataframe(B))
    return js, ps


ANSWERS = {
    "count_star_empty_group_keeps_outer_rows": ("""
        select k from a
        where (select count(*) from b where bk = k) = 0
        order by k""", [3, 4, 5]),
    "count_nonzero_comparison_matches": ("""
        select k from a
        where (select count(bv) from b where bk = k) = 2
        order by k""", [1]),
    "non_count_aggregate_null_drops_unmatched": ("""
        select k from a
        where (select sum(bv) from b where bk = k) > 0
        order by k""", [1, 2]),
    "correlated_max_beside_a_plain_conjunct": ("""
        select k, av from a
        where av > 5 and k = (select max(bk) from b where bk = k)
        order by k""", [1, 2]),
}


@pytest.mark.parametrize("name", list(ANSWERS))
def test_decorrelated_answer_equals_jax(env, name):
    sql, keys = ANSWERS[name]
    js, ps = env
    jt, pt_ = js.sql(sql).to_arrow(), ps.sql(sql).to_arrow()
    assert pt_.equals(jt)
    assert pt_.column("k").to_pylist() == keys


REJECTED = {
    "unguarded_no_aggregate_subquery": ("""
        select k from a
        where (select bv from b where bk = k) > 0""", "aggregate"),
    "bare_scalar_subquery_conjunct":
        ("select k from a where (select max(bk) from b)", "comparison"),
    "subquery_in_select_list":
        ("select exists (select bk from b where bk = k) from a", None),
    "subquery_in_having": ("""
        select k, count(*) as c from a group by k
        having k in (select bk from b)""", None),
    "subquery_in_join_on": ("""
        select * from a join b
        on k = (select max(bk) from b)""", None),
    "marker_in_or_tree": ("""
        select k from a
        where k = 9 or exists (select bk from b where bk = k)""", None),
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_rejection_equals_jax(env, name):
    sql, match = REJECTED[name]
    js, ps = env
    with pytest.raises(JUnsupported) as je:
        js.sql(sql)
    with pytest.raises(PUnsupported) as pe:
        ps.sql(sql)
    assert str(pe.value) == str(je.value)
    if match:
        assert match in str(pe.value)
