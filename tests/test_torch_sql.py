"""`TpuSession.sql` and temp views (`sql/parser.py`): the statements of the
JAX package's `tests/test_sql.py` through both packages over the same
Arrow tables, at each package's default conf, equal as Arrow tables
(a statement without ORDER BY compared sorted by every column)."""
import contextlib
import io

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.expr.expressions import UnsupportedExpr
from spark_rapids_tpu_torch.workloads import tpch


def _ints(rng, n, lo, hi):
    return pa.array(rng.integers(lo, hi, n), pa.int32())


def _views():
    rng = np.random.default_rng(100)
    return {
        "t": pa.table({"k": _ints(rng, 1000, 0, 5),
                       "v": _ints(rng, 1000, 0, 100)}),
        "l": pa.table({"id": _ints(rng, 300, 0, 50),
                       "x": _ints(rng, 300, -2**31, 2**31 - 1)}),
        "r": pa.table({"id": _ints(rng, 200, 0, 50),
                       "y": _ints(rng, 200, -2**31, 2**31 - 1)}),
        "e": pa.table({"a": pa.array([1, 2, 3, None]),
                       "s": pa.array(["x", "yy", "zzz", None])}),
        "f": pa.table({"s": ["apple", "banana", "apple", "cherry"]}),
        "h": pa.table({"k": [1, 1, 2, 2, 3], "v": [10, 20, 1, 2, 100]}),
        "base": pa.table({"k": [1, 1, 2, 2, 3], "v": [10, 20, 1, 2, 100]}),
        "base2": pa.table({"k": [1, 1, 2, 3], "v": [5, 7, 11, 13]}),
        "shad": pa.table({"x": [1, 2, 3]}),
        "lineitem": tpch.gen_lineitem(sf=0.002, seed=21, full=True),
        "supplier": tpch.gen_supplier(sf=0.01, seed=22),
    }


@pytest.fixture(scope="module")
def sessions():
    views = _views()
    out = []
    for s in (st.TpuSession(), pt.TpuSession(device="cpu")):
        for name, at in views.items():
            s.create_dataframe(at).create_or_replace_temp_view(name)
        out.append(s)
    return out


STATEMENTS = {
    "select_where_group_order":
        "SELECT k, sum(v) AS sv, count(*) AS n FROM t "
        "WHERE v > 10 GROUP BY k ORDER BY k",
    "join_using": "SELECT id, x, y FROM l JOIN r USING (id)",
    "expressions":
        "SELECT a * 2 + 1 AS b, CASE WHEN a >= 2 THEN 'big' ELSE 'small' "
        "END AS c, CAST(a AS string) AS d, length(s) AS ln FROM e "
        "WHERE a IS NOT NULL",
    "distinct_like": "SELECT DISTINCT s FROM f WHERE s LIKE 'a%'",
    "order_limit": "SELECT s FROM f ORDER BY s LIMIT 2",
    "having": "SELECT k, sum(v) AS sv FROM h GROUP BY k "
              "HAVING sum(v) > 10 ORDER BY k",
    "single_cte":
        "WITH sums AS (SELECT k, sum(v) AS sv FROM base GROUP BY k) "
        "SELECT k, sv FROM sums WHERE sv > 10 ORDER BY k",
    "chained_ctes":
        "WITH s AS (SELECT k, sum(v) AS sv FROM base2 GROUP BY k), "
        "     big AS (SELECT k, sv FROM s WHERE sv > 10) "
        "SELECT k, sv FROM big ORDER BY k",
    "cte_shadows_a_view":
        "WITH shad AS (SELECT x FROM shad WHERE x > 1) "
        "SELECT x FROM shad ORDER BY x",
    "view_back_after_the_cte": "SELECT x FROM shad ORDER BY x",
    "tpch_q15_with_a_cte":
        "WITH revenue AS ("
        "    SELECT l_suppkey AS supplier_no,"
        "           sum(l_extendedprice * (1 - l_discount))"
        "               AS total_revenue"
        "    FROM lineitem GROUP BY l_suppkey) "
        "SELECT s_suppkey, s_name, total_revenue "
        "FROM supplier JOIN revenue ON s_suppkey = supplier_no "
        "WHERE total_revenue = (SELECT max(total_revenue) FROM revenue) "
        "ORDER BY s_suppkey",
    "unaliased_aggregates_and_arith":
        "SELECT k, sum(v), max(v) - min(v) AS spread, count(v) FROM t "
        "GROUP BY k ORDER BY k",
    "left_join_and_or":
        "SELECT l.id, x, y FROM l LEFT JOIN r ON l.id = r.id "
        "WHERE x > 0 OR y IS NULL",
    "between_in_not_like":
        "SELECT k, v FROM t WHERE v BETWEEN 20 AND 30 AND k IN (1, 3) "
        "AND NOT k = 2",
}


def _sorted(at):
    return at.sort_by([(n, "ascending") for n in at.column_names])


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_jax(sessions, name):
    sql = STATEMENTS[name]
    js, ps = sessions
    jt, pt_ = js.sql(sql).to_arrow(), ps.sql(sql).to_arrow()
    if "ORDER BY" not in sql.split(")")[-1]:
        jt, pt_ = _sorted(jt), _sorted(pt_)
    assert pt_.schema == jt.schema
    assert pt_.equals(jt), (jt.to_pylist()[:5], pt_.to_pylist()[:5])
    assert pt_.num_rows > 0


def test_the_results_the_jax_tests_expect(sessions):
    _, ps = sessions
    assert ps.sql(STATEMENTS["expressions"]).to_pydict() == {
        "b": [3, 5, 7], "c": ["small", "big", "big"],
        "d": ["1", "2", "3"], "ln": [1, 2, 3]}
    assert ps.sql(STATEMENTS["distinct_like"]).collect() == [("apple",)]
    assert ps.sql(STATEMENTS["having"]).collect() == [(1, 30), (3, 100)]
    assert ps.sql(STATEMENTS["chained_ctes"]).collect() == \
        [(1, 12), (2, 11), (3, 13)]
    assert ps.sql(STATEMENTS["cte_shadows_a_view"]).collect() == \
        [(2,), (3,)]
    assert ps.sql(STATEMENTS["view_back_after_the_cte"]).collect() == \
        [(1,), (2,), (3,)]


def test_views_are_case_insensitive_and_replaceable():
    s = pt.TpuSession(device="cpu")
    s.create_dataframe({"a": [1, 2]}).createOrReplaceTempView("MyView")
    assert s.sql("select a from myview order by a").collect() == [(1,), (2,)]
    s.create_dataframe({"a": [7]}).create_or_replace_temp_view("myview")
    assert s.sql("SELECT a FROM MYVIEW").collect() == [(7,)]
    with pytest.raises(ValueError, match="unknown table/view"):
        s.sql("SELECT a FROM nope")


def test_explain_statement_returns_the_plan(sessions):
    _, ps = sessions
    with contextlib.redirect_stdout(io.StringIO()):
        out = ps.sql("EXPLAIN SELECT k FROM t WHERE v > 10").to_arrow()
    assert out.column_names == ["plan"] and out.num_rows == 1
    text = out.column(0)[0].as_py()
    assert text.startswith("* [loreId=1] Project[") and "!cpu" not in text
    assert "== Physical Plan ==" in text
    # EXPLAIN ANALYZE runs the statement and renders the tree that ran,
    # as the JAX parser does
    with contextlib.redirect_stdout(io.StringIO()):
        out = ps.sql("EXPLAIN ANALYZE SELECT k FROM t").to_arrow()
    assert out.column_names == ["plan"] and out.num_rows == 1
    lines = out.column(0)[0].as_py().splitlines()
    assert lines[0] == "== EXPLAIN ANALYZE =="
    assert lines[1].startswith("[loreId=1] ProjectExec[")
    assert "rows=1000" in lines[2]


def test_functions_resolve_through_the_port_functions_module(sessions):
    js, ps = sessions
    # udf resolves to the port's udf factory since A.12 landed; SQL
    # passes the column as its function and no return type, so both
    # packages raise the same TypeError
    msgs = []
    for s in (js, ps):
        with pytest.raises(TypeError) as e:
            s.sql("SELECT udf(s) FROM f")
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "missing 1 required positional argument: 'return_type'" \
        in msgs[1]
    # rlike resolves to the port's RLike since A.10 landed; a SQL call
    # passes its pattern as a Literal, which neither package's regex
    # compiler takes
    for s in (js, ps):
        with pytest.raises(AttributeError, match="encode"):
            s.sql("SELECT rlike(s, 'a.*') FROM f")
    with pytest.raises(UnsupportedExpr, match="unknown function"):
        ps.sql("SELECT no_such_fn(s) FROM f")
    assert ps.sql("SELECT upper(s) AS u FROM f ORDER BY u LIMIT 1") \
        .collect() == [("APPLE",)]


def test_a_host_expression_in_sql_falls_back(sessions):
    """A SQL WHERE the device cannot run (IN of strings over an int)
    plans !cpu and answers as the JAX package does."""
    js, ps = sessions
    sql = "SELECT k, v FROM t WHERE k IN ('1', '3') ORDER BY v, k"
    jt, pt_ = js.sql(sql).to_arrow(), ps.sql(sql).to_arrow()
    assert pt_.equals(jt)
    with contextlib.redirect_stdout(io.StringIO()):
        assert "!cpu [loreId=3] Filter" in ps.sql(sql).explain(
            "NOT_ON_TPU")
