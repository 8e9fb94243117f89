"""SQL subqueries in the port's frontend: the TPC-H statements of the JAX
package's `tests/test_sql_subqueries.py` (Q2, Q4, Q17, Q18, Q21 and Q22:
correlated and uncorrelated scalar subqueries, EXISTS / NOT EXISTS,
IN over a grouped subquery, a derived table) and its two scoping cases,
through both packages over the same `gen_all(0.01, 7)` tables, cached,
as in the JAX test. Every column is exact but a double, which may be
within DOUBLE_ULPS of the JAX value (an average's division: XLA
multiplies by the reciprocal, the port divides, ROADMAP C.3)."""
import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu.sql.parser import register_view as j_register
from spark_rapids_tpu_torch.sql.parser import register_view as p_register
from spark_rapids_tpu_torch.workloads import tpch
from torch_parity import ulps

DOUBLE_ULPS = 4
D0, D1 = tpch.day("1993-07-01"), tpch.day("1993-10-01")

STATEMENTS = {
    "q4_exists": f"""
        select o_orderpriority, count(*) as order_count
        from orders
        where o_orderdate >= {D0}
          and o_orderdate < {D1}
          and exists (
            select * from lineitem
            where l_orderkey = o_orderkey
              and l_commitdate < l_receiptdate)
        group by o_orderpriority
        order by o_orderpriority""",
    "q17_correlated_scalar": """
        select sum(l_extendedprice) / 7.0 as avg_yearly
        from lineitem join part on l_partkey = p_partkey
        where p_brand = 'Brand#23' and p_container = 'MED BOX'
          and l_quantity < (
            select 0.2 * avg(l_quantity) from lineitem
            where l_partkey = p_partkey)""",
    "q18_in_grouped_subquery": """
        select c_name, c_custkey, o_orderkey, o_orderdate,
               o_totalprice, sum(l_quantity) as sq
        from customer
          join orders on c_custkey = o_custkey
          join lineitem on o_orderkey = l_orderkey
        where o_orderkey in (
            select l_orderkey from lineitem
            group by l_orderkey having sum(l_quantity) > 250)
        group by c_name, c_custkey, o_orderkey, o_orderdate,
                 o_totalprice
        order by o_totalprice desc, o_orderdate
        limit 100""",
    "q21_not_exists_self_join": """
        select s_name, count(*) as numwait
        from supplier
          join lineitem l1 on s_suppkey = l_suppkey
          join orders on o_orderkey = l_orderkey
          join nation on s_nationkey = n_nationkey
        where o_orderstatus = 'F'
          and l1.l_receiptdate > l1.l_commitdate
          and n_name = 'SAUDI ARABIA'
          and exists (
            select * from lineitem l2
            where l2.l_orderkey = l1.l_orderkey
              and l2.l_suppkey <> l1.l_suppkey)
          and not exists (
            select * from lineitem l3
            where l3.l_orderkey = l1.l_orderkey
              and l3.l_suppkey <> l1.l_suppkey
              and l3.l_receiptdate > l3.l_commitdate)
        group by s_name
        order by numwait desc, s_name
        limit 100""",
    "q22_uncorrelated_scalar_and_not_exists": """
        select cntrycode, count(*) as numcust,
               sum(c_acctbal) as totacctbal
        from (select substring(c_phone, 1, 2) as cntrycode,
                     c_acctbal, c_custkey
              from customer
              where substring(c_phone, 1, 2)
                    in ('13','31','23','29','30','18','17'))
        where c_acctbal > (
            select avg(c_acctbal) from customer
            where c_acctbal > 0.00
              and substring(c_phone, 1, 2)
                  in ('13','31','23','29','30','18','17'))
          and not exists (
            select * from orders where o_custkey = c_custkey)
        group by cntrycode
        order by cntrycode""",
    "q2_correlated_min": """
        select s_acctbal, s_name, n_name, p_partkey, p_mfgr,
               s_address, s_phone, s_comment
        from part
          join partsupp on p_partkey = ps_partkey
          join supplier on ps_suppkey = s_suppkey
          join nation on s_nationkey = n_nationkey
          join region on n_regionkey = r_regionkey
        where p_size = 15 and endswith(p_type, 'BRASS')
          and r_name = 'EUROPE'
          and ps_supplycost = (
            select min(ps_supplycost)
            from partsupp
              join supplier on ps_suppkey = s_suppkey
              join nation on s_nationkey = n_nationkey
              join region on n_regionkey = r_regionkey
            where p_partkey = ps_partkey and r_name = 'EUROPE')
        order by s_acctbal desc, n_name, s_name, p_partkey
        limit 100""",
}


@pytest.fixture(scope="module")
def env():
    tabs = tpch.gen_all(sf=0.01, seed=7)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1 << 20}
    js, ps = st.TpuSession(conf), pt.TpuSession(conf, device="cpu")
    for s, reg in ((js, j_register), (ps, p_register)):
        for name, t in tabs.items():
            reg(s, name, s.create_dataframe(t).cache())
    return js, ps


def assert_tables_equal(jt, pt_, what):
    assert pt_.schema == jt.schema, what
    assert pt_.num_rows == jt.num_rows, what
    for name in jt.column_names:
        j, p = jt.column(name), pt_.column(name)
        if pa.types.is_floating(j.type):
            jv, pv = j.to_pylist(), p.to_pylist()
            assert [v is None for v in jv] == [v is None for v in pv], what
            keep = [i for i, v in enumerate(jv) if v is not None]
            d = ulps(np.array([jv[i] for i in keep], np.float64),
                     np.array([pv[i] for i in keep], np.float64))
            assert (d <= DOUBLE_ULPS).all(), (what, name, d.max())
        else:
            assert p.equals(j), (what, name)


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_tpch_statement_equals_jax(env, name):
    js, ps = env
    sql = STATEMENTS[name]
    assert_tables_equal(js.sql(sql).to_arrow(), ps.sql(sql).to_arrow(),
                        name)


def test_nonempty_answers(env):
    """The statements select rows at this scale (Q17's one row may be
    null where no part qualifies)."""
    _, ps = env
    for name in ("q4_exists", "q18_in_grouped_subquery",
                 "q22_uncorrelated_scalar_and_not_exists",
                 "q2_correlated_min"):
        assert ps.sql(STATEMENTS[name]).to_arrow().num_rows > 0, name


def _scoped(reg_pair, t1, t2, sql):
    out = []
    for s, reg in reg_pair:
        reg(s, "t1", s.create_dataframe(t1))
        reg(s, "t2", s.create_dataframe(t2))
        out.append(s.sql(sql).to_arrow())
    return out


def _fresh():
    return ((st.TpuSession(), j_register),
            (pt.TpuSession(device="cpu"), p_register))


def test_correlation_via_table_name_qualifier():
    """Qualified by the outer TABLE NAME: correlates, not a tautology."""
    jt, pt_ = _scoped(
        _fresh(),
        {"a": pa.array([1, 2], pa.int64()),
         "k": pa.array([10, 20], pa.int64())},
        {"b": pa.array([1, 2], pa.int64()),
         "k": pa.array([10, 99], pa.int64())},
        "select a from t1 where a in (select b from t2 where t2.k = t1.k)")
    assert pt_.equals(jt)
    assert pt_.column("a").to_pylist() == [1]


def test_correlated_in_subquery_keeps_corr_columns():
    jt, pt_ = _scoped(
        _fresh(),
        {"a": pa.array([1, 2, 3], pa.int64()),
         "k": pa.array([10, 20, 30], pa.int64())},
        {"b": pa.array([1, 2, 3], pa.int64()),
         "k": pa.array([10, 99, 30], pa.int64())},
        "select a from t1 x where a in (select b from t2 where t2.k = x.k)")
    assert sorted(pt_.column("a").to_pylist()) == \
        sorted(jt.column("a").to_pylist()) == [1, 3]
