"""The port's TPC-H generators against the JAX package's.

Every generator of `spark_rapids_tpu_torch.workloads.tpch` must build a
table equal (`pa.Table.equals`: schema, values, nulls) to the JAX
generator's for the same scale factor and seed: the base tables and the
`full=True` ones, part, supplier, partsupp, nation, region and `gen_all`.
Two scale factors (one that rounds row counts) and two seeds each; the
vocabularies and row counts must be the JAX package's too.
"""
import pytest

from spark_rapids_tpu.workloads import tpch as jtpch
from spark_rapids_tpu_torch.workloads import tpch as ptpch

SFS = (0.01, 0.0137)
SEEDS = (7, 11)
SEEDED = ("gen_lineitem", "gen_orders", "gen_customer", "gen_part",
          "gen_supplier", "gen_partsupp")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sf", SFS)
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", ["gen_lineitem", "gen_orders",
                                  "gen_customer"])
def test_fact_generators_equal_jax(name, full, sf, seed):
    got = getattr(ptpch, name)(sf, seed, full=full)
    exp = getattr(jtpch, name)(sf, seed, full=full)
    assert got.schema == exp.schema
    assert got.equals(exp)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sf", SFS)
@pytest.mark.parametrize("name", ["gen_part", "gen_supplier",
                                  "gen_partsupp"])
def test_dimension_generators_equal_jax(name, sf, seed):
    assert getattr(ptpch, name)(sf, seed).equals(
        getattr(jtpch, name)(sf, seed))


@pytest.mark.parametrize("name", SEEDED)
def test_default_seeds_equal_jax(name):
    assert getattr(ptpch, name)(0.002).equals(getattr(jtpch, name)(0.002))


def test_nation_and_region_equal_jax():
    assert ptpch.gen_nation().equals(jtpch.gen_nation())
    assert ptpch.gen_region().equals(jtpch.gen_region())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sf", SFS)
def test_gen_all_equals_jax_table_for_table(sf, seed):
    got = ptpch.gen_all(sf, seed)
    exp = jtpch.gen_all(sf, seed)
    assert list(got) == list(exp)
    for name in exp:
        assert got[name].equals(exp[name]), name


def test_gen_all_is_foreign_key_consistent():
    """The joins the ported queries make find their rows: keys are 0..n-1
    and every foreign key names a row (l_orderkey may pass the orders'
    count, as in the JAX generator)."""
    t = ptpch.gen_all(0.01, seed=11)
    for table, key in (("orders", "o_orderkey"), ("customer", "c_custkey"),
                       ("part", "p_partkey"), ("supplier", "s_suppkey"),
                       ("nation", "n_nationkey"),
                       ("region", "r_regionkey")):
        assert t[table].column(key).to_pylist() == \
            list(range(t[table].num_rows))
    li = t["lineitem"]
    assert max(li.column("l_partkey").to_pylist()) < t["part"].num_rows
    assert max(li.column("l_suppkey").to_pylist()) < t["supplier"].num_rows
    assert max(t["orders"].column("o_custkey").to_pylist()) < \
        t["customer"].num_rows
    assert all(k % 3 for k in t["orders"].column("o_custkey").to_pylist())


def test_vocabularies_and_row_counts_equal_jax():
    for name in ("SHIPMODES", "SHIPINSTRUCT", "ORDERPRIORITIES", "SEGMENTS",
                 "TYPE_S1", "TYPE_S2", "TYPE_S3", "CONTAINER_S1",
                 "CONTAINER_S2", "COLORS", "NATIONS", "REGIONS",
                 "PART_ROWS_PER_SF", "SUPPLIER_ROWS_PER_SF",
                 "LINEITEM_ROWS_PER_SF", "ORDERS_ROWS_PER_SF"):
        assert getattr(ptpch, name) == getattr(jtpch, name), name


def test_queries_registry_holds_the_ported_queries():
    from spark_rapids_tpu_torch.workloads import tpch_queries
    reg = ptpch.queries()
    assert sorted(reg) == list(range(1, 23))
    assert tpch_queries.PORTED == (2, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14,
                                   15, 16, 17, 18, 19, 20, 21, 22)
