"""ROLLUP / CUBE / GROUPING SETS through ExpandExec in the PyTorch port
(on the CPU) against the JAX package: the four cases of the JAX
package's `tests/test_expand.py`, under the same names, and
grouping_sets with grouping_id over a string key and over a decimal
key. Each query runs through both packages over the same Arrow table
(`data_gen.gen_arrow_table`, seeded); the rows of a grouped aggregate
have no order, so the outputs compare as multisets of rows, exactly,
and against the JAX file's Python expectations.
"""
from collections import Counter, defaultdict
from decimal import Decimal

import pyarrow as pa
import pytest

import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as PF
from data_gen import IntegerGen, StringGen, gen_arrow_table
from torch_parity import sessions

CONF = {"spark.rapids.tpu.sql.batchSizeRows": 4096}


def _rows(at):
    return list(zip(*[at.column(i).to_pylist()
                      for i in range(at.num_columns)]))


def both(at, make, conf=CONF):
    """`make(df, F)` through each package; asserts equal types and equal
    multisets of rows, and returns the port's rows."""
    js, ps = sessions(conf)
    want = make(js.create_dataframe(at), JF).to_arrow()
    got = make(ps.create_dataframe(at), PF).to_arrow()
    assert got.column_names == want.column_names
    assert got.schema.types == want.schema.types
    assert Counter(_rows(got)) == Counter(_rows(want))
    return _rows(got)


def _full(at, kcols, vcol):
    full = defaultdict(lambda: [0, 0])
    cols = [at.column(c).to_pylist() for c in kcols + [vcol]]
    for row in zip(*cols):
        ks, v = row[:-1], row[-1]
        if v is not None:
            full[ks][0] += v
            full[ks][1] += 1
        else:
            full[ks]
    return full


def test_rollup_sums():
    at = gen_arrow_table([("a", IntegerGen(lo=0, hi=3)),
                          ("b", IntegerGen(lo=0, hi=4)),
                          ("v", IntegerGen(lo=0, hi=100, nullable=False))],
                         n=500, seed=90)
    got = both(at, lambda d, F: d.rollup("a", "b").agg(
        F.sum("v").alias("s"), F.grouping_id().alias("g")))
    full = _full(at, ["a", "b"], "v")
    exp = [(x, y, sv if c else None, 0) for (x, y), (sv, c) in full.items()]
    suba = defaultdict(lambda: [0, 0])
    for (x, y), (sv, c) in full.items():
        suba[x][0] += sv
        suba[x][1] += c
    exp += [(x, None, sv if c else None, 1) for x, (sv, c) in suba.items()]
    tot_s = sum(sv for sv, c in full.values())
    tot_c = sum(c for _, c in full.values())
    exp.append((None, None, tot_s if tot_c else None, 3))
    assert Counter(got) == Counter(exp)


def test_cube_counts_string_key():
    at = gen_arrow_table([("a", StringGen(max_len=3, charset="xy")),
                          ("b", IntegerGen(lo=0, hi=3, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=50, nullable=False))],
                         n=400, seed=91)
    got = both(at, lambda d, F: d.cube("a", "b").agg(
        F.count("v").alias("c")))
    cnt = Counter()
    for x, y in zip(at.column("a").to_pylist(), at.column("b").to_pylist()):
        for g in [(x, y), (x, None), (None, y), (None, None)]:
            cnt[g] += 1
    per_pair = Counter()
    for x, y, c in got:
        per_pair[(x, y)] += c
    assert dict(per_pair) == dict(cnt)


def test_grouping_sets_explicit():
    at = gen_arrow_table([("a", IntegerGen(lo=0, hi=3, nullable=False)),
                          ("b", IntegerGen(lo=0, hi=3, nullable=False)),
                          ("v", IntegerGen(lo=0, hi=100, nullable=False))],
                         n=300, seed=92)
    got = both(at, lambda d, F: d.grouping_sets(
        ["a", "b"], [["a"], ["b"]]).agg(F.sum("v").alias("s")))
    sa, sb = defaultdict(int), defaultdict(int)
    for x, y, v in zip(at.column("a").to_pylist(),
                       at.column("b").to_pylist(),
                       at.column("v").to_pylist()):
        sa[x] += v
        sb[y] += v
    exp = ([(x, None, s) for x, s in sa.items()]
           + [(None, y, s) for y, s in sb.items()])
    assert Counter(got) == Counter(exp)


def test_rollup_distinguishes_real_null_keys():
    at = pa.table({"a": pa.array([1, 1, None, None], pa.int64()),
                   "v": pa.array([10, 20, 5, 7], pa.int64())})
    got = both(at, lambda d, F: d.rollup("a").agg(
        F.sum("v").alias("s"), F.grouping_id().alias("g")))
    assert Counter(got) == Counter([(1, 30, 0), (None, 12, 0),
                                    (None, 42, 1)])


@pytest.mark.parametrize("kind", ["string", "decimal"])
@pytest.mark.parametrize("parts", ["one", "many"])
def test_grouping_sets_grouping_id_string_and_decimal_keys(kind, parts):
    """Three sets over (k, j) with grouping_id, a count and a sum, over
    a string key or a decimal(12,2) key, with nulls; on one input
    partition and on many (the partial aggregate, the exchange on the
    keys and the id, the final merge)."""
    kgen = (StringGen(max_len=2, charset="pq") if kind == "string"
            else IntegerGen(lo=0, hi=6))
    at = gen_arrow_table([("k", kgen),
                          ("j", IntegerGen(lo=0, hi=3)),
                          ("v", IntegerGen(lo=0, hi=1000))],
                         n=700, seed=93)
    if kind == "decimal":
        # a few distinct decimal(12,2) keys, so groups hold several rows
        at = at.set_column(0, "k", pa.array(
            [None if x is None else Decimal(x) + Decimal("0.25")
             for x in at.column("k").to_pylist()], pa.decimal128(12, 2)))
    conf = dict(CONF)
    if parts == "many":
        conf["spark.rapids.tpu.sql.batchSizeRows"] = 128
    got = both(at, lambda d, F: d.grouping_sets(
        ["k", "j"], [["k", "j"], ["k"], []]).agg(
            F.count("v").alias("c"), F.sum("v").alias("s"),
            F.grouping_id().alias("g")), conf=conf)
    ks, js_, vs = (at.column(c).to_pylist() for c in ("k", "j", "v"))
    exp = Counter()
    for sets, gid in (((0, 1), 0), ((0,), 1), ((), 3)):
        groups = defaultdict(lambda: [0, 0])
        for row in zip(ks, js_, vs):
            key = tuple(row[i] if i in sets else None for i in (0, 1))
            if row[2] is not None:
                groups[key][0] += 1
                groups[key][1] += row[2]
            else:
                groups[key]
        for (x, y), (c, s) in groups.items():
            exp[(x, y, c, s if c else None, gid)] += 1
    assert Counter(got) == exp
