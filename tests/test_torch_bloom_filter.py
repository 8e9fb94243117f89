"""bloom_filter_agg and might_contain in the port against the JAX package
(JAX `expr/aggregates.py` `BloomFilterAggregate`, `expr/hash_expr.py`
`BloomFilterMightContain`): the packed payload equal byte for byte, over
each key type with nulls and merged over several batches, the probe's
masks equal, no false negative, and the same refusals. Both packages
run with the host fallback and degrade-to-host off (`torch_parity`)."""
import datetime

import numpy as np
import pyarrow as pa
import pytest

from torch_parity import sessions
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu_torch.expr.aggregates import parse_bloom_filter
from spark_rapids_tpu_torch.expr.expressions import (
    UnsupportedExpr as PUnsupported)


def _table(n=3000, seed=11):
    rng = np.random.default_rng(seed)
    v = rng.integers(-2 ** 40, 2 ** 40, n)
    null = rng.random(n) < 0.1
    return pa.table({
        "i": pa.array(v.astype(np.int32), mask=null),
        "l": pa.array(v, mask=null),
        "dt": pa.array((v % 30000).astype(np.int32), mask=null).cast(
            pa.date32()),
        "s": pa.array([f"k{x % 997}" for x in v], mask=null),
        "d": pa.array(rng.normal(0, 1e3, n).round(2), mask=null),
    }), null


KEYS = ["i", "l", "dt", "s", "d"]
#: one batch, and many: the many-batch build merges per-batch filters
CONFS = {"one_batch": {},
         "merged": {"spark.rapids.tpu.sql.batchSizeRows": 256}}


def _blob(s, F, tab, key, **kw):
    out = s.create_dataframe(tab).agg(
        F.bloom_filter_agg(F.col(key), **kw).alias("bf")).to_arrow()
    return out.column("bf")[0].as_py()


@pytest.mark.parametrize("conf", sorted(CONFS))
@pytest.mark.parametrize("key", KEYS)
def test_payload_is_byte_equal(key, conf):
    tab, _ = _table()
    js, ps = sessions(CONFS[conf])
    jb = _blob(js, JF, tab, key, estimated_items=2000)
    pb = _blob(ps, PF, tab, key, estimated_items=2000)
    assert isinstance(pb, bytes) and pb.startswith(b"BF1|5|16384|")
    assert jb == pb


@pytest.mark.parametrize("key", KEYS)
def test_might_contain_masks_are_equal_and_complete(key):
    """Probe a filter of the first half over every row: equal masks, and
    every valid row of the first half is found."""
    tab, null = _table()
    half = tab.slice(0, 1500)
    js, ps = sessions({"spark.rapids.tpu.sql.batchSizeRows": 512})
    jb = _blob(js, JF, half, key, estimated_items=1500)
    pb = _blob(ps, PF, half, key, estimated_items=1500)
    assert jb == pb
    jm = js.create_dataframe(tab).select(
        JF.might_contain(JF.lit(jb), JF.col(key)).alias("m")).to_arrow()
    pm = ps.create_dataframe(tab).select(
        PF.might_contain(PF.lit(pb), PF.col(key)).alias("m")).to_arrow()
    got = pm.column("m").to_pylist()
    assert jm.column("m").to_pylist() == got
    assert all(got[i] for i in range(1500) if not null[i])
    assert all(got[i] is None for i in range(3000) if null[i])


def test_no_false_negatives_and_few_false_positives():
    rng = np.random.default_rng(3)
    members = rng.choice(10_000_000, size=5000, replace=False).astype(
        np.int64)
    _, ps = sessions()
    blob = _blob(ps, PF, pa.table({"v": members}), "v",
                 estimated_items=5000)
    k, m, bits = parse_bloom_filter(blob)
    assert (k, m, bits.shape[0]) == (5, 65536, 65536)
    others = (rng.choice(10_000_000, size=4000) + 10_000_000).astype(
        np.int64)
    probe = pa.table({"x": np.concatenate([members[:2000], others])})
    got = ps.create_dataframe(probe).select(
        PF.might_contain(PF.lit(blob), PF.col("x")).alias("m")
    ).to_arrow().column("m").to_pylist()
    assert all(got[:2000])
    assert sum(got[2000:]) / 4000 < 0.05


def test_empty_input_gives_an_empty_filter():
    js, ps = sessions()
    tab = pa.table({"v": pa.array([], pa.int64())})
    jb = _blob(js, JF, tab, "v", estimated_items=10)
    pb = _blob(ps, PF, tab, "v", estimated_items=10)
    assert jb == pb and set(pb[len(b"BF1|5|128|"):]) == {0}


def _refusal(s, F, case):
    if case == "non_foldable_filter":
        df = s.create_dataframe({"x": pa.array([1, 2]),
                                 "b": pa.array([b"BF1|", b"BF1|"],
                                               pa.binary())})
        return df.select(F.might_contain(F.col("b"), F.col("x"))
                         .alias("m")).to_arrow()
    if case == "grouped":
        df = s.create_dataframe({"k": pa.array([1]), "v": pa.array([1])})
        return df.group_by("k").agg(
            F.bloom_filter_agg(F.col("v")).alias("bf")).to_arrow()
    df = s.create_dataframe({"a": pa.array([[1, 2], [3]])})
    return df.agg(F.bloom_filter_agg(F.col("a")).alias("bf")).to_arrow()


@pytest.mark.parametrize("case,word", [("non_foldable_filter", "foldable"),
                                       ("grouped", "grouped"),
                                       ("nested_input", "nested")])
def test_refusals_match(case, word):
    js, ps = sessions()
    with pytest.raises(JUnsupported) as je:
        _refusal(js, JF, case)
    with pytest.raises(PUnsupported) as pe:
        _refusal(ps, PF, case)
    assert word in str(je.value) and word in str(pe.value)


def test_date_literal_probe_matches():
    """A date value probed through a literal, beside the column path."""
    js, ps = sessions()
    days = [datetime.date(1995, 3, d) for d in range(1, 29)]
    tab = pa.table({"dt": pa.array(days, pa.date32())})
    jb = _blob(js, JF, tab, "dt", estimated_items=64)
    pb = _blob(ps, PF, tab, "dt", estimated_items=64)
    assert jb == pb
    probe = pa.table({"dt": pa.array(days[::3] + [datetime.date(2001, 1, 1)],
                                     pa.date32())})
    jm = js.create_dataframe(probe).select(
        JF.might_contain(JF.lit(jb), JF.col("dt")).alias("m")).to_arrow()
    pm = ps.create_dataframe(probe).select(
        PF.might_contain(PF.lit(pb), PF.col("dt")).alias("m")).to_arrow()
    assert jm.equals(pm) and all(pm.column("m").to_pylist()[:-1])
