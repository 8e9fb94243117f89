"""The grouped hash aggregate of the PyTorch port against the JAX package.

`group_by(...).agg(sum, count, count(*), avg)` over int, long, date,
bool, decimal, float and string keys, two keys, and null keys, in
complete mode (one input partition) and as partial -> exchange -> final
(many partitions), over the same seeded Arrow tables in both packages.
A bare group_by has no defined row order, so both outputs are sorted by
the keys before they are compared; values must be equal exactly. One
case has enough distinct keys per batch that the hash pass leaves rows
over and the batch takes the sort-segmented path (its counter shows it);
a small `sql.agg.maxMergeRows` splits the merge into hash buckets. The
bucket hash (`hash_once_rows`) is held bit for bit against the JAX one.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.exec import aggregate as jagg_exec
from spark_rapids_tpu.ops import hash as jhash
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.exec import aggregate as pagg_exec
from spark_rapids_tpu_torch.ops import hash as phash

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

N = 6000
COMPLETE = {"spark.rapids.tpu.sql.batchSizeRows": 1 << 20}
PARTIAL = {"spark.rapids.tpu.sql.batchSizeRows": 1024}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _table(seed=0, n=N):
    rng = np.random.default_rng(seed)
    D = __import__("decimal").Decimal
    words = ["", "A", "N", "R", "é", "日本語", "x" * 70, "x" * 70 + "y",
             "abcdefgh", "abcdefgi"]

    def nulls(a, frac=0.1):
        return [None if rng.random() < frac else v for v in a]
    return pa.table({
        "i": pa.array(rng.integers(-20, 20, n).astype(np.int32)),
        "l": pa.array(nulls([int(x) for x in
                             rng.integers(-2**40, 2**40, 30)[
                                 rng.integers(0, 30, n)]]), pa.int64()),
        "d": pa.array(rng.integers(8036, 8100, n).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
        "b": pa.array(nulls(list(rng.integers(0, 2, n).astype(bool)))),
        "dec": pa.array([D(int(x)).scaleb(-2) for x in
                         rng.integers(-50, 50, n)], pa.decimal128(10, 2)),
        "f": pa.array(nulls(list(rng.integers(-3, 3, n) * 0.5)),
                      pa.float64()),
        "s": pa.array(nulls([words[i] for i in
                             rng.integers(0, len(words), n)]), pa.string()),
        "v": pa.array(nulls([int(x) for x in
                             rng.integers(-10**9, 10**9, n)], 0.05),
                      pa.int64()),
        "q": pa.array(nulls([D(int(x)).scaleb(-2) for x in
                             rng.integers(100, 5000, n)], 0.05),
                      pa.decimal128(12, 2)),
    })


def _agg(F, df, keys):
    return df.group_by(*keys).agg(F.sum("v").alias("sv"),
                                  F.sum("q").alias("sq"),
                                  F.count("v").alias("cv"),
                                  F.count("*").alias("n"),
                                  F.avg("q").alias("aq"),
                                  F.avg("v").alias("av"))


def _sorted(at, keys):
    return at.sort_by([(k, "ascending") for k in keys])


def _plan(df):
    node, _ = df.physical_plan()
    out = []
    while node is not None:
        out.append(type(node).__name__ + (f"[{node.mode}]"
                                          if hasattr(node, "mode") else ""))
        node = node.children[0] if node.children else None
    return out


def _run_both(at, keys, conf, build=_agg):
    jdf = build(JF, st.TpuSession(dict(conf)).create_dataframe(at), keys)
    pdf = build(PF, pt.TpuSession(dict(conf), device="cpu")
                .create_dataframe(at), keys)
    return pdf, pdf.to_arrow(), jdf.to_arrow()


KEYS = {"int": ["i"], "long_nulls": ["l"], "date": ["d"],
        "bool_nulls": ["b"], "decimal": ["dec"], "float": ["f"],
        "string_nulls": ["s"], "string_and_int": ["s", "i"],
        "date_and_long": ["d", "l"]}
# a float key takes the sort path in complete mode; its exchange needs
# the float murmur3, which waits for a later slice
CASES = [(c, m) for c in sorted(KEYS) for m in ("complete", "partial")
         if (c, m) != ("float", "partial")]
# partial -> exchange -> final behind the adaptive reader (the default)
CASES += [(c, "adaptive") for c in ("int", "decimal", "string_and_int")]


@pytest.mark.parametrize("case,mode", CASES)
def test_grouped_agg_matches_jax(case, mode):
    keys = KEYS[case]
    at = _table(seed=len(case))
    conf = {"complete": COMPLETE,
            "partial": dict(PARTIAL, **chip_smoke.WRITTEN_CONF),
            "adaptive": PARTIAL}[mode]
    pdf, got, exp = _run_both(at, keys, conf)
    chain = _plan(pdf)
    if mode == "complete":
        assert chain[0] == "HashAggregateExec[complete]"
    elif mode == "partial":
        assert chain[:3] == ["HashAggregateExec[final]",
                             "ShuffleExchangeExec",
                             "HashAggregateExec[partial]"]
    else:
        assert chain[:4] == ["HashAggregateExec[final]",
                             "AQEShuffleReadExec", "ShuffleExchangeExec",
                             "HashAggregateExec[partial]"]
        (d,) = pdf.last_aqe_decisions()
        assert d["partitions_before"] == 8 and d["partitions_after"] == 1
    assert got.schema == exp.schema
    assert got.num_rows == exp.num_rows
    assert _sorted(got, keys).equals(_sorted(exp, keys))


def test_hash_pass_and_sort_leftover_path():
    """Few keys: every batch takes the hash pass. Distinct keys in one
    8,192-row batch: the hash pass leaves rows over, the batch takes the
    sort-segmented path, and so does the rest of the query."""
    rng = np.random.default_rng(3)
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 8192}
    few = pa.table({"k": pa.array(rng.integers(0, 40, 20000)),
                    "v": pa.array(rng.integers(0, 99, 20000))})
    many = pa.table({"k": pa.array(rng.integers(0, 1 << 40, 20000)),
                     "v": pa.array(rng.integers(0, 99, 20000))})
    for at, path in ((few, "hashPassBatches"), (many, "sortPassBatches")):
        def build(F, df, keys):
            return df.group_by(*keys).agg(F.sum("v").alias("s"),
                                          F.count("*").alias("n"))
        pdf, got, exp = _run_both(at, ["k"], conf, build)
        assert _sorted(got, ["k"]).equals(_sorted(exp, ["k"]))
        counts = {}
        for m in pdf.last_metrics().values():
            for k in ("hashPassBatches", "sortPassBatches"):
                counts[k] = counts.get(k, 0) + m.get(k, 0)
        assert counts[path] > 0
        if path == "sortPassBatches":
            assert counts["hashPassBatches"] == 0


@pytest.mark.parametrize("max_rows", [40, 200])
def test_merge_splits_into_buckets(max_rows):
    """Partials above sql.agg.maxMergeRows merge bucket by bucket (16
    buckets here), and at 40 a bucket still too big recurses with a fresh
    seed."""
    rng = np.random.default_rng(max_rows)
    at = pa.table({"k": pa.array(rng.integers(0, 300, 4000)),
                   "v": pa.array(rng.integers(-99, 99, 4000))})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 1024,
            "spark.rapids.tpu.sql.agg.maxMergeRows": max_rows,
            "spark.rapids.tpu.sql.shuffle.partitions": 1}

    def build(F, df, keys):
        return df.group_by(*keys).agg(F.sum("v").alias("sv"),
                                      F.count("*").alias("n"))
    pdf, got, exp = _run_both(at, ["k"], conf, build)
    assert _sorted(got, ["k"]).equals(_sorted(exp, ["k"]))
    recursions = sum(m.get("numBucketRecursions", 0)
                     for m in pdf.last_metrics().values())
    assert (recursions > 0) == (max_rows == 40)


def test_empty_and_filtered_out_input():
    at = _table(seed=1, n=0)
    for conf in (COMPLETE, PARTIAL):
        _, got, exp = _run_both(at, ["s", "i"], conf)
        assert got.num_rows == exp.num_rows == 0
        assert got.schema == exp.schema

    def none_left(F, df, keys):
        return _agg(F, df.filter(df_col(F)("i") > 1000), keys)
    _, got, exp = _run_both(_table(seed=2), ["s"], COMPLETE, none_left)
    assert got.num_rows == exp.num_rows == 0


def df_col(F):
    return F.col


def test_trailing_zero_byte_keys_group_like_the_reference():
    """The reference pads string keys with 0x00 bytes, so "a" and "a\\x00"
    fall into one group (a departure from Spark, ROADMAP §C); the port
    reproduces it."""
    at = pa.table({"s": pa.array(["a", "a\x00", "a", "b", "b\x00\x00"]),
                   "v": pa.array([1, 2, 3, 4, 5])})

    def build(F, df, keys):
        return df.group_by(*keys).agg(F.sum("v").alias("sv"))
    _, got, exp = _run_both(at, ["s"], COMPLETE, build)
    assert got.num_rows == exp.num_rows == 2
    assert sorted(got.column("sv").to_pylist()) == \
        sorted(exp.column("sv").to_pylist()) == [6, 9]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_once_rows_match_jax(seed):
    """The xxhash64-style bucket hash over the equality arrays: null
    flags (uint8), negative int32 and int64 keys, and 32-bit chunk words
    packed in pairs."""
    rng = np.random.default_rng(seed)
    n = 4000
    flags = rng.integers(0, 2, n).astype(np.uint8)
    i32 = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    i64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    packed = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    jh = np.asarray(jhash.hash_once_rows(
        [[jnp.asarray(flags), jnp.asarray(i32)],
         [jnp.asarray(i64), jnp.asarray(packed)]]))
    ppacked = pagg_exec._pack_pair(torch.from_numpy(hi.astype(np.int64)),
                                   torch.from_numpy(lo.astype(np.int64)))
    assert np.array_equal(ppacked.numpy().view(np.uint64), packed)
    ph = phash.hash_once_rows(
        [[torch.from_numpy(flags), torch.from_numpy(i32)],
         [torch.from_numpy(i64), ppacked]]).numpy()
    np.testing.assert_array_equal(ph, jh.astype(np.int64) & 0xFFFFFFFF)
    # the second round's remix
    jr = np.asarray(jagg_exec._remix_round(jnp.asarray(jh), 1))
    pr = pagg_exec._remix_round(torch.from_numpy(ph), 1).numpy()
    np.testing.assert_array_equal(pr, jr.astype(np.int64) & 0xFFFFFFFF)
