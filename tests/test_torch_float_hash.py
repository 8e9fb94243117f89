"""Float, double and decimal128 hash keys in the PyTorch port (on the CPU)
against the JAX package's `ops/hash.py` `partition_ids`.

The JAX package hashes a float32 as Spark does (-0.0 as 0.0, then
hashInt of the bits), a float64 through its engine-internal frexp word
(`mant ^ (e << 1)` through hashLong, docs/compatibility.md:44-46), and a
decimal128 as hashLong of its two limbs xor-ed. Its CPU compile flushes
subnormals to zero, hashes a float64 NaN as 0.0 and saturates the cast
of an infinity; the port writes those values out. Cases, over 200 and
7 partitions and through the row fold with an int column: magnitudes
from 1e-300 to 1e300, +-0.0, subnormals, the smallest normals,
+-infinity, the canonical NaN, nulls; decimal128 limbs across the whole
int64 range. Then, through the engine: `repartition` on a double and on
a decimal(31,4) key places every row where the JAX package does, and
NaN keys group as one (JAX `tests/test_aggregate.py:107`) through a
partial exchange on a double key. A float32 NaN with other bits than
0x7FC00000 is the one departure: the port hashes every NaN as that one
(ROADMAP C.15), so all NaN rows land in one partition on any device.
Tolerance: exact.
"""
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.ops.hash import partition_ids as jax_ids
from spark_rapids_tpu.ops.kernel_utils import CV as JCV
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.ops.hash import partition_ids
from spark_rapids_tpu_torch.ops.kernel_utils import CV

SPECIAL = [0.0, -0.0, 5e-324, -5e-324, 2.225073858507201e-308,
           2.2250738585072014e-308, -2.2250738585072014e-308, 1.0, -1.0,
           1.5, 0.1, 1e300, -1e300, 1.7976931348623157e308,
           -1.7976931348623157e308, math.inf, -math.inf, math.nan]


def _doubles(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    return np.concatenate([x, np.array(SPECIAL)])


def _floats(seed=1):
    with np.errstate(over="ignore"):       # past 3.4e38: infinity
        x = _doubles(seed).astype(np.float32)
    bits = np.array([1, 0x807FFFFF, 0x00800000, 0x80800000, 0x7F7FFFFF,
                     0x7FC00000], np.uint32).view(np.float32)
    return np.concatenate([x, bits])


def _decimals(seed=2, n=3000):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**63, 2**63, (n, 2), dtype=np.int64)
    x[:8] = [[0, 0], [-1, -1], [1, 0], [0, 1], [2**63 - 1, 0],
             [-2**63, -1], [5, 5], [-5, 4]]
    return x


def _both(data, ptype, jtype, n, valid, extra=None):
    cvs = [CV(torch.from_numpy(data), torch.from_numpy(valid))]
    jcvs = [JCV(jnp.asarray(data), jnp.asarray(valid))]
    ptypes, jtypes = [ptype], [jtype]
    if extra is not None:
        cvs.insert(0, CV(torch.from_numpy(extra),
                         torch.ones(len(extra), dtype=torch.bool)))
        jcvs.insert(0, JCV(jnp.asarray(extra),
                           jnp.ones(len(extra), jnp.bool_)))
        ptypes.insert(0, dt.INT32)
        jtypes.insert(0, jdt.INT32)
    got = partition_ids(cvs, ptypes, n).numpy()
    want = np.asarray(jax_ids(jcvs, jtypes, n))
    return got, want


CASES = {"float32": (_floats, dt.FLOAT32, jdt.FLOAT32),
         "float64": (_doubles, dt.FLOAT64, jdt.FLOAT64),
         "decimal128": (_decimals, dt.DecimalType(38, 4),
                        jdt.DecimalType(38, 4))}


@pytest.mark.parametrize("n", [200, 7])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("kind", list(CASES))
def test_partition_ids_equal_jax(kind, folded, n):
    make, ptype, jtype = CASES[kind]
    data = make()
    rng = np.random.default_rng(3)
    valid = rng.random(len(data)) > 0.1
    valid[-len(SPECIAL):] = True
    extra = (rng.integers(-1000, 1000, len(data)).astype(np.int32)
             if folded else None)
    got, want = _both(data, ptype, jtype, n, valid, extra)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    # a null row keeps the seed: it lands with the other nulls
    if not folded:
        assert len(set(got[~valid].tolist())) == 1


def test_zeros_and_subnormals_hash_as_zero():
    d = np.array([0.0, -0.0, 5e-324, -5e-324, 2.225073858507201e-308])
    got, want = _both(d, dt.FLOAT64, jdt.FLOAT64, 200,
                      np.ones(len(d), bool))
    assert np.array_equal(got, want) and len(set(got.tolist())) == 1
    f = np.array([0, 0x80000000, 1, 0x807FFFFF], np.uint32).view(
        np.float32)
    got, want = _both(f, dt.FLOAT32, jdt.FLOAT32, 200,
                      np.ones(len(f), bool))
    assert np.array_equal(got, want) and len(set(got.tolist())) == 1


def test_every_nan_lands_in_one_partition():
    d = np.array([math.nan, -math.nan, 0.0]).astype(np.float64)
    d = np.concatenate([d, np.array([0x7FF0000000000001,
                                     0xFFF8000000000000], np.uint64)
                        .view(np.float64)])
    got, want = _both(d, dt.FLOAT64, jdt.FLOAT64, 200,
                      np.ones(len(d), bool))
    assert np.array_equal(got, want)          # NaN hashes as 0.0 there
    assert len(set(got.tolist())) == 1
    f = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                 np.uint32).view(np.float32)
    pids = partition_ids([CV(torch.from_numpy(f),
                             torch.ones(4, dtype=torch.bool))],
                         [dt.FLOAT32], 200).numpy()
    assert len(set(pids.tolist())) == 1
    # the canonical NaN is the JAX package's id
    _, want = _both(f[:1], dt.FLOAT32, jdt.FLOAT32, 200,
                    np.ones(1, bool))
    assert pids[0] == want[0]


def _placed(sess, at, key, F):
    """A repartition's output, partition by partition: the order of its
    `id` column shows where every row went."""
    q = sess.create_dataframe(at).repartition(13, F.col(key))
    return q.to_arrow()


@pytest.mark.parametrize("key", ["d", "m"])
def test_repartition_places_rows_as_jax(key):
    rng = np.random.default_rng(5)
    n = 4000
    d = _doubles(6, n - len(SPECIAL))
    m = [None if i % 11 == 0 else int(v) for i, v in
         enumerate(rng.integers(-10**17, 10**17, n))]
    at = pa.table({"id": pa.array(np.arange(n)),
                   "d": pa.array(d, mask=rng.random(n) < 0.05),
                   "m": pa.array(m, pa.decimal128(31, 4))})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 512}
    got = _placed(pt.TpuSession(dict(conf), device="cpu"), at, key, PF)
    want = _placed(st.TpuSession(dict(conf)), at, key, JF)
    assert got.num_rows == n
    assert got.column("id").equals(want.column("id"))


def test_nan_keys_group_as_one_through_a_partial_exchange():
    vals = [math.nan, -math.nan, 1.0, 1.0, -0.0, 0.0, None] * 40
    at = pa.table({"k": pa.array(vals, pa.float64()),
                   "v": pa.array(np.arange(len(vals), dtype=np.int64))})
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 32}
    outs = []
    for sess, F in ((pt.TpuSession(dict(conf), device="cpu"), PF),
                    (st.TpuSession(dict(conf)), JF)):
        q = sess.create_dataframe(at).group_by("k").agg(
            F.sum("v").alias("s"), F.count("*").alias("c"))
        got = {}
        for k, s, c in zip(*[q.to_arrow().column(i).to_pylist()
                             for i in range(3)]):
            got["nan" if k is not None and math.isnan(k) else k] = (s, c)
        outs.append(got)
    port, jax = outs
    assert port == jax
    assert set(port) == {"nan", 1.0, 0.0, None}
    assert port["nan"][1] == 80 and port[0.0][1] == 80
