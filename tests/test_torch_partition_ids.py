"""Hash-partition ids of the PyTorch port against the JAX package.

The port's plain partition-id function (the CPU side of the Hopper
kernel) must equal, bit for bit, both the Pallas kernel it replaces (run
in interpret mode, as the JAX package's own tests run it on the CPU) and
the JAX package's `hash.partition_ids`; the port's murmur3 fold must
equal `hash.partition_ids` for int64, decimal64, boolean and two-key
rows. The kernels' division (Lemire's fastmod by the host-computed
`pmod_magic`, emulated step for step by `pmod_fastmod`) must equal floor
modulo and, after the port's murmur3, the Pallas kernel; the alignment
rule that picks the vector or scalar kernel is checked on CPU tensors
and views. Tolerance: exact, since ids are integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import dtypes as jdt
from spark_rapids_tpu.ops import hash as jhash
from spark_rapids_tpu.ops.kernel_utils import CV as JCV
from spark_rapids_tpu.ops.pallas_kernels import pallas_partition_ids_i32
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.ops import hash as phash
from spark_rapids_tpu_torch.ops import partition_kernels as pk
from spark_rapids_tpu_torch.ops.kernel_utils import CV as PCV

I32_MIN, I32_MAX = -2**31, 2**31 - 1
NUM_PARTITIONS = [1, 7, 16, 200, 2**31 - 1]
PMOD_PARTITIONS = [1, 2, 3, 7, 16, 200, 2**30 + 1, 2**31 - 1]
EDGE_KEYS = [I32_MIN, I32_MAX, 0, 1, -1, 42]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _keys(n, validity, seed=0):
    """int32 keys with the extremes up front, and a validity pattern."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
    edge = np.array([I32_MIN, I32_MAX, 0, -1, 1, 42], np.int32)
    vals[:min(n, len(edge))] = edge[:n]
    if validity == "none_null":
        valid = np.ones(n, bool)
    elif validity == "all_null":
        valid = np.zeros(n, bool)
    else:
        valid = rng.integers(0, 2, n).astype(bool)
    return vals, valid


def _jax_ids(vals, valid, n):
    cv = JCV(jnp.asarray(vals), jnp.asarray(valid))
    return np.asarray(jhash.partition_ids([cv], [jdt.INT32], n))


@pytest.mark.parametrize("validity", ["none_null", "all_null", "mixed"])
@pytest.mark.parametrize("num_partitions", NUM_PARTITIONS)
def test_plain_matches_pallas_and_jax_hash(validity, num_partitions):
    vals, valid = _keys(2048, validity, seed=num_partitions % 97)
    pallas = np.asarray(pallas_partition_ids_i32(
        jnp.asarray(vals), jnp.asarray(valid), num_partitions,
        interpret=True))
    ref = pk.partition_ids_i32_ref(torch.from_numpy(vals),
                                   torch.from_numpy(valid),
                                   num_partitions)
    assert ref.dtype == torch.int32
    np.testing.assert_array_equal(ref.numpy(), pallas)
    np.testing.assert_array_equal(ref.numpy(),
                                  _jax_ids(vals, valid, num_partitions))


@pytest.mark.parametrize("length", [1, 6, 1000, 1027])
@pytest.mark.parametrize("num_partitions", NUM_PARTITIONS)
def test_any_length_matches_jax_hash(length, num_partitions):
    """Lengths the Pallas kernel's 1024-row tiling cannot take."""
    vals, valid = _keys(length, "mixed", seed=length)
    got = pk.partition_ids_i32(torch.from_numpy(vals),
                               torch.from_numpy(valid), num_partitions)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_ids(vals, valid, num_partitions))


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    vals, valid = _keys(4096, "mixed")
    before = pk.launches
    got = pk.partition_ids_i32(torch.from_numpy(vals),
                               torch.from_numpy(valid), 16)
    ref = pk.partition_ids_i32_ref(torch.from_numpy(vals),
                                   torch.from_numpy(valid), 16)
    assert torch.equal(got, ref)
    assert pk.launches == before


@pytest.mark.parametrize("bad", [
    dict(vals=np.zeros(4, np.int64)),
    dict(valid=np.zeros(4, np.uint8)),
    dict(valid=np.zeros(5, bool)),
    dict(n=0),
    dict(n=2**31),
])
def test_wrapper_rejects_bad_arguments(bad):
    vals = torch.from_numpy(bad.get("vals", np.zeros(4, np.int32)))
    valid = torch.from_numpy(bad.get("valid", np.ones(4, bool)))
    with pytest.raises((TypeError, ValueError)):
        pk.partition_ids_i32(vals, valid, bad.get("n", 8))


def _multi_key_case(kind, n, rng):
    """(jax cvs, port cvs, jax dtypes, port dtypes) for a key layout."""
    cols = []
    if kind in ("int64", "two_keys"):
        v = rng.integers(-2**63, 2**63 - 1, n, endpoint=True,
                         dtype=np.int64)
        v[:3] = [-2**63, 2**63 - 1, -1]
        cols.append((v, jdt.INT64, pdt.INT64))
    if kind == "decimal64":
        v = rng.integers(-10**17, 10**17, n).astype(np.int64)
        cols.append((v, jdt.DecimalType(18, 2), pdt.DecimalType(18, 2)))
    if kind == "bool":
        cols.append((rng.integers(0, 2, n).astype(bool), jdt.BOOL,
                     pdt.BOOL))
    if kind in ("two_keys", "date"):
        v = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
        cols.append((v, jdt.DATE, pdt.DATE))
    out = ([], [], [], [])
    for data, jt, pt_ in cols:
        valid = rng.integers(0, 4, n) > 0
        out[0].append(JCV(jnp.asarray(data), jnp.asarray(valid)))
        out[1].append(PCV(torch.from_numpy(data), torch.from_numpy(valid)))
        out[2].append(jt)
        out[3].append(pt_)
    return out


@pytest.mark.parametrize("kind", ["int64", "decimal64", "bool", "date",
                                  "two_keys"])
@pytest.mark.parametrize("num_partitions", [1, 16, 200, 2**31 - 1])
def test_murmur3_fold_matches_jax(kind, num_partitions):
    rng = np.random.default_rng(7)
    jcvs, pcvs, jts, pts = _multi_key_case(kind, 1500, rng)
    exp = np.asarray(jhash.partition_ids(jcvs, jts, num_partitions))
    got = phash.partition_ids(pcvs, pts, num_partitions)
    np.testing.assert_array_equal(got.numpy(), exp)
    jrow = np.asarray(jhash.murmur3_row_hash(jcvs, jts))
    prow = phash.to_signed32(phash.murmur3_row_hash(pcvs, pts)).numpy()
    np.testing.assert_array_equal(prow, jrow)


def _hashes(n, seed):
    """int32 values as signed hashes: the extremes, then random ones."""
    rng = np.random.default_rng(seed)
    h = rng.integers(I32_MIN, I32_MAX, n, endpoint=True).astype(np.int32)
    edge = np.array(EDGE_KEYS + [I32_MIN + 1, I32_MAX - 1, -42], np.int32)
    h[:len(edge)] = edge
    return h


@pytest.mark.parametrize("num_partitions", PMOD_PARTITIONS)
def test_pmod_fastmod_is_floor_modulo(num_partitions):
    magic = pk.pmod_magic(num_partitions)
    assert 0 <= magic < 2**64
    # magic = ceil(2^64 / n) mod 2^64: magic * n overshoots 2^64 by < n
    assert (magic * num_partitions) % 2**64 < num_partitions
    h = _hashes(20000, seed=num_partitions % 101)
    got = pk.pmod_fastmod(h, num_partitions)
    exp = torch.remainder(torch.from_numpy(h).to(torch.int64),
                          num_partitions).to(torch.int32).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("num_partitions", PMOD_PARTITIONS)
def test_kernel_arithmetic_matches_pallas(num_partitions):
    """murmur3, null -> 42, then the kernels' fastmod pmod, against the
    Pallas kernel on the same keys."""
    vals, valid = _keys(2048, "mixed", seed=num_partitions % 89)
    valid[:len(EDGE_KEYS)] = True
    valid[len(EDGE_KEYS):2 * len(EDGE_KEYS)] = False
    vals[len(EDGE_KEYS):2 * len(EDGE_KEYS)] = EDGE_KEYS
    seed = torch.full((len(vals),), 42, dtype=torch.int64)
    h = phash.to_signed32(phash.hash_int32(torch.from_numpy(vals), seed))
    h = torch.where(torch.from_numpy(valid), h, 42).numpy()
    got = pk.pmod_fastmod(h, num_partitions)
    pallas = np.asarray(pallas_partition_ids_i32(
        jnp.asarray(vals), jnp.asarray(valid), num_partitions,
        interpret=True))
    np.testing.assert_array_equal(got, pallas)
    ref = pk.partition_ids_i32_ref(torch.from_numpy(vals),
                                   torch.from_numpy(valid), num_partitions)
    np.testing.assert_array_equal(ref.numpy(), pallas)


@pytest.mark.parametrize("key_off,valid_off,out_off,kind", [
    (0, 0, 0, "vector"),
    (4, 4, 0, "vector"),      # 16 B key offset, 4 B validity offset
    (8, 8, 4, "vector"),
    (1, 1, 0, "scalar"),      # a view at an odd row offset
    (2, 2, 0, "scalar"),
    (3, 3, 0, "scalar"),
    (0, 2, 0, "scalar"),      # validity word misaligned
    (0, 0, 1, "scalar"),      # output misaligned
    (2, 0, 0, "scalar"),      # keys 8 B aligned only
])
def test_variant_follows_pointer_alignment(key_off, valid_off, out_off,
                                           kind):
    keys = torch.zeros(64, dtype=torch.int32)
    valid = torch.ones(64, dtype=torch.bool)
    out = torch.empty(64, dtype=torch.int32)
    assert keys.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert valid.data_ptr() % 16 == 0
    assert pk.variant(keys[key_off:].data_ptr(),
                      valid[valid_off:].data_ptr(),
                      out[out_off:].data_ptr()) == kind


@pytest.mark.parametrize("offset", range(8))
def test_variant_of_row_offset_views(offset):
    """Keys and validity viewed one row range in, output fresh: the
    vector kernel exactly when the offset is a multiple of 4 rows."""
    vals, valid = _keys(100, "mixed", seed=offset)
    # clones: torch's allocator aligns a buffer to 64 B
    kv = torch.from_numpy(vals).clone()[offset:]
    vv = torch.from_numpy(valid).clone()[offset:]
    out = torch.empty_like(kv)
    assert pk.variant(kv.data_ptr(), vv.data_ptr(), out.data_ptr()) == (
        "vector" if offset % 4 == 0 else "scalar")
    # on the CPU the wrapper runs the plain version, whatever the rule
    before = (pk.launches, pk.vector_launches, pk.scalar_launches)
    got = pk.partition_ids_i32(kv, vv, 200)
    assert (pk.launches, pk.vector_launches, pk.scalar_launches) == before
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_ids(vals[offset:], valid[offset:],
                                           200))
