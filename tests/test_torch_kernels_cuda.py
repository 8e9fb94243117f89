"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. The module imports neither JAX nor the JAX package,
so it also runs where only the port is installed; on the card:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Covered: both variants of the partition kernel (the vector kernel on
aligned tensors, the scalar kernel on views at row offsets 1-3), lengths
around the vector kernel's 4-row chunks and 1,024-row blocks, and the
per-variant launch counts. Tolerance: exact (partition ids are integers).
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.ops import partition_kernels as pk

NUM_PARTITIONS = [1, 7, 16, 200, 2**31 - 1]
TILE_EDGES = [1, 2, 3, 4, 5, 15, 16, 17, 1023, 1024, 1025, 4095, 4096,
              4097, 4099, 4096 + 17]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2**31, 2**31 - 1, n, endpoint=True).astype(np.int32)
    edge = np.array([-2**31, 2**31 - 1, 0, -1, 1, 42], np.int32)
    vals[:min(n, len(edge))] = edge[:n]
    return vals, rng.integers(0, 2, n).astype(bool)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("num_partitions", NUM_PARTITIONS)
def test_partition_kernel_matches_plain(cuda, n, num_partitions):
    vals, valid = _keys(n, seed=n)
    before = (pk.launches, pk.vector_launches)
    got = pk.partition_ids_i32(torch.from_numpy(vals).to(cuda),
                               torch.from_numpy(valid).to(cuda),
                               num_partitions)
    torch.cuda.synchronize()
    assert (pk.launches, pk.vector_launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = pk.partition_ids_i32_ref(torch.from_numpy(vals),
                                   torch.from_numpy(valid), num_partitions)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_partition_kernel_empty_input_launches_nothing(cuda):
    before = pk.launches
    out = pk.partition_ids_i32(torch.zeros(0, dtype=torch.int32,
                                           device=cuda),
                               torch.zeros(0, dtype=torch.bool, device=cuda),
                               8)
    assert out.shape == (0,) and pk.launches == before


@pytest.mark.cuda
def test_partition_kernel_rejects_strided_input(cuda):
    vals = torch.zeros(16, dtype=torch.int32, device=cuda)[::2]
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        pk.partition_ids_i32(vals, valid, 8)


def _counts():
    return pk.launches, pk.vector_launches, pk.scalar_launches


def _at_offset(cuda, arr, offset):
    """arr on the card as a view `offset` elements into a fresh buffer."""
    t = torch.from_numpy(arr)
    buf = torch.empty(len(arr) + offset, dtype=t.dtype, device=cuda)
    buf[offset:].copy_(t)
    return buf[offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("n", TILE_EDGES)
@pytest.mark.parametrize("num_partitions", [200, 2**31 - 1])
def test_vector_kernel_at_tile_edges(cuda, n, num_partitions):
    vals, valid = _keys(n, seed=n + 1)
    before = _counts()
    got = pk.partition_ids_i32(_at_offset(cuda, vals, 0),
                               _at_offset(cuda, valid, 0), num_partitions)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])
    ref = pk.partition_ids_i32_ref(torch.from_numpy(vals),
                                   torch.from_numpy(valid), num_partitions)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 4097, (1 << 20) + 3])
def test_views_at_row_offsets(cuda, offset, n):
    """Row offsets 1-3 break the 16 B alignment: the scalar kernel runs;
    at offset 4 the vector kernel does."""
    vals, valid = _keys(n, seed=offset)
    kv, vv = _at_offset(cuda, vals, offset), _at_offset(cuda, valid, offset)
    kind = "vector" if offset == 4 else "scalar"
    assert pk.variant(kv.data_ptr(), vv.data_ptr(),
                      torch.empty_like(kv).data_ptr()) == kind
    before = _counts()
    got = pk.partition_ids_i32(kv, vv, 200)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_counts(), before))
    assert moved == ((1, 1, 0) if kind == "vector" else (1, 0, 1))
    ref = pk.partition_ids_i32_ref(torch.from_numpy(vals),
                                   torch.from_numpy(valid), 200)
    assert torch.equal(got.cpu(), ref)
