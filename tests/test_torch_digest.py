"""PyTorch port: chunk digests (plain version, dispatch, CUDA kernel).

The plain PyTorch version must equal the JAX reference's host oracle
``chunk_digests_np`` bit for bit (digests are integers: no tolerance), over
the reference's own DTYPES x SHAPES x CHUNKS sweep and its interpret-mode
shapes, where the Pallas kernel runs in the interpreter. The CUDA kernel
itself runs only on a card (``tests/test_torch_card.py``).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.chunking import chunk_digest_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import chunk_digest, ops, ref
from repro_torch.models.convert import array_to_tensor

# the reference's sweep (tests/kernels/test_chunk_digest.py)
DTYPES = [np.float32, np.int32, np.int8, np.uint8, np.float16, ml_dtypes.bfloat16]
SHAPES = [(17,), (1024,), (257, 33), (1, 1), (4096,), (63, 7, 5)]
CHUNKS = [64, 256, 4096]


def _rand(rng, dtype, shape):
    dt = np.dtype(dtype)
    if dt.kind == "f" or dt == np.dtype(ml_dtypes.bfloat16):
        return rng.standard_normal(shape).astype(np.float32).astype(dt)
    return rng.integers(0, 100, shape).astype(dt)


def _as_u32(d: torch.Tensor) -> np.ndarray:
    return d.numpy().astype(np.uint32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_numpy_oracle(rng, dtype, shape):
    x = _rand(rng, dtype, shape)
    t = array_to_tensor(x)
    for cb in CHUNKS:
        want = jref.chunk_digests_np(x, cb)
        assert np.array_equal(want, _as_u32(ref.chunk_digests_plain(t, cb))), cb
        assert np.array_equal(want, _as_u32(ops.chunk_digests(t, cb))), cb


@pytest.mark.parametrize("shape,cb", [
    ((1024,), 256), ((100_000,), 4096), ((7, 130), 512),
    ((2**20,), 4 << 20), ((2**18 + 3,), 65536),
])
def test_plain_matches_pallas_interpret(rng, shape, cb):
    x = rng.standard_normal(shape).astype(np.float32)
    pallas = np.asarray(jops.chunk_digests(jnp.asarray(x), cb, use_pallas="interpret"))
    got = _as_u32(ops.chunk_digests(torch.from_numpy(x), cb))
    assert np.array_equal(pallas, got)


@pytest.mark.parametrize("nbytes", [1, 2, 3, 5, 6, 7, 65, 4097, 4099])
@pytest.mark.parametrize("cb", [4, 8, 64, 4096])
def test_partial_last_word_matches_host_digest(rng, nbytes, cb):
    x = rng.integers(0, 256, nbytes).astype(np.uint8)
    d = _as_u32(ref.chunk_digests_plain(torch.from_numpy(x), cb))
    for i in range(d.shape[0]):
        want = chunk_digest_np(x[i * cb : (i + 1) * cb])
        assert (int(d[i, 0]) << 32) | int(d[i, 1]) == want


@pytest.mark.parametrize("shape", [(0,), (3, 0)])
def test_empty_leaf_follows_host_oracle(shape):
    x = np.zeros(shape, np.float32)
    d = ref.chunk_digests_plain(torch.from_numpy(x), 64)
    assert d.tolist() == [[0, 0]]
    assert chunk_digest_np(x) == 0
    assert ops.digests_to_u64(d).tolist() == [0]
    # known divergence, not fixed: the reference's jnp path seeds hi even
    # for an empty chunk; manifests hold host digests, so the port follows
    # chunk_digest_np
    jnp_d = np.asarray(jref.chunk_digests_jnp(jnp.asarray(x), 64))
    assert jnp_d.tolist() == [[int(jref.DIGEST_SEED), 0]]


def test_zero_d_tensor(rng):
    x = np.asarray(rng.standard_normal(), dtype=np.float32)
    d = ops.digests_to_u64(ref.chunk_digests_plain(torch.from_numpy(x), 64))
    assert d.tolist() == [chunk_digest_np(x)]


def test_cpu_tensor_never_launches_kernel(rng):
    before = chunk_digest.chunk_digests.launches
    t = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    ops.chunk_digests(t, 1024)
    ops.tree_chunk_digests({"a": t, "b": {"c": t[:7]}}, 64)
    assert chunk_digest.chunk_digests.launches == before


def test_kernel_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        chunk_digest.chunk_digests(torch.zeros(16), 64)


def test_dispatch_refuses_other_devices():
    with pytest.raises(ValueError, match="no chunk_digest kernel"):
        ops.chunk_digests(torch.zeros(16, device="meta"), 64)


def test_tree_digests_match_reference(rng):
    tree = {
        "w": rng.standard_normal((33, 17)).astype(np.float32),
        "b": rng.integers(0, 9, 5).astype(np.int8),
        "s": np.asarray(3, np.int32),
    }
    want = jops.tree_chunk_digests(tree, 64)
    torch_tree = {k: array_to_tensor(v) for k, v in tree.items()}
    assert ops.tree_chunk_digests(torch_tree, 64) == want
    # host leaves (numpy) take the numpy oracle path
    assert ops.tree_chunk_digests(tree, 64) == want
