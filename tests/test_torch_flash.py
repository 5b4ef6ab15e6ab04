"""PyTorch port: ``ops.flash_attention`` on the CPU against the JAX kernel.

On the CPU the port's entry point runs the kernel's plain version
(``kernels.ref.flash_attention_plain``, blocked online softmax in f32). It
is held against the reference's Pallas ``_flash_kernel`` run in interpret
mode and against the reference's pure-JAX ``_chunked_attention``, on the
same numpy-seeded inputs. Tolerances are the reference test's: 2e-5 (abs
and rel) in f32, 3e-2 in bf16; f16 gets 2e-3, two f16 ulps at |out| < 2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models.layers import _chunked_attention
from repro_torch.kernels import flash_attention as kernel
from repro_torch.kernels import ops, ref

SHAPES = [  # (B, Hq, Hkv, Sq, Sk, D): tests/kernels/test_flash_attention.py
    (1, 1, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),      # GQA
    (1, 8, 1, 128, 128, 128),     # MQA
    (1, 4, 4, 128, 512, 64),      # decode-aligned Sq < Sk
    (2, 2, 2, 384, 384, 32),      # non-pow2 seq (3 blocks of 128)
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 2e-3}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def _ours(arrs, dtype="float32", **kw):
    ts = [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrs]
    out = ops.flash_attention(*ts, **kw)
    assert out.dtype == _TORCH[dtype] and out.shape == ts[0].shape
    return out.float().numpy()


def _jax(arrs, dtype="float32", **kw):
    js = [jnp.asarray(a, dtype) for a in arrs]
    return np.asarray(rops.flash_attention(*js, use_pallas="interpret", **kw), np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matches_jax_kernel_f32(shape):
    arrs = _inputs(0, *shape)
    _close(_ours(arrs, causal=True), _jax(arrs, causal=True), TOL["float32"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(1, 2, 2, 128, 128, 64), (1, 14, 2, 256, 256, 64)],
                         ids=str)
def test_matches_jax_kernel_half(shape, dtype):
    """bf16 and f16 inputs: f32 inside, output rounded to the input dtype.
    (1, 14, 2, ...) is qwen2-0.5b's head layout, a group of 7."""
    arrs = _inputs(1, *shape)
    _close(_ours(arrs, dtype), _jax(arrs, dtype), TOL[dtype])


def test_non_causal():
    arrs = _inputs(2, 1, 2, 1, 128, 256, 64)
    _close(_ours(arrs, causal=False), _jax(arrs, causal=False), TOL["float32"])


def test_scale_override():
    arrs = _inputs(3, 1, 1, 1, 128, 128, 64)
    _close(_ours(arrs, scale=0.5), _jax(arrs, scale=0.5), TOL["float32"])


def test_block_shape_independence():
    arrs = _inputs(4, 1, 2, 2, 256, 256, 64)
    a = _ours(arrs, block_q=128, block_k=128)
    b = _ours(arrs, block_q=64, block_k=256)
    _close(a, b, TOL["float32"])
    _close(b, _jax(arrs, block_q=64, block_k=256), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_with_no_key_are_the_mean_of_v(dtype):
    """Sq > Sk, causal: rows 0..Sq-Sk-1 see no key. Masked logits are
    -1e30, not -inf, so every key weighs exp(0) = 1 there and the row comes
    out as the mean of v over all Sk keys, in the JAX kernel and here."""
    B, Hq, Hkv, Sq, Sk, D = 1, 2, 1, 256, 128, 64
    arrs = _inputs(5, B, Hq, Hkv, Sq, Sk, D)
    ours, want = _ours(arrs, dtype), _jax(arrs, dtype)
    _close(ours, want, TOL[dtype])
    v = np.asarray(jnp.asarray(arrs[2], dtype), np.float32)
    mean = np.repeat(v.mean(axis=2), Hq // Hkv, axis=1)[:, :, None]
    n = Sq - Sk
    _close(ours[:, :, :n], np.broadcast_to(mean, (B, Hq, n, D)), TOL[dtype])
    _close(want[:, :, :n], np.broadcast_to(mean, (B, Hq, n, D)), TOL[dtype])
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("shape", [(2, 4, 2, 256, 256, 32), (1, 14, 2, 128, 128, 64)],
                         ids=str)
def test_matches_jax_chunked_attention_at_smoke_blocks(shape):
    """The model's long-S lowering at the smoke config's 32/32 blocks."""
    arrs = _inputs(6, *shape)
    scale = 1.0 / np.sqrt(shape[-1])
    want = _chunked_attention(*map(jnp.asarray, arrs), causal=True, prefix_len=None,
                              scale=scale, block_q=32, block_k=32)
    _close(_ours(arrs, scale=scale, block_q=32, block_k=32), np.asarray(want),
           TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_twin(causal):
    arrs = _inputs(7, 2, 4, 2, 64, 128, 32)
    ts = [torch.from_numpy(a) for a in arrs]
    got = ref.mha_reference(*ts, causal=causal).numpy()
    want = rref.mha_reference(*map(jnp.asarray, arrs), causal=causal)
    _close(got, np.asarray(want), TOL["float32"])
    _close(_ours(arrs, causal=causal), got, TOL["float32"])


@pytest.mark.parametrize("shape,match", [
    ((1, 3, 2, 128, 128, 64), "multiple of Hkv"),
    ((1, 2, 1, 192, 192, 64), "not divisible by blocks"),   # Sq % 128
    ((1, 2, 1, 128, 320, 64), "not divisible by blocks"),   # Sk % 128
])
def test_same_value_errors_as_reference(shape, match):
    arrs = _inputs(8, *shape)
    with pytest.raises(ValueError, match=match):
        _jax(arrs)
    with pytest.raises(ValueError, match=match):
        _ours(arrs)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's own wrapper takes only CUDA tensors; it fails before it
    builds or loads anything, so this runs without a card."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, 1, 2, 1, 64, 64, 64))
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention(q, k, v)
    assert kernel.flash_attention.launches == before


def test_entry_point_refuses_other_devices():
    q = torch.empty((1, 2, 64, 64), device="meta")
    k = torch.empty((1, 1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel for device"):
        ops.flash_attention(q, k, k)


# The kernel wrapper's route and layout checks, as a pure function of dtype,
# shapes, strides and data pointers: no card needed.
_SERVE = ((2, 14, 8192, 64), (2, 2, 8192, 64))


def _plan(dtype, shapes=_SERVE, strides=None, ptrs=(0, 0, 0)):
    qs, ks = shapes
    strides = strides or [torch.empty(s, device="meta").stride() for s in (qs, ks, ks)]
    return kernel.launch_plan(dtype, (qs, ks, ks), strides, ptrs)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"), (torch.bfloat16, "wgmma"),
                                         (torch.float16, "wgmma")])
def test_route_is_fixed_by_dtype(dtype, route):
    assert kernel.route(dtype) == route
    r, maps = _plan(dtype)
    assert r == route
    assert (maps is None) == (route == "simt")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32, torch.float8_e4m3fn])
def test_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="takes float32, bfloat16 or float16"):
        kernel.route(dtype)


def test_tensor_maps_of_contiguous_operands():
    """(B, H, S, D) contiguous: the map is (D, S, H, B) with the tensor's
    byte strides, S in slot 1 and H in slot 2."""
    _, (mq, mk, mv) = _plan(torch.bfloat16)
    assert mq == (64, 8192, 14, 2, 128, 8192 * 128, 14 * 8192 * 128, 1 | 2 << 2)
    assert mk == mv == (64, 8192, 2, 2, 128, 8192 * 128, 2 * 8192 * 128, 1 | 2 << 2)


def test_tensor_map_of_the_models_transposed_v():
    """The model's v is (B, Sk, Hkv, D) seen as (B, Hkv, Sk, D): strides
    (Sk*Hkv*D, D, Hkv*D, 1). H has the smaller stride, so the map is
    (D, H, S, B) and S sits in slot 2: the same bytes, no copy."""
    B, Hkv, Sk, D = 2, 2, 8192, 64
    v = torch.empty((B, Sk, Hkv, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
    assert v.stride() == (Sk * Hkv * D, D, Hkv * D, 1)
    m = kernel.tensor_map("v", v.shape, v.stride(), 2, 0)
    assert m == (D, Hkv, Sk, B, D * 2, Hkv * D * 2, Sk * Hkv * D * 2, 2 | 1 << 2)


def test_tensor_map_puts_size_one_dims_last():
    m = kernel.tensor_map("q", (1, 1, 100, 64), (6400, 6400, 64, 1), 2, 0)
    assert m[:4] == (64, 100, 1, 1)
    assert m[4] == 128 and m[5] == m[6] and m[5] % 16 == 0 and m[5] >= 100 * 128
    assert m[7] == 1 | 2 << 2


# the model's v view over a (1, 8192, 2, 65) buffer cut to D = 64: strides
# (2*65*8192, 65, 2*65, 1), so 260 bytes between keys in 16 bits
_WIDE_V = [(524288, 65536, 64, 1), (65536, 8192, 64, 1), (65 * 2 * 8192, 65, 65 * 2, 1)]
_SMALL = ((1, 8, 1024, 64), (1, 2, 8192, 64))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shapes,strides,ptrs,match", [
    (_SMALL, _WIDE_V, (0, 0, 0), "v's s stride of 260 bytes is not a positive multiple of 16"),
    (_SERVE, None, (0, 2, 0), "k's data pointer is not 16-byte aligned"),
    (_SERVE, None, (8, 0, 0), "q's data pointer is not 16-byte aligned"),
], ids=["v-stride", "k-pointer", "q-pointer"])
def test_tensor_core_route_refuses_what_tma_cannot_read(dtype, shapes, strides, ptrs, match):
    with pytest.raises(ValueError, match=match):
        _plan(dtype, shapes, strides, ptrs)


def test_cuda_core_route_takes_any_stride_and_pointer():
    """f32 reads element by element: no TMA layout rules."""
    assert _plan(torch.float32, _SMALL, _WIDE_V, (4, 4, 4)) == ("simt", None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,strides,match", [
    (((1, 2, 64, 48), (1, 1, 64, 48)), None, "head dim D"),
    (((1, 3, 64, 64), (1, 2, 64, 64)), None, "multiple of Hkv"),
    (((1, 2, 64, 64), (2, 1, 64, 64)), None, "disagree on batch or head dim"),
    (((1, 2, 0, 64), (1, 1, 64, 64)), None, "non-empty"),
    (((1, 2, 64, 64), (1, 1, 64, 64)),
     [(8192, 4096, 64, 1), (4096, 4096, 1, 64), (4096, 4096, 64, 1)], "unit stride"),
])
def test_launch_plan_refuses_bad_shapes_on_both_routes(dtype, shapes, strides, match):
    with pytest.raises(ValueError, match=match):
        _plan(dtype, shapes, strides)
