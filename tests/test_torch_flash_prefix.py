"""PyTorch port: the prefix-LM mask of the attention lowerings and the flash
kernel's plain versions, against the reference on the CPU.

PaliGemma's image is a bidirectional prefix: key ``col`` is open to every
row when ``col < prefix_len``, beside the right-aligned causal mask
(``src/repro/models/layers.py``, ``_dense_attention`` and
``_chunked_attention``). The port's dense lowering, its chunked lowering
(``ops.flash_attention``: on the CPU the flash kernel's plain version and
its plain backward) and ``multihead_attention``'s routing are held against
the reference's on the same numpy-seeded inputs, forward and ``jax.grad``,
for prefixes of 0, less than one block, across blocks and at or past Sk,
with Sq != Sk both ways, and the backward at head dim 256 (gemma-2b's and
paligemma-3b's). Tolerance: 2e-5 (abs and rel) in f32, where the
frameworks order their sums differently (the flash tests' limit). The
kernel wrappers' checks (head dim 256 with a prefix, in the forward's plan
and the backward's) run without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _chunked_attention, _dense_attention
from repro.models.layers import multihead_attention as ref_mha
from repro_torch.kernels import flash_attention as kernel
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

TOL = (2e-5, 2e-5)
BLOCK = 32
SHAPES = [  # (B, Hq, Hkv, Sq, Sk, D)
    (1, 4, 2, 64, 96, 32),   # Sq < Sk, g = 2
    (1, 2, 1, 96, 64, 64),   # Sq > Sk: rows with no key unless a prefix
]
PREFIXES = [0, 8, 40, 64, 200]  # none, < one block, across blocks, = Sk or Sq, past both
# the backward also at head dim 256, MQA as gemma-2b's and paligemma-3b's heads
BWD_SHAPES = SHAPES + [(1, 4, 1, 64, 64, 256), (1, 2, 1, 96, 64, 256)]


def _inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    return q, k, v, do


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=TOL[0], rtol=TOL[1])


def _ref_fns(prefix, D):
    scale = 1.0 / np.sqrt(D)
    return {
        "dense": lambda q, k, v: _dense_attention(q, k, v, causal=True, prefix_len=prefix,
                                                  scale=scale),
        "chunked": lambda q, k, v: _chunked_attention(q, k, v, causal=True, prefix_len=prefix,
                                                      scale=scale, block_q=BLOCK,
                                                      block_k=BLOCK),
    }


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_forward_matches_both_reference_lowerings(shape, prefix):
    arrs = _inputs(0, *shape)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    got = ops.flash_attention(q, k, v, block_q=BLOCK, block_k=BLOCK, prefix_len=prefix)
    plain = ref.flash_attention_plain(q, k, v, block_q=BLOCK, block_k=BLOCK,
                                      prefix_len=prefix)
    assert torch.equal(got, plain)
    for name, fn in _ref_fns(prefix, shape[-1]).items():
        want = np.asarray(fn(*(jnp.asarray(a) for a in arrs[:3])))
        _close(got.numpy(), want)


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_plain_backward_matches_jax_grad_of_both_lowerings(shape, prefix):
    arrs = _inputs(1, *shape)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    out = ops.flash_attention(q, k, v, block_q=BLOCK, block_k=BLOCK, prefix_len=prefix)
    ours = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrs[3]))
    js = [jnp.asarray(a) for a in arrs]
    for name, fn in _ref_fns(prefix, shape[-1]).items():
        want = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * js[3]),
                        argnums=(0, 1, 2))(*js[:3])
        for g, w in zip(ours, want):
            _close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prefix", [8, 40, 200])
def test_plain_backward_matches_autograd_through_the_plain_forward(prefix):
    """The backward's skip rule with a prefix (key blocks past every row's
    diagonal but inside the prefix are read) against autograd through the
    forward's plain version, in f64."""
    arrs = _inputs(2, 1, 4, 2, 96, 64, 32)
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True) for a in arrs[:3])
    do = torch.from_numpy(arrs[3]).double()
    out, m, l = ref.flash_attention_plain(q, k, v, block_q=BLOCK, block_k=BLOCK,
                                          return_stats=True, prefix_len=prefix)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = ref.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                        m, l, do, block_q=BLOCK, block_k=BLOCK,
                                        prefix_len=prefix)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-10)


def test_a_prefix_gives_every_row_a_key():
    """Sq > Sk: without a prefix the first Sq - Sk rows see no key (the mean
    of v over all keys); with one they see exactly the prefix's keys."""
    arrs = _inputs(3, 1, 2, 1, 96, 64, 32)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    out, m, _ = ref.flash_attention_plain(q, k, v, block_q=BLOCK, block_k=BLOCK,
                                          return_stats=True, prefix_len=5)
    assert bool((m > -1e29).all())
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, :32], k[:, :, :5].expand(-1, 2, -1, -1))
    p = torch.softmax(s / np.sqrt(32), dim=-1)
    want = torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, :5].expand(-1, 2, -1, -1))
    torch.testing.assert_close(out[:, :, :32], want, atol=TOL[0], rtol=TOL[1])


@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("prefix", [None, 0, 16, 48])
def test_multihead_attention_routes_and_masks_as_the_reference(S, prefix):
    """The routing of ``multihead_attention`` (threshold 64: S = 32 dense,
    S = 64 chunked) with a prefix, against the reference's, forward and
    gradients."""
    arrs = _inputs(4, 2, 4, 2, S, S, 32)
    kw = dict(causal=True, prefix_len=prefix, chunked_threshold=64, block_q=BLOCK,
              block_k=BLOCK)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    out = layers.multihead_attention(q, k, v, **kw)
    ours = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrs[3]))
    js = [jnp.asarray(a) for a in arrs]
    _close(out.detach().numpy(), np.asarray(ref_mha(*js[:3], **kw)))
    want = jax.grad(lambda q, k, v: jnp.sum(ref_mha(q, k, v, **kw) * js[3]),
                    argnums=(0, 1, 2))(*js[:3])
    for g, w in zip(ours, want):
        _close(g.numpy(), np.asarray(w))


def test_non_causal_calls_ignore_the_prefix():
    """As the reference's lowerings: the prefix widens the causal mask only."""
    arrs = _inputs(5, 1, 2, 1, 64, 64, 32)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    a = ops.flash_attention(q, k, v, causal=False, block_q=BLOCK, block_k=BLOCK, prefix_len=9)
    b = ops.flash_attention(q, k, v, causal=False, block_q=BLOCK, block_k=BLOCK)
    assert torch.equal(a, b)
    c = layers.dense_attention(q, k, v, causal=False, scale=0.125, prefix_len=9)
    _close(c.numpy(), np.asarray(_dense_attention(*(jnp.asarray(x) for x in arrs[:3]),
                                                  causal=False, prefix_len=9, scale=0.125)))


@pytest.mark.parametrize("dtype, route", [(torch.bfloat16, "wgmma"), (torch.float16, "wgmma"),
                                          (torch.float32, "simt")])
def test_launch_plan_takes_head_dim_256(dtype, route):
    """paligemma's head dim: both forward routes take it, with a prefix."""
    shapes = [(2, 8, 8192, 256), (2, 1, 8192, 256), (2, 1, 8192, 256)]
    strides = [(8 * 8192 * 256, 8192 * 256, 256, 1)] + [(8192 * 256, 8192 * 256, 256, 1)] * 2
    r, maps = kernel.launch_plan(dtype, shapes, strides, [1 << 20] * 3, prefix_len=256)
    assert r == route
    if route == "wgmma":
        assert [mp[0] for mp in maps] == [256] * 3


def test_launch_plan_refuses_a_negative_prefix():
    shapes = [(1, 2, 64, 64), (1, 1, 64, 64), (1, 1, 64, 64)]
    strides = [(2 * 64 * 64, 64 * 64, 64, 1)] + [(64 * 64, 64 * 64, 64, 1)] * 2
    with pytest.raises(ValueError, match="prefix_len"):
        kernel.launch_plan(torch.float32, shapes, strides, [0] * 3, prefix_len=-1)


def _bwd_plan(dtype, D, prefix):
    shapes = [(1, 2, 64, D), (1, 1, 64, D), (1, 1, 64, D), (1, 2, 64, D), (1, 2, 64, D)]
    strides = [(2 * 64 * D, 64 * D, D, 1), (64 * D, 64 * D, D, 1), (64 * D, 64 * D, D, 1),
               (2 * 64 * D, 64 * D, D, 1), (2 * 64 * D, 64 * D, D, 1)]
    return kernel.bwd_launch_plan(dtype, shapes, strides, [1 << 20] * 5, prefix)


@pytest.mark.parametrize("prefix", [0, 16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_plan_takes_a_prefix_and_every_forward_head_dim(dtype, D, prefix):
    """The backward kernel takes what the forward takes: every head dim of
    ``HEAD_DIMS``, with or without a prefix, on both routes."""
    assert D in kernel.HEAD_DIMS
    assert _bwd_plan(dtype, D, prefix) == kernel.BWD_ROUTES[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_plan_refuses_what_the_forward_refuses(dtype):
    """A head dim outside ``HEAD_DIMS`` and a negative prefix raise, as the
    forward's plan does; nothing else about them is refused."""
    with pytest.raises(ValueError, match="head dim D in .* not 48"):
        _bwd_plan(dtype, 48, 0)
    with pytest.raises(ValueError, match="prefix_len"):
        _bwd_plan(dtype, 64, -1)
    assert not hasattr(kernel, "check_bwd_supported")


def test_kernel_wrapper_with_a_prefix_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 64, 256), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 64, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention(q, k, k, prefix_len=16)
