"""PyTorch port: model, loss, gradients and AdamW against the JAX reference.

A reduced qwen2 (``reduced_for_smoke``: 2 layers, d_model 128, f32) with S
below the chunked-attention threshold, and at and above it. Parity is by weight transfer: the
reference initialises, its arrays cross to the port as numpy, and both
compute on the same inputs. Tolerances are for f32 on the CPU, where the
two frameworks order their sums differently: 1e-5 (abs and rel) for
logits, loss and gradients, 1e-6 for the optimizer's params and moments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
import repro.optim as roptim
from repro.configs import get_config as ref_get_config
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config
from repro_torch.models import build, chunked_lm_xent, softmax_xent
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

B, S = 2, 16


@pytest.fixture(scope="module")
def ref_cfg():
    return ref_get_config("qwen2-0.5b", smoke=True)


@pytest.fixture(scope="module")
def cfg(ref_cfg):
    c = get_config("qwen2-0.5b", smoke=True)
    assert dataclasses.asdict(c) == dataclasses.asdict(ref_cfg)
    assert S < c.attn_chunked_threshold
    return c


@pytest.fixture(scope="module")
def ref_params(ref_cfg):
    return rmodels.build(ref_cfg).init(jax.random.key(0))


@pytest.fixture(scope="module")
def batch(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def test_param_tree_matches_reference(cfg, ref_params):
    ours = build(cfg).init(torch.Generator().manual_seed(0))
    ref_flat, _ = ref_flatten(ref_params)
    our_flat, _ = flatten_with_paths(ours)
    assert list(our_flat) == list(ref_flat)  # same paths, same (sorted) order
    for p in ref_flat:
        assert tuple(our_flat[p].shape) == ref_flat[p].shape, p
        assert str(our_flat[p].dtype).replace("torch.", "") == ref_flat[p].dtype.name


def test_weight_transfer_is_bitwise(ref_params):
    tparams = state_from_numpy(_np(ref_params))
    ref_flat, _ = ref_flatten(_np(ref_params))
    for p, t in flatten_with_paths(tparams)[0].items():
        assert t.numpy().tobytes() == ref_flat[p].tobytes(), p


def test_logits_and_loss_match_reference(cfg, ref_cfg, ref_params, batch):
    rmodel = rmodels.build(ref_cfg)
    model = build(cfg)
    tparams = state_from_numpy(_np(ref_params))
    jb = jax.tree.map(jnp.asarray, batch)
    with torch.no_grad():
        logits = model.forward(tparams, _tb(batch))
        loss, metrics = model.loss(tparams, _tb(batch))
    assert logits.shape == (B, S, cfg.vocab_size) and logits.dtype == torch.float32
    _close(logits, rmodel.forward(ref_params, jb), 1e-5)
    rloss, rmetrics = rmodel.loss(ref_params, jb)
    _close(loss, rloss, 1e-5)
    for k in ("loss", "ce", "aux"):
        _close(metrics[k], rmetrics[k], 1e-5)


def test_gradients_match_jax_grad(cfg, ref_cfg, ref_params, batch):
    rmodel = rmodels.build(ref_cfg)
    model = build(cfg)
    rgrads = jax.grad(lambda p: rmodel.loss(p, jax.tree.map(jnp.asarray, batch))[0])(
        ref_params
    )
    flat, treedef = flatten_with_paths(state_from_numpy(_np(ref_params)))
    leaves = {k: v.requires_grad_(True) for k, v in flat.items()}
    loss, _ = model.loss(unflatten_from_paths(treedef, leaves), _tb(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ref_flat, _ = ref_flatten(_np(rgrads))
    for (path, _), g in zip(leaves.items(), grads):
        _close(g, ref_flat[path], 1e-5)


def test_adamw_matches_reference_on_same_gradients(ref_params):
    rng = np.random.default_rng(2)
    ropt = roptim.get_optimizer("adamw", 1e-3)
    opt = adamw(1e-3)
    rp, rs = ref_params, ropt.init(ref_params)
    tparams = state_from_numpy(_np(ref_params))
    tstate = opt.init(tparams)
    for step in range(3):
        g = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, _np(rp)
        )
        rp, rs = jax.jit(ropt.update)(jax.tree.map(jnp.asarray, g), rs, rp,
                             jnp.asarray(step, jnp.int32))
        tparams, tstate = opt.update(state_from_numpy(g), tstate, tparams,
                                     torch.tensor(step, dtype=torch.int32))
    for name, ours, ref in (("params", tparams, rp), ("m", tstate["m"], rs["m"]),
                            ("v", tstate["v"], rs["v"])):
        ref_flat, _ = ref_flatten(_np(ref))
        for path, t in flatten_with_paths(ours)[0].items():
            _close(t, ref_flat[path], 1e-6)


@pytest.mark.parametrize("step", [0, 3, 9, 10, 15, 99])
def test_warmup_cosine_matches_reference(step):
    ref = roptim.warmup_cosine(3e-4, 10, 50)(step)
    _close(warmup_cosine(3e-4, 10, 50)(torch.tensor(step, dtype=torch.int32)), ref, 1e-9)


@pytest.mark.parametrize("chunk_tokens", [1, 4, 5, 16, 1024])
def test_chunked_ce_equals_full_ce(chunk_tokens):
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, 32)).astype(np.float32)
    table = rng.standard_normal((64, 32)).astype(np.float32)
    t = rng.integers(0, 64, (B, S)).astype(np.int32)
    full = softmax_xent(torch.from_numpy(h @ table.T), torch.from_numpy(t))
    got = chunked_lm_xent(torch.from_numpy(h), torch.from_numpy(table),
                          torch.from_numpy(t), chunk_tokens=chunk_tokens)
    ref = rmodels.zoo.chunked_lm_xent(jnp.asarray(h), jnp.asarray(table),
                                      jnp.asarray(t), chunk_tokens=chunk_tokens)
    for a, b, c in zip(got, full, ref):
        _close(a, b, 1e-5)
        _close(a, c, 1e-5)


@pytest.mark.parametrize("mult", [1, 2])
def test_long_sequence_forward_matches_reference(cfg, ref_cfg, ref_params, mult):
    """S = attn_chunked_threshold and twice it: both models take their
    long-S lowering (the reference's ``_chunked_attention``, the port's
    ``ops.flash_attention``), forward and loss."""
    rng = np.random.default_rng(4)
    S_long = cfg.attn_chunked_threshold * mult
    toks = rng.integers(0, cfg.vocab_size, (B, S_long + 1)).astype(np.int32)
    long_batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    rmodel = rmodels.build(ref_cfg)
    tparams = state_from_numpy(_np(ref_params))
    jb = jax.tree.map(jnp.asarray, long_batch)
    with torch.no_grad():
        logits = build(cfg).forward(tparams, _tb(long_batch))
        loss, _ = build(cfg).loss(tparams, _tb(long_batch))
    assert logits.shape == (B, S_long, cfg.vocab_size)
    _close(logits, rmodel.forward(ref_params, jb), 1e-5)
    _close(loss, rmodel.loss(ref_params, jb)[0], 1e-5)
