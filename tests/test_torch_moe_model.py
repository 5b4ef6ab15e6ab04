"""PyTorch port: the reduced MoE models (moonshot-v1-16b-a3b,
arctic-480b) against the JAX reference on the CPU.

``reduced_for_smoke`` (2 layers, d_model 128, 4 experts top-2, f32): the
logits, the loss with its aux and the grads, router grads included, held
to ``jax.value_and_grad`` of the reference's loss below the
chunked-attention threshold (S = 16) and above it (S = 128); the port's
decode to the reference's ``decode_step`` at capacity 1.25; remat none,
dots and full bitwise equal. Weights cross with ``models/convert.py``.
Tolerances: 1e-5 (abs and rel), f32 on the CPU with the two frameworks'
sum orders. The MoE layer itself is held to the reference in
``test_torch_moe.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
from repro.configs import get_config as ref_get_config
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models.convert import state_from_numpy
from repro_torch.runtime.steps import loss_and_grads
from repro_torch.utils.tree import flatten_with_paths

ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]
B = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _batch(vocab, S, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    ref_cfg = ref_get_config(name, smoke=True)
    return name, ref_cfg, rmodels.build(ref_cfg).init(jax.random.key(0))


# -- the models ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 128])
def test_logits_loss_and_grads_match_reference(arch, S):
    name, ref_cfg, ref_params = arch
    cfg = get_config(name, smoke=True)
    assert (S >= cfg.attn_chunked_threshold) == (S == 128)
    batch = _batch(cfg.vocab_size, S)
    jb = jax.tree.map(jnp.asarray, batch)
    rmodel, model = rmodels.build(ref_cfg), build(cfg)
    params = state_from_numpy(_np(ref_params))
    with torch.no_grad():
        logits = model.forward(params, _tb(batch))
    _close(logits, rmodel.forward(ref_params, jb))
    (rloss, rmetrics), rgrads = jax.value_and_grad(rmodel.loss, has_aux=True)(ref_params, jb)
    loss, metrics, grads = loss_and_grads(model, params, _tb(batch))
    assert sorted(metrics) == sorted(rmetrics) == ["aux", "ce", "loss"]
    assert float(metrics["aux"]) > 0
    _close(loss, rloss)
    for key in metrics:
        _close(metrics[key], rmetrics[key])
    ref_flat, _ = ref_flatten(_np(rgrads))
    flat = flatten_with_paths(grads)[0]
    assert list(flat) == list(ref_flat) and "blocks/moe/router" in flat
    for path, g in flat.items():
        _close(g, ref_flat[path])


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_bitwise_equal_grads(arch, remat):
    name, _, ref_params = arch
    cfg = get_config(name, smoke=True).with_overrides(moe_capacity_factor=1.25)
    params = state_from_numpy(_np(ref_params))
    batch = _tb(_batch(cfg.vocab_size, 16, seed=2))
    loss, _, grads = loss_and_grads(build(cfg.with_overrides(remat=remat)), params, batch)
    base_loss, _, base = loss_and_grads(build(cfg.with_overrides(remat="none")), params, batch)
    assert torch.equal(loss, base_loss)
    base = flatten_with_paths(base)[0]
    for path, g in flatten_with_paths(grads)[0].items():
        assert torch.equal(g, base[path]), path


def test_decode_matches_reference_decode_step(arch):
    """Capacity 1.25: a decode step routes B tokens (G = 2, Cg = 1) and
    never drops, in both packages."""
    name, ref_cfg, ref_params = arch
    rcfg = ref_cfg.with_overrides(moe_capacity_factor=1.25)
    cfg = get_config(name, smoke=True).with_overrides(moe_capacity_factor=1.25)
    toks = _batch(cfg.vocab_size, 16, seed=3)["inputs"]
    rmodel, model = rmodels.build(rcfg), build(cfg)
    params = state_from_numpy(_np(ref_params))
    rcache = rmodel.init_cache(B, 16)
    cache = model.init_cache(B, 16, device="cpu")
    rdecode = jax.jit(rmodel.decode)
    with torch.no_grad():
        for t in range(8):
            rlg, rcache = rdecode(ref_params, rcache, jnp.asarray(toks[:, t]))
            lg, cache = model.decode(params, cache, torch.from_numpy(toks[:, t]))
            _close(lg, rlg)


# twins of tests/models/test_arch_smoke.py's MoE checks, on the port

@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """Teacher-forced decode reproduces the full forward's logits (no drops
    at the reduced configs' capacity 4.0)."""
    cfg = get_config(name, smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(_batch(cfg.vocab_size, 16, seed=4)["inputs"])
    with torch.no_grad():
        full = model.forward(params, {"inputs": toks})
        cache = model.init_cache(B, 16, device="cpu")
        errs = []
        for t in range(16):
            lg, cache = model.decode(params, cache, toks[:, t])
            errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-2, f"{name}: decode diverges from forward ({max(errs)})"


@pytest.mark.parametrize("name", ARCHS)
def test_moe_router_balances_under_training(name):
    cfg = get_config(name, smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, metrics = model.loss(params, _tb(_batch(cfg.vocab_size, 32)))
    assert float(metrics["aux"]) > 0  # balance loss active
