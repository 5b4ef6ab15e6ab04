"""PyTorch port: the other dense configs (gemma-2b, granite-8b,
command-r-plus-104b) against the JAX reference on the CPU.

Each config is the reference's, field for field, registered under the same
id. At ``reduced_for_smoke`` size (2 layers, d_model 128, f32, the
config's own block kind: gemma's GeGLU and sqrt(D) embedding scale, MQA;
granite's GQA; command-r's parallel block and ``remat="full"``) the port's
param tree, logits, loss and grads are held against the reference's by
weight transfer, below the chunked-attention threshold (S = 16) and above
it (S = 128, the long-S lowering and its backward). Their full sizes do not
fit one card, so they are not run there. Tolerances: 1e-5 (abs and rel), f32
on the CPU with the two frameworks' sum orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
from repro.configs import get_config as ref_get_config
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config, list_archs
from repro_torch.models import build
from repro_torch.models.convert import state_from_numpy
from repro_torch.runtime.steps import loss_and_grads
from repro_torch.utils.tree import flatten_with_paths

ARCHS = ["gemma-2b", "granite-8b", "command-r-plus-104b"]
B = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    ref_cfg = ref_get_config(name, smoke=True)
    return name, ref_cfg, rmodels.build(ref_cfg).init(jax.random.key(0))


def _batch(vocab, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("name", ARCHS)
def test_config_is_the_reference_and_registered(name):
    assert name in list_archs()
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(ref_get_config(name))
    assert dataclasses.asdict(get_config(name, smoke=True)) == dataclasses.asdict(
        ref_get_config(name, smoke=True))


def test_param_tree_matches_reference(arch):
    name, _, ref_params = arch
    ours = build(get_config(name, smoke=True)).init(torch.Generator().manual_seed(0))
    ref_flat, _ = ref_flatten(ref_params)
    our_flat, _ = flatten_with_paths(ours)
    assert list(our_flat) == list(ref_flat)
    for p in ref_flat:
        assert tuple(our_flat[p].shape) == ref_flat[p].shape, p
        assert str(our_flat[p].dtype).replace("torch.", "") == ref_flat[p].dtype.name


@pytest.mark.parametrize("S", [16, 128])
def test_logits_loss_and_grads_match_reference(arch, S):
    name, ref_cfg, ref_params = arch
    cfg = get_config(name, smoke=True)
    assert (S >= cfg.attn_chunked_threshold) == (S == 128)
    batch = _batch(cfg.vocab_size, S)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    rmodel, model = rmodels.build(ref_cfg), build(cfg)
    params = state_from_numpy(_np(ref_params))
    with torch.no_grad():
        logits = model.forward(params, tb)
    _close(logits, rmodel.forward(ref_params, jb))
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss, has_aux=True)(ref_params, jb)
    loss, _, grads = loss_and_grads(model, params, tb)
    _close(loss, rloss)
    ref_flat, _ = ref_flatten(_np(rgrads))
    for path, g in flatten_with_paths(grads)[0].items():
        _close(g, ref_flat[path])
