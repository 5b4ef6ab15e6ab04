"""PyTorch port: training at long sequence lengths, remat and microbatch
accumulation, against the JAX reference on the CPU.

The reduced qwen2 (``reduced_for_smoke``: 2 layers, d_model 128, f32,
``attn_chunked_threshold`` 64, attention blocks 32) at S = 128, so both
models take their long-S lowering: the reference differentiates its
``_chunked_attention``, the port runs ``ops.flash_attention`` and its
backward (on the CPU, their plain versions). Weights cross from the
reference with ``models/convert.py``. Tolerances are for f32 on the CPU,
where the two frameworks order their sums differently: 1e-5 (abs and rel)
for the loss and the gradients. Remat changes no value: the port's grads
are bitwise equal across ``remat`` none, dots and full.
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
from repro.launch.mesh import make_host_mesh, use_mesh
from repro.runtime.sharding import ShardingRules
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.runtime.steps import loss_and_grads, make_train_step
from repro_torch.utils.tree import flatten_with_paths

B, S = 2, 128


@pytest.fixture(scope="module")
def ref_cfg():
    return ref_get_config("qwen2-0.5b", smoke=True)


@pytest.fixture(scope="module")
def cfg(ref_cfg):
    c = get_config("qwen2-0.5b", smoke=True)
    assert dataclasses.asdict(c) == dataclasses.asdict(ref_cfg)
    assert S >= 2 * c.attn_chunked_threshold and c.remat == "dots"
    return c


@pytest.fixture(scope="module")
def ref_params(ref_cfg):
    return rmodels.build(ref_cfg).init(jax.random.key(0))


def _batch(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _grads(cfg, params, batch, remat=None):
    model = build(cfg if remat is None else cfg.with_overrides(remat=remat))
    loss, _, grads = loss_and_grads(model, params, _tb(batch))
    return loss, flatten_with_paths(grads)[0]


def test_long_s_loss_and_grads_match_jax_value_and_grad(cfg, ref_cfg, ref_params):
    batch = _batch(cfg, B, 1)
    rmodel = rmodels.build(ref_cfg)
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        ref_params, jax.tree.map(jnp.asarray, batch))
    loss, grads = _grads(cfg, state_from_numpy(_np(ref_params)), batch)
    _close(loss, rloss)
    ref_flat, _ = ref_flatten(_np(rgrads))
    assert list(grads) == list(ref_flat)
    for path, g in grads.items():
        _close(g, ref_flat[path])


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_bitwise_equal_grads(cfg, ref_params, remat):
    batch = _batch(cfg, B, 2)
    params = state_from_numpy(_np(ref_params))
    loss, grads = _grads(cfg, params, batch, remat)
    base_loss, base = _grads(cfg, params, batch, "none")
    assert torch.equal(loss, base_loss)
    for path, g in grads.items():
        assert torch.equal(g, base[path]), path


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_attention_launches_count_for_the_thread_that_ran_the_forward(
        cfg, ref_params, remat, monkeypatch):
    """Autograd runs a CUDA backward on its own thread, and remat recomputes
    the layer there: every attention forward and backward, recomputed ones
    included, counts for the thread that ran the forward. Here the backward
    runs on a second thread (where autograd runs a CPU backward), and each
    plain version notes whose counts it would add to."""
    import threading

    from repro_torch.kernels import flash_attention, ref

    seen = {"fwd": [], "bwd": []}
    for kind, name in (("fwd", "flash_attention_plain"), ("bwd", "flash_attention_bwd_plain")):
        def spy(*a, _kind=kind, _real=getattr(ref, name), **kw):
            seen[_kind].append(flash_attention.thread_counts())
            return _real(*a, **kw)

        monkeypatch.setattr(ref, name, spy)
    params = state_from_numpy(_np(ref_params))
    leaves = {p: t.requires_grad_(True) for p, t in flatten_with_paths(params)[0].items()}
    loss, _ = build(cfg.with_overrides(remat=remat)).loss(params, _tb(_batch(cfg, B, 2)))
    worker = threading.Thread(target=lambda: torch.autograd.grad(loss, list(leaves.values())))
    worker.start()
    worker.join()
    L, mine = cfg.num_layers, flash_attention.thread_counts()
    assert len(seen["fwd"]) == (L if remat == "none" else 2 * L) and len(seen["bwd"]) == L
    assert all(c is mine for c in seen["fwd"] + seen["bwd"])


def test_unknown_remat_raises(cfg, ref_params):
    with pytest.raises(ValueError, match="unknown remat"):
        _grads(cfg, state_from_numpy(_np(ref_params)), _batch(cfg, B, 2), "some")


# microbatches: per leaf, |ours - ref| <= tol * max |ref| for the first
# moment (the clipped grads times 1 - b1): 1e-5 in f32; in bf16 each
# microbatch's grads and their sum round to bf16 in both frameworks, a
# rounding apart at most 3 times 2**-8 of the leaf's largest: 2**-6. The
# updated params within 1e-5 absolute (lr 1.2e-4 at step 3: Adam divides each
# grad by its own root mean square, so near-zero grads move their element's
# update by up to that much). Loss and grad_norm within 1e-5 relative.
MB_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


@pytest.mark.parametrize("accum_dtype", ["float32", "bfloat16"])
def test_microbatch_step_matches_reference(ref_cfg, ref_params, accum_dtype):
    rcfg = ref_cfg.with_overrides(accum_dtype=accum_dtype)
    cfg = get_config("qwen2-0.5b", smoke=True).with_overrides(accum_dtype=accum_dtype)
    batch = _batch(cfg, 2 * B, 3)
    rmodel = rmodels.build(rcfg)
    ropt = roptim.get_optimizer("adamw", roptim.warmup_cosine(3e-4, 10, 100))
    mesh = make_host_mesh((1,), ("data",))
    with use_mesh(mesh):
        rstep, _, _ = ref_make_train_step(rmodel, ShardingRules(cfg=rcfg, mesh=mesh), ropt,
                                          microbatches=2, donate=False)
        rstate = {"params": ref_params, "opt": ropt.init(ref_params),
                  "step": jnp.asarray(3, jnp.int32)}
        rnew, rmetrics = rstep(rstate, jax.tree.map(jnp.asarray, batch))
    opt = get_optimizer("adamw", warmup_cosine(3e-4, 10, 100))
    params = state_from_numpy(_np(ref_params))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.tensor(3, dtype=torch.int32)}
    new, metrics = make_train_step(build(cfg), opt, microbatches=2)(state, _tb(batch))
    assert sorted(metrics) == sorted(rmetrics) == ["grad_norm", "loss"]
    for key in metrics:
        _close(metrics[key], rmetrics[key])
    assert int(new["step"]) == 4
    tol = MB_TOL[accum_dtype]
    ref_m, _ = ref_flatten(_np(rnew["opt"]["m"]))
    for path, m in flatten_with_paths(new["opt"]["m"])[0].items():
        err = np.abs(m.numpy() - ref_m[path]).max()
        assert err <= tol * np.abs(ref_m[path]).max(), path
    ref_p, _ = ref_flatten(_np(rnew["params"]))
    for path, p in flatten_with_paths(new["params"])[0].items():
        np.testing.assert_allclose(p.numpy(), ref_p[path], atol=1e-5, rtol=0)


def test_microbatch_grads_are_the_mean_of_the_microbatches(cfg, ref_params):
    """mb = 2 in f32: the loss is the mean of the two halves' losses, the
    grads the mean of theirs, and both are close to the whole batch's."""
    batch = _batch(cfg, 2 * B, 4)
    params = state_from_numpy(_np(ref_params))
    model = build(cfg)
    loss, metrics, grads = loss_and_grads(model, params, _tb(batch), 2)
    halves = [loss_and_grads(model, params, _tb({k: v[i * B:(i + 1) * B]
                                                 for k, v in batch.items()}))
              for i in range(2)]
    assert list(metrics) == ["loss"]
    assert torch.equal(loss, (halves[0][0] + halves[1][0]) / 2)
    whole_loss, _, whole = loss_and_grads(model, params, _tb(batch))
    _close(loss, whole_loss)
    for path, g in flatten_with_paths(grads)[0].items():
        a, b = (flatten_with_paths(h[2])[0][path] for h in halves)
        assert g.dtype == torch.float32
        assert torch.equal(g, (torch.zeros_like(a) + a + b) / 2), path
        _close(g, flatten_with_paths(whole)[0][path])


def test_microbatches_must_divide_the_batch(cfg, ref_params):
    params = state_from_numpy(_np(ref_params))
    with pytest.raises(ValueError, match="does not split into 3 microbatches"):
        loss_and_grads(build(cfg), params, _tb(_batch(cfg, B, 5)), 3)
