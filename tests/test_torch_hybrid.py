"""PyTorch port: the SSM and hybrid models (``models/hybrid.py``:
mamba2-130m, zamba2-1.2b) against the JAX reference on the CPU.

``reduced_for_smoke`` (2 layers, d_model 128, SSD heads 8 x 32, state 16,
chunk 32, f32; zamba2's shared block after layer 2, 4 heads x 32): the
param tree, the logits, the loss and every gradient held to
``jax.value_and_grad`` of the reference's loss, the prefill and a
teacher-forced decode to the reference's, and one AdamW step of the
port's train step to the reference's optimizer on the reference's grads.
mamba2-130m at S = 64 (2 chunks), zamba2-1.2b at S = 128 (4 chunks, at
and above the chunked-attention threshold 64: the flash lowering's plain
version, in the forward and the prefill). Tolerances: 1e-5 (abs and rel),
f32 on the CPU with the two frameworks' sum orders; the AdamW step's params
1e-5 abs. Remat ``"dots"`` gives the bits of ``"none"``. Twins of
``tests/models/test_arch_smoke.py``'s checks on these two archs, and the
full configs' param counts.
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
from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticBatches
from repro_torch.models import build, hybrid
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.runtime.steps import loss_and_grads, make_train_step
from repro_torch.utils.tree import flatten_with_paths

ARCHS = {"mamba2-130m": 64, "zamba2-1.2b": 128}  # arch: S
B, TOL = 2, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _batch(vocab, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    """The reference's params, batch, loss, grads and logits, computed once."""
    name, S = request.param, ARCHS[request.param]
    ref_cfg = ref_get_config(name, smoke=True)
    cfg = get_config(name, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    rmodel = rmodels.build(ref_cfg)
    ref_params = jax.jit(rmodel.init)(jax.random.key(0))
    batch = _batch(cfg.vocab_size, S)
    jb = jax.tree.map(jnp.asarray, batch)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(
        ref_params, jb)
    logits = jax.jit(rmodel.forward)(ref_params, jb)
    return dict(name=name, S=S, cfg=cfg, ref_cfg=ref_cfg, rmodel=rmodel,
                ref_params=ref_params, batch=batch, loss=loss, metrics=_np(metrics),
                grads=ref_flatten(_np(grads))[0], logits=np.asarray(logits))


@pytest.mark.parametrize("name", list(ARCHS))
def test_config_is_the_reference_and_registered(name):
    assert name in list_archs()
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(ref_get_config(name))


def test_param_tree_matches_reference(arch):
    """Same paths in the same order, shapes and dtypes (A_log, D and
    dt_bias f32 in a bf16 model too); the shared block stored once."""
    want = ref_flatten(_np(arch["ref_params"]))[0]
    got = flatten_with_paths(build(arch["cfg"]).init(torch.Generator(), device="meta"))[0]
    assert list(got) == list(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == want[path].dtype.name, path
    assert ("shared/attn/wq" in got) == (arch["name"] == "zamba2-1.2b")
    bf16 = build(arch["cfg"].with_overrides(param_dtype="bfloat16"))
    dtypes = {p: t.dtype for p, t in flatten_with_paths(
        bf16.init(torch.Generator(), device="meta"))[0].items()}
    assert {p for p, d in dtypes.items() if d == torch.float32} == {
        "blocks/ssm/A_log", "blocks/ssm/D", "blocks/ssm/dt_bias"}


@pytest.mark.parametrize("name,layers,n", [("mamba2-130m", 24, 128_983_488),
                                           ("zamba2-1.2b", 12, 439_688_960),
                                           ("zamba2-1.2b", 38, 1_104_937_856)])
def test_full_width_param_counts(name, layers, n):
    """The meta init's leaves at full width: the exact count (zamba2 at 12
    of its 38 layers is the card's cut), within 2% of the analytic
    ``n_params`` (the twin of test_param_counts_match_analytic)."""
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    params = build(cfg).init(torch.Generator(), device="meta")
    total = sum(t.numel() for t in flatten_with_paths(params)[0].values())
    assert total == n
    assert abs(total - cfg.n_params()) / cfg.n_params() < 0.02, (total, cfg.n_params())


def test_logits_loss_and_grads_match_reference(arch):
    model = build(arch["cfg"])
    params = state_from_numpy(_np(arch["ref_params"]))
    batch = _tb(arch["batch"])
    with torch.no_grad():
        _close(model.forward(params, batch), arch["logits"])
    loss, metrics, grads = loss_and_grads(model, params, batch)
    assert sorted(metrics) == sorted(arch["metrics"]) == ["aux", "ce", "loss"]
    _close(loss, arch["loss"])
    for key in metrics:
        _close(metrics[key], arch["metrics"][key])
    flat = flatten_with_paths(grads)[0]
    assert list(flat) == list(arch["grads"])
    for path, g in flat.items():
        _close(g, arch["grads"][path])


def test_prefill_and_teacher_forced_decode_match_reference(arch):
    """Prefill over the first half of the sequence (one chunk or more; for
    zamba2 at the chunked threshold), then decode the second half's tokens
    one by one; every step's logits and the cache's SSM states against the
    reference's."""
    cfg, rmodel, S = arch["cfg"], arch["rmodel"], arch["S"]
    P = S // 2
    toks = arch["batch"]["inputs"]
    rp, params = arch["ref_params"], state_from_numpy(_np(arch["ref_params"]))
    model = build(cfg)
    rlg, rcache = jax.jit(rmodel.prefill, static_argnums=2)(
        rp, {"inputs": jnp.asarray(toks[:, :P])}, S)
    with torch.no_grad():
        lg, cache = model.prefill(params, {"inputs": torch.from_numpy(toks[:, :P])}, S)
    _close(lg, rlg)
    assert int(cache["pos"]) == int(rcache["pos"]) == P
    assert sorted(cache) == sorted(rcache)
    rdecode = jax.jit(rmodel.decode)
    for t in range(P, S):
        rlg, rcache = rdecode(rp, rcache, jnp.asarray(toks[:, t]))
        with torch.no_grad():
            lg, cache = model.decode(params, cache, torch.from_numpy(toks[:, t]))
        _close(lg, rlg)
    assert int(cache["pos"]) == S
    for key in ("h", "conv"):
        _close(cache["ssm"][key], rcache["ssm"][key])


def test_adamw_step_matches_reference(arch):
    """The port's train step (loss, grads, AdamW) against the reference's
    AdamW update on the reference's grads, at step 3 of a warmup."""
    cfg = arch["cfg"]
    sched = (3e-4, 10, 100)
    ropt = roptim.get_optimizer("adamw", roptim.warmup_cosine(*sched))
    rp = arch["ref_params"]
    grads = jax.tree.map(jnp.asarray, jax.tree.unflatten(
        jax.tree.structure(rp), [arch["grads"][p] for p in ref_flatten(_np(rp))[0]]))
    rnew, rstate = jax.jit(ropt.update)(grads, ropt.init(rp), rp, jnp.asarray(3, jnp.int32))
    opt = get_optimizer("adamw", warmup_cosine(*sched))
    params = state_from_numpy(_np(rp))
    state = {"params": params, "opt": opt.init(params), "step": torch.tensor(3, dtype=torch.int32)}
    new, metrics = make_train_step(build(cfg), opt)(state, _tb(arch["batch"]))
    assert int(new["step"]) == 4
    _close(metrics["loss"], arch["loss"])
    for name, ours, ref in (("params", new["params"], rnew), ("m", new["opt"]["m"], rstate["m"]),
                            ("v", new["opt"]["v"], rstate["v"])):
        want = ref_flatten(_np(ref))[0]
        for path, t in flatten_with_paths(ours)[0].items():
            np.testing.assert_allclose(t.numpy(), want[path], atol=TOL,
                                       rtol=0 if name == "params" else TOL,
                                       err_msg=f"{name} {path}")


def test_remat_dots_gives_the_bits_of_none(arch):
    cfg = arch["cfg"]
    assert cfg.remat == "dots"
    params = state_from_numpy(_np(arch["ref_params"]))
    batch = _tb(arch["batch"])
    loss, _, grads = loss_and_grads(build(cfg), params, batch)
    base_loss, _, base = loss_and_grads(build(cfg.with_overrides(remat="none")), params, batch)
    assert torch.equal(loss, base_loss)
    base = flatten_with_paths(base)[0]
    for path, g in flatten_with_paths(grads)[0].items():
        assert torch.equal(g, base[path]), path


# -- twins of tests/models/test_arch_smoke.py on these archs ---------------------------

@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_and_train_step(name):
    cfg = get_config(name, smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticBatches(cfg, batch=2,
                                                                      seq_len=32)).items()}
    with torch.no_grad():
        logits = model.forward(params, batch)
    assert logits.shape == (2, 32, cfg.vocab_size) and bool(logits.isfinite().all())
    before = {p: t.clone() for p, t in flatten_with_paths(params)[0].items()}
    opt = get_optimizer(cfg.optimizer, 1e-3)
    state, metrics = make_train_step(model, opt)(
        {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)},
        batch)
    assert bool(metrics["loss"].isfinite())
    delta = sum(float((t.float() - before[p].float()).abs().sum())
                for p, t in flatten_with_paths(state["params"])[0].items())
    assert delta > 0


@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_matches_forward(name):
    """Teacher-forced decode reproduces the full forward's logits."""
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


def test_hybrid_cache_holds_one_kv_per_application():
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), num_layers=12)
    assert hybrid._app_layers(cfg) == [5, 11] and hybrid.n_shared_apps(cfg) == 2
    cache = build(cfg).init_cache(2, 64, device="meta")
    assert cache["k"].shape == (2, 2, 32, 64, 64) and cache["v"].shape == cache["k"].shape
    assert cache["ssm"]["h"].shape == (12, 2, 64, 64, 64)
    assert cache["ssm"]["conv"].shape == (12, 2, 3, 4096 + 2 * 64)
    assert cache["ssm"]["h"].dtype == torch.float32
    pure = build(get_config("mamba2-130m")).init_cache(2, 64, device="meta")
    assert sorted(pure) == ["pos", "ssm"] and pure["ssm"]["h"].shape == (24, 2, 24, 64, 128)
