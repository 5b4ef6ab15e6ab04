"""PyTorch port: the multimodal models (``models/multimodal.py``:
paligemma-3b, musicgen-medium) against the JAX reference on the CPU.

``reduced_for_smoke`` (2 layers, d_model 128, 4 heads x 32, f32; paligemma
16 patches and 1 kv head, musicgen 4 codebooks of 256): the leaf set, the
logits, the loss and every gradient held to ``jax.value_and_grad`` of the
reference's loss on the reference's init and the same numpy-seeded batch,
the prefill and a teacher-forced decode to the reference's, and one AdamW
step of the port's train step to the reference's optimizer. paligemma runs
16 patches + 48 text tokens (64 positions: the chunked lowering at the
smoke threshold 64, so the flash kernel's plain version with a prefix of
16, inside one 32-key block) and 16 + 16 (the dense lowering); a variant
with 48 patches puts the prefix across blocks. musicgen runs 64 frames
(chunked) and 32 (dense). Tolerance: 1e-5 (abs and rel), f32 on the CPU
with the two frameworks' sum orders. Twins of
``tests/models/test_arch_smoke.py``'s checks on both archs.
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
from repro.configs import list_archs as ref_list_archs
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticBatches
from repro_torch.models import build
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.runtime.steps import loss_and_grads, make_train_step
from repro_torch.utils.tree import flatten_with_paths

CASES = {  # id: (arch, text positions, patches or None for the config's)
    "paligemma-chunked": ("paligemma-3b", 48, None),
    "paligemma-dense": ("paligemma-3b", 16, None),
    "paligemma-prefix-across-blocks": ("paligemma-3b", 48, 48),
    "musicgen-chunked": ("musicgen-medium", 64, None),
    "musicgen-dense": ("musicgen-medium", 32, None),
}
NAMES = ["paligemma-3b", "musicgen-medium"]
B, TOL = 2, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _batch(cfg, S, seed=1):
    """inputs/targets (B, S) or (B, S, K) ids, and patches (B, P, D) f32."""
    rng = np.random.default_rng(seed)
    K = (cfg.audio_codebooks,) if cfg.frontend == "audio" else ()
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1, *K)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jb(batch):
    return jax.tree.map(jnp.asarray, batch)


def _configs(name, patches=None):
    ref_cfg, cfg = ref_get_config(name, smoke=True), get_config(name, smoke=True)
    if patches is not None:
        ref_cfg = ref_cfg.with_overrides(num_patches=patches)
        cfg = cfg.with_overrides(num_patches=patches)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return cfg, ref_cfg


@pytest.fixture(scope="module", params=list(CASES))
def arch(request):
    """The reference's params, batch, loss, grads and logits, computed once."""
    name, S, patches = CASES[request.param]
    cfg, ref_cfg = _configs(name, patches)
    rmodel = rmodels.build(ref_cfg)
    ref_params = jax.jit(rmodel.init)(jax.random.key(0))
    batch = _batch(cfg, S)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(rmodel.loss, has_aux=True))(
        ref_params, _jb(batch))
    logits = jax.jit(rmodel.forward)(ref_params, _jb(batch))
    return dict(name=name, S=S, cfg=cfg, rmodel=rmodel, ref_params=ref_params, batch=batch,
                loss=loss, metrics=_np(metrics), grads=ref_flatten(_np(grads))[0],
                logits=np.asarray(logits))


@pytest.mark.parametrize("name", NAMES)
def test_config_is_the_reference_and_registered(name):
    assert name in list_archs()
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(ref_get_config(name))
    assert dataclasses.asdict(get_config(name, smoke=True)) == dataclasses.asdict(
        ref_get_config(name, smoke=True))


def test_every_reference_config_builds():
    """After the multimodal family, every config of the reference builds
    in the port (on the meta device: full sizes, no storage)."""
    assert sorted(list_archs()) == sorted(ref_list_archs())
    for name in list_archs():
        model = build(get_config(name))
        assert flatten_with_paths(model.init(torch.Generator(), device="meta"))[0]


@pytest.mark.parametrize("name", NAMES)
def test_leaf_set_matches_reference(name):
    """Paths in the same order, shapes and dtypes, at smoke size and at full
    size: paligemma's dense leaves plus ``vision_proj``; musicgen's without
    ``embed`` (and without ``lm_head``) but with the codebook tables."""
    for smoke in (True, False):
        ref_cfg = ref_get_config(name, smoke=smoke)
        want = {p: (tuple(s.shape), s.dtype.name) for p, s in ref_flatten(
            jax.eval_shape(lambda c=ref_cfg: rmodels.build(c).init(jax.random.key(0))))[0].items()}
        got = flatten_with_paths(build(get_config(name, smoke=smoke)).init(
            torch.Generator(), device="meta"))[0]
        assert list(got) == list(want)
        for path, t in got.items():
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == want[path], path
        if name == "paligemma-3b":
            assert "vision_proj" in got and "embed" in got and "lm_head" not in got
        else:
            assert "embed" not in got and "lm_head" not in got
            assert {"codebook_embed", "codebook_head"} <= set(got)


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
    """Prefill over the first half of the text (with the image ahead of it),
    then decode the second half's tokens one by one; every step's logits
    and the cache against the reference's."""
    cfg, rmodel, S = arch["cfg"], arch["rmodel"], arch["S"]
    P = S // 2
    batch = arch["batch"]
    toks = batch["inputs"]
    extra = cfg.num_patches if cfg.frontend == "vision" else 0
    rp, params = arch["ref_params"], state_from_numpy(_np(arch["ref_params"]))
    model = build(cfg)
    prompt = {k: v for k, v in batch.items() if k == "patches"}
    prompt["inputs"] = toks[:, :P]
    # the reference pads its cache only to cache_len: room for the image too
    cache_len = extra + S
    rlg, rcache = jax.jit(rmodel.prefill, static_argnums=2)(rp, _jb(prompt), cache_len)
    with torch.no_grad():
        lg, cache = model.prefill(params, _tb(prompt), cache_len)
    _close(lg, rlg)
    assert int(cache["pos"]) == int(rcache["pos"]) == extra + P
    rdecode = jax.jit(rmodel.decode)
    for t in range(P, S):
        rlg, rcache = rdecode(rp, rcache, jnp.asarray(toks[:, t]))
        with torch.no_grad():
            lg, cache = model.decode(params, cache, torch.from_numpy(np.ascontiguousarray(
                toks[:, t])))
        _close(lg, rlg)
    assert int(cache["pos"]) == extra + S
    for key in ("k", "v"):
        _close(cache[key], rcache[key])


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


def test_bf16_forward_matches_reference():
    """paligemma in bf16 (the card's dtype): the patches are cast to the
    param dtype before ``vision_proj``, and the text logits stay within
    bf16's reach of the reference's on the same params."""
    cfg, ref_cfg = (c.with_overrides(param_dtype="bfloat16", compute_dtype="bfloat16")
                    for c in _configs("paligemma-3b"))
    rmodel = rmodels.build(ref_cfg)
    rp = jax.jit(rmodel.init)(jax.random.key(3))
    batch = _batch(cfg, 48, seed=3)
    want = np.asarray(jax.jit(rmodel.forward)(rp, _jb(batch)))
    params = state_from_numpy(_np(rp))
    assert params["vision_proj"].dtype == torch.bfloat16
    with torch.no_grad():
        got = build(cfg).forward(params, _tb(batch))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.05, rtol=0.05)


# -- twins of tests/models/test_arch_smoke.py on these archs ---------------------------

@pytest.mark.parametrize("name", NAMES)
def test_forward_and_train_step(name):
    cfg = get_config(name, smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tb(next(SyntheticBatches(cfg, batch=2, seq_len=32)))
    with torch.no_grad():
        logits = model.forward(params, batch)
    assert logits.shape[0] == 2 and logits.shape[-1] == cfg.vocab_size
    assert bool(logits.isfinite().all())
    before = {p: t.clone() for p, t in flatten_with_paths(params)[0].items()}
    opt = get_optimizer(cfg.optimizer, 1e-3)
    state, metrics = make_train_step(model, opt)(
        {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)},
        batch)
    assert bool(metrics["loss"].isfinite())
    delta = sum(float((t.float() - before[p].float()).abs().sum())
                for p, t in flatten_with_paths(state["params"])[0].items())
    assert delta > 0


def test_decode_matches_forward():
    """musicgen: teacher-forced decode reproduces the full forward's logits."""
    cfg = get_config("musicgen-medium", smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = _tb(_batch(cfg, 16, seed=4))["inputs"]
    with torch.no_grad():
        full = model.forward(params, {"inputs": toks})
        cache = model.init_cache(B, 16, device="cpu")
        errs = []
        for t in range(16):
            lg, cache = model.decode(params, cache, toks[:, t])
            assert lg.shape == (B, cfg.audio_codebooks, cfg.vocab_size)
            errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 2e-2, f"decode diverges from forward ({max(errs)})"


def test_vlm_prefill_decode_consistency():
    cfg = get_config("paligemma-3b", smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tb(next(SyntheticBatches(cfg, batch=2, seq_len=16)))
    with torch.no_grad():
        full = model.forward(params, batch)  # text logits
        lp, cache = model.prefill(params, {"patches": batch["patches"],
                                           "inputs": batch["inputs"][:, :10]}, 64)
        assert torch.allclose(lp[:, 0], full[:, 9], atol=2e-2)
        ld, cache = model.decode(params, cache, batch["inputs"][:, 10])
    assert torch.allclose(ld, full[:, 10], atol=2e-2)


def test_vlm_uses_patches():
    cfg = get_config("paligemma-3b", smoke=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _tb(next(SyntheticBatches(cfg, batch=2, seq_len=32)))
    with torch.no_grad():
        l1 = model.forward(params, batch)
        l2 = model.forward(params, dict(batch, patches=batch["patches"] + 10.0))
    assert not torch.allclose(l1, l2), "patches ignored"


@pytest.mark.parametrize("name,layers,n", [("paligemma-3b", 2, 751_183_872),
                                           ("paligemma-3b", 18, 2_512_857_088),
                                           ("musicgen-medium", 48, 1_384_269_312)])
def test_param_counts_match_analytic(name, layers, n):
    """The meta init's leaves at full width: the exact count (paligemma at 2
    of its 18 layers is the card's cut), within 2% of the analytic
    ``n_params``."""
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    params = build(cfg).init(torch.Generator(), device="meta")
    total = sum(t.numel() for t in flatten_with_paths(params)[0].values())
    assert total == n
    assert abs(total - cfg.n_params()) / cfg.n_params() < 0.02, (total, cfg.n_params())
