"""PyTorch port: the MoE family (moonshot-v1-16b-a3b, arctic-480b) against
the JAX reference on the CPU.

Both configs are the reference's, field for field. The MoE layer is held
to the reference's ``moe_apply`` without a mesh (its group-local
formulation), with and without capacity drops, with ``T`` not a multiple
of the 16 groups, with and without arctic's dense branch: the expert ids
and the kept slots exactly, the output, aux and grads (the f32 router's
among them) within 1e-5 (abs and rel, f32 on the CPU, the two frameworks'
sum orders). Both full configs allocate their analytic parameter count on
the meta device, and a bf16 model keeps its router f32. Weights cross
with ``models/convert.py``.

The reduced models are held to the reference in
``test_torch_moe_model.py``.

A router near-tie could flip one top-k choice between the frameworks and
move that token's output a long way: the routing tests print the smallest
gap they drew between the K-th and (K+1)-th probability, so a failure
there reads as such.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rmodels
from repro.configs import get_config as ref_get_config
from repro.models import moe as rmoe
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config, list_archs
from repro_torch.models import build
from repro_torch.models import moe
from repro_torch.models.convert import state_from_numpy
from repro_torch.utils.tree import flatten_with_paths

ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]
B = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    ref_cfg = ref_get_config(name, smoke=True)
    return name, ref_cfg, rmodels.build(ref_cfg).init(jax.random.key(0))


# -- configs -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_config_is_the_reference_and_registered(name):
    assert name in list_archs()
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(ref_get_config(name))
    assert dataclasses.asdict(get_config(name, smoke=True)) == dataclasses.asdict(
        ref_get_config(name, smoke=True))


@pytest.mark.parametrize("name", ARCHS)
def test_meta_init_allocates_the_analytic_param_count(name):
    cfg = get_config(name)
    params = build(cfg).init(torch.Generator(), device="meta")
    total = sum(t.numel() for t in flatten_with_paths(params)[0].values())
    assert abs(total - cfg.n_params()) / cfg.n_params() < 0.02, (total, cfg.n_params())


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_param_tree_matches_reference_with_an_f32_router(name):
    """Paths, shapes and dtypes of a bf16 model equal the reference's; the
    router stays f32, through the transfer too."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    ref = rmodels.build(ref_get_config(name, smoke=True).with_overrides(**over)).init(
        jax.random.key(0))
    ours = build(get_config(name, smoke=True).with_overrides(**over)).init(
        torch.Generator().manual_seed(0))
    ref_flat, _ = ref_flatten(_np(ref))
    for tree in (ours, state_from_numpy(_np(ref))):
        flat, _ = flatten_with_paths(tree)
        assert list(flat) == list(ref_flat)
        for p in ref_flat:
            assert tuple(flat[p].shape) == ref_flat[p].shape, p
            assert str(flat[p].dtype).replace("torch.", "") == ref_flat[p].dtype.name, p
    assert flatten_with_paths(ours)[0]["blocks/moe/router"].dtype == torch.float32
    assert ("blocks/moe/dense/wi" in ref_flat) == (name == "arctic-480b")


# -- the MoE layer -------------------------------------------------------------------

def _ref_routing(cfg, router, x):
    """The reference's routing lines of ``_moe_gspmd`` (models/moe.py), which
    its ``moe_apply`` does not return: ids, keep, and the top-k gap."""
    Bx, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = Bx * S
    G = math.gcd(cfg.moe_groups, T)
    Tg = T // G
    probs = jax.nn.softmax(x.reshape(G, Tg, D).astype(jnp.float32) @ router, axis=-1)
    _, ids = jax.lax.top_k(probs, K)
    ids_flat = ids.reshape(G, Tg * K)
    onehot = jax.nn.one_hot(ids_flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - onehot,
                              ids_flat[..., None], axis=2)[..., 0]
    Cg = int(np.ceil(Tg * K / E * cfg.moe_capacity_factor))
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    return np.asarray(ids_flat), np.asarray(pos < Cg), float((top[..., K - 1] - top[..., K]).min())


@pytest.mark.parametrize("capacity", [4.0, 1.25])
@pytest.mark.parametrize("S", [24, 25])
def test_moe_layer_matches_reference(arch, capacity, S):
    """S = 24: T = 48, 16 groups of 3; S = 25: T = 50, gcd 2 groups of 25.
    The last three quarters of each sequence repeat its first token, so at
    capacity 1.25 the experts that token picks overflow (asserted); at 4.0
    (Cg = 2 Tg) nothing can drop."""
    name, ref_cfg, ref_params = arch
    rcfg = ref_cfg.with_overrides(moe_capacity_factor=capacity)
    cfg = get_config(name, smoke=True).with_overrides(moe_capacity_factor=capacity)
    p = jax.tree.map(lambda t: t[0], ref_params["blocks"]["moe"])  # layer 0
    x = np.random.default_rng(7).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x[:, S // 4:] = x[:, :1]
    rout, raux = rmoe.moe_apply(rcfg, p, jnp.asarray(x))
    tp = state_from_numpy(_np(p))
    out, aux = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    ids, keep, gap = _ref_routing(rcfg, p["router"], jnp.asarray(x))
    T = B * S
    G = math.gcd(cfg.moe_groups, T)
    r = moe.route(cfg, tp["router"], torch.from_numpy(x).reshape(G, T // G, -1))
    print(f"{name} capacity={capacity} T={T} G={G}: smallest top-k gap {gap:.3g}, "
          f"dropped {int((~keep).sum())}/{keep.size} slots")
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert bool(keep.all()) == (capacity == 4.0)
    _close(out.numpy(), rout)
    _close(aux, raux)


def test_routing_is_logged(arch):
    """``routing_log`` holds each call's routing: the ids, the kept slots
    and the capacity ``route`` gives for the same groups."""
    name, _, ref_params = arch
    cfg = get_config(name, smoke=True).with_overrides(moe_capacity_factor=1.25)
    tp = state_from_numpy(_np(jax.tree.map(lambda t: t[0], ref_params["blocks"]["moe"])))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, 24, cfg.d_model)).astype(np.float32))
    x[:, 6:] = x[:, :1]
    with moe.routing_log() as log:
        moe.moe_apply(cfg, tp, x)
        moe.moe_apply(cfg, tp, x[:, :1])
    r = moe.route(cfg, tp["router"], x.reshape(16, 3, -1))
    assert len(log) == 2 and log[0].capacity == r.capacity == 2
    assert torch.equal(log[0].ids, r.ids) and torch.equal(log[0].keep, r.keep)
    assert 0 < int((~log[0].keep).sum()) and bool(log[1].keep.all())
    assert not any(t.requires_grad for t in log[0] if isinstance(t, torch.Tensor))


def test_moe_layer_grads_match_reference(arch):
    """Grads of a scalar of the layer's output and aux, to x and every leaf
    (the f32 router among them), with drops."""
    name, ref_cfg, ref_params = arch
    rcfg = ref_cfg.with_overrides(moe_capacity_factor=1.25)
    cfg = get_config(name, smoke=True).with_overrides(moe_capacity_factor=1.25)
    p = jax.tree.map(lambda t: t[0], ref_params["blocks"]["moe"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)

    def rloss(p, x):
        out, aux = rmoe.moe_apply(rcfg, p, x)
        return jnp.sum(out * w) + aux

    rgp, rgx = jax.grad(rloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = {k: v for k, v in flatten_with_paths(state_from_numpy(_np(p)))[0].items()}
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    nested = {}
    for k, v in leaves.items():
        *parents, last = k.split("/")
        node = nested
        for q in parents:
            node = node.setdefault(q, {})
        node[last] = v
    out, aux = moe.moe_apply(cfg, nested, tx)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [tx, *leaves.values()])
    _close(grads[0].numpy(), rgx)
    ref_flat, _ = ref_flatten(_np(rgp))
    for k, g in zip(leaves, grads[1:]):
        _close(g.numpy(), ref_flat[k])


def test_routing_at_moonshot_width_matches_reference():
    """moonshot-v1-16b-a3b's routing at full width (d_model 2048, 64
    experts top-6, capacity 1.25: 16 groups of 64 tokens, Cg = 8) on the
    MoE input of the first microbatch of ``chip_smoke.py``'s ``[moe]``
    data, as ``tools/moe_drops.py`` traces it: layer 0 at init over
    numpy-seeded weights of the init's scales (embedding rows 0.02,
    projections and router 1/sqrt(fan-in), zero norms), f32, the expert
    width cut to 8 (routing reads none). The reference's ``moe_apply``
    keeps and drops the same slots as the port's, and gives the same
    output and aux; the share it drops is printed."""
    from repro_torch.data import SyntheticBatches
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import apply_rope, multihead_attention, rmsnorm

    over = dict(num_layers=1, d_ff=8, param_dtype="float32", compute_dtype="float32")
    cfg = get_config("moonshot-v1-16b-a3b").with_overrides(**over)
    rcfg = ref_get_config("moonshot-v1-16b-a3b").with_overrides(**over)
    D, E, F = cfg.d_model, cfg.moe_experts, cfg.d_ff
    tokens = next(SyntheticBatches(cfg, batch=4, seq_len=512))["inputs"][:2]
    rng = np.random.default_rng(9)
    uniq, inverse = np.unique(tokens, return_inverse=True)
    embed = (rng.standard_normal((uniq.size, D)) * 0.02).astype(np.float32)

    def normal(*shape, fan_in):
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))

    w = {"ln1": torch.zeros(D), "wq": normal(D, cfg.q_dim, fan_in=D),
         "wk": normal(D, cfg.kv_dim, fan_in=D), "wv": normal(D, cfg.kv_dim, fan_in=D)}
    wo = normal(cfg.q_dim, D, fan_in=cfg.q_dim)
    x = torch.from_numpy(embed[inverse.reshape(tokens.shape)])
    S = tokens.shape[1]
    with torch.no_grad():
        q, k, v = tfm._qkv(cfg, w, rmsnorm(x, w["ln1"], cfg.norm_eps))
        q, k = (apply_rope(t, torch.arange(S), cfg.rope_theta) for t in (q, k))
        att = multihead_attention(q, k, v, causal=True)
        att = att.transpose(1, 2).reshape(*tokens.shape, cfg.q_dim) @ wo
        h = rmsnorm(x + att, torch.zeros(D), cfg.norm_eps).numpy()
    p = {"router": normal(D, E, fan_in=D).numpy(), "wi": normal(E, D, F, fan_in=D).numpy(),
         "wg": normal(E, D, F, fan_in=D).numpy(), "wo": normal(E, F, D, fan_in=F).numpy()}
    # jitted: one compile, where op-by-op dispatch compiles each of ~90 ops
    rout, raux = jax.jit(lambda p, x: rmoe.moe_apply(rcfg, p, x))(p, jnp.asarray(h))
    ids, keep, gap = _ref_routing(rcfg, p["router"], jnp.asarray(h))
    tp = state_from_numpy(p)
    out, aux = moe.moe_apply(cfg, tp, torch.from_numpy(h))
    r = moe.route(cfg, tp["router"], torch.from_numpy(h).reshape(16, 64, D))
    print(f"moonshot width, T=1024 G=16 Cg={r.capacity}: smallest top-k gap {gap:.3g}, "
          f"the reference dropped {int((~keep).sum())}/{keep.size} slots "
          f"({float((~keep).mean()):.4f}), the port {int((~r.keep).sum())}")
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    _close(out.numpy(), rout)
    _close(aux, raux)
