"""PyTorch port: Mamba2's SSD (``models/mamba2.py``) against the JAX
reference on the CPU, in f32.

- Twins of ``tests/models/test_mamba2_ssd.py`` on the port, with its
  tolerances (atol 2e-3, rtol 1e-3: the chunked form against the
  recurrence).
- ``ssd_forward`` and ``ssm_decode_step`` against the reference's on the
  same weights (carried across with ``models/convert.state_from_numpy``):
  atol = rtol = 1e-5, the two frameworks' f32 sum orders.
- The segment sums (a product with lower-triangular ones in f64, rounded
  once to f32) against the reference's f32 ``cumsum``: within the bound of
  a recursive f32 sum's error, Q * 2**-24 * the prefix sum of |dA|.
- The departure at large decay: where the reference's ``jax.grad`` of
  ``ssd_forward`` is NaN (dt = 0.2, ``ssm_chunk`` 64: |A| dt Q = 204.8),
  the port's gradient is finite and equals a float64 autograd of the port's
  own recurrence (``ssd_reference``) within 2e-5 of each leaf's largest
  gradient (f32 against f64 over 128 steps of decays down to e^-3.2; the
  port reads up to 4.7e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as rmamba
from repro.configs import get_config as ref_get_config
from repro.models.config import ModelConfig as RefConfig
from repro_torch.models import mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import state_from_numpy

# port vs reference on the same weights, f32 on the CPU
TOL = 1e-5
# the port's f32 gradient at large decay vs f64 autograd of its recurrence,
# relative to each leaf's largest gradient
F64_TOL = 2e-5


def _cfgs(chunk=8, state=16, head_dim=16, d_model=32):
    ref = RefConfig(
        name="t", family="ssm", num_layers=1, d_model=d_model, vocab_size=64,
        ssm_state=state, ssm_head_dim=head_dim, ssm_chunk=chunk,
        param_dtype="float32", compute_dtype="float32",
    )
    return ModelConfig(**dataclasses.asdict(ref)), ref


def _params(cfg, seed):
    return mamba2.mamba_init(cfg, torch.Generator().manual_seed(seed), dtype=torch.float32)


def _x(rng, B, S, D):
    return torch.from_numpy((rng.standard_normal((B, S, D)) * 0.5).astype(np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_init(seed, ref):
    return jax.jit(rmamba.mamba_init, static_argnums=(1, 2))(jax.random.key(seed), ref,
                                                            jnp.float32)


# -- twins of tests/models/test_mamba2_ssd.py ----------------------------------------

@pytest.mark.parametrize("S,chunk", [(24, 8), (32, 32), (16, 4), (64, 16)])
def test_ssd_equals_recurrence(rng, S, chunk):
    cfg, _ = _cfgs(chunk=chunk)
    p = _params(cfg, 1)
    x = _x(rng, 2, S, 32)
    with torch.no_grad():
        y_ssd, _ = mamba2.ssd_forward(cfg, p, x)
        y_ref = mamba2.ssd_reference(cfg, p, x)
    np.testing.assert_allclose(y_ssd.numpy(), y_ref.numpy(), atol=2e-3, rtol=1e-3)


def test_final_state_continues_generation(rng):
    """The state after ssd_forward equals the state after stepping the prompt."""
    cfg, _ = _cfgs()
    p = _params(cfg, 2)
    x = _x(rng, 1, 16, 32)
    with torch.no_grad():
        _, final = mamba2.ssd_forward(cfg, p, x)
        state = mamba2.init_ssm_state(cfg, 1)
        for t in range(16):
            _, state = mamba2.ssm_decode_step(cfg, p, state, x[:, t : t + 1])
    for key in ("h", "conv"):  # the conv window continues exactly as well
        np.testing.assert_allclose(final[key].numpy(), state[key].numpy(),
                                   atol=2e-3, rtol=1e-3)


def test_decay_bounds():
    """A < 0 keeps the recurrence stable (decay in (0, 1))."""
    cfg, _ = _cfgs()
    p = _params(cfg, 3)
    assert bool((-torch.exp(p["A_log"]) < 0).all())


def test_conv_cache_consistency(rng):
    """The decode conv window reproduces the causal conv of the full pass."""
    cfg, _ = _cfgs(chunk=4)
    p = _params(cfg, 4)
    x = _x(rng, 1, 8, 32)
    with torch.no_grad():
        y_full, _ = mamba2.ssd_forward(cfg, p, x)
        state = mamba2.init_ssm_state(cfg, 1)
        ys = []
        for t in range(8):
            y, state = mamba2.ssm_decode_step(cfg, p, state, x[:, t : t + 1])
            ys.append(y)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, 1).numpy(), atol=2e-3, rtol=1e-3)


# -- against the reference on the same weights -----------------------------------------

def test_init_has_the_reference_leaves_shapes_and_dtypes():
    cfg, ref = _cfgs()
    want = _np(_ref_init(0, ref))
    got = mamba2.mamba_init(cfg, torch.Generator(), 3, dtype=torch.bfloat16)
    assert list(got) == list(mamba2.LEAVES) and set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == (3,) + want[name].shape, name
        assert t.dtype == (torch.float32 if name in mamba2.F32_LEAVES else torch.bfloat16)
    one = mamba2.mamba_init(cfg, torch.Generator(), dtype=torch.float32)
    for name in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(one[name].numpy(), want[name], rtol=1e-6, atol=0)


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24)])
def test_ssd_forward_matches_reference(rng, S, chunk):
    cfg, ref = _cfgs(chunk=chunk)
    rp = _ref_init(5, ref)
    x = _x(rng, 2, S, 32)
    ry, rstate = jax.jit(lambda p, x: rmamba.ssd_forward(ref, p, x))(rp, jnp.asarray(x.numpy()))
    with torch.no_grad():
        y, state = mamba2.ssd_forward(cfg, state_from_numpy(_np(rp)), x)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=TOL, rtol=TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(rstate[key]),
                                   atol=TOL, rtol=TOL)


def test_decode_step_matches_reference(rng):
    cfg, ref = _cfgs()
    rp = _ref_init(6, ref)
    p = state_from_numpy(_np(rp))
    x = _x(rng, 2, 6, 32)
    rstate, state = rmamba.init_ssm_state(ref, 2), mamba2.init_ssm_state(cfg, 2)
    step = jax.jit(lambda s, xt: rmamba.ssm_decode_step(ref, rp, s, xt))
    for t in range(6):
        ry, rstate = step(rstate, jnp.asarray(x[:, t : t + 1].numpy()))
        with torch.no_grad():
            y, state = mamba2.ssm_decode_step(cfg, p, state, x[:, t : t + 1])
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=TOL, rtol=TOL)
        for key in ("h", "conv"):
            np.testing.assert_allclose(state[key].numpy(), np.asarray(rstate[key]),
                                       atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Q", [32, 256])
def test_segment_sums_against_reference_cumsum(Q):
    """|port - cumsum| <= Q u sum(|dA|) over the prefix (u = 2**-24): the
    port's sum is the f64 sum rounded once, within u of the exact one, and
    a recursive f32 sum lies within (Q - 1) u of it. The reading is the
    largest share of that bound taken, which must stay below 1."""
    rng = np.random.default_rng(Q)
    # zamba2's range: dt up to ~1, |A| in [1, 16]
    dA = -(rng.uniform(0, 1, (2, 3, Q, 8)) * np.linspace(1, 16, 8)).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(dA), axis=2))
    got = mamba2.segment_sums(torch.from_numpy(dA)).numpy()
    bound = Q * 2.0**-24 * np.cumsum(np.abs(dA).astype(np.float64), axis=2)
    share = np.abs(got.astype(np.float64) - want) / bound
    assert share.max() < 1, share.max()
    exact = np.cumsum(dA.astype(np.float64), axis=2)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


def test_large_decay_gradient_finite_where_reference_is_nan(rng):
    """zamba2's smoke widths, ssm_chunk 64, dt_bias so that softplus(dt_bias)
    = 0.2: |A| dt Q reaches 204.8, and exp(seg_t - seg_s) over the
    reference's unmasked upper triangle overflows. Its forward stays
    finite (the overflow is masked after the product); its gradient reads
    NaN. The port's forward equals the reference's, and its gradient is
    finite and equals f64 autograd of the recurrence."""
    ref = ref_get_config("zamba2-1.2b", smoke=True).with_overrides(ssm_chunk=64)
    cfg = ModelConfig(**dataclasses.asdict(ref))
    rp = _ref_init(7, ref)
    rp["dt_bias"] = jnp.full_like(rp["dt_bias"], np.log(np.expm1(0.2)))
    S = 128
    x = (rng.standard_normal((2, S, cfg.d_model)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    assert float(jnp.max(jnp.exp(rp["A_log"]))) * 0.2 * 64 > 200

    def ref_loss(p):
        y = rmamba.ssd_forward(ref, p, jnp.asarray(x))[0]
        return jnp.sum(y * ct), y

    (_, ry), rgrads = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(rp)
    rgrads, ry = _np(rgrads), np.asarray(ry)
    nan = {k: int(np.isnan(g).sum()) for k, g in rgrads.items()}
    assert nan["w_B"] > 0 and nan["w_C"] > 0, nan

    def grads(p, fn, dtype):
        leaves = {k: v.to(dtype).requires_grad_(True) for k, v in p.items()}
        y = fn(cfg, leaves, torch.from_numpy(x).to(dtype))
        y = y[0] if isinstance(y, tuple) else y
        loss = (y * torch.from_numpy(ct).to(dtype)).sum()
        return y.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    p = state_from_numpy(_np(rp))
    y, g = grads(p, mamba2.ssd_forward, torch.float32)
    assert np.isfinite(ry).all()
    np.testing.assert_allclose(y.numpy(), ry, atol=TOL, rtol=TOL)
    _, g64 = grads(p, mamba2.ssd_reference, torch.float64)
    for name, t in g.items():
        assert bool(t.isfinite().all()), name
        want = g64[name].numpy()
        err = np.abs(t.double().numpy() - want).max()
        assert err <= F64_TOL * np.abs(want).max(), (name, err, np.abs(want).max())
