"""PyTorch port: adafactor and q8adam against the JAX reference on the CPU.

Three steps of each on a tree with rank-1, rank-2 (one of them bf16, one
with a dim of 1, which adafactor does not factor) and rank-4 leaves,
warmup-cosine learning rate, numpy-seeded grads: the state trees have the
reference's paths, shapes and dtypes; params and states agree within 1e-6
(absolute; f32 on the CPU, the frameworks' sum orders in the means and
the global norm), and q8adam's int8 codes are equal exactly. The port
updates in place: the tensors it returns are the ones it was given.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.optim as roptim
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.models.convert import state_from_numpy
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.utils.tree import flatten_with_paths


def _params(rng):
    return {
        "bias": rng.standard_normal((300,)).astype(np.float32),
        "w": rng.standard_normal((17, 33)).astype(np.float32),
        "col": rng.standard_normal((12, 1)).astype(np.float32),
        "experts": {"wi": rng.standard_normal((2, 3, 16, 24)).astype(np.float32)},
        "embed": rng.standard_normal((40, 8)).astype(ml_dtypes.bfloat16),
    }


def _f32(x):
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)
    return a


@pytest.mark.parametrize("name", ["adafactor", "q8adam"])
def test_optimizer_matches_reference_over_three_steps(name):
    rng = np.random.default_rng(0)
    params = _params(rng)
    ropt = roptim.get_optimizer(name, roptim.warmup_cosine(1e-2, 2, 10))
    opt = get_optimizer(name, warmup_cosine(1e-2, 2, 10))
    rp = jax.tree.map(jnp.asarray, params)
    rs = ropt.init(rp)
    tp = state_from_numpy(params)
    ts = opt.init(tp)
    for step in range(3):
        grads = {p: (rng.standard_normal(g.shape) * 0.3).astype(g.dtype)
                 for p, g in flatten_with_paths(params)[0].items()}
        nested = jax.tree.unflatten(jax.tree.structure(params),
                                    [grads[p] for p in flatten_with_paths(params)[0]])
        rp, rs = ropt.update(jax.tree.map(jnp.asarray, nested), rs, rp,
                             jnp.asarray(step, jnp.int32))
        got_p, got_s = opt.update(state_from_numpy(nested), ts, tp,
                                  torch.tensor(step, dtype=torch.int32))
        assert got_p is tp and got_s is ts
    ref = ref_flatten(jax.tree.map(np.asarray, {"params": rp, "opt": rs}))[0]
    ours = flatten_with_paths({"params": tp, "opt": ts})[0]
    assert list(ours) == list(ref)
    codes = 0
    for path, want in ref.items():
        got = ours[path]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).replace("torch.", "") == want.dtype.name, path
        if want.dtype == np.int8:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
            codes += 1
        else:
            np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6, rtol=0,
                                       err_msg=path)
    assert codes == (5 if name == "q8adam" else 0)
    if name == "adafactor":
        assert "opt/f/col/v" in ours and "opt/f/experts/wi/vr" in ours


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError, match="unknown optimizer"):
        get_optimizer("lion")
