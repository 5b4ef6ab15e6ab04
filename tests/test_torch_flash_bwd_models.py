"""PyTorch port: gemma-2b and paligemma-3b trained through the flash
backward at head dim 256, against ``jax.value_and_grad`` of the reference.

Both configs are cut to 2 layers of d_model 256 with their own head dim
256 (2 q heads, 1 kv head: MQA as in the full configs), vocab 256, f32,
and the smoke threshold ``attn_chunked_threshold`` 64 with 32 x 32
blocks, so the long-S lowering runs: on the CPU the flash kernel's plain
forward and its plain backward, at head dim 256, paligemma's with the
image a bidirectional prefix (16 patches inside one block, 48 across
blocks). The reference's params (``init`` at key 0) go to the port through
``repro_torch.models.convert.state_from_numpy``; tokens and patches are
drawn with numpy. The loss and every gradient leaf are held within 2e-5
(abs and rel), the flash tests' f32 limit for two frameworks' sum orders.
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
from repro_torch.kernels import ref
from repro_torch.models import build
from repro_torch.models.convert import state_from_numpy
from repro_torch.runtime.steps import loss_and_grads
from repro_torch.utils.tree import flatten_with_paths

CUT = dict(num_layers=2, d_model=256, num_heads=2, num_kv_heads=1, head_dim=256, d_ff=512,
           vocab_size=256, attn_chunked_threshold=64, attn_block_q=32, attn_block_k=32,
           param_dtype="float32", compute_dtype="float32")
CASES = {  # id: (arch, text positions, patches)
    "gemma-2b-S128": ("gemma-2b", 128, None),
    "paligemma-3b-16p+48": ("paligemma-3b", 48, 16),
    "paligemma-3b-48p+80": ("paligemma-3b", 80, 48),
}
B = 2


def _cut(get, name, patches):
    kw = dict(CUT, num_patches=patches) if patches else CUT
    return get(name).with_overrides(**kw)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_through_the_flash_backward_match_reference(case, monkeypatch):
    name, S, P = CASES[case]
    cfg, ref_cfg = _cut(get_config, name, P), _cut(ref_get_config, name, P)
    assert cfg.head_dim == 256 and (P or 0) + S >= cfg.attn_chunked_threshold
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if P:
        batch["patches"] = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    rmodel, model = rmodels.build(ref_cfg), build(cfg)
    ref_params = rmodel.init(jax.random.key(0))
    params = state_from_numpy(jax.tree.map(np.asarray, ref_params))
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss, has_aux=True)(
        ref_params, jax.tree.map(jnp.asarray, batch))
    calls = []
    plain_bwd = ref.flash_attention_bwd_plain

    def counted(q, *args, prefix_len=None, **kw):
        calls.append((q.shape[-1], prefix_len))
        return plain_bwd(q, *args, prefix_len=prefix_len, **kw)

    monkeypatch.setattr(ref, "flash_attention_bwd_plain", counted)
    loss, _, grads = loss_and_grads(model, params,
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert calls == [(256, P or 0)] * cfg.num_layers  # every layer's gradient
    _close(loss, rloss)
    ref_flat, _ = ref_flatten(jax.tree.map(np.asarray, rgrads))
    ours = flatten_with_paths(grads)[0]
    assert list(ours) == list(ref_flat)
    for path, g in ours.items():
        assert bool(g.isfinite().all()), path
        _close(g, ref_flat[path])
