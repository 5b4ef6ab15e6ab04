"""Dense decoder-only transformer as ``nn.Module``s.

Layer weights are stacked along a leading L axis in the reference's
``(in, out)`` layout, under the reference's names, so the parameter tree
(``params/blocks/attn/wq`` ...) and every checkpoint chunk key are the same
in both packages. The forward pass loops over the L slices.

The module is the *program*; the parameter values live in the checkpointed
state tree. ``Model`` (models/zoo.py) builds the module on the ``meta``
device (no storage) and runs it with ``torch.func.functional_call`` on the
state's tensors — the same split as the reference's pure functions over a
param pytree. ``init_params`` makes those tensors.

Not ported: activation rematerialisation (``cfg.remat``, which only saves
memory), MoE blocks, prefill/decode with a KV cache.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    embed_lookup,
    logits_from_embed,
    mlp_apply,
    multihead_attention,
    rmsnorm,
)
from repro_torch.utils.dtypes import torch_dtype


def _param(*shape: int, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype))


class Attention(nn.Module):
    """GQA projections for all L layers: wq (L, D, Q), wk/wv (L, D, KV),
    wo (L, Q, D), optional biases bq (L, Q), bk/bv (L, KV)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        L, D, Q, KV = cfg.num_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim
        self.wq = _param(L, D, Q, dtype=dtype)
        self.wk = _param(L, D, KV, dtype=dtype)
        self.wv = _param(L, D, KV, dtype=dtype)
        self.wo = _param(L, Q, D, dtype=dtype)
        if cfg.qkv_bias:
            self.bq = _param(L, Q, dtype=dtype)
            self.bk = _param(L, KV, dtype=dtype)
            self.bv = _param(L, KV, dtype=dtype)

    def qkv(self, cfg: ModelConfig, layer: int, h: torch.Tensor):
        B, S, _ = h.shape
        q = h @ self.wq[layer]
        k = h @ self.wk[layer]
        v = h @ self.wv[layer]
        if cfg.qkv_bias:
            q, k, v = q + self.bq[layer], k + self.bk[layer], v + self.bv[layer]
        q = q.reshape(B, S, cfg.num_heads, cfg.head_dim).transpose(1, 2)
        k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
        return q, k, v


class MLP(nn.Module):
    """wi/wg (L, D, F) and wo (L, F, D); wg only for gated MLPs."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
        self.wi = _param(L, D, F, dtype=dtype)
        self.wo = _param(L, F, D, dtype=dtype)
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wg = _param(L, D, F, dtype=dtype)

    def forward(self, cfg: ModelConfig, layer: int, x: torch.Tensor) -> torch.Tensor:
        wg = self.wg[layer] if cfg.mlp_type in ("swiglu", "geglu") else None
        return mlp_apply(self.wi[layer], self.wo[layer], wg, x, cfg.mlp_type)


class Blocks(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.ln1 = _param(cfg.num_layers, cfg.d_model, dtype=dtype)
        self.attn = Attention(cfg, dtype)
        self.mlp = MLP(cfg, dtype)
        if not cfg.parallel_block:
            self.ln2 = _param(cfg.num_layers, cfg.d_model, dtype=dtype)

    def layer(self, cfg: ModelConfig, i: int, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        h = rmsnorm(x, self.ln1[i], cfg.norm_eps)
        q, k, v = self.attn.qkv(cfg, i, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        attn_out = multihead_attention(
            q, k, v, causal=True,
            chunked_threshold=cfg.attn_chunked_threshold,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        )
        attn_out = attn_out.transpose(1, 2).reshape(B, S, cfg.q_dim)
        attn_out = attn_out @ self.attn.wo[i]
        if cfg.parallel_block:
            return x + attn_out + self.mlp(cfg, i, h)
        x = x + attn_out
        h2 = rmsnorm(x, self.ln2[i], cfg.norm_eps)
        return x + self.mlp(cfg, i, h2)


class Transformer(nn.Module):
    """tokens (B, S) -> final hidden (B, S, D), or f32 logits (B, S, V)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "dense" or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: only dense text transformers are ported to "
                "PyTorch yet"
            )
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = _param(cfg.vocab_size, cfg.d_model, dtype=dtype)
        self.blocks = Blocks(cfg, dtype)
        self.final_norm = _param(cfg.d_model, dtype=dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.vocab_size, cfg.d_model, dtype=dtype)

    def lm_table(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def forward(self, tokens: torch.Tensor, *, logits: bool = False) -> torch.Tensor:
        cfg = self.cfg
        x = embed_lookup(self.embed, tokens)
        if cfg.embed_scale:
            x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for i in range(cfg.num_layers):
            x = self.blocks.layer(cfg, i, x, positions)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return logits_from_embed(self.lm_table(), x) if logits else x


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random params as a nested dict, made on the generator's device.

    The same distributions as the reference's ``init_params`` (normal
    weights scaled by 1/sqrt(fan-in), embeddings by 0.02, zero norms and
    biases); the numbers differ, since the two RNG streams differ.
    """
    dtype = torch_dtype(cfg.param_dtype)
    dev = generator.device
    L, D, Q, KV, F = (cfg.num_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                      cfg.d_ff)

    def normal(*shape: int, scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=dev)

    s_in = 1.0 / np.sqrt(D)
    attn = {
        "wq": normal(L, D, Q, scale=s_in),
        "wk": normal(L, D, KV, scale=s_in),
        "wv": normal(L, D, KV, scale=s_in),
        "wo": normal(L, Q, D, scale=1.0 / np.sqrt(Q)),
    }
    if cfg.qkv_bias:
        attn.update(bq=zeros(L, Q), bk=zeros(L, KV), bv=zeros(L, KV))
    mlp = {
        "wi": normal(L, D, F, scale=s_in),
        "wo": normal(L, F, D, scale=1.0 / np.sqrt(F)),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp["wg"] = normal(L, D, F, scale=s_in)
    blocks = {"ln1": zeros(L, D), "attn": attn, "mlp": mlp}
    if not cfg.parallel_block:
        blocks["ln2"] = zeros(L, D)
    params = {
        "embed": normal(cfg.vocab_size, D, scale=0.02),
        "blocks": blocks,
        "final_norm": zeros(D),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.vocab_size, D, scale=0.02)
    return params
