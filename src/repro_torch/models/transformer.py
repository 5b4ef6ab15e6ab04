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

Serving: ``prefill`` runs the forward over a prompt and keeps the stacked
post-RoPE k/v cache, ``decode_step`` runs one token against it. The cache
is the server's own buffer, so a decode step writes the new k/v into it in
place (the reference returns a new array).

Not ported: activation rematerialisation (``cfg.remat``, which only saves
memory), MoE blocks, ``prefix_len`` (prefix-LM masking).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    embed_lookup,
    logits_from_embed,
    mlp_apply,
    multihead_attention,
    rmsnorm,
)
from repro_torch.utils.dtypes import torch_dtype
from repro_torch.utils.tree import flatten_with_paths


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
              positions: torch.Tensor):
        """Layer i over (B, S, D) -> (x, post-RoPE k, v (B, Hkv, S, Dh))."""
        h = rmsnorm(x, self.ln1[i], cfg.norm_eps)
        q, k, v = self.attn.qkv(cfg, i, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        attn_out = multihead_attention(
            q, k, v, causal=True,
            chunked_threshold=cfg.attn_chunked_threshold,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        )
        return self._finish(cfg, i, x, h, attn_out), k, v

    def decode_layer(self, cfg: ModelConfig, i: int, x: torch.Tensor, pos: int,
                     positions: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor) -> torch.Tensor:
        """Layer i for one token (B, 1, D) at ``pos`` (``positions`` is
        ``[pos]`` on x's device); writes its k/v into the layer's cache
        (B, Hkv, Smax, Dh) in place."""
        h = rmsnorm(x, self.ln1[i], cfg.norm_eps)
        q, k, v = self.attn.qkv(cfg, i, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_cache[:, :, pos] = k[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, pos] = v[:, :, 0].to(v_cache.dtype)
        attn_out = decode_attention(q, k_cache, v_cache, pos)
        return self._finish(cfg, i, x, h, attn_out)

    def _finish(self, cfg: ModelConfig, i: int, x: torch.Tensor, h: torch.Tensor,
                attn_out: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
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

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(self.embed, tokens)
        if self.cfg.embed_scale:
            x = x * torch.tensor(np.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        return x

    def forward(self, tokens: torch.Tensor, *, logits: bool = False,
                return_cache: bool = False, cache: dict | None = None):
        """The full forward, or with ``cache`` one decode step.

        Without ``cache``: tokens (B, S) -> final hidden (B, S, D), or f32
        logits (B, S, V) with ``logits``; with ``return_cache`` also
        ``{"k", "v"}``, the stacked post-RoPE k/v (L, B, Hkv, S, Dh).

        With ``cache`` (``{"k", "v"}`` of (L, B, Hkv, Smax, Dh) and ``pos``,
        the index the new token is written at): tokens (B,) -> f32 logits
        (B, V). The new k/v go into the cache's buffers in place.
        """
        cfg = self.cfg
        if cache is not None:
            pos = int(cache["pos"])
            x = self.embed_tokens(tokens[:, None])
            positions = torch.tensor([pos], device=x.device)
            for i in range(cfg.num_layers):
                x = self.blocks.decode_layer(cfg, i, x, pos, positions,
                                             cache["k"][i], cache["v"][i])
            x = rmsnorm(x, self.final_norm, cfg.norm_eps)
            return logits_from_embed(self.lm_table(), x)[:, 0]
        x = self.embed_tokens(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, k, v = self.blocks.layer(cfg, i, x, positions)
            if return_cache:
                ks.append(k)
                vs.append(v)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        out = logits_from_embed(self.lm_table(), x) if logits else x
        if return_cache:
            return out, {"k": torch.stack(ks), "v": torch.stack(vs)}
        return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random params as a nested dict, made on the generator's device (or on
    ``device``: ``"meta"`` gives the structure alone, drawing nothing).

    The same distributions as the reference's ``init_params`` (normal
    weights scaled by 1/sqrt(fan-in), embeddings by 0.02, zero norms and
    biases); the numbers differ, since the two RNG streams differ.
    """
    dtype = torch_dtype(cfg.param_dtype)
    dev = torch.device(device) if device is not None else generator.device
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


# ---------------------------------------------------------------------------
# running the module on a params dict
# ---------------------------------------------------------------------------

def module_params(params: dict) -> dict[str, torch.Tensor]:
    """Nested params -> ``{"blocks.attn.wq": tensor}`` for functional_call."""
    flat, _ = flatten_with_paths(params)
    return {path.replace("/", "."): t for path, t in flat.items()}


def lm_table(cfg: ModelConfig, params: dict) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# serving: prefill and decode with a KV cache
# ---------------------------------------------------------------------------

def prefill(module: Transformer, params: dict, tokens: torch.Tensor,
            cache_len: int | None = None, prefix_len: int | None = None):
    """Build a KV cache of size ``cache_len`` (>= S); returns (logits, cache).

    tokens (B, S) -> f32 logits of the last position only (B, 1, V), and
    ``{"k", "v"}`` (L, B, Hkv, cache_len, Dh) zero-padded past S, with
    ``pos`` = S, the index the next token is written at.
    """
    if prefix_len is not None:
        raise NotImplementedError("prefix_len (prefix-LM serving) is not ported yet")
    B, S = tokens.shape
    cache_len = cache_len or S
    h, cache = functional_call(module, module_params(params), (tokens,),
                               {"return_cache": True})
    k, v = cache["k"], cache["v"]
    if cache_len > S:
        k = F.pad(k, (0, 0, 0, cache_len - S))
        v = F.pad(v, (0, 0, 0, cache_len - S))
    logits = logits_from_embed(lm_table(module.cfg, params), h[:, -1:, :])
    return logits, {"k": k, "v": v, "pos": S}


def decode_step(module: Transformer, params: dict, cache: dict, tokens: torch.Tensor):
    """One decode step. tokens: (B,) int; cache k/v: (L, B, Hkv, Smax, Dh).

    Returns (logits (B, V) f32, cache): the same k/v buffers, written in
    place at ``pos``, and ``pos + 1``.
    """
    logits = functional_call(module, module_params(params), (tokens,), {"cache": cache})
    return logits, {"k": cache["k"], "v": cache["v"], "pos": int(cache["pos"]) + 1}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: torch.device | str, dtype: torch.dtype | None = None) -> dict:
    dtype = dtype or torch_dtype(cfg.param_dtype)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }
