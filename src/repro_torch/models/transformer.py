"""Decoder-only transformer as ``nn.Module``s: the dense family, and the
MoE family, whose blocks swap the MLP for ``models/moe.py``.

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

Training rematerialises each layer as the reference's ``_remat`` does
(``cfg.remat``): ``"none"`` keeps every activation, ``"full"`` recomputes
the layer in the backward, ``"dots"`` keeps the outputs of matmuls without
batch dims and recomputes the rest. Remat changes memory, never values.

The forward also gives the MoE layers' summed router aux loss
(``return_aux``; 0 for a dense model), which the loss adds.

The forward takes token ids or, like the reference's ``forward``,
embeddings (``embeds``), and a ``prefix_len``: the first ``prefix_len``
positions form a bidirectional prefix (PaliGemma's prefix-LM attention),
the rest is causal. The module carries the leaves of the reference's
multimodal models (``models/multimodal.py`` runs them): with the vision
frontend ``vision_proj`` (D, D) beside the dense leaves; with the audio
frontend no ``embed`` and no ``lm_head`` but ``codebook_embed`` and
``codebook_head`` (K, V, D). The SSM and hybrid families are
``models/hybrid.py``.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels import flash_attention as _flash
from repro_torch.launch import mesh as _mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_apply
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


class MLP(nn.Module):
    """wi/wg (L, D, F) and wo (L, F, D); wg only for gated MLPs. F is
    ``cfg.d_ff``, or ``width`` (the MoE block's dense residual branch)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, width: int | None = None):
        super().__init__()
        L, D, F = cfg.num_layers, cfg.d_model, width or cfg.d_ff
        self.wi = _param(L, D, F, dtype=dtype)
        self.wo = _param(L, F, D, dtype=dtype)
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wg = _param(L, D, F, dtype=dtype)


class MoE(nn.Module):
    """The experts of all L layers: router (L, D, E) f32 in every model,
    wi/wg (L, E, D, F), wo (L, E, F, D), and ``dense`` where
    ``cfg.moe_dense_ff``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        L, D, E, F = cfg.num_layers, cfg.d_model, cfg.moe_experts, cfg.d_ff
        self.router = _param(L, D, E, dtype=torch.float32)
        self.wi = _param(L, E, D, F, dtype=dtype)
        self.wo = _param(L, E, F, D, dtype=dtype)
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.wg = _param(L, E, D, F, dtype=dtype)
        if cfg.moe_dense_ff:
            self.dense = MLP(cfg, dtype, cfg.moe_dense_ff)


# the sharded train step's tensor parallelism while it runs the layers
# (see :func:`tensor_parallel`), and its gathering of each layer's weights
# (see :func:`gathered_layers`)
_TP: list = []
_GATHER: list = []


@contextlib.contextmanager
def tensor_parallel(mesh, *, heads: bool, mlp: bool):
    """Inside the block, each rank's layers hold its own heads of every
    attention projection (``heads``: a config with the heads divided by the
    ``model`` axis) and its own columns of the dense MLP's ``wi``/``wg``
    and rows of its ``wo`` (``mlp``), and the ranks of ``model`` run the
    same rows: a split part's input carries its gradient summed over
    ``model``, its output is the sum over ``model`` (Megatron's f and g).
    Process-wide, as ``launch.mesh.use_mesh``, for autograd's recomputing
    thread."""
    _TP.append((mesh, heads, mlp))
    try:
        yield
    finally:
        _TP.pop()


@contextlib.contextmanager
def gathered_layers(gather):
    """Inside the block, the params under ``blocks`` are this rank's
    blocks of the stacked weights, and layer i's weights reach the layer
    as ``gather(path, block)`` of its slices (``path`` the param's, e.g.
    ``blocks/attn/wq``), inside the layer's remat: a layer's gathered
    weights live while it runs, and the backward gathers them again (FSDP)."""
    _GATHER.append(gather)
    try:
        yield
    finally:
        _GATHER.pop()


def _tree_map(fn, tree: dict, *rest: dict) -> dict:
    return {k: _tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def _qkv(cfg: ModelConfig, w: dict, h: torch.Tensor):
    B, S, _ = h.shape
    q = h @ w["wq"]
    k = h @ w["wk"]
    v = h @ w["wv"]
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    return q, k, v


def _ffn(cfg: ModelConfig, w: dict, h: torch.Tensor):
    """The block's MLP, or its MoE layer -> (out, aux: None for an MLP)."""
    if "moe" in w:
        return moe_apply(cfg, w["moe"], h)
    if _TP and _TP[-1][2]:
        mesh = _TP[-1][0]
        out = mlp_apply(w["wi"], w["mlp_wo"], w.get("wg"),
                        _mesh.sum_grad_over(h, mesh, "model"), cfg.mlp_type)
        return _mesh.sum_over(out, mesh, "model"), None
    return mlp_apply(w["wi"], w["mlp_wo"], w.get("wg"), h, cfg.mlp_type), None


def _finish(cfg: ModelConfig, w: dict, x: torch.Tensor, h: torch.Tensor,
            attn_out: torch.Tensor):
    """The block after attention -> (x, the MoE aux or None)."""
    B, S, _ = x.shape
    attn_out = attn_out.transpose(1, 2).reshape(B, S, cfg.q_dim)
    attn_out = attn_out @ w["attn_wo"]
    if _TP and _TP[-1][1]:
        attn_out = _mesh.sum_over(attn_out, _TP[-1][0], "model")
    if cfg.parallel_block:
        out, aux = _ffn(cfg, w, h)
        return x + attn_out + out, aux
    x = x + attn_out
    out, aux = _ffn(cfg, w, rmsnorm(x, w["ln2"], cfg.norm_eps))
    return x + out, aux


def _layer(cfg: ModelConfig, w: dict, x: torch.Tensor, positions: torch.Tensor,
           prefix_len: int | None = None):
    """One layer over (B, S, D) from its weights ``w`` -> (x, post-RoPE k,
    v (B, Hkv, S, Dh), the MoE aux or None). A function of its arguments
    alone, so remat can run it again in the backward."""
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, w, _mesh.sum_grad_over(h, _TP[-1][0], "model")
                   if _TP and _TP[-1][1] else h)
    attn_out, k = attend(cfg, q, k, v, positions, prefix_len)
    x, aux = _finish(cfg, w, x, h, attn_out)
    return x, k, v, aux


def attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor, prefix_len: int | None = None):
    """A layer's attention on its q (B, H, S, Dh), k and v (B, Hkv, S, Dh):
    RoPE on q and k, then causal (or prefix-LM) attention, the flash
    kernels from ``cfg.attn_chunked_threshold`` positions on -> (out (B, H,
    S, Dh), post-RoPE k). Each head alone: under a mesh a rank runs it on
    its own heads."""
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = multihead_attention(
        q, k, v, causal=True, prefix_len=prefix_len,
        chunked_threshold=cfg.attn_chunked_threshold,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
    )
    return out, k


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep ``x @ W`` (aten ``mm`` and
    ``addmm``, the router's logits among them), recompute everything else
    (batched products such as the experts', norms, RoPE, attention,
    activations, the routing)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _credited(fn):
    """``fn`` counting its kernel launches for the calling thread, also
    when the backward recomputes it on autograd's thread for the device."""
    counts = _flash.thread_counts()

    def run(*args):
        with _flash.credit(counts):
            return fn(*args)

    return run


def _remat(cfg: ModelConfig, fn):
    """The reference's ``_remat``: ``fn`` as the backward will see it."""
    if cfg.remat == "none":
        return fn
    fn = _credited(fn)
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context)
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat {cfg.remat!r}: none, dots or full")


def _gathering(fn, gather, paths: dict):
    """``fn(w, x, positions)`` on the layer's weights ``gather``-ed from
    this rank's blocks ``w``."""
    def run(w, x, positions):
        return fn(_tree_map(lambda t, p: gather("blocks/" + p, t), w, paths), x, positions)

    return run


class Blocks(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.ln1 = _param(cfg.num_layers, cfg.d_model, dtype=dtype)
        self.attn = Attention(cfg, dtype)
        if cfg.family == "moe":
            self.moe = MoE(cfg, dtype)
        else:
            self.mlp = MLP(cfg, dtype)
        if not cfg.parallel_block:
            self.ln2 = _param(cfg.num_layers, cfg.d_model, dtype=dtype)

    def weight_paths(self, cfg: ModelConfig) -> dict:
        """:meth:`weights`' tree, each leaf the path of its stacked param
        under ``blocks``."""
        p = {"ln1": "ln1", "wq": "attn/wq", "wk": "attn/wk", "wv": "attn/wv",
             "attn_wo": "attn/wo"}
        if cfg.qkv_bias:
            p.update(bq="attn/bq", bk="attn/bk", bv="attn/bv")
        if cfg.family == "moe":
            p["moe"] = {n: f"moe/{n}" for n in ("router", "wi", "wg", "wo")
                        if hasattr(self.moe, n)}
            if hasattr(self.moe, "dense"):
                p["moe"]["dense"] = {n: f"moe/dense/{n}" for n in ("wi", "wg", "wo")
                                     if hasattr(self.moe.dense, n)}
        else:
            p.update(wi="mlp/wi", mlp_wo="mlp/wo")
            if cfg.mlp_type in ("swiglu", "geglu"):
                p["wg"] = "mlp/wg"
        if not cfg.parallel_block:
            p["ln2"] = "ln2"
        return p

    def weights(self, cfg: ModelConfig, i: int) -> dict:
        """Layer i's slices of the stacked weights."""
        def get(path: str) -> torch.Tensor:
            node = self
            for name in path.split("/"):
                node = getattr(node, name)
            return node[i]

        return _tree_map(get, self.weight_paths(cfg))

    def layer(self, cfg: ModelConfig, i: int, x: torch.Tensor,
              positions: torch.Tensor, prefix_len: int | None = None):
        """Layer i over (B, S, D) -> (x, post-RoPE k, v (B, Hkv, S, Dh), the
        MoE aux or None), rematerialised per ``cfg.remat`` when a gradient
        is being taken; under :func:`gathered_layers` its weights are
        gathered inside the remat."""
        w = self.weights(cfg, i)
        fn = functools.partial(_layer, cfg, prefix_len=prefix_len)
        if _GATHER:
            fn = _gathering(fn, _GATHER[-1], self.weight_paths(cfg))
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in flatten_with_paths(w)[0].values())):
            fn = _remat(cfg, fn)
        return fn(w, x, positions)

    def decode_layer(self, cfg: ModelConfig, i: int, x: torch.Tensor, pos: int,
                     positions: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor) -> torch.Tensor:
        """Layer i for one token (B, 1, D) at ``pos`` (``positions`` is
        ``[pos]`` on x's device); writes its k/v into the layer's cache
        (B, Hkv, Smax, Dh) in place."""
        w = self.weights(cfg, i)
        h = rmsnorm(x, w["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, w, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        k_cache[:, :, pos] = k[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, pos] = v[:, :, 0].to(v_cache.dtype)
        attn_out = decode_attention(q, k_cache, v_cache, pos)
        return _finish(cfg, w, x, h, attn_out)[0]


class Transformer(nn.Module):
    """tokens (B, S) or embeddings (B, S, D) -> final hidden (B, S, D), or
    f32 logits (B, S, V)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.frontend not in ("none", "vision", "audio"):
            raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"{cfg.name}: the Transformer runs the dense and moe "
                             f"families; {cfg.family} runs in models/hybrid.py")
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        D, V = cfg.d_model, cfg.vocab_size
        if cfg.frontend == "audio":
            # the reference's audio_init: per-codebook tables replace both
            self.codebook_embed = _param(cfg.audio_codebooks, V, D, dtype=dtype)
            self.codebook_head = _param(cfg.audio_codebooks, V, D, dtype=dtype)
        else:
            self.embed = _param(V, D, dtype=dtype)
            if not cfg.tie_embeddings:
                self.lm_head = _param(V, D, dtype=dtype)
        if cfg.frontend == "vision":
            self.vision_proj = _param(D, D, dtype=dtype)
        self.blocks = Blocks(cfg, dtype)
        self.final_norm = _param(D, dtype=dtype)

    def lm_table(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return _embed(self.cfg, self.embed, tokens)

    def forward(self, tokens: torch.Tensor | None = None, *,
                embeds: torch.Tensor | None = None, prefix_len: int | None = None,
                logits: bool = False, return_cache: bool = False,
                return_aux: bool = False, cache: dict | None = None):
        """The full forward, or with ``cache`` one decode step.

        Without ``cache``: tokens (B, S), or ``embeds`` (B, S, D) in their
        place, -> final hidden (B, S, D), or f32 logits (B, S, V) with
        ``logits``; ``prefix_len`` makes the first positions a bidirectional
        prefix; with ``return_cache`` also ``{"k", "v"}``, the stacked
        post-RoPE k/v (L, B, Hkv, S, Dh); with ``return_aux`` last the
        layers' summed MoE aux loss (f32 scalar).

        With ``cache`` (``{"k", "v"}`` of (L, B, Hkv, Smax, Dh) and ``pos``,
        the index the new token is written at): tokens (B,) -> f32 logits
        (B, V), or ``embeds`` (B, 1, D) -> the final hidden (B, 1, D). The
        new k/v go into the cache's buffers in place.
        """
        cfg = self.cfg
        if cache is not None:
            pos = int(cache["pos"])
            x = embeds if embeds is not None else self.embed_tokens(tokens[:, None])
            positions = torch.tensor([pos], device=x.device)
            for i in range(cfg.num_layers):
                x = self.blocks.decode_layer(cfg, i, x, pos, positions,
                                             cache["k"][i], cache["v"][i])
            x = rmsnorm(x, self.final_norm, cfg.norm_eps)
            if embeds is not None:
                return x
            return logits_from_embed(self.lm_table(), x)[:, 0]
        x = embeds if embeds is not None else self.embed_tokens(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        ks, vs = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            x, k, v, a = self.blocks.layer(cfg, i, x, positions, prefix_len)
            if a is not None:
                aux = aux + a
            if return_cache:
                ks.append(k)
                vs.append(v)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        out = (logits_from_embed(self.lm_table(), x) if logits else x,)
        if return_cache:
            out += ({"k": torch.stack(ks), "v": torch.stack(vs)},)
        if return_aux:
            out += (aux,)
        return out if len(out) > 1 else out[0]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random params as a nested dict, made on the generator's device (or on
    ``device``: ``"meta"`` gives the structure alone, drawing nothing).

    The same distributions as the reference's ``init_params`` (normal
    weights scaled by 1/sqrt(fan-in), embeddings by 0.02, zero norms and
    biases, the MoE router in f32); the numbers differ, since the two RNG
    streams differ.
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

    def mlp(*lead: int, width: int) -> dict:
        p = {"wi": normal(*lead, D, width, scale=s_in),
             "wo": normal(*lead, width, D, scale=1.0 / np.sqrt(width))}
        if cfg.mlp_type in ("swiglu", "geglu"):
            p["wg"] = normal(*lead, D, width, scale=s_in)
        return p

    blocks = {"ln1": zeros(L, D), "attn": attn}
    if cfg.family == "moe":
        E = cfg.moe_experts
        moe = mlp(L, E, width=F)
        moe["router"] = (torch.randn((L, D, E), generator=generator, device=dev)
                         * s_in).float()
        if cfg.moe_dense_ff:
            moe["dense"] = mlp(L, width=cfg.moe_dense_ff)
        blocks["moe"] = moe
    else:
        blocks["mlp"] = mlp(L, width=F)
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


def _embed(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    x = embed_lookup(table, tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> embeddings (B, S, D), times sqrt(D) where the config
    scales them (gemma's)."""
    return _embed(cfg, params["embed"], tokens)


def forward(module: Transformer, params: dict, x: torch.Tensor, *,
            prefix_len: int | None = None, return_cache: bool = False):
    """The reference's ``forward``: embeddings x (B, S, D) -> (final hidden
    (B, S, D), the stacked k/v ``{"k", "v"}`` with ``return_cache`` or None,
    the MoE aux loss)."""
    out = functional_call(module, module_params(params), (None,),
                          {"embeds": x, "prefix_len": prefix_len,
                           "return_cache": return_cache, "return_aux": True})
    if return_cache:
        return out
    h, aux = out
    return h, None, aux


def pad_cache(k: torch.Tensor, v: torch.Tensor, cache_len: int):
    """Stacked k/v (L, B, Hkv, S, Dh) zero-padded along S to ``cache_len``."""
    S = k.shape[3]
    if cache_len > S:
        k = F.pad(k, (0, 0, 0, cache_len - S))
        v = F.pad(v, (0, 0, 0, cache_len - S))
    return k, v


# ---------------------------------------------------------------------------
# serving: prefill and decode with a KV cache
# ---------------------------------------------------------------------------

def prefill(module: Transformer, params: dict, tokens: torch.Tensor,
            cache_len: int | None = None, prefix_len: int | None = None):
    """Build a KV cache of size ``cache_len`` (>= S); returns (logits, cache).

    tokens (B, S) -> f32 logits of the last position only (B, 1, V), and
    ``{"k", "v"}`` (L, B, Hkv, cache_len, Dh) zero-padded past S, with
    ``pos`` = S, the index the next token is written at. ``prefix_len``
    makes the first positions a bidirectional prefix.
    """
    B, S = tokens.shape
    cache_len = cache_len or S
    h, cache = functional_call(module, module_params(params), (tokens,),
                               {"return_cache": True, "prefix_len": prefix_len})
    k, v = pad_cache(cache["k"], cache["v"], cache_len)
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
