"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
(the reference's ``models/hybrid.py``); with ``attn_every == 0`` the pure
SSM LM (the mamba2 family).

The shared block (one parameter set) runs after every ``attn_every``-th
mamba layer. The mamba layers' weights are stacked along a leading L axis
under the reference's names (``params/blocks/ssm/w_z`` ...), the shared
block's are stored once (``params/shared/attn/wq`` ...), so every
checkpoint chunk key is the same in both packages. As in
``models/transformer.py``, the ``nn.Module`` is the program: it lives on
the ``meta`` device and runs on the state's tensors through
``torch.func.functional_call``; ``init_params`` makes the tensors.

Training rematerialises as the reference does: for every ``cfg.remat`` but
``"none"`` each mamba layer and each application of the shared block is
recomputed whole in the backward (the reference's plain
``jax.checkpoint``). Remat changes memory, never values.

Serving: the cache is ``{"ssm": {"h": (L, B, H, P, N), "conv": (L, B,
W-1, Ch)} f32, "k", "v": (n_apps, B, Hkv, cache_len, Dh), "pos"}`` (no
``k``/``v`` without the shared block), a KV cache per *application* of the
shared block. A decode step writes the new SSM states and k/v into the
cache's buffers in place (the reference returns new arrays).

Departure noted by the reference (its DESIGN §6): Zamba2 concatenates the
block input with the original embeddings before the shared block and
applies per-invocation LoRA deltas; both packages apply the shared block
to the residual stream directly.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.models import mamba2
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
from repro_torch.models.transformer import _credited, _param, _qkv, module_params
from repro_torch.utils.dtypes import torch_dtype
from repro_torch.utils.tree import flatten_with_paths


def n_shared_apps(cfg: ModelConfig) -> int:
    return len(_app_layers(cfg))


def _app_layers(cfg: ModelConfig) -> list[int]:
    """Layer indices after which the shared block applies."""
    if not cfg.attn_every:
        return []
    return [i for i in range(cfg.num_layers) if (i + 1) % cfg.attn_every == 0]


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

class Mixers(nn.Module):
    """The mamba mixers of all L layers: each of ``mamba2.LEAVES`` with a
    leading L axis (``A_log``, ``D`` and ``dt_bias`` f32 in every model)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        for name, shape in mamba2.leaf_shapes(cfg).items():
            dt = torch.float32 if name in mamba2.F32_LEAVES else dtype
            setattr(self, name, _param(cfg.num_layers, *shape, dtype=dt))


class MambaBlocks(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.ln = _param(cfg.num_layers, cfg.d_model, dtype=dtype)
        self.ssm = Mixers(cfg, dtype)

    def weights(self, i: int) -> dict:
        """Layer i's slices, under the reference's names."""
        return {"ln": self.ln[i],
                "ssm": {name: getattr(self.ssm, name)[i] for name in mamba2.LEAVES}}


class SharedBlock(nn.Module):
    """ln1, attn {wq (D, Q), wk/wv (D, KV), wo (Q, D), biases with
    ``qkv_bias``}, ln2, mlp {wi (D, F), wg (gated MLPs), wo (F, D)}."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        D, Q, KV, Fw = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
        self.ln1 = _param(D, dtype=dtype)
        self.ln2 = _param(D, dtype=dtype)
        self.attn = nn.Module()
        for name, shape in (("wq", (D, Q)), ("wk", (D, KV)), ("wv", (D, KV)), ("wo", (Q, D))):
            setattr(self.attn, name, _param(*shape, dtype=dtype))
        if cfg.qkv_bias:
            for name, n in (("bq", Q), ("bk", KV), ("bv", KV)):
                setattr(self.attn, name, _param(n, dtype=dtype))
        self.mlp = nn.Module()
        self.mlp.wi = _param(D, Fw, dtype=dtype)
        self.mlp.wo = _param(Fw, D, dtype=dtype)
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.mlp.wg = _param(D, Fw, dtype=dtype)

    def weights(self) -> dict:
        return {"ln1": self.ln1, "ln2": self.ln2,
                "attn": dict(self.attn.named_parameters()),
                "mlp": dict(self.mlp.named_parameters())}


def _mamba_layer(cfg: ModelConfig, w: dict, x: torch.Tensor):
    """One mamba layer over (B, S, D) -> (x, its final SSM state h, conv).
    A function of its arguments alone, so remat can run it again."""
    y, state = mamba2.ssd_forward(cfg, w["ssm"], rmsnorm(x, w["ln"], cfg.norm_eps))
    return x + y, state["h"], state["conv"]


def _shared_block(cfg: ModelConfig, w: dict, x: torch.Tensor, positions: torch.Tensor):
    """The shared block over (B, S, D) -> (x, post-RoPE k, v (B, Hkv, S,
    Dh)). Long sequences take the chunked lowering: the flash kernel on the
    card."""
    B, S, _ = x.shape
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, w["attn"], h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    a = multihead_attention(
        q, k, v, causal=True,
        chunked_threshold=cfg.attn_chunked_threshold,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
    )
    x = x + a.transpose(1, 2).reshape(B, S, cfg.q_dim) @ w["attn"]["wo"]
    return x + _mlp(cfg, w, rmsnorm(x, w["ln2"], cfg.norm_eps)), k, v


def _mlp(cfg: ModelConfig, w: dict, h: torch.Tensor) -> torch.Tensor:
    m = w["mlp"]
    return mlp_apply(m["wi"], m["wo"], m.get("wg"), h, cfg.mlp_type)


def _shared_decode(cfg: ModelConfig, w: dict, x: torch.Tensor, pos: int,
                   positions: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor) -> torch.Tensor:
    """The shared block for one token (B, 1, D) at ``pos``; writes its k/v
    into the application's cache (B, Hkv, Smax, Dh) in place."""
    B = x.shape[0]
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, w["attn"], h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_cache[:, :, pos] = k[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v[:, :, 0].to(v_cache.dtype)
    a = decode_attention(q, k_cache, v_cache, pos)
    x = x + a.transpose(1, 2).reshape(B, 1, cfg.q_dim) @ w["attn"]["wo"]
    return x + _mlp(cfg, w, rmsnorm(x, w["ln2"], cfg.norm_eps))


def _remat(cfg: ModelConfig, fn):
    """The reference's remat of the hybrid: ``fn`` recomputed whole in the
    backward for every ``cfg.remat`` but ``"none"``."""
    if cfg.remat == "none":
        return fn
    return functools.partial(checkpoint, _credited(fn), use_reentrant=False)


class Hybrid(nn.Module):
    """tokens (B, S) -> final hidden (B, S, D), or f32 logits (B, S, V)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in ("ssm", "hybrid") or cfg.frontend != "none":
            raise ValueError(f"{cfg.name}: Hybrid runs the ssm and hybrid text "
                             f"families, not {cfg.family} (frontend={cfg.frontend})")
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        self.embed = _param(cfg.vocab_size, cfg.d_model, dtype=dtype)
        self.blocks = MambaBlocks(cfg, dtype)
        self.final_norm = _param(cfg.d_model, dtype=dtype)
        self.apps = _app_layers(cfg)
        if self.apps:
            self.shared = SharedBlock(cfg, dtype)

    def _run(self, fn, w: dict, *args):
        """``fn(cfg, w, *args)``, rematerialised per ``cfg.remat`` when a
        gradient is being taken."""
        fn = functools.partial(fn, self.cfg)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [*flatten_with_paths(w)[0].values(), *args]):
            fn = _remat(self.cfg, fn)
        return fn(w, *args)

    def forward(self, tokens: torch.Tensor, *, logits: bool = False,
                return_cache: bool = False, cache: dict | None = None):
        """The full forward, or with ``cache`` one decode step.

        Without ``cache``: tokens (B, S) -> final hidden (B, S, D), or f32
        logits (B, S, V) with ``logits``; with ``return_cache`` also
        ``{"ssm": {"h", "conv"}, "k", "v"}``: each layer's final SSM state
        stacked (L, ...), and each application's post-RoPE k/v stacked
        (n_apps, B, Hkv, S, Dh).

        With ``cache`` (and ``pos`` in it, the index the new token is
        written at): tokens (B,) -> f32 logits (B, V); the cache's buffers
        are written in place.
        """
        cfg = self.cfg
        if cache is not None:
            return self._decode(tokens, cache)
        x = embed_lookup(self.embed, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        shared = self.shared.weights() if self.apps else None
        hs, convs, ks, vs = [], [], [], []
        for i in range(cfg.num_layers):
            x, h, conv = self._run(_mamba_layer, self.blocks.weights(i), x)
            if return_cache:
                hs.append(h)
                convs.append(conv)
            if i in self.apps:
                x, k, v = self._run(_shared_block, shared, x, positions)
                if return_cache:
                    ks.append(k)
                    vs.append(v)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        out = logits_from_embed(self.embed, x) if logits else x
        if not return_cache:
            return out
        parts = {"ssm": {"h": torch.stack(hs), "conv": torch.stack(convs)}}
        if ks:
            parts.update(k=torch.stack(ks), v=torch.stack(vs))
        return out, parts

    def _decode(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        cfg = self.cfg
        pos = int(cache["pos"])
        x = embed_lookup(self.embed, tokens[:, None])
        positions = torch.tensor([pos], device=x.device)
        shared = self.shared.weights() if self.apps else None
        ssm = cache["ssm"]
        for i in range(cfg.num_layers):
            w = self.blocks.weights(i)
            state = {"h": ssm["h"][i], "conv": ssm["conv"][i]}
            y, new = mamba2.ssm_decode_step(cfg, w["ssm"], state,
                                            rmsnorm(x, w["ln"], cfg.norm_eps))
            state["h"].copy_(new["h"])
            state["conv"].copy_(new["conv"])
            x = x + y
            if i in self.apps:
                app = self.apps.index(i)
                x = _shared_decode(cfg, shared, x, pos, positions,
                                   cache["k"][app], cache["v"][app])
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return logits_from_embed(self.embed, x)[:, 0]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> dict:
    """Random params as a nested dict, made on the generator's device (or on
    ``device``: ``"meta"`` gives the structure alone, drawing nothing).

    The reference's distributions (``mamba_init`` per layer, embeddings by
    0.02, the shared block's attention and MLP scaled by 1/sqrt(fan-in),
    zero norms and biases); the numbers differ, since the RNG streams do.
    """
    dtype = torch_dtype(cfg.param_dtype)
    dev = torch.device(device) if device is not None else generator.device
    L, D = cfg.num_layers, cfg.d_model

    def normal(*shape: int, scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=dev)

    params = {
        "embed": normal(cfg.vocab_size, D, scale=0.02),
        "blocks": {"ln": zeros(L, D),
                   "ssm": mamba2.mamba_init(cfg, generator, L, dtype=dtype, device=dev)},
        "final_norm": zeros(D),
    }
    if cfg.attn_every:
        Q, KV, Fw = cfg.q_dim, cfg.kv_dim, cfg.d_ff
        s_in = D ** -0.5
        attn = {"wq": normal(D, Q, scale=s_in), "wk": normal(D, KV, scale=s_in),
                "wv": normal(D, KV, scale=s_in), "wo": normal(Q, D, scale=Q ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(Q), bk=zeros(KV), bv=zeros(KV))
        mlp = {"wi": normal(D, Fw, scale=s_in), "wo": normal(Fw, D, scale=Fw ** -0.5)}
        if cfg.mlp_type in ("swiglu", "geglu"):
            mlp["wg"] = normal(D, Fw, scale=s_in)
        params["shared"] = {"ln1": zeros(D), "attn": attn, "ln2": zeros(D), "mlp": mlp}
    return params


# ---------------------------------------------------------------------------
# running the module on a params dict
# ---------------------------------------------------------------------------

def hidden_forward(module: Hybrid, params: dict, tokens: torch.Tensor):
    """tokens (B, S) -> (final hidden (B, S, D), aux = 0 f32)."""
    h = functional_call(module, module_params(params), (tokens,))
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def lm_forward(module: Hybrid, params: dict, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V) f32, aux = 0)."""
    h, aux = hidden_forward(module, params, tokens)
    return logits_from_embed(params["embed"], h), aux


def prefill(module: Hybrid, params: dict, tokens: torch.Tensor,
            cache_len: int | None = None):
    """Run the prompt, building the SSM states and the shared block's KV
    caches of size ``cache_len`` (>= S, zero-padded past S). Returns (f32
    logits of the last position (B, 1, V), cache with ``pos`` = S)."""
    S = tokens.shape[1]
    cache_len = cache_len or S
    h, cache = functional_call(module, module_params(params), (tokens,),
                               {"return_cache": True})
    for name in ("k", "v"):
        if name in cache and cache_len > S:
            cache[name] = F.pad(cache[name], (0, 0, 0, cache_len - S))
    cache["pos"] = S
    return logits_from_embed(params["embed"], h[:, -1:, :]), cache


def decode_step(module: Hybrid, params: dict, cache: dict, tokens: torch.Tensor):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32, cache):
    the same buffers, written in place, and ``pos + 1``."""
    logits = functional_call(module, module_params(params), (tokens,), {"cache": cache})
    return logits, dict(cache, pos=int(cache["pos"]) + 1)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device: torch.device | str, dtype: torch.dtype | None = None) -> dict:
    dtype = dtype or torch_dtype(cfg.param_dtype)
    cache = {"ssm": mamba2.init_ssm_state(cfg, batch, cfg.num_layers, device=device),
             "pos": 0}
    apps = n_shared_apps(cfg)
    if apps:
        shape = (apps, batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
