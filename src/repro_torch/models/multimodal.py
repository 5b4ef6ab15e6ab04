"""Multimodal backbones with stub frontends: the reference's
``models/multimodal.py`` on the port's transformer.

paligemma-3b [vlm]: the SigLIP tower is a stub: the batch carries
precomputed patch embeddings (B, P, D), cast to the param dtype and
multiplied by a learned ``vision_proj`` (D, D) into the gemma backbone's
residual stream. The image tokens form a bidirectional *prefix*
(PaliGemma's prefix-LM attention, ``prefix_len`` = P), the text is causal.
A prefill's cache holds the image and the text, so decode is the
transformer's (the image lives in the cache prefix).

musicgen-medium [audio]: EnCodec is a stub: the backbone takes K codebook
token streams (B, S, K), embeds them with K tables (``codebook_embed``, the
gathers summed) and predicts K vocabulary heads per position
(``codebook_head``). The model has no ``embed`` and no ``lm_head``. The
delay-pattern interleaving is data preparation, out of scope.

Every function takes the meta-device ``Transformer`` (the program) and the
params (a nested dict of tensors, the checkpointed state), as
``models/transformer.py``'s do.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_lookup, logits_from_embed
from repro_torch.models.transformer import Transformer, module_params
from repro_torch.utils.dtypes import torch_dtype


# ---------------------------------------------------------------------------
# vision-language (paligemma)
# ---------------------------------------------------------------------------

def vlm_init(cfg: ModelConfig, generator: torch.Generator,
             device: torch.device | str | None = None) -> dict:
    """The transformer's params plus ``vision_proj`` (D, D), normal / sqrt(D)."""
    params = tfm.init_params(cfg, generator, device)
    dev = torch.device(device) if device is not None else generator.device
    D = cfg.d_model
    params["vision_proj"] = (torch.randn((D, D), generator=generator, device=dev)
                             / np.sqrt(D)).to(torch_dtype(cfg.param_dtype))
    return params


def _vlm_embed(cfg: ModelConfig, params: dict, patches: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """The image's projected patches, then the text's embeddings: (B, P + S, D)."""
    x_img = patches.to(torch_dtype(cfg.param_dtype)) @ params["vision_proj"]
    x_txt = tfm.embed_tokens(cfg, params, tokens)
    return torch.cat([x_img, x_txt], dim=1)


def vlm_hidden(module: Transformer, params: dict, patches: torch.Tensor,
               tokens: torch.Tensor):
    """patches: (B, P, D) stub embeddings; tokens: (B, S_text).

    Returns (text hidden (B, S_text, D), aux)."""
    x = _vlm_embed(module.cfg, params, patches, tokens)
    P = patches.shape[1]
    h, _, aux = tfm.forward(module, params, x, prefix_len=P)
    return h[:, P:, :], aux


def vlm_forward(module: Transformer, params: dict, patches: torch.Tensor,
                tokens: torch.Tensor):
    """Returns (text logits (B, S_text, V) f32, aux)."""
    h, aux = vlm_hidden(module, params, patches, tokens)
    return logits_from_embed(tfm.lm_table(module.cfg, params), h), aux


def vlm_prefill(module: Transformer, params: dict, patches: torch.Tensor,
                tokens: torch.Tensor, cache_len: int):
    """-> (f32 logits of the last text position (B, 1, V), cache): k/v over
    the image and the text, zero-padded to ``cache_len``, and ``pos`` the
    whole prompt's length P + S_text (where decode writes next)."""
    x = _vlm_embed(module.cfg, params, patches, tokens)
    S = x.shape[1]
    h, cache, _ = tfm.forward(module, params, x, prefix_len=patches.shape[1],
                              return_cache=True)
    k, v = tfm.pad_cache(cache["k"], cache["v"], cache_len)
    logits = logits_from_embed(tfm.lm_table(module.cfg, params), h[:, -1:, :])
    return logits, {"k": k, "v": v, "pos": S}


# vlm decode == transformer decode (the image lives in the cache prefix)
vlm_decode_step = tfm.decode_step


# ---------------------------------------------------------------------------
# audio LM over codebooks (musicgen)
# ---------------------------------------------------------------------------

def audio_init(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device | str | None = None) -> dict:
    """The transformer's params without ``embed`` (and, as the reference's
    tied init, without ``lm_head``), plus ``codebook_embed`` and
    ``codebook_head`` (K, V, D), normal * 0.02."""
    params = tfm.init_params(cfg.with_overrides(tie_embeddings=True), generator, device)
    del params["embed"]  # replaced by per-codebook tables
    dev = torch.device(device) if device is not None else generator.device
    shape = (cfg.audio_codebooks, cfg.vocab_size, cfg.d_model)
    dt = torch_dtype(cfg.param_dtype)
    params["codebook_embed"] = (torch.randn(shape, generator=generator, device=dev)
                                * 0.02).to(dt)
    params["codebook_head"] = (torch.randn(shape, generator=generator, device=dev)
                               * 0.02).to(dt)
    return params


def _audio_embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S, K) -> the K codebooks' embeddings summed (B, S, D)."""
    embeds = params["codebook_embed"]  # (K, V, D)
    xs = [embed_lookup(embeds[k], tokens[..., k]) for k in range(cfg.audio_codebooks)]
    return sum(xs)


def _audio_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """h (B, S, D) -> (B, S, K, V) f32."""
    return torch.einsum("bsd,kvd->bskv", h, params["codebook_head"]).float()


def audio_hidden(module: Transformer, params: dict, tokens: torch.Tensor):
    """tokens (B, S, K) -> (hidden (B, S, D), aux)."""
    x = _audio_embed(module.cfg, params, tokens)
    h, _, aux = tfm.forward(module, params, x)
    return h, aux


def audio_forward(module: Transformer, params: dict, tokens: torch.Tensor):
    """tokens (B, S, K) -> (logits (B, S, K, V) f32, aux)."""
    h, aux = audio_hidden(module, params, tokens)
    return _audio_logits(module.cfg, params, h), aux


def audio_prefill(module: Transformer, params: dict, tokens: torch.Tensor,
                  cache_len: int):
    """-> (f32 logits of the last frame (B, 1, K, V), cache)."""
    S = tokens.shape[1]
    x = _audio_embed(module.cfg, params, tokens)
    h, cache, _ = tfm.forward(module, params, x, return_cache=True)
    k, v = tfm.pad_cache(cache["k"], cache["v"], cache_len)
    logits = _audio_logits(module.cfg, params, h[:, -1:, :])
    return logits, {"k": k, "v": v, "pos": S}


def audio_decode_step(module: Transformer, params: dict, cache: dict,
                      tokens: torch.Tensor):
    """tokens (B, K), one frame -> (logits (B, K, V) f32, cache): the
    transformer's per-layer decode (each layer's k/v written into the cache
    in place at ``pos``) on the summed codebook embeddings, then the
    codebook heads."""
    x = _audio_embed(module.cfg, params, tokens[:, None, :])  # (B, 1, D)
    h = functional_call(module, module_params(params), (None,),
                        {"embeds": x, "cache": cache})
    logits = _audio_logits(module.cfg, params, h)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": int(cache["pos"]) + 1}
