"""Model zoo: one API over every family (the dense and MoE text
transformers, the SSM and hybrid models, the vision and audio models).

``build(cfg)`` returns a ``Model`` whose functions take the params as a
nested dict of tensors (the checkpointed state), like the reference's:

    init(generator)                   -> params
    loss(params, batch)               -> (CE + z-loss + MoE aux, {"loss",
                                         "ce", "aux"})
    forward(params, batch)            -> logits (B, S, V) f32
    prefill(params, batch, cache_len) -> (logits (B, 1, V) f32, cache)
    decode(params, cache, tokens)     -> (logits (B, V) f32, cache)
    init_cache(batch, cache_len, device=...) -> cache

A batch holds ``inputs`` (and ``targets``) of token ids (B, S); the vision
model's also ``patches`` (B, P, D), its logits are the text's; the audio
model's ids are (B, S, K), its logits (B, S, K, V) and its decode takes
(B, K) and gives (B, K, V).

The ``nn.Module`` program lives on the ``meta`` device and runs on the
params through ``torch.func.functional_call``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.func import functional_call

from repro_torch.models import hybrid as hyb
from repro_torch.models import multimodal as mm
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import logits_from_embed
from repro_torch.models.transformer import lm_table, module_params


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, targets: torch.Tensor, *, z_weight: float = 1e-4):
    """logits (..., V) f32; targets (...) int -> (mean CE + z-loss, mean CE)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    z = (lse**2).mean() * z_weight
    return ce + z, ce


def chunked_lm_xent(
    hidden: torch.Tensor,
    table: torch.Tensor,
    targets: torch.Tensor,
    *,
    chunk_tokens: int,
    z_weight: float = 1e-4,
):
    """CE over sequence chunks of at most ``chunk_tokens`` per sequence.

    hidden (B, S, D), table (V, D), targets (B, S). Chunks are cut along S
    exactly as the reference cuts them, and each chunk's logits are made in
    the table's dtype and then widened to f32. The reference also remats
    each chunk so that only one chunk's logits are live; the port does not
    (that only saves memory).
    """
    B, S, D = hidden.shape
    per_b = max(1, min(S, chunk_tokens))
    while S % per_b:
        per_b -= 1
    ce_sum = hidden.new_zeros((), dtype=torch.float32)
    z_sum = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, per_b):
        h = hidden[:, s0 : s0 + per_b]
        t = targets[:, s0 : s0 + per_b]
        logits = logits_from_embed(table, h)
        lse = torch.logsumexp(logits, dim=-1)
        # gather: deterministic backward on CUDA
        gold = logits.gather(-1, t.long()[..., None])[..., 0]
        ce_sum = ce_sum + (lse - gold).sum()
        z_sum = z_sum + (lse**2).sum()
    ntok = B * S
    ce = ce_sum / ntok
    return ce + z_weight * z_sum / ntok, ce


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclass
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def _hidden_xent(cfg: ModelConfig, params, hidden, targets):
    table = lm_table(cfg, params)
    if cfg.ce_chunk_tokens:
        return chunked_lm_xent(hidden, table, targets, chunk_tokens=cfg.ce_chunk_tokens)
    return softmax_xent(logits_from_embed(table, hidden), targets)


def _meta_transformer(cfg: ModelConfig) -> tfm.Transformer:
    with torch.device("meta"):
        return tfm.Transformer(cfg)


def _build_dense_or_moe(cfg: ModelConfig) -> Model:
    module = _meta_transformer(cfg)

    def loss(params, batch):
        h, aux = functional_call(module, module_params(params), (batch["inputs"],),
                                 {"return_aux": True})
        l, ce = _hidden_xent(cfg, params, h, batch["targets"])
        return l + aux, {"loss": l, "ce": ce, "aux": aux}

    def forward(params, batch):
        return functional_call(
            module, module_params(params), (batch["inputs"],), {"logits": True}
        )

    return Model(
        cfg=cfg,
        init=lambda generator, device=None: tfm.init_params(cfg, generator, device),
        loss=loss,
        forward=forward,
        prefill=lambda params, batch, cache_len: tfm.prefill(
            module, params, batch["inputs"], cache_len
        ),
        decode=lambda params, cache, tokens: tfm.decode_step(module, params, cache, tokens),
        init_cache=lambda batch, cache_len, *, device: tfm.init_cache(
            cfg, batch, cache_len, device=device
        ),
    )


def _build_ssm_or_hybrid(cfg: ModelConfig) -> Model:
    with torch.device("meta"):
        module = hyb.Hybrid(cfg)

    def loss(params, batch):
        h, aux = hyb.hidden_forward(module, params, batch["inputs"])
        if cfg.ce_chunk_tokens:
            l, ce = chunked_lm_xent(
                h, params["embed"], batch["targets"], chunk_tokens=cfg.ce_chunk_tokens
            )
        else:
            l, ce = softmax_xent(logits_from_embed(params["embed"], h), batch["targets"])
        return l + aux, {"loss": l, "ce": ce, "aux": aux}

    return Model(
        cfg=cfg,
        init=lambda generator, device=None: hyb.init_params(cfg, generator, device),
        loss=loss,
        forward=lambda params, batch: hyb.lm_forward(module, params, batch["inputs"])[0],
        prefill=lambda params, batch, cache_len: hyb.prefill(
            module, params, batch["inputs"], cache_len
        ),
        decode=lambda params, cache, tokens: hyb.decode_step(module, params, cache, tokens),
        init_cache=lambda batch, cache_len, *, device: hyb.init_cache(
            cfg, batch, cache_len, device=device
        ),
    )


def _build_vlm(cfg: ModelConfig) -> Model:
    module = _meta_transformer(cfg)

    def loss(params, batch):
        h, aux = mm.vlm_hidden(module, params, batch["patches"], batch["inputs"])
        l, ce = _hidden_xent(cfg, params, h, batch["targets"])
        return l + aux, {"loss": l, "ce": ce, "aux": aux}

    return Model(
        cfg=cfg,
        init=lambda generator, device=None: mm.vlm_init(cfg, generator, device),
        loss=loss,
        forward=lambda params, batch: mm.vlm_forward(
            module, params, batch["patches"], batch["inputs"])[0],
        prefill=lambda params, batch, cache_len: mm.vlm_prefill(
            module, params, batch["patches"], batch["inputs"], cache_len),
        decode=lambda params, cache, tokens: mm.vlm_decode_step(
            module, params, cache, tokens),
        init_cache=lambda batch, cache_len, *, device: tfm.init_cache(
            cfg, batch, cache_len, device=device
        ),
    )


def _build_audio(cfg: ModelConfig) -> Model:
    module = _meta_transformer(cfg)

    def loss(params, batch):
        h, aux = mm.audio_hidden(module, params, batch["inputs"])
        if cfg.ce_chunk_tokens:
            K = cfg.audio_codebooks
            ls, ces = [], []
            for k in range(K):
                lk, cek = chunked_lm_xent(h, params["codebook_head"][k],
                                          batch["targets"][..., k],
                                          chunk_tokens=cfg.ce_chunk_tokens)
                ls.append(lk)
                ces.append(cek)
            l, ce = sum(ls) / K, sum(ces) / K
        else:
            l, ce = softmax_xent(mm._audio_logits(cfg, params, h), batch["targets"])
        return l + aux, {"loss": l, "ce": ce, "aux": aux}

    return Model(
        cfg=cfg,
        init=lambda generator, device=None: mm.audio_init(cfg, generator, device),
        loss=loss,
        forward=lambda params, batch: mm.audio_forward(module, params, batch["inputs"])[0],
        prefill=lambda params, batch, cache_len: mm.audio_prefill(
            module, params, batch["inputs"], cache_len),
        decode=lambda params, cache, tokens: mm.audio_decode_step(
            module, params, cache, tokens),
        init_cache=lambda batch, cache_len, *, device: tfm.init_cache(
            cfg, batch, cache_len, device=device
        ),
    )


def build(cfg: ModelConfig) -> Model:
    if cfg.frontend == "vision":
        return _build_vlm(cfg)
    if cfg.frontend == "audio":
        return _build_audio(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return _build_ssm_or_hybrid(cfg)
    if cfg.family in ("dense", "moe"):
        return _build_dense_or_moe(cfg)
    raise ValueError(f"unknown family {cfg.family}")
