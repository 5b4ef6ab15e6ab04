"""Shared neural-net layers (plain tensor functions).

Conventions, as in the reference's ``models/layers.py``:
  - activations (B, S, D); attention tensors (B, H, S, Dh);
  - weights are (in, out): ``x @ w``;
  - params bf16 (config.param_dtype), accumulation/normalization in f32;
  - attention has the reference's three lowerings: dense (short S),
    chunked (long S: blocked online softmax, which on the card is the
    hand-written flash kernel, its gradient the hand-written backward
    kernel) and decode (one query token against a cache).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's norm: RMSNorm(x * silu(z)), the gate in f32 rounded to x's
    dtype before the product."""
    return rmsnorm(x * F.silu(z.float()).to(x.dtype), w, eps)


# ---------------------------------------------------------------------------
# rotary embeddings (half-split convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim // 2, dtype=np.float32) * 2 / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # one host->device copy per table, not one (and a stream wait) per call
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, Dh); positions: (S,) or scalar broadcast over S."""
    dh = x.shape[-1]
    freqs = _rope_freqs_on(dh, theta, x.device)                      # (Dh/2,)
    angles = positions.float()[..., None] * freqs                   # (S, Dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_apply(wi: torch.Tensor, wo: torch.Tensor, wg: torch.Tensor | None,
              x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type in ("swiglu", "geglu"):
        act = F.silu if mlp_type == "swiglu" else (
            lambda t: F.gelu(t, approximate="tanh")
        )
        h = act(x @ wg) * (x @ wi)
        return h @ wo
    h = F.gelu(x @ wi, approximate="tanh")
    return h @ wo


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float,
                    prefix_len: int | None = None) -> torch.Tensor:
    """Materialized-scores path for short sequences. GQA without kv repeat.

    The causal mask is right-aligned (``col <= row + Sk - Sq``), and a
    ``prefix_len`` opens the first keys to every row (``col < prefix_len``:
    the prefix-LM's bidirectional prefix); masked logits are -1e30, as in
    the reference.
    """
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, Dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        cols = torch.arange(Sk, device=q.device)[None, :]
        ok = cols <= rows
        if prefix_len is not None:
            ok = ok | (cols < prefix_len)
        s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, Dh).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, scale: float, block_q: int,
                      block_k: int, prefix_len: int | None = None) -> torch.Tensor:
    """Long-S lowering: the reference's ``_chunked_attention`` (bounded
    memory, online softmax over key blocks, the same prefix-LM mask as
    :func:`dense_attention`), through ``ops.flash_attention``.

    On the CPU that is the blocked plain version and its plain backward; on
    the card the flash kernel and, when a gradient is taken, the backward
    kernel (neither ever gives way to the plain version).
    """
    return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k, prefix_len=prefix_len)


def multihead_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    prefix_len: int | None = None,
    scale: float | None = None,
    chunked_threshold: int = 4096,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    scale = float(scale if scale is not None else 1.0 / np.sqrt(q.shape[-1]))
    bq, bk = min(block_q, q.shape[2]), min(block_k, k.shape[2])
    if q.shape[2] >= chunked_threshold and q.shape[2] % bq == 0 and k.shape[2] % bk == 0:
        return chunked_attention(q, k, v, causal=causal, scale=scale,
                                 block_q=bq, block_k=bk, prefix_len=prefix_len)
    return dense_attention(q, k, v, causal=causal, scale=scale, prefix_len=prefix_len)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, *, scale: float | None = None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, Hq, 1, Dh); caches: (B, Hkv, S, Dh); pos: the index of the token
    being generated (attends to cache[: pos + 1]).
    """
    B, Hq, _, Dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(Dh))
    qg = q.reshape(B, Hkv, g, Dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float()) * scale
    ok = torch.arange(S, device=q.device) <= pos
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    # index_select: deterministic backward on CUDA
    flat = table.index_select(0, ids.reshape(-1).long())
    return flat.reshape(*ids.shape, table.shape[-1])


def logits_from_embed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (x @ table.t()).float()
