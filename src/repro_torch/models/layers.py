"""Shared neural-net layers (plain tensor functions).

Conventions, as in the reference's ``models/layers.py``:
  - activations (B, S, D); attention tensors (B, H, S, Dh);
  - weights are (in, out): ``x @ w``;
  - params bf16 (config.param_dtype), accumulation/normalization in f32;
  - attention here is the dense (materialized-scores) lowering for short
    sequences. The chunked flash-style lowering the reference uses at
    S >= ``attn_chunked_threshold`` is not ported yet, and asking for it
    raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (half-split convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim // 2, dtype=np.float32) * 2 / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, Dh); positions: (S,) or scalar broadcast over S."""
    dh = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(dh, theta)).to(x.device)   # (Dh/2,)
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
                    causal: bool, scale: float) -> torch.Tensor:
    """Materialized-scores path for short sequences. GQA without kv repeat.

    The causal mask is right-aligned (``col <= row + Sk - Sq``); masked
    logits are -1e30, as in the reference.
    """
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Sq, Dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, Dh).to(q.dtype)


def multihead_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    scale: float | None = None,
    chunked_threshold: int = 4096,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    scale = float(scale if scale is not None else 1.0 / np.sqrt(q.shape[-1]))
    if q.shape[2] >= chunked_threshold and q.shape[2] % min(block_q, q.shape[2]) == 0 \
            and k.shape[2] % min(block_k, k.shape[2]) == 0:
        raise NotImplementedError(
            f"S={q.shape[2]} >= attn_chunked_threshold={chunked_threshold}: "
            "chunked attention is not ported to PyTorch yet"
        )
    return dense_attention(q, k, v, causal=causal, scale=scale)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    # index_select: deterministic backward on CUDA
    flat = table.index_select(0, ids.reshape(-1).long())
    return flat.reshape(*ids.shape, table.shape[-1])


def logits_from_embed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (x @ table.t()).float()
