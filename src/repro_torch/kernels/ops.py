"""Dispatch for the kernels package.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the hand-written kernel, and if the kernel cannot run the
call raises — it never falls back to the plain version or to the host.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.chunking import chunk_digest_np, num_chunks
from repro_torch.kernels import chunk_digest as _kernel
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes


def chunk_digests(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Per-chunk digests of a tensor's byte stream -> (n_chunks, 2) int64.

    Columns are ``[hi, lo]``, each in [0, 2**32). Bit-identical to
    ``checkpoint.chunking.chunk_digest_np`` over the same chunk bytes (the
    shadow manager compares them directly).
    """
    if x.device.type == "cpu":
        return _ref.chunk_digests_plain(x, chunk_bytes)
    if x.device.type == "cuda":
        return _kernel.chunk_digests(x.contiguous(), chunk_bytes)
    raise ValueError(f"no chunk_digest kernel for device {x.device}")


def digests_to_u64(d: torch.Tensor | np.ndarray) -> np.ndarray:
    """(n, 2) ``[hi, lo]`` -> (n,) u64 digests on the host."""
    if isinstance(d, torch.Tensor):
        d = d.cpu().numpy()
    d = np.asarray(d).astype(np.uint64)
    return (d[:, 0] << np.uint64(32)) | d[:, 1]


def tree_chunk_digests(state: Any, chunk_bytes: int) -> dict[str, list[int]]:
    """Per-chunk u64 digests of every leaf: {path: [digest, ...]}.

    Tensor leaves go through :func:`chunk_digests` (the kernel on the card,
    the plain version on the CPU); host leaves hash with the bit-identical
    numpy reference.
    """
    flat, _ = flatten_with_paths(state)
    out: dict[str, list[int]] = {}
    for path, leaf in flat.items():
        if isinstance(leaf, torch.Tensor):
            d = digests_to_u64(chunk_digests(leaf, chunk_bytes))
            out[path] = [int(x) for x in d]
            continue
        raw = leaf_bytes(leaf)
        cb = int(chunk_bytes)
        out[path] = [
            chunk_digest_np(raw[i * cb : min(raw.nbytes, (i + 1) * cb)])
            for i in range(num_chunks(raw.nbytes, cb))
        ]
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Causal GQA attention. q: (B,Hq,Sq,D); k,v: (B,Hkv,Sk,D).

    The reference's entry point and its checks: Hq must divide by Hkv, and
    Sq, Sk by ``min(block_q, Sq)``, ``min(block_k, Sk)``. On the CPU the
    plain version runs at those blocks; on the card the kernel, whose own
    tiling does not depend on them.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"seq lengths ({Sq},{Sk}) not divisible by blocks ({bq},{bk})")
    if q.device.type == "cpu":
        return _ref.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                          block_q=bq, block_k=bk)
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash_attention kernel for device {q.device}")
