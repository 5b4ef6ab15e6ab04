"""Dispatch for the kernels package.

A tensor on the CPU goes to the kernel's plain PyTorch version (the
digests that cross to the host, ``host_chunk_digests``, take the numpy
oracle there); a CUDA tensor goes to the hand-written kernel, and if the
kernel cannot run the call raises — it never falls back to the plain
version or to the host. ``flash_attention`` is differentiable: its gradient
is the backward kernel on the card and the backward's plain version on the
CPU.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.chunking import chunk_digest_np, num_chunks
from repro_torch.kernels import chunk_digest as _kernel
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.utils.dtypes import byte_view
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the digest kernel takes it: contiguous and 4-byte aligned.

    A view that is neither (a window of a 16-bit leaf starting at an odd
    element, a transposed view) is copied into a fresh allocation first —
    the bytes, and so the digests, are the same."""
    if x.is_contiguous() and x.data_ptr() % 4 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def chunk_digests(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Per-chunk digests of a tensor's byte stream -> (n_chunks, 2) int64.

    Columns are ``[hi, lo]``, each in [0, 2**32). Bit-identical to
    ``checkpoint.chunking.chunk_digest_np`` over the same chunk bytes (the
    shadow manager compares them directly).
    """
    if x.device.type == "cpu":
        return _ref.chunk_digests_plain(x, chunk_bytes)
    if x.device.type == "cuda":
        return _kernel.chunk_digests(_kernel_ready(x), chunk_bytes)
    raise ValueError(f"no chunk_digest kernel for device {x.device}")


def chunk_digest_table(xs: Sequence[torch.Tensor],
                       chunk_bytes: int) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Digests of many tensors of one device in one ``(rows, 2)`` table.

    Returns ``(table, bounds)``; tensor k's rows are ``bounds[k]:bounds[k + 1]``.
    On the CPU each tensor goes through the plain version; on the card all
    of them go through one grouped kernel call (one launch per
    ``chunk_digest.CAPACITY`` non-empty tensors).
    """
    devices = {x.device for x in xs}
    if len(devices) > 1:
        raise ValueError(f"chunk_digest_table needs tensors on one device, got {devices}")
    device = devices.pop() if devices else torch.device("cpu")
    if device.type == "cpu":
        parts = [_ref.chunk_digests_plain(x, chunk_bytes) for x in xs]
        bounds = np.cumsum([0] + [p.shape[0] for p in parts]).tolist()
        table = torch.cat(parts) if parts else torch.zeros((0, 2), dtype=torch.int64)
        return table, tuple(bounds)
    if device.type == "cuda":
        return _kernel.chunk_digest_table([_kernel_ready(x) for x in xs], chunk_bytes)
    raise ValueError(f"no chunk_digest kernel for device {device}")


def digests_to_u64(d: torch.Tensor | np.ndarray) -> np.ndarray:
    """(n, 2) ``[hi, lo]`` -> (n,) u64 digests on the host."""
    if isinstance(d, torch.Tensor):
        d = d.cpu().numpy()
    d = np.asarray(d).astype(np.uint64)
    return (d[:, 0] << np.uint64(32)) | d[:, 1]


def _np_chunk_digests(raw: np.ndarray, chunk_bytes: int) -> list[int]:
    """Per-chunk u64 digests of host bytes with the numpy oracle."""
    cb = int(chunk_bytes)
    return [chunk_digest_np(raw[i * cb : min(raw.nbytes, (i + 1) * cb)])
            for i in range(num_chunks(raw.nbytes, cb))]


def host_chunk_digests(xs: Sequence[torch.Tensor], chunk_bytes: int) -> list[list[int]]:
    """Per-chunk u64 digests of many tensors, on the host, in their order.

    CPU tensors hash with ``chunk_digest_np`` over a zero-copy byte view
    (the host oracle: the same bits, several times faster than the plain
    torch version). Every other device takes one grouped call, whose table
    crosses to the host in one copy."""
    by_device: dict[torch.device, list[int]] = {}
    for k, x in enumerate(xs):
        by_device.setdefault(x.device, []).append(k)
    out: list[list[int]] = [[] for _ in xs]
    for device, ks in by_device.items():
        if device.type == "cpu":
            for k in ks:
                out[k] = _np_chunk_digests(byte_view(xs[k]).numpy(), chunk_bytes)
            continue
        table, b = chunk_digest_table([xs[k] for k in ks], chunk_bytes)
        d = digests_to_u64(table).tolist()
        for j, k in enumerate(ks):
            out[k] = d[b[j] : b[j + 1]]
    return out


def tree_chunk_digests(state: Any, chunk_bytes: int) -> dict[str, list[int]]:
    """Per-chunk u64 digests of every leaf: {path: [digest, ...]}.

    Tensor leaves go through :func:`host_chunk_digests` (card tensors: one
    grouped kernel call and one copy of its table to the host); host leaves
    hash with the bit-identical numpy oracle.
    """
    flat, _ = flatten_with_paths(state)
    tensors = {p: leaf for p, leaf in flat.items() if isinstance(leaf, torch.Tensor)}
    digests = dict(zip(tensors, host_chunk_digests(list(tensors.values()), chunk_bytes)))
    return {path: digests[path] if path in digests
            else _np_chunk_digests(leaf_bytes(leaf), chunk_bytes)
            for path, leaf in flat.items()}


class _FlashAttention(torch.autograd.Function):
    """The forward with its row statistics, saved with q, k, v and the
    output for the backward: the kernels on the card, the plain versions
    (at the call's blocks) on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bq, bk, prefix):
        if q.device.type == "cpu":
            out, m, l = _ref.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                                   block_q=bq, block_k=bk,
                                                   return_stats=True, prefix_len=prefix)
        else:
            out, m, l = _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                               stats=True, prefix_len=prefix)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, scale, bq, bk, prefix)
        # the backward may run on autograd's own thread: credit this one's
        ctx.counts = _flash.thread_counts()
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, scale, bq, bk, prefix = ctx.args
        with _flash.credit(ctx.counts):
            if q.device.type == "cpu":
                grads = _ref.flash_attention_bwd_plain(q, k, v, out, m, l, do, causal=causal,
                                                       scale=scale, block_q=bq, block_k=bk,
                                                       prefix_len=prefix)
            else:
                grads = _flash.flash_attention_bwd(q, k, v, out, m, l, do, causal=causal,
                                                   scale=scale, prefix_len=prefix)
        return (*grads, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    block_q: int = 128,
    block_k: int = 128,
    prefix_len: int | None = None,
) -> torch.Tensor:
    """Causal GQA attention. q: (B,Hq,Sq,D); k,v: (B,Hkv,Sk,D).

    The reference's entry point and its checks: Hq must divide by Hkv, and
    Sq, Sk by ``min(block_q, Sq)``, ``min(block_k, Sk)``. ``prefix_len``
    opens keys ``col < prefix_len`` to every row (the prefix-LM mask of the
    reference's ``_chunked_attention``; None or 0: causal alone). On the
    CPU the plain version runs at those blocks; on the card the kernel,
    whose own tiling does not depend on them. Differentiable in q, k and v:
    when a gradient is being taken the forward also keeps its row
    statistics and the backward runs the backward kernel (card) or its
    plain version (CPU); otherwise the forward alone runs, with no
    statistics. Both kernels take every head dim in
    ``flash_attention.HEAD_DIMS`` with or without a prefix.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"seq lengths ({Sq},{Sk}) not divisible by blocks ({bq},{bk})")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    prefix = int(prefix_len or 0) if causal else 0  # the mask widens the causal one
    if prefix < 0:
        raise ValueError(f"prefix_len must be >= 0, not {prefix_len}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, bq, bk, prefix)
    if q.device.type == "cpu":
        return _ref.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                          block_q=bq, block_k=bk, prefix_len=prefix)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale, prefix_len=prefix)
