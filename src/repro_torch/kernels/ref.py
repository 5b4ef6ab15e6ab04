"""Plain PyTorch versions of the hand-written kernels.

Each kernel in this package must agree with its plain version bit for bit
(digests). The plain versions run on any device; on the CPU they are what
the kernel wrappers use, and on the card ``chip_smoke.py`` holds each kernel
against them.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.chunking import num_chunks
from repro_torch.utils.dtypes import byte_view

DIGEST_PRIME = 16777619
DIGEST_SEED = 2166136261
_M32 = 0xFFFFFFFF
# words per batch of chunks: bounds the int64 temporaries (~8 x 128 MiB)
_BATCH_WORDS = 1 << 24


def _words_i64(b: torch.Tensor) -> torch.Tensor:
    """Little-endian u32 words of a byte tensor, as int64 in [0, 2**32).

    Torch has no u32 arithmetic on the CPU, so the digest runs in int64;
    a last partial word is zero-filled, as ``chunk_digest_np`` pads it.
    """
    nbytes = b.numel()
    full = nbytes // 4
    if b.storage_offset() % 4:
        b = b.clone()  # a u32 view needs a 4-byte-aligned start
    words = b[: full * 4].view(torch.int32).to(torch.int64) & _M32
    tail = nbytes - full * 4
    if tail:
        last = b[full * 4 :].to(torch.int64)
        shifts = torch.arange(tail, device=b.device, dtype=torch.int64) * 8
        words = torch.cat([words, (last << shifts).sum().reshape(1)])
    return words


def _xor_fold(t: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last dim (torch has no xor reduction): pairwise fold."""
    while t.shape[-1] > 1:
        if t.shape[-1] % 2:
            t = torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
        t = t[..., 0::2] ^ t[..., 1::2]
    return t[..., 0]


def chunk_digests_plain(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """(n_chunks, 2) int64 ``[hi, lo]`` digests of a tensor's byte stream.

    Per chunk, with 1-based word index i within the chunk:

        hi = SEED ^ xor_i(w_i * ((i << 1) | 1))   (mod 2**32)
        lo = sum_i(w_i ^ (i * PRIME))             (mod 2**32)

    Bit-identical to ``checkpoint.chunking.chunk_digest_np`` over the same
    chunk bytes, including its digest 0 (``[0, 0]``) for an empty leaf.
    A u32 product overflows int64, so ``w * m mod 2**32`` is formed from
    the 16-bit halves of ``w``.
    """
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError("chunk_bytes must be a positive multiple of 4")
    b = byte_view(x)
    dev = b.device
    nbytes = b.numel()
    n = num_chunks(nbytes, chunk_bytes)
    if nbytes == 0:
        return torch.zeros((1, 2), dtype=torch.int64, device=dev)
    words = _words_i64(b)
    total = words.numel()
    cw = chunk_bytes // 4
    width = min(cw, total)  # a leaf smaller than one chunk needs no padding
    idx = torch.arange(1, width + 1, device=dev, dtype=torch.int64)
    lo_mix = (idx * DIGEST_PRIME) & _M32
    hi_mul = ((idx << 1) | 1) & _M32
    out = torch.empty((n, 2), dtype=torch.int64, device=dev)
    rows = max(1, _BATCH_WORDS // width)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        w = words[r0 * cw : min(total, r1 * cw)]
        pad = (r1 - r0) * width - w.numel()
        if pad:
            w = torch.cat([w, w.new_zeros(pad)])
        w = w.reshape(r1 - r0, width)
        # real words per chunk: padding words are masked out of both mixes
        starts = torch.arange(r0, r1, device=dev, dtype=torch.int64) * cw
        real = (total - starts).clamp(0, cw)
        mask = idx[None, :] <= real[:, None]
        lo = torch.where(mask, w ^ lo_mix, 0).sum(dim=1) & _M32
        prod = ((w & 0xFFFF) * hi_mul
                + ((((w >> 16) * hi_mul) & 0xFFFF) << 16)) & _M32
        hi = _xor_fold(torch.where(mask, prod, 0)) ^ DIGEST_SEED
        out[r0:r1, 0] = hi
        out[r0:r1, 1] = lo
    return out
