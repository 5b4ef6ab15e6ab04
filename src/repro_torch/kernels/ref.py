"""Plain PyTorch versions of the hand-written kernels.

Each kernel in this package must agree with its plain version bit for bit
(digests) or to numerical tolerance (attention). The plain versions run on
any device; on the CPU they are what the kernel wrappers use, and on the
card ``chip_smoke.py`` holds each kernel against them.
"""
from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

_MASKED = -1e30


def _blocks(q: torch.Tensor, k: torch.Tensor, block_q: int, block_k: int):
    """(g, bq, bk) of a blocked attention call, with the reference's checks."""
    Hq, Sq = q.shape[1], q.shape[2]
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"seq lengths ({Sq},{Sk}) not divisible by blocks ({bq},{bk})")
    return Hq // Hkv, bq, bk


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 arithmetic, f64 for f64 inputs (gradcheck's)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: float | None = None,
    block_q: int = 128, block_k: int = 128, return_stats: bool = False,
):
    """Blocked online-softmax attention, the math of the flash kernel.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); kv head = h // (Hq // Hkv).
    The same steps as the reference's ``_flash_kernel`` and
    ``_chunked_attention``, in f32: scale, then the right-aligned causal mask
    (``col <= row + Sk - Sq``) with -1e30, never -inf; ``m``, ``l`` and the
    accumulator carried over key blocks; ``l == 0 -> 1``; output in q's
    dtype. A row with no valid key comes out as the mean of v over all Sk.
    ``Sq`` and ``Sk`` must divide by ``min(block_q, Sq)``, ``min(block_k, Sk)``.
    With ``return_stats`` it returns ``(out, m, l)``: each row's max logit
    (-1e30 for a row with no key) and its ``l`` (after ``l == 0 -> 1``), as
    (B, Hq, Sq) f32, what the kernel stores for the backward.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g, bq, bk = _blocks(q, k, block_q, block_k)
    acc_t = _acc_dtype(q.dtype)
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))
    offset = Sk - Sq
    qg = q.reshape(B, Hkv, g, Sq, D)
    out = torch.empty((B, Hkv, g, Sq, D), dtype=q.dtype, device=q.device)
    m_all = torch.empty((B, Hkv, g, Sq, 1), dtype=acc_t, device=q.device)
    l_all = torch.empty_like(m_all)
    for q0 in range(0, Sq, bq):
        qi = qg[:, :, :, q0 : q0 + bq].to(acc_t)
        acc = torch.zeros((B, Hkv, g, bq, D), dtype=acc_t, device=q.device)
        m = torch.full((B, Hkv, g, bq, 1), _MASKED, dtype=acc_t, device=q.device)
        l = torch.zeros((B, Hkv, g, bq, 1), dtype=acc_t, device=q.device)
        for k0 in range(0, Sk, bk):
            kj = k[:, :, k0 : k0 + bk].to(acc_t)
            vj = v[:, :, k0 : k0 + bk].to(acc_t)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            if causal:
                rows = torch.arange(q0, q0 + bq, device=q.device)[:, None] + offset
                cols = torch.arange(k0, k0 + bk, device=q.device)[None, :]
                s = torch.where(cols <= rows, s, _MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, :, q0 : q0 + bq] = (acc / l).to(q.dtype)
        m_all[:, :, :, q0 : q0 + bq] = m
        l_all[:, :, :, q0 : q0 + bq] = l
    out = out.reshape(B, Hq, Sq, D)
    if not return_stats:
        return out
    return out, m_all.reshape(B, Hq, Sq), l_all.reshape(B, Hq, Sq)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    m: torch.Tensor, l: torch.Tensor, do: torch.Tensor, *,
    causal: bool = True, scale: float | None = None,
    block_q: int = 128, block_k: int = 128,
):
    """Gradients of :func:`flash_attention_plain`, the math of the backward
    kernel block by block: ``(dq, dk, dv)`` in their inputs' dtypes.

    Takes the forward's output ``o``, its row statistics ``m``, ``l``
    ((B, Hq, Sq)) and the output's gradient ``do``. In f32:
    ``Delta = rowsum(do * o)``; per (q block, key block) the masked logits
    (-1e30 where ``col > row + Sk - Sq``), ``P = exp(s - m) / l``,
    ``dP = do . v``, ``dS = P * (dP - Delta)`` set to 0 at masked positions
    (``torch.where`` passes no gradient to a masked logit, and a row with no
    key has ``P = 1 / Sk`` there); ``dv += P^T do``, ``dk += dS^T q``,
    ``dq += dS k``, the last two times ``scale``. dk and dv sum over the q
    heads of each kv head's group. A key block that every row of a q block
    masks, in a q block without rows that have no key, adds nothing and is
    skipped.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g, bq, bk = _blocks(q, k, block_q, block_k)
    acc_t = _acc_dtype(q.dtype)
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))
    offset = Sk - Sq
    shape5 = (B, Hkv, g, Sq)
    qg = q.reshape(*shape5, D)
    dog = do.reshape(*shape5, D).to(acc_t)
    delta = (dog * o.reshape(*shape5, D).to(acc_t)).sum(dim=-1, keepdim=True)
    mg = m.reshape(*shape5, 1).to(acc_t)
    lg = l.reshape(*shape5, 1).to(acc_t)
    dq = torch.zeros((*shape5, D), dtype=acc_t, device=q.device)
    dk = torch.zeros((B, Hkv, Sk, D), dtype=acc_t, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, bq):
        qi = qg[:, :, :, q0 : q0 + bq].to(acc_t)
        doi = dog[:, :, :, q0 : q0 + bq]
        mi, li, di = (t[:, :, :, q0 : q0 + bq] for t in (mg, lg, delta))
        for k0 in range(0, Sk, bk):
            if causal and q0 + offset >= 0 and k0 > q0 + bq - 1 + offset:
                continue
            kj = k[:, :, k0 : k0 + bk].to(acc_t)
            vj = v[:, :, k0 : k0 + bk].to(acc_t)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            if causal:
                rows = torch.arange(q0, q0 + bq, device=q.device)[:, None] + offset
                cols = torch.arange(k0, k0 + bk, device=q.device)[None, :]
                ok = cols <= rows
                s = torch.where(ok, s, _MASKED)
            p = torch.exp(s - mi) / li
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doi, vj)
            ds = p * (dp - di)
            if causal:
                ds = torch.where(ok, ds, 0.0)
            dv[:, :, k0 : k0 + bk] += torch.einsum("bhgqk,bhgqd->bhkd", p, doi)
            dk[:, :, k0 : k0 + bk] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qi)
            dq[:, :, :, q0 : q0 + bq] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kj)
    return ((dq * scale).reshape(B, Hq, Sq, D).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, scale: float | None = None,
) -> torch.Tensor:
    """Dense softmax attention oracle (the reference's ``mha_reference``).

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA).
    Returns (B, Hq, Sq, D) in q's dtype; softmax in f32. Masks with -inf,
    so a row with no valid key is NaN here (the flash kernel's is not).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(D))
    kq = k.repeat_interleave(group, dim=1)
    vq = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vq.float())
    return out.to(q.dtype)
