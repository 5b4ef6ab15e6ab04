"""Chunking + digests — the device-memory analogue of CRUM's UVM pages.

A leaf array's bytes are split into fixed-size chunks addressed by
``ChunkKey(path, index)`` with a global byte range. Chunks are the unit of

  - dirty tracking (digest diff — Algorithm 1's page-granularity, scaled to
    DMA-friendly sizes),
  - parallel compression (the pgzip / writer-pool unit),
  - sharded + elastic restore (chunks intersect shard index ranges).

The digest is a 64-bit FNV-1a-style rolling hash computed with numpy (host
side) or the ``chunk_digest`` CUDA kernel (device side); both produce the
same value for the same bytes, so device-computed digests can be compared
against manifest digests written by the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

DEFAULT_CHUNK_BYTES = 4 << 20  # 4 MiB — bulk-DMA friendly; ~1000 pages worth

# Digest constants shared with kernels/csrc/chunk_digest.cu: a blocked sum/xor
# mix over u32 words: only 32-bit wrapping adds, multiplies and xors, so a
# device kernel needs no 64-bit arithmetic.
_DIGEST_PRIME = np.uint32(16777619)
_DIGEST_SEED = np.uint32(2166136261)


@dataclass(frozen=True, order=True)
class ChunkKey:
    path: str
    index: int

    def render(self) -> str:
        return f"{self.path}#{self.index}"


def _as_u32_words(buf: np.ndarray) -> np.ndarray:
    """View arbitrary bytes as u32 words, zero-padding the tail."""
    b = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    pad = (-len(b)) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, np.uint8)])
    return b.view(np.uint32)


def chunk_digest_np(data: bytes | np.ndarray) -> int:
    """Reference digest for one chunk (matches the chunk_digest kernel).

    Two 32-bit mixes over u32 words, both expressible with wrapping u32
    adds/muls/xors (vector-lane friendly; no 64-bit arithmetic on device):

        lo = sum_i  (w_i XOR (i * PRIME))          (wrapping add, i from 1)
        hi = xor_i  (w_i * ((i << 1) | 1))         (wrapping mul by odd)

    Zero-padding can be masked out exactly on device (a padded word with
    w=0 at masked position contributes nothing once masked), so host bytes
    and device padded-tile computations agree bit-for-bit. Order-sensitive
    (catches permutations) and cheap enough to run every sync.
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(bytes(data), np.uint8)
    else:
        arr = np.asarray(data)
    words = _as_u32_words(arr)
    if words.size == 0:
        return 0
    idx = np.arange(1, words.size + 1, dtype=np.uint32)
    with np.errstate(over="ignore"):
        lo = np.uint64(
            int((words ^ (idx * _DIGEST_PRIME)).sum(dtype=np.uint64)) & 0xFFFFFFFF
        )
        hi = np.uint64(
            int(np.bitwise_xor.reduce(words * ((idx << np.uint32(1)) | np.uint32(1))))
            ^ int(_DIGEST_SEED)
        )
    return int((hi << np.uint64(32)) | lo)


def split_into_chunks(
    path: str, arr: np.ndarray, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> list[tuple["ChunkKey", bytes]]:
    """Split a host array into (key, raw_bytes) chunks."""
    return list(iter_chunks(path, arr, chunk_bytes))


def iter_chunks(
    path: str, arr: np.ndarray, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> Iterator[tuple["ChunkKey", bytes]]:
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    n = max(1, int(np.ceil(raw.nbytes / chunk_bytes))) if raw.nbytes else 1
    for i in range(n):
        lo = i * chunk_bytes
        hi = min(raw.nbytes, lo + chunk_bytes)
        yield ChunkKey(path, i), raw[lo:hi].tobytes()


def num_chunks(nbytes: int, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    return max(1, int(np.ceil(nbytes / chunk_bytes))) if nbytes else 1


def join_chunks(
    chunks: list[bytes], shape: tuple[int, ...], dtype: np.dtype
) -> np.ndarray:
    """Reassemble raw chunk bytes into an array of the given shape/dtype."""
    buf = b"".join(chunks)
    expected = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    if len(buf) != expected:
        raise ValueError(
            f"chunk bytes {len(buf)} != expected {expected} for {shape} {dtype}"
        )
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
