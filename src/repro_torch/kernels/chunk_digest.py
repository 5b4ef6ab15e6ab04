"""Hand-written CUDA kernel for per-chunk content digests (Hopper, sm_90a).

The source is ``csrc/chunk_digest.cu``; its header says which TPU kernel it
replaces, what bounds it and how it is laid out. ``kernels/_build.py``
compiles it with ``nvcc`` on first use; this module loads the shared
library with ``ctypes`` and launches it on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_digest.cu"

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile the kernel's shared library (once per source/flags hash)."""
    return _build.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.chunk_digest_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.chunk_digest_launch.restype = ctypes.c_int
            lib.chunk_digest_error_string.argtypes = [ctypes.c_int]
            lib.chunk_digest_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def chunk_digests(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """(n_chunks, 2) int64 ``[hi, lo]`` digests of a CUDA tensor's bytes.

    Equal, bit for bit, to ``kernels.ref.chunk_digests_plain``. Takes a
    contiguous, 4-byte-aligned CUDA tensor and raises on anything else. An
    empty tensor gets the one ``[0, 0]`` row of ``chunk_digest_np`` without
    a launch. ``chunk_digests.launches`` counts the launches.
    """
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("chunk_digest kernel needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("chunk_digest kernel needs a contiguous tensor")
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError("chunk_bytes must be a positive multiple of 4")
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return torch.zeros((1, 2), dtype=torch.int64, device=x.device)
    if x.data_ptr() % 4:
        raise ValueError("chunk_digest kernel needs a 4-byte-aligned tensor")
    n_chunks = -(-nbytes // chunk_bytes)
    # zeroed: the kernel folds every block's part (and SEED) into it
    out = torch.zeros((n_chunks, 2), dtype=torch.int64, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):  # the launch's device, restored after
        err = lib.chunk_digest_launch(
            x.data_ptr(), nbytes, chunk_bytes, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.chunk_digest_error_string(err).decode()
        raise RuntimeError(f"chunk_digest launch failed: {msg} ({err})")
    chunk_digests.launches += 1
    return out


chunk_digests.launches = 0
