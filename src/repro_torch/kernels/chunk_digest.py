"""Hand-written CUDA kernel for per-chunk content digests (Hopper, sm_90a).

The source is ``csrc/chunk_digest.cu``; its header says which TPU kernel it
replaces, what bounds it and how it is laid out. This module builds it with
``nvcc`` on first use (never at import: a machine without a card imports
this module too), loads the shared library with ``ctypes`` and launches it
on PyTorch's current stream.

The build lands in ``build/repro_torch/`` at the repository root, under a
name that carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_digest.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the chunk_digest "
                       "kernel cannot be built")


def build() -> Path:
    """Compile the kernel's shared library (once per source/flags hash)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libchunk_digest-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.chunk_digest_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.chunk_digest_launch(
        x.data_ptr(), nbytes, chunk_bytes, out.data_ptr(),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        stream,
    )
    if err != 0:
        msg = lib.chunk_digest_error_string(err).decode()
        raise RuntimeError(f"chunk_digest launch failed: {msg} ({err})")
    chunk_digests.launches += 1
    return out


chunk_digests.launches = 0
