"""Hand-written CUDA kernel for forward causal GQA flash attention (sm_90a).

The source is ``csrc/flash_attention.cu``; its header says which TPU kernel
it replaces, what bounds it and how it is laid out. ``kernels/_build.py``
compiles it with ``nvcc`` on first use; this module loads the shared
library with ``ctypes`` and launches it on PyTorch's current stream.

q, k, v and the output are read through their (b, h, s) strides with unit
stride in the head dim, so the model's transposed v view goes in without a
copy; a tensor whose last dim is not contiguous is refused.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

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
            lib.flash_attention_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.flash_attention_launch.restype = ctypes.c_int
            lib.flash_attention_error_string.argtypes = [ctypes.c_int]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention on the card. q: (B,Hq,Sq,D); k, v: (B,Hkv,Sk,D).

    Returns (B, Hq, Sq, D) in q's dtype, equal within rounding to
    ``kernels.ref.flash_attention_plain``. Takes CUDA tensors of one dtype
    (float32, bfloat16 or float16) on one device, D in {32, 64, 128},
    unit stride in D, and raises on anything else. Its own tiling needs no
    divisibility of Sq or Sk. ``flash_attention.launches`` counts launches.
    """
    ts = (q, k, v)
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in ts):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if len({t.device for t in ts}) != 1 or len({t.dtype for t in ts}) != 1:
        raise ValueError("flash_attention kernel needs q, k, v on one device "
                         "with one dtype")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32, bfloat16 or "
                         f"float16, not {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel needs q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim D in "
                         f"{HEAD_DIMS}, not {D}")
    if min(B, Hq, Sq, Sk) == 0:
        raise ValueError(f"flash_attention kernel needs non-empty inputs; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention kernel takes at most 65535 batches "
                         f"and heads; got B={B}, Hq={Hq}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention kernel needs unit stride in the head dim")
    scale_f = float(scale if scale is not None else 1.0 / np.sqrt(D))
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _load()
    with torch.cuda.device(q.device):  # the launch's device, restored after
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, Hq, Hkv, Sq, Sk, D, _DTYPES[q.dtype], scale_f, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
