"""Hand-written CUDA kernel for forward causal GQA flash attention (sm_90a).

The source is ``csrc/flash_attention.cu``; its header says which TPU kernel
it replaces, what bounds it and how it is laid out. ``kernels/_build.py``
compiles it with ``nvcc`` on first use; this module loads the shared
library with ``ctypes`` and launches it on PyTorch's current stream.

The dtype alone fixes the route (:func:`route`): bfloat16 and float16 run
on the tensor cores (``wgmma``, fed by TMA), float32 on the CUDA cores. A
call that its route cannot take raises ``ValueError``; nothing is re-routed.
:func:`launch_plan` holds the checks, as a pure function of dtype, shapes,
strides and data pointers, so they run without a card. q, k, v and the
output go in through their (b, h, s) strides with unit stride in the head
dim, so the model's transposed v view needs no copy.
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
ROUTES = {torch.float32: "simt", torch.bfloat16: "wgmma", torch.float16: "wgmma"}
_DTYPES = {torch.bfloat16: 1, torch.float16: 2}  # the tensor-core entry's codes
_MAX_STRIDE_BYTES = 1 << 40  # TMA's limit on a tensor map's byte strides

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_thread = threading.local()  # this thread's launches (thread_launches)


def thread_launches() -> int:
    """The kernel's launches made by the calling thread so far (a proxy
    session's own, in a daemon that serves several)."""
    return getattr(_thread, "launches", 0)


def build() -> Path:
    """Compile the kernel's shared library (once per source/flags hash)."""
    return _build.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i64p, c_int = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int
            lib.flash_attention_simt_launch.argtypes = [
                ptr, ptr, ptr, ptr, i64p,
                c_int, c_int, c_int, c_int, c_int, c_int, ctypes.c_float, c_int, ptr,
            ]
            lib.flash_attention_simt_launch.restype = c_int
            lib.flash_attention_wgmma_launch.argtypes = [
                ptr, ptr, ptr, ptr, i64p, i64p,
                c_int, c_int, c_int, c_int, c_int, c_int, c_int, ctypes.c_float, c_int, ptr,
            ]
            lib.flash_attention_wgmma_launch.restype = c_int
            lib.flash_attention_error_string.argtypes = [c_int]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def route(dtype: torch.dtype) -> str:
    """The kernel a dtype runs on: ``"wgmma"`` or ``"simt"``."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention kernel takes float32, bfloat16 or "
                         f"float16, not {dtype}")
    return ROUTES[dtype]


def tensor_map(name: str, shape, strides, itemsize: int, data_ptr: int) -> tuple[int, ...]:
    """The 4-D TMA tensor map of one (B, H, S, D) operand, as 8 integers.

    Dims in the map's order (D, then S, H and B by ascending byte stride),
    the byte strides of map dims 1..3, and the map slots of S and H packed
    as ``S | H << 2``. A dim of size 1 is never stepped, so its stride is
    set past the others. Raises ``ValueError`` where TMA cannot read the
    tensor: a base pointer not 16-byte aligned, or a stride of a dim longer
    than 1 that is not a positive multiple of 16 bytes below 2**40.
    """
    B, H, S, D = shape
    if data_ptr % 16:
        raise ValueError(f"flash_attention tensor-core kernel: {name}'s data pointer "
                         f"is not 16-byte aligned")
    outer = {"s": (S, strides[2] * itemsize), "h": (H, strides[1] * itemsize),
             "b": (B, strides[0] * itemsize)}
    for dim, (n, st) in outer.items():
        if n > 1 and not (0 < st < _MAX_STRIDE_BYTES and st % 16 == 0):
            raise ValueError(f"flash_attention tensor-core kernel: {name}'s {dim} stride "
                             f"of {st} bytes is not a positive multiple of 16 bytes "
                             f"below 2**40")
    past = max([D * itemsize] + [n * st for n, st in outer.values() if n > 1])
    past = -(-past // 16) * 16
    order = sorted(outer, key=lambda dim: outer[dim][1] if outer[dim][0] > 1 else past)
    dims = [D] + [outer[dim][0] for dim in order]
    byte_strides = [outer[dim][1] if outer[dim][0] > 1 else past for dim in order]
    slots = (1 + order.index("s")) | (1 + order.index("h")) << 2
    return (*dims, *byte_strides, slots)


def launch_plan(dtype: torch.dtype, shapes, strides, data_ptrs):
    """Route and layout of one call, from q, k, v's dtype, shapes, strides
    and data pointers alone: ``(route, maps)``, where ``maps`` holds the
    tensor maps of q, k and v for the ``wgmma`` route and is None for
    ``simt``. Raises ``ValueError`` on anything the route cannot take.
    """
    r = route(dtype)
    qs, ks, vs = (tuple(s) for s in shapes)
    if len(qs) != 4 or len(ks) != 4 or ks != vs:
        raise ValueError(f"flash_attention kernel needs q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D); got {qs}, {ks}, {vs}")
    B, Hq, Sq, D = qs
    Hkv, Sk = ks[1], ks[2]
    if ks[0] != B or ks[3] != D:
        raise ValueError(f"q {qs} and k {ks} disagree on batch or head dim")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim D in "
                         f"{HEAD_DIMS}, not {D}")
    if min(B, Hq, Sq, Sk) == 0:
        raise ValueError(f"flash_attention kernel needs non-empty inputs; got "
                         f"{qs}, {ks}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"flash_attention kernel takes at most 65535 batches "
                         f"and heads; got B={B}, Hq={Hq}")
    if any(st[3] != 1 for st in strides):
        raise ValueError("flash_attention kernel needs unit stride in the head dim")
    if r == "simt":
        return r, None
    itemsize = torch.empty((), dtype=dtype).element_size()
    return r, [tensor_map(name, shape, st, itemsize, ptr)
               for name, shape, st, ptr in zip("qkv", (qs, ks, vs), strides, data_ptrs)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Causal GQA attention on the card. q: (B,Hq,Sq,D); k, v: (B,Hkv,Sk,D).

    Returns (B, Hq, Sq, D) in q's dtype, equal within rounding to
    ``kernels.ref.flash_attention_plain``. Takes CUDA tensors of one dtype
    (float32, bfloat16 or float16) on one device, D in {32, 64, 128},
    unit stride in D and, for bfloat16 and float16, the layout TMA reads
    (:func:`tensor_map`); raises on anything else. Its own tiling needs no
    divisibility of Sq or Sk. ``flash_attention.launches`` counts launches,
    ``flash_attention.launches_by_route`` counts them per route and
    :func:`thread_launches` the calling thread's.
    """
    ts = (q, k, v)
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda" for t in ts):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if len({t.device for t in ts}) != 1 or len({t.dtype for t in ts}) != 1:
        raise ValueError("flash_attention kernel needs q, k, v on one device "
                         "with one dtype")
    r, maps = launch_plan(q.dtype, [t.shape for t in ts], [t.stride() for t in ts],
                          [t.data_ptr() for t in ts])
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale_f = float(scale if scale is not None else 1.0 / np.sqrt(D))
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lib = _load()
    with torch.cuda.device(q.device):  # the launch's device, restored after
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if r == "wgmma":
            err = lib.flash_attention_wgmma_launch(
                *ptrs, (ctypes.c_int64 * 24)(*(x for m in maps for x in m)),
                (ctypes.c_int64 * 3)(*out.stride()[:3]),
                B, Hq, Hkv, Sq, Sk, D, _DTYPES[q.dtype], scale_f, int(causal), stream)
        else:
            strides = (ctypes.c_int64 * 12)(*(s for t in (*ts, out) for s in t.stride()[:3]))
            err = lib.flash_attention_simt_launch(
                *ptrs, strides, B, Hq, Hkv, Sq, Sk, D, scale_f, int(causal), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[r] += 1
    _thread.launches = thread_launches() + 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
