"""Hand-written CUDA kernels for causal GQA flash attention (sm_90a): the
forward and its backward.

The sources are ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (dq, dk, dv); their headers say which TPU
kernel each replaces (the backward: none), what bounds it and how it is
laid out. ``kernels/_build.py`` compiles each with ``nvcc`` on first use;
this module loads the shared libraries with ``ctypes`` and launches them on
PyTorch's current stream.

The dtype alone fixes the route (:func:`route`): bfloat16 and float16 run
on the tensor cores (``wgmma``, fed by TMA), float32 on the CUDA cores. A
call that its route cannot take raises ``ValueError``; nothing is re-routed.
:func:`launch_plan` holds the checks, as a pure function of dtype, shapes,
strides and data pointers, so they run without a card. q, k, v and the
output go in through their (b, h, s) strides with unit stride in the head
dim, so the model's transposed v view needs no copy.

The forward stores each row's softmax statistics m and l when asked
(``stats=True``); :func:`flash_attention_bwd` takes them with the forward's
output and the output's gradient, at every head dim and ``prefix_len``
the forward takes. Its route is fixed by dtype as well: bfloat16 and
float16 on the tensor cores (route ``"mma"``: ``wgmma``; three launches:
dq, dk and dv per q head into f32 partials, the sum over each kv head's
group), float32 on the CUDA cores (two launches); :func:`bwd_launch_plan`
holds its checks and :func:`bwd_scratch` its scratch.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SOURCE_BWD = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (32, 64, 128, 256)
_MAX_PREFIX = (1 << 31) - 1
ROUTES = {torch.float32: "simt", torch.bfloat16: "wgmma", torch.float16: "wgmma"}
BWD_ROUTES = {torch.float32: "simt", torch.bfloat16: "mma", torch.float16: "mma"}
_DTYPES = {torch.bfloat16: 1, torch.float16: 2}  # the tensor-core entry's codes
_BWD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_STRIDE_BYTES = 1 << 40  # TMA's limit on a tensor map's byte strides

_lib_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_thread = threading.local()  # this thread's launch counts (thread_counts)


def thread_counts() -> dict[str, int]:
    """The calling thread's launch counts, ``{"fwd", "bwd"}`` (a proxy
    session's own, in a daemon that serves several), or inside
    :func:`credit` the counts it was given."""
    owner = getattr(_thread, "owner", None)
    if owner is not None:
        return owner
    if not hasattr(_thread, "counts"):
        _thread.counts = {"fwd": 0, "bwd": 0}
    return _thread.counts


@contextlib.contextmanager
def credit(counts: dict[str, int]):
    """Count the calling thread's launches in ``counts`` (another thread's
    :func:`thread_counts`) inside the block. Autograd runs a CUDA backward,
    and the forward that remat recomputes in it, on its own thread for the
    device: ``ops.flash_attention`` and ``models.transformer`` credit those
    launches to the thread that ran the forward."""
    before = getattr(_thread, "owner", None)
    _thread.owner = counts
    try:
        yield
    finally:
        _thread.owner = before


def thread_launches() -> int:
    """The forward kernel's launches made for the calling thread so far."""
    return thread_counts()["fwd"]


def thread_bwd_launches() -> int:
    """The backward's calls made for the calling thread so far."""
    return thread_counts()["bwd"]


def build() -> Path:
    """Compile the forward's shared library (once per source/flags hash)."""
    return _build.build(SOURCE)


def build_bwd() -> Path:
    """Compile the backward's shared library (once per source/flags hash)."""
    return _build.build(SOURCE_BWD)


def _declare(lib: ctypes.CDLL, name: str) -> None:
    ptr, i64p, c_int, c_float = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_int, ctypes.c_float)
    if name == "fwd":
        lib.flash_attention_simt_launch.argtypes = [
            ptr, ptr, ptr, ptr, i64p,
            c_int, c_int, c_int, c_int, c_int, c_int, c_float, c_int, c_int, ptr, ptr, ptr,
        ]
        lib.flash_attention_simt_launch.restype = c_int
        lib.flash_attention_wgmma_launch.argtypes = [
            ptr, ptr, ptr, ptr, i64p, i64p,
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_float, c_int, c_int,
            ptr, ptr, ptr,
        ]
        lib.flash_attention_wgmma_launch.restype = c_int
        lib.flash_attention_error_string.argtypes = [c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    else:
        lib.flash_attention_bwd_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64p,
            c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_float, c_int, c_int, ptr,
        ]
        lib.flash_attention_bwd_launch.restype = c_int
        lib.flash_attention_bwd_error_string.argtypes = [c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p


def _load(name: str = "fwd") -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build() if name == "fwd" else build_bwd()))
            _declare(lib, name)
            _libs[name] = lib
        return _libs[name]


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


def launch_plan(dtype: torch.dtype, shapes, strides, data_ptrs, prefix_len: int = 0):
    """Route and layout of one call, from q, k, v's dtype, shapes, strides
    and data pointers and its ``prefix_len`` alone: ``(route, maps)``,
    where ``maps`` holds the tensor maps of q, k and v for the ``wgmma``
    route and is None for ``simt``. Raises ``ValueError`` on anything the
    route cannot take.
    """
    r = route(dtype)
    if not 0 <= int(prefix_len) <= _MAX_PREFIX:
        raise ValueError(f"flash_attention kernel takes a prefix_len in [0, 2**31), "
                         f"not {prefix_len}")
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
                    causal: bool = True, scale: float | None = None,
                    stats: bool = False, prefix_len: int = 0):
    """Causal GQA attention on the card. q: (B,Hq,Sq,D); k, v: (B,Hkv,Sk,D).

    Returns (B, Hq, Sq, D) in q's dtype, equal within rounding to
    ``kernels.ref.flash_attention_plain``; with ``stats`` it returns
    ``(out, m, l)``, m and l the rows' softmax statistics as (B, Hq, Sq)
    f32 (what the backward takes). With ``prefix_len`` > 0 the first
    ``prefix_len`` keys are open to every row (the prefix-LM mask; causal
    calls only). Takes CUDA tensors of one dtype
    (float32, bfloat16 or float16) on one device, D in {32, 64, 128, 256},
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
                          [t.data_ptr() for t in ts], prefix_len)
    prefix = int(prefix_len) if causal else 0
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale_f = float(scale if scale is not None else 1.0 / np.sqrt(D))
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    stat_ptrs = (m.data_ptr() if stats else None, l.data_ptr() if stats else None)
    lib = _load()
    with torch.cuda.device(q.device):  # the launch's device, restored after
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if r == "wgmma":
            err = lib.flash_attention_wgmma_launch(
                *ptrs, (ctypes.c_int64 * 24)(*(x for mp in maps for x in mp)),
                (ctypes.c_int64 * 3)(*out.stride()[:3]),
                B, Hq, Hkv, Sq, Sk, D, _DTYPES[q.dtype], scale_f, int(causal), prefix,
                *stat_ptrs, stream)
        else:
            strides = (ctypes.c_int64 * 12)(*(s for t in (*ts, out) for s in t.stride()[:3]))
            err = lib.flash_attention_simt_launch(
                *ptrs, strides, B, Hq, Hkv, Sq, Sk, D, scale_f, int(causal), prefix,
                *stat_ptrs, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[r] += 1
    thread_counts()["fwd"] += 1
    return (out, m, l) if stats else out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}


def bwd_launch_plan(dtype: torch.dtype, shapes, strides, data_ptrs,
                    prefix_len: int = 0) -> str:
    """Route of one backward call, from q, k, v, o and dO's dtype, shapes,
    strides and data pointers and its ``prefix_len`` alone: ``"mma"``
    (bfloat16, float16) or ``"simt"`` (float32). The forward's checks on q,
    k, v and ``prefix_len`` (D in ``HEAD_DIMS``, a prefix in [0, 2**31)),
    plus: o and dO shaped like q, unit stride in the head dim, and on the
    tensor-core route rows that 16-byte loads can read (every operand's
    data pointer and the byte strides of its dims longer than 1 multiples
    of 16). Raises ``ValueError`` on anything the route cannot take."""
    if dtype not in BWD_ROUTES:
        raise ValueError(f"flash_attention backward kernel takes float32, bfloat16 "
                         f"or float16, not {dtype}")
    launch_plan(torch.float32, shapes[:3], strides[:3], data_ptrs[:3], prefix_len)
    qs = tuple(shapes[0])
    for name, shape in zip(("o", "dO"), shapes[3:]):
        if tuple(shape) != qs:
            raise ValueError(f"flash_attention backward: {name} {tuple(shape)} is not "
                             f"shaped like q {qs}")
    if any(st[3] != 1 for st in strides[3:]):
        raise ValueError("flash_attention kernel needs unit stride in the head dim")
    route_ = BWD_ROUTES[dtype]
    if route_ == "mma":
        itemsize = torch.empty((), dtype=dtype).element_size()
        for name, shape, st, ptr in zip(("q", "k", "v", "o", "dO"), shapes, strides,
                                        data_ptrs):
            tensor_map(name, tuple(shape), st, itemsize, ptr)  # raises where 16 B cannot read
    return route_


def check_stats(shape, m: torch.Tensor, l: torch.Tensor) -> None:
    """The row statistics the backward takes: contiguous float32 of
    ``shape`` (B, Hq, Sq) each; raises ``ValueError`` otherwise."""
    for name, st in (("m", m), ("l", l)):
        if st.dtype != torch.float32 or tuple(st.shape) != tuple(shape) \
                or not st.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be contiguous "
                             f"float32 {tuple(shape)}, not {st.dtype} {tuple(st.shape)}")


def bwd_scratch(dtype: torch.dtype, B: int, Hq: int, Hkv: int, Sq: int, Sk: int,
                D: int) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The f32 scratch one backward call allocates, ``{name: (shape,
    dtype)}``, in the order the kernel takes it. float32: ``delta`` (B, Hq,
    Sq), rowsum(dO * O). bfloat16 and float16: ``rows`` (3, B, Hq, Sq
    rounded up to 4: m in log base 2, 1 / l and Delta, so that every q
    tile's statistics are 16-byte copies), and ``dk_part``, ``dv_part``
    (B, Hq, Sk, D), each q head's unscaled dk and dv before the sum over
    its kv head's group (134 MB each at paligemma's training shape, q (2,
    8, 8192, 256))."""
    f32 = torch.float32
    if BWD_ROUTES[dtype] == "simt":
        return {"delta": ((B, Hq, Sq), f32)}
    part = ((B, Hq, Sk, D), f32)
    return {"rows": ((3, B, Hq, -(-Sq // 4) * 4), f32), "dk_part": part, "dv_part": part}


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None, prefix_len: int = 0):
    """Gradients of :func:`flash_attention` on the card: ``(dq, dk, dv)``.

    q, k, v and the forward's output ``o`` with its row statistics ``m``,
    ``l`` (``flash_attention(..., stats=True)``), and ``do``, the output's
    gradient; ``prefix_len`` as the forward's (causal calls only). Returns
    contiguous dq (B, Hq, Sq, D) and dk, dv (B, Hkv, Sk, D) in their
    inputs' dtype, equal within rounding to
    ``kernels.ref.flash_attention_bwd_plain``, the same bits from run to run
    (no atomics; every sum in a fixed order). A ``do`` without unit stride
    in the head dim is copied first; everything else the kernel cannot take
    raises. Each call launches its kernels in order (bfloat16, float16: dq
    with Delta = rowsum(dO * O), dk and dv per q head, their sum over each
    group; float32: dq and Delta, then dk and dv)
    on the scratch of :func:`bwd_scratch`: ``flash_attention_bwd.launches``
    counts calls, ``launches_by_route`` calls per route, and
    :func:`thread_bwd_launches` the calling thread's.
    """
    if do.dim() == 4 and do.stride(3) != 1:
        do = do.contiguous()
    ts = (q, k, v, o, do)
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in (*ts, m, l)):
        raise ValueError("flash_attention backward kernel needs CUDA tensors")
    if len({t.device for t in (*ts, m, l)}) != 1 or len({t.dtype for t in ts}) != 1:
        raise ValueError("flash_attention backward kernel needs q, k, v, o, dO on one "
                         "device with one dtype")
    prefix = int(prefix_len) if causal else 0
    r = bwd_launch_plan(q.dtype, [t.shape for t in ts], [t.stride() for t in ts],
                        [t.data_ptr() for t in ts], prefix)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    check_stats((B, Hq, Sq), m, l)
    scale_f = float(scale if scale is not None else 1.0 / np.sqrt(D))
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Sk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    scratch = [torch.empty(shape, dtype=dt, device=q.device)
               for shape, dt in bwd_scratch(q.dtype, B, Hq, Hkv, Sq, Sk, D).values()]
    parts = [t.data_ptr() for t in scratch[1:]] or [None, None]  # f32: no partials
    lib = _load("bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        strides = (ctypes.c_int64 * 15)(*(s for t in ts for s in t.stride()[:3]))
        err = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in (*ts, m, l, scratch[0], dq, dk, dv)), *parts, strides,
            B, Hq, Hkv, Sq, Sk, D, _BWD_DTYPES[q.dtype], scale_f, int(causal), prefix,
            stream)
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention backward launch failed: {msg} ({err})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[r] += 1
    thread_counts()["bwd"] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"mma": 0, "simt": 0}
