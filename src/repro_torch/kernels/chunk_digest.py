"""Hand-written CUDA kernel for per-chunk content digests (Hopper, sm_90a).

The source is ``csrc/chunk_digest.cu``; its header says which TPU kernel it
replaces, what bounds it and how it is laid out. ``kernels/_build.py``
compiles it with ``nvcc`` on first use; this module loads the shared
library with ``ctypes`` and launches it on PyTorch's current stream.

One launch digests up to :data:`CAPACITY` leaves into one zeroed table.
:func:`launch_plan` is the pure-Python account of what each launch does —
each leaf's rows, the groups of leaves per launch and every work unit's
byte range and load split — so the CPU tests check the split without a
card; the kernel computes the same split from the same formulas.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Sequence

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunk_digest.cu"
CAPACITY = 120         # leaves per launch: the source's kCapacity
UNIT_BYTES = 64 << 10  # bytes of one chunk per work unit: the source's kUnitBytes

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_thread = threading.local()  # this thread's launches (thread_launches)


def thread_launches() -> int:
    """The kernel's launches made by the calling thread so far: a proxy
    session counts its own steps' launches by it while other sessions of
    the same daemon launch on their threads."""
    return getattr(_thread, "launches", 0)


def _count(n: int) -> None:
    """Count ``n`` launches just made, in all and in the calling thread."""
    chunk_digests.launches += n
    _thread.launches = thread_launches() + n


def build() -> Path:
    """Compile the kernel's shared library (once per source/flags hash)."""
    return _build.build(SOURCE)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.chunk_digest_launch.argtypes = [
                ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.chunk_digest_launch.restype = ctypes.c_int
            lib.chunk_digest_capacity.restype = ctypes.c_int
            lib.chunk_digest_unit_bytes.restype = ctypes.c_int64
            lib.chunk_digest_error_string.argtypes = [ctypes.c_int]
            lib.chunk_digest_error_string.restype = ctypes.c_char_p
            if (lib.chunk_digest_capacity(), lib.chunk_digest_unit_bytes()) != (CAPACITY, UNIT_BYTES):
                raise RuntimeError(f"{SOURCE.name} takes {lib.chunk_digest_capacity()} leaves "
                                   f"and {lib.chunk_digest_unit_bytes()}-byte units, "
                                   f"not {CAPACITY} and {UNIT_BYTES}")
            _lib = lib
        return _lib


@dataclass(frozen=True)
class Unit:
    """One work unit: a segment of one chunk of one leaf, as the kernel
    reads it. ``lo``/``hi`` are byte offsets in the leaf; ``head`` words
    before the first 16-byte boundary and ``tail`` words after the last
    (a zero-filled partial word included) are scalar loads, ``body`` the
    16-byte loads between them; ``first_word`` is the 1-based word index,
    from the chunk's start, of the word at ``lo``."""

    leaf: int
    chunk: int
    segment: int
    lo: int
    hi: int
    head: int
    body: int
    tail: int
    first_word: int


@dataclass(frozen=True)
class Plan:
    """What one grouped call launches. Leaf k owns rows
    ``bounds[k]:bounds[k + 1]`` of one ``(bounds[-1], 2)`` table (one row
    when empty); ``groups`` holds the non-empty leaves of each launch."""

    nbytes: tuple[int, ...]
    addrs: tuple[int, ...]
    chunk_bytes: int
    unit_bytes: int
    bounds: tuple[int, ...]
    groups: tuple[tuple[int, ...], ...]

    def units(self, leaf: int) -> Iterator[Unit]:
        """Leaf ``leaf``'s units in the kernel's order."""
        nb, cb, ub = self.nbytes[leaf], self.chunk_bytes, self.unit_bytes
        for c in range(-(-nb // cb)):
            cs, ce = c * cb, min((c + 1) * cb, nb)
            for s, lo in enumerate(range(cs, ce, ub)):
                hi = min(lo + ub, ce)
                full, partial = divmod(hi - lo, 4)
                head = min(((16 - (self.addrs[leaf] + lo) % 16) % 16) // 4, full)
                body = (full - head) // 4
                yield Unit(leaf, c, s, lo, hi, head, body,
                           full - head - 4 * body + (partial > 0), (lo - cs) // 4 + 1)


def launch_plan(nbytes: Sequence[int], chunk_bytes: int, *,
                addrs: Sequence[int] | None = None,
                unit_bytes: int = UNIT_BYTES) -> Plan:
    """Rows, launches and units of one grouped call over leaves of
    ``nbytes`` bytes at device addresses ``addrs`` (0 when not given).
    The kernel's units are :data:`UNIT_BYTES`; ``unit_bytes`` lets the CPU
    tests check the split at small sizes. Raises ``ValueError`` on what the
    kernel does not take."""
    if chunk_bytes <= 0 or chunk_bytes % 4:
        raise ValueError("chunk_bytes must be a positive multiple of 4")
    if unit_bytes <= 0 or unit_bytes % 16:
        raise ValueError("unit_bytes must be a positive multiple of 16")
    nbytes = tuple(int(n) for n in nbytes)
    addrs = tuple(int(a) for a in addrs) if addrs is not None else (0,) * len(nbytes)
    if any(a % 4 for a, n in zip(addrs, nbytes) if n):
        raise ValueError("chunk_digest kernel needs 4-byte-aligned tensors")
    bounds = [0]
    for n in nbytes:
        bounds.append(bounds[-1] + max(1, -(-n // chunk_bytes)))
    busy = [k for k, n in enumerate(nbytes) if n]
    groups = tuple(tuple(busy[i : i + CAPACITY]) for i in range(0, len(busy), CAPACITY))
    return Plan(nbytes, addrs, int(chunk_bytes), int(unit_bytes), tuple(bounds), groups)


def _check(tensors: Sequence[torch.Tensor]) -> torch.device:
    device = None
    for x in tensors:
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError("chunk_digest kernel needs CUDA tensors")
        if device is not None and x.device != device:
            raise ValueError(f"chunk_digest kernel needs tensors on one device, "
                             f"got {device} and {x.device}")
        device = x.device
        if not x.is_contiguous():
            raise ValueError("chunk_digest kernel needs contiguous tensors")
    if device is None:
        raise ValueError("chunk_digest kernel needs at least one tensor")
    return device


def _launch(plan: Plan, out: torch.Tensor) -> None:
    """Launch the kernel once per group of ``plan`` into the zeroed table
    ``out``, on the current stream of ``out``'s device; raises if a launch
    is refused."""
    lib = _load()
    with torch.cuda.device(out.device):  # the launch's device, restored after
        stream = torch.cuda.current_stream(out.device).cuda_stream
        for group in plan.groups:
            n = len(group)
            err = lib.chunk_digest_launch(
                n,
                (ctypes.c_uint64 * n)(*(plan.addrs[k] for k in group)),
                (ctypes.c_int64 * n)(*(plan.nbytes[k] for k in group)),
                (ctypes.c_int64 * n)(*(plan.bounds[k] for k in group)),
                plan.bounds[-1], plan.chunk_bytes, out.data_ptr(), stream,
            )
            if err != 0:
                msg = lib.chunk_digest_error_string(err).decode()
                raise RuntimeError(f"chunk_digest launch failed: {msg} ({err})")


def chunk_digest_table(tensors: Sequence[torch.Tensor],
                       chunk_bytes: int) -> tuple[torch.Tensor, tuple[int, ...]]:
    """``(table, bounds)``: the ``[hi, lo]`` int64 digests of every chunk of
    every tensor in one zeroed ``(bounds[-1], 2)`` table, tensor k's rows at
    ``bounds[k]:bounds[k + 1]``, each equal bit for bit to
    ``kernels.ref.chunk_digests_plain``.

    Takes contiguous, 4-byte-aligned CUDA tensors of one device and raises on
    anything else. One launch per :data:`CAPACITY` non-empty tensors (none
    when all are empty); ``chunk_digests.launches`` counts them, and
    :func:`thread_launches` the calling thread's.
    """
    device = _check(tensors)
    nbytes = [x.numel() * x.element_size() for x in tensors]
    plan = launch_plan(nbytes, chunk_bytes,
                       addrs=[x.data_ptr() if n else 0 for x, n in zip(tensors, nbytes)])
    # zeroed: the kernel folds every unit's part (and SEED) into it
    out = torch.zeros((plan.bounds[-1], 2), dtype=torch.int64, device=device)
    if plan.groups:
        _launch(plan, out)
        _count(len(plan.groups))
    return out, plan.bounds


def chunk_digests(x: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """(n_chunks, 2) int64 ``[hi, lo]`` digests of one CUDA tensor's bytes:
    the one-leaf case of :func:`chunk_digest_table` (one launch, none for an
    empty tensor, which gets the one ``[0, 0]`` row of ``chunk_digest_np``).
    ``chunk_digests.launches`` counts every launch of the kernel."""
    return chunk_digest_table([x], chunk_bytes)[0]


chunk_digests.launches = 0
