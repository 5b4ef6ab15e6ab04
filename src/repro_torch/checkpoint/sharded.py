"""Restore of stored leaves into tensors (the read half of the reference's
``checkpoint/sharded.py``).

Leaves are stored as global logical arrays, each shard keyed by its global
index range; a window of a leaf is assembled from whichever stored shards
overlap it. Bytes become a tensor through ``torch.frombuffer`` and a dtype
view, with the dtype named in the manifest mapped through
``utils.dtypes`` — no ``ml_dtypes`` — and the result is moved to the target
device.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.chunking import chunk_digest_np
from repro_torch.checkpoint.manifest import LeafRecord, Manifest
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.utils.dtypes import torch_dtype


class _LeafAssembler:
    """Assembles arbitrary index-windows of one stored leaf (CPU tensors)."""

    def __init__(self, store: ChunkStore, lrec: LeafRecord):
        self.store = store
        self.lrec = lrec
        self.shape = tuple(lrec.shape)
        self.dtype = torch_dtype(lrec.dtype)
        self._shard_cache: dict[int, torch.Tensor] = {}

    def _shard_tensor(self, i: int) -> torch.Tensor:
        if i not in self._shard_cache:
            s = self.lrec.shards[i]
            shp = tuple(b - a for a, b in zip(s.start, s.stop))
            n = math.prod(shp)
            nbytes = n * self.dtype.itemsize
            buf = bytearray(nbytes)
            off = 0
            for c in s.chunks:
                raw = self.store.read_chunk(c)
                take = min(len(raw), nbytes - off)
                buf[off : off + take] = memoryview(raw)[:take]
                off += take
            if off != nbytes:
                raise IOError(
                    f"stored shard {s.start}:{s.stop} of {self.lrec.path} has "
                    f"{off} bytes, expected {nbytes}"
                )
            if nbytes == 0:
                t = torch.empty(shp, dtype=self.dtype)
            else:
                t = torch.frombuffer(buf, dtype=torch.uint8)
                t = t.view(self.dtype).reshape(shp)
            self._shard_cache[i] = t
        return self._shard_cache[i]

    def window(self, start: list[int], stop: list[int]) -> torch.Tensor:
        """Assemble the [start, stop) window from overlapping stored shards."""
        out_shape = tuple(b - a for a, b in zip(start, stop))
        if not out_shape:  # 0-d leaf
            return self._shard_tensor(0).clone()
        out = torch.empty(out_shape, dtype=self.dtype)
        filled = 0
        for i, s in enumerate(self.lrec.shards):
            lo = [max(a, sa) for a, sa in zip(start, s.start)]
            hi = [min(b, sb) for b, sb in zip(stop, s.stop)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            src = self._shard_tensor(i)[
                tuple(slice(l - sa, h - sa) for l, h, sa in zip(lo, hi, s.start))
            ]
            out[tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, start))] = src
            filled += src.numel()
        if filled < math.prod(out_shape):
            raise ValueError(
                f"stored shards do not cover window {start}:{stop} of "
                f"{self.lrec.path} (covered {filled})"
            )
        return out

    def full(self) -> torch.Tensor:
        if len(self.lrec.shards) == 1 and list(self.lrec.shards[0].start) == [0] * len(
            self.shape
        ) and tuple(self.lrec.shards[0].stop) == self.shape:
            return self._shard_tensor(0)  # one whole-leaf shard: no copy
        return self.window([0] * len(self.shape), list(self.shape))


def restore_leaf(
    store: ChunkStore, lrec: LeafRecord, device: torch.device | str | None
) -> Any:
    """Restore one leaf.

    With a ``device`` the leaf comes back as a tensor there. Without one it
    stays on the host as the reference returns it: a numpy array — except
    for dtypes numpy has no type for (bfloat16), which stay CPU tensors.
    """
    t = _LeafAssembler(store, lrec).full()
    if device is not None:
        return t.to(device)
    if t.dtype == torch.bfloat16:
        return t
    return t.numpy()


def verify_manifest(store: ChunkStore, manifest: Manifest) -> None:
    """Integrity pass: re-digest every chunk on disk (paper's 'verified mode')."""
    for lv in manifest.leaves.values():
        for s in lv.shards:
            for c in s.chunks:
                raw = store.read_chunk(c)
                d = chunk_digest_np(np.frombuffer(raw, np.uint8))
                if d != c.digest:
                    raise IOError(
                        f"digest mismatch for {lv.path} shard {s.start}:{s.stop} "
                        f"chunk {c.index}: {d:#x} != {c.digest:#x}"
                    )
