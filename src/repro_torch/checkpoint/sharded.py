"""Sharded, topology-independent save/restore of tensor trees.

The CRUM principle applied to a cluster: the checkpoint image holds *no
device state*. Leaves are stored as global logical arrays; every rank
writes only the shards it owns, keyed by their global index ranges
(:func:`host_slice_plan` is the ownership rule of a replicated state; a
DTensor's rank owns its local shard when its coordinate is 0 on every mesh
dim the leaf is replicated over, the reference's ``replica_id == 0``), and
a restore onto any rank count or mesh assembles each window it needs from
whichever stored shards overlap it, reading only the chunks that hold the
window's bytes (a :class:`ShardTarget` names a mesh and its placements).
Bytes become a tensor through ``torch.frombuffer`` and a dtype
view, with the dtype named in the manifest mapped through
``utils.dtypes`` — no ``ml_dtypes`` — and the result is moved to the target
device.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.chunking import (
    DEFAULT_CHUNK_BYTES,
    chunk_digest_np,
    iter_chunks,
)
from repro_torch.checkpoint.codecs import DEFAULT_CODEC
from repro_torch.checkpoint.manifest import (
    LeafRecord,
    Manifest,
    ShardRecord,
    build_skeleton,
    commit_manifest,
    load_manifest,
    skeleton_fill,
)
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.utils.dtypes import dtype_name, leaf_shape, torch_dtype
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

# (path, global shape) -> target device, or None to keep the leaf on the host
DeviceFor = Callable[[str, tuple[int, ...]], "torch.device | str | None"]


def host_slice_plan(
    path: str, shape: tuple[int, ...], host: int, n_hosts: int
) -> tuple[list[int], list[int]] | None:
    """The global [start, stop) window ``host`` of ``n_hosts`` owns.

    THE ownership rule of the cluster (the reference's, copied exactly),
    defined once so persist (``coord.worker.shard_tree_for_host``) and
    elastic restore (``RestoreManager.restore_elastic``) can never drift
    apart — in either package:

      - a leaf whose leading dimension is >= n_hosts splits contiguously
        along dim 0, ``(host * n0) // n_hosts`` style — non-divisible
        splits give some hosts one extra row, never gaps or overlaps;
      - smaller leaves and scalars are whole-owned by a stable hash of
        their path (exactly one host persists each byte);
      - returns None when this host owns nothing of the leaf.
    """
    shape = tuple(int(d) for d in shape)
    if n_hosts <= 0:
        raise ValueError(f"n_hosts must be positive, got {n_hosts}")
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} outside [0, {n_hosts})")
    if len(shape) >= 1 and shape[0] >= n_hosts:
        n0 = shape[0]
        lo = (host * n0) // n_hosts
        hi = ((host + 1) * n0) // n_hosts
        return [lo] + [0] * (len(shape) - 1), [hi] + list(shape[1:])
    if zlib.crc32(path.encode()) % n_hosts == host:
        return [0] * len(shape), list(shape)
    return None


@dataclass(frozen=True)
class ShardTarget:
    """Where a restored leaf goes under a mesh: this rank's block of it, as
    a DTensor with ``placements`` on ``mesh`` (a ``DeviceMesh``), its local
    tensor on ``device``. Not a tuple, so that a tree of them has one leaf
    per target."""

    mesh: Any
    placements: tuple
    device: Any


def local_window(shape: tuple[int, ...], mesh, placements) -> tuple[list[int], list[int]]:
    """The global [start, stop) of this rank's block of a leaf of ``shape``
    laid out by ``placements`` on ``mesh``. A dim sharded over several mesh
    dims splits in mesh order, the first mesh dim major (DTensor's layout).
    Every split must divide."""
    coord = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    start, size = [0] * len(shape), list(shape)
    for i, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        d = pl.dim
        if size[d] % sizes[i]:
            raise ValueError(f"dim {d} of {tuple(shape)} ({size[d]} here) does not split "
                             f"over {sizes[i]} ranks")
        size[d] //= sizes[i]
        start[d] += coord[i] * size[d]
    return start, [a + n for a, n in zip(start, size)]


def owns_replica(mesh, placements) -> bool:
    """This rank writes its block: coordinate 0 on every mesh dim the leaf
    is replicated over."""
    return all(c == 0 for c, pl in zip(mesh.get_coordinate(), placements)
               if pl.is_replicate())


def _leaf_shards(leaf: Any) -> list[tuple[list[int], list[int], np.ndarray]]:
    """(start, stop, host bytes) of the shards this process writes: a
    tensor or host value is one whole-leaf shard, a ``HostShardView`` its
    window (nothing when unowned)."""
    from repro_torch.core.shadow import _owned_host_shards

    return [(start, stop, leaf_bytes(data))
            for _ordinal, start, stop, data in _owned_host_shards(leaf)]


def _prev_digest_map(prev: Manifest | None) -> dict[tuple, Any]:
    """(path, start, stop, chunk_idx) -> ChunkRecord from a prior manifest."""
    if prev is None:
        return {}
    out = {}
    for path, lv in prev.leaves.items():
        for s in lv.shards:
            for c in s.chunks:
                out[(path, tuple(s.start), tuple(s.stop), c.index)] = c
    return out


def save_pytree(
    state: Any,
    store: ChunkStore,
    step: int,
    *,
    codec: str = DEFAULT_CODEC,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    host: int = 0,
    prev_manifest: Manifest | None = None,
    meta: dict | None = None,
    commit: bool = True,
    fsync: bool = False,
) -> Manifest:
    """Write this host's shards of ``state`` synchronously; commit the
    manifest (or, with ``commit=False``, only return it).

    Leaves are tensors (on any device: their bytes are copied to the host),
    host values, or ``HostShardView`` windows. ``prev_manifest`` enables
    incremental checkpoints: chunks whose digest matches the previous
    image are *referenced*, not rewritten.
    """
    flat, _ = flatten_with_paths(state)
    skeleton = build_skeleton(state)
    prev = _prev_digest_map(prev_manifest)

    manifest = Manifest(step=step, skeleton=skeleton, meta=meta or {})
    writer = store.writer(step, host)
    reused = written = 0
    try:
        for path, leaf in flat.items():
            lrec = LeafRecord(path=path, shape=leaf_shape(leaf), dtype=dtype_name(leaf))
            for start, stop, data in _leaf_shards(leaf):
                srec = ShardRecord(start=start, stop=stop)
                for key, raw in iter_chunks(path, data, chunk_bytes):
                    digest = chunk_digest_np(raw)
                    old = prev.get((path, tuple(start), tuple(stop), key.index))
                    if old is not None and old.digest == digest and old.raw_len == len(raw):
                        srec.chunks.append(old)  # delta reference
                        reused += 1
                    else:
                        srec.chunks.append(
                            writer.append(raw, codec, index=key.index, digest=digest)
                        )
                        written += 1
                lrec.shards.append(srec)
            manifest.leaves[path] = lrec
    finally:
        writer.close(fsync=fsync)
    manifest.meta.setdefault("chunks_written", written)
    manifest.meta.setdefault("chunks_reused", reused)
    if commit:
        # directory durability tracks the payload fsync knob (see manifest
        # .fsync_dir): dir fsyncs without payload fsyncs buy nothing
        commit_manifest(store.root, manifest, durable=fsync)
    return manifest


# --------------------------------------------------------------------------
# Restore
# --------------------------------------------------------------------------


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

    def _part(self, i: int, lo: int, hi: int) -> torch.Tensor:
        """Elements [lo, hi) (flat, C order) of stored shard i, read from
        the chunks that hold them and no other."""
        s = self.lrec.shards[i]
        isz = self.dtype.itemsize
        b_lo, b_hi = lo * isz, hi * isz
        buf = bytearray(b_hi - b_lo)
        off = 0
        for c in s.chunks:
            c_lo, off = off, off + c.raw_len
            if off <= b_lo or c_lo >= b_hi:
                continue
            raw = self.store.read_chunk(c)
            a, b = max(c_lo, b_lo), min(off, b_hi)
            buf[a - b_lo : b - b_lo] = memoryview(raw)[a - c_lo : b - c_lo]
        if off < b_hi:
            raise IOError(f"stored shard {s.start}:{s.stop} of {self.lrec.path} has "
                          f"{off} bytes, expected at least {b_hi}")
        return torch.frombuffer(buf, dtype=torch.uint8).view(self.dtype)

    def window(self, start: list[int], stop: list[int]) -> torch.Tensor:
        """Assemble the [start, stop) window from overlapping stored shards,
        reading of each only the chunks between the overlap's first and
        last element."""
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
            size = [h - l for l, h in zip(lo, hi)]
            if i in self._shard_cache:
                src = self._shard_cache[i][
                    tuple(slice(l - sa, h - sa) for l, h, sa in zip(lo, hi, s.start))]
            else:
                shp = [b - a for a, b in zip(s.start, s.stop)]
                strides = [math.prod(shp[d + 1:]) for d in range(len(shp))]
                first = sum((l - sa) * st for l, sa, st in zip(lo, s.start, strides))
                last = sum((h - 1 - sa) * st for h, sa, st in zip(hi, s.start, strides))
                src = self._part(i, first, last + 1).as_strided(size, strides, 0)
            out[tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, start))] = src
            filled += math.prod(size)
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


def _placed(t: torch.Tensor, device: torch.device | str | None) -> Any:
    """A restored CPU tensor on ``device``; without one, on the host as the
    reference returns it: a numpy array — except for dtypes numpy has no
    type for (bfloat16), which stay CPU tensors."""
    if device is not None:
        return t.to(device)
    if t.dtype == torch.bfloat16:
        return t
    return t.numpy()


def restore_leaf(
    store: ChunkStore, lrec: LeafRecord, device: "torch.device | str | ShardTarget | None"
) -> Any:
    """Restore one leaf: a tensor on ``device``, a host value without one
    (see :func:`_placed`), or for a :class:`ShardTarget` this rank's block
    as a DTensor, assembled from its window alone."""
    asm = _LeafAssembler(store, lrec)
    if isinstance(device, ShardTarget):
        from torch.distributed.tensor import DTensor

        start, stop = local_window(asm.shape, device.mesh, device.placements)
        local = asm.window(start, stop).to(device.device)
        strides = tuple(math.prod(asm.shape[d + 1:]) for d in range(len(asm.shape)))
        return DTensor.from_local(local, device.mesh, device.placements, run_check=False,
                                  shape=torch.Size(asm.shape), stride=strides)
    return _placed(asm.full(), device)


def restore_pytree(
    store: ChunkStore,
    step: int,
    device: Any = None,
    *,
    verify_digests: bool = False,
) -> tuple[Any, Manifest]:
    """Restore the full tree saved at ``step``.

    ``device`` is None (host values), one device for every leaf, or a tree
    matching the saved structure whose leaves are devices or None — the
    port's counterpart of the reference's shardings argument.
    """
    manifest = load_manifest(store.root, step)
    if verify_digests:
        verify_manifest(store, manifest)
    per_path: dict[str, Any] | None = None
    if isinstance(device, (dict, list, tuple)):
        per_path, _ = flatten_with_paths(device)
    leaves = {
        path: restore_leaf(
            store, lrec, per_path.get(path) if per_path is not None else device
        )
        for path, lrec in manifest.leaves.items()
    }
    return skeleton_fill(manifest.skeleton, leaves), manifest


def restore_pytree_elastic(
    store: ChunkStore,
    step: int,
    device_for: DeviceFor,
) -> tuple[Any, Manifest]:
    """Elastic restore: each leaf's target device chosen per (path, shape)."""
    manifest = load_manifest(store.root, step)
    leaves = {
        path: restore_leaf(store, lrec, device_for(path, tuple(lrec.shape)))
        for path, lrec in manifest.leaves.items()
    }
    return skeleton_fill(manifest.skeleton, leaves), manifest


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
