"""ShadowStateManager — Algorithm 1 over PyTorch tensors on a CUDA card.

CRUM's shadow UVM pages keep an application-side copy of device memory in
sync lazily, driven by page faults. Ordinary device tensors give no page
faults to hook, but the structure of the algorithm survives intact once
"page" becomes "chunk" and "fault" becomes "digest mismatch at a sync
point":

    paper (Algorithm 1)                 here
    -----------------------------       ------------------------------------
    CUDA kernel launch marks pages      train step marks all chunks
    writable-by-device                  DEVICE_DIRTY (conservative)
    read fault on a shadow page ->      sync(): device-side digest compare;
    ReadDataFromRealPage()              only mismatching chunks are fetched
    write fault -> MarkPageAsDirty()    host mutation marks HOST_DIRTY
    CUDA call -> SendDataToRealPages()  upload(): not ported yet (it
                                        comes with the device-proxy slice)

The digest compare runs *on device* (the hand-written CUDA ``chunk_digest``
kernel for CUDA tensors, its plain PyTorch version for CPU tensors): only
the (n_chunks, 2) digest table crosses to the host before any data does, so
clean chunks cost nothing to skip — the same economy CRUM gets from not
faulting untouched pages.

Leaves are tensors (one shard each: the whole leaf) or host values (numpy
arrays and scalars). Byte views of tensors come from
``t.reshape(-1).view(torch.uint8)`` (``utils.dtypes.byte_view``), because a
dtype view refuses 0-d tensors.
"""
from __future__ import annotations

import enum
import mmap
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.chunking import (
    DEFAULT_CHUNK_BYTES,
    chunk_digest_np,
    num_chunks,
)
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.dtypes import byte_view, leaf_nbytes
from repro_torch.utils.timing import Timings
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes


class ChunkState(enum.Enum):
    CLEAN = "clean"              # shadow == device
    DEVICE_DIRTY = "device_dirty"  # device may have advanced; shadow stale
    HOST_DIRTY = "host_dirty"    # shadow mutated on host; device stale


@dataclass
class _ShardStream:
    """One owned shard of one leaf, viewed as a byte stream of chunks."""

    path: str
    shard_ordinal: int
    start: list[int]
    stop: list[int]
    nbytes: int
    n_chunks: int
    states: list[ChunkState]
    digests: list[int]                    # digest of current *shadow* content
    buffer: np.ndarray | None = None      # host shadow bytes (u8), lazily alloc'd


@dataclass
class SyncStats:
    chunks_total: int = 0
    chunks_fetched: int = 0
    bytes_total: int = 0
    bytes_fetched: int = 0
    leaves: int = 0
    # exactly which chunks this sync materialized, keyed (path, ordinal) —
    # the streamed proxy transport forwards precisely these chunk payloads
    # to the application, so wire bytes track what actually changed
    changed: dict[tuple[str, int], list[int]] = field(default_factory=dict)
    # phase breakdown: time spent hashing device chunks vs moving bytes
    digest_us: float = 0.0
    fetch_us: float = 0.0

    def merge(self, other: "SyncStats") -> None:
        self.chunks_total += other.chunks_total
        self.chunks_fetched += other.chunks_fetched
        self.bytes_total += other.bytes_total
        self.bytes_fetched += other.bytes_fetched
        self.leaves += other.leaves
        self.changed.update(other.changed)
        self.digest_us += other.digest_us
        self.fetch_us += other.fetch_us


def _owned_host_shards(leaf: Any):
    """(ordinal, start, stop, data) for the shards this process owns.

    A tensor is one shard: the whole leaf (the port runs on one card).
    """
    if isinstance(leaf, torch.Tensor):
        return [(0, [0] * leaf.dim(), list(leaf.shape), leaf)]
    arr = np.asarray(leaf)
    return [(0, [0] * arr.ndim, list(arr.shape), arr)]


def _copy_bytes(buffer: np.ndarray, data: Any, lo: int = 0, hi: int | None = None) -> None:
    """Copy bytes [lo, hi) of a leaf into the same range of a host buffer.

    A tensor's bytes go device->host straight into the shadow buffer (no
    intermediate host copy); host leaves are a numpy copy.
    """
    hi = buffer.nbytes if hi is None else hi
    if hi <= lo:
        return
    if isinstance(data, torch.Tensor):
        torch.from_numpy(buffer[lo:hi]).copy_(byte_view(data)[lo:hi])
    else:
        buffer[lo:hi] = leaf_bytes(data)[lo:hi]


class ShadowStateManager:
    """Maintains a host shadow of an on-device state pytree.

    One manager owns one shadow buffer set. The forked checkpointer holds
    two managers (double buffering) so persisting snapshot A never blocks
    filling snapshot B.
    """

    def __init__(
        self,
        *,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        defer_first_digests: bool = False,
        shared_buffers: bool = False,
        timings: Timings | None = None,
    ):
        self.chunk_bytes = int(chunk_bytes)
        # True: first sync skips the digest pass (a persist phase will
        # backfill via set_digests) — used by ForkedCheckpointer
        self.defer_first_digests = defer_first_digests
        # True: shadow buffers live in anonymous MAP_SHARED mmap segments.
        # Across an os.fork() the pages are *shared*, not COW-duplicated, so
        # a persist child reads the snapshot at zero copy cost and the
        # parent's later writes to *other* buffers never trigger page
        # copies — the paper's fork-and-persist economics. The caller must
        # not mutate a buffer while a child is persisting it (the forked
        # checkpointer's busy-buffer discipline guarantees this).
        self.shared_buffers = shared_buffers
        self.timings = timings or Timings()
        self._streams: dict[tuple[str, int], _ShardStream] = {}
        self._mmaps: list[mmap.mmap] = []
        self._registered = False
        # pin/retire: a persisting fork child may still be reading the
        # MAP_SHARED pages of a buffer generation that register() replaces;
        # retired generations are released only once the pin count drops to 0
        self._pin_lock = threading.Lock()
        self._pins = 0
        self._retired: list[tuple[dict, list]] = []
        # buffer generation: bumped by register() so a digest backfill from
        # a persist of the *previous* generation can be recognized and
        # dropped instead of installing stale digests into fresh streams
        self.generation = 0

    def _alloc_buffer(self, nbytes: int) -> np.ndarray:
        if self.shared_buffers and nbytes > 0:
            mm = mmap.mmap(-1, nbytes)  # anonymous + MAP_SHARED on POSIX
            self._mmaps.append(mm)
            return np.frombuffer(mm, dtype=np.uint8, count=nbytes)
        return np.empty(nbytes, np.uint8)

    # -- buffer generation pinning ------------------------------------------------
    def pin(self) -> None:
        """A consumer (e.g. a forked persist child's parent-side job) still
        reads the current buffer generation: re-registration must not release
        it. Balanced by :meth:`unpin`."""
        with self._pin_lock:
            self._pins += 1

    def unpin(self) -> None:
        with self._pin_lock:
            self._pins = max(0, self._pins - 1)
            if self._pins == 0 and self._retired:
                retired, self._retired = self._retired, []
            else:
                retired = []
        for streams, mmaps in retired:
            self._drop_generation(streams, mmaps)

    @staticmethod
    def _drop_generation(streams: dict, mmaps: list) -> None:
        """Release one buffer generation: sever the stream->buffer views so
        the mmaps can actually close (a view held elsewhere — e.g. a
        persist job's snapshot dict — downgrades close to GC-time)."""
        for s in streams.values():
            s.buffer = None
        for mm in mmaps:
            try:
                mm.close()
            except (BufferError, ValueError):  # a view still alive: GC frees
                pass

    # -- registration ---------------------------------------------------------
    def register(self, state: Any) -> None:
        """Learn the chunk layout of ``state``; all chunks start DEVICE_DIRTY.

        Re-registration retires (rather than releases) the previous buffer
        generation while any consumer holds a pin — a persisting fork child
        may still be reading those MAP_SHARED pages.
        """
        flat, _ = flatten_with_paths(state)
        with self._pin_lock:
            old_streams, old_mmaps = self._streams, self._mmaps
            retire = self._pins > 0 and bool(old_streams or old_mmaps)
            if retire:
                self._retired.append((old_streams, old_mmaps))
            self._streams = {}
            self._mmaps = []
        if not retire:
            self._drop_generation(old_streams, old_mmaps)
        for path, leaf in flat.items():
            for ordinal, start, stop, data in _owned_host_shards(leaf):
                nbytes = leaf_nbytes(data)
                nc = num_chunks(nbytes, self.chunk_bytes)
                self._streams[(path, ordinal)] = _ShardStream(
                    path=path,
                    shard_ordinal=ordinal,
                    start=start,
                    stop=stop,
                    nbytes=nbytes,
                    n_chunks=nc,
                    states=[ChunkState.DEVICE_DIRTY] * nc,
                    digests=[-1] * nc,
                )
        self.generation += 1
        self._registered = True

    # -- Algorithm-1 events -----------------------------------------------------
    def mark_device_step(self) -> None:
        """Paper: a CUDA call may mutate real pages -> mark shadows stale.

        Every CLEAN chunk becomes DEVICE_DIRTY: any step may have touched
        any byte, and the next sync's digest compare finds which did. (The
        reference also takes page-granular marks from its managed-memory
        space; that slice is not ported.)
        """
        for s in self._streams.values():
            s.states = [
                ChunkState.DEVICE_DIRTY if st is ChunkState.CLEAN else st
                for st in s.states
            ]

    # -- sync (the read-fault path, batched) ------------------------------------
    def sync(self, state: Any) -> SyncStats:
        """Bring the shadow up to date with the device; returns transfer stats.

        Only chunks whose device digest differs from the shadow digest are
        materialized on host — CRUM's read-fault economy at chunk scale.
        """
        tr = obs_trace.get()
        t0 = time.perf_counter() if tr is not None else 0.0
        if not self._registered:
            self.register(state)
        flat, _ = flatten_with_paths(state)
        stats = SyncStats()
        for path, leaf in flat.items():
            for ordinal, start, stop, data in _owned_host_shards(leaf):
                stream = self._streams.get((path, ordinal))
                if stream is None:  # new leaf appeared: register on the fly
                    self.register(state)
                    stream = self._streams[(path, ordinal)]
                stats.merge(self._sync_stream(stream, data))
            stats.leaves += 1
        if tr is not None:
            tr.complete("shadow.sync", t0,
                        chunks_fetched=stats.chunks_fetched,
                        bytes_fetched=stats.bytes_fetched)
        return stats

    def _sync_stream(self, stream: _ShardStream, data: Any) -> SyncStats:
        stats = SyncStats(
            chunks_total=stream.n_chunks, bytes_total=stream.nbytes
        )
        if stream.buffer is None:
            # first sync: everything must move regardless — bulk copy; the
            # digest pass is skipped when a persist phase will backfill it
            t0 = time.perf_counter()
            with self.timings.measure("shadow/fetch"):
                stream.buffer = self._alloc_buffer(stream.nbytes)
                _copy_bytes(stream.buffer, data)
                stream.states = [ChunkState.CLEAN] * stream.n_chunks
                stats.chunks_fetched = stream.n_chunks
                stats.bytes_fetched = stream.nbytes
                stats.changed[(stream.path, stream.shard_ordinal)] = list(
                    range(stream.n_chunks)
                )
            stats.fetch_us += (time.perf_counter() - t0) * 1e6
            if self.defer_first_digests:
                stream.digests = [-2] * stream.n_chunks  # pending backfill
            else:
                t0 = time.perf_counter()
                with self.timings.measure("shadow/digest"):
                    stream.digests = self._device_digests(data, stream)
                stats.digest_us += (time.perf_counter() - t0) * 1e6
            return stats
        dirty = [
            i for i, st in enumerate(stream.states)
            if st is ChunkState.DEVICE_DIRTY
        ]
        if not dirty:
            return stats

        t0 = time.perf_counter()
        with self.timings.measure("shadow/digest"):
            dev_digests = self._device_digests(data, stream)
        stats.digest_us += (time.perf_counter() - t0) * 1e6

        changed = [i for i in dirty if dev_digests[i] != stream.digests[i]]
        # unchanged-but-marked chunks are clean after the compare
        for i in dirty:
            if i not in changed:
                stream.states[i] = ChunkState.CLEAN

        if not changed:
            return stats
        stats.changed[(stream.path, stream.shard_ordinal)] = sorted(changed)

        t_fetch = time.perf_counter()
        with self.timings.measure("shadow/fetch"):
            cb = self.chunk_bytes
            if len(changed) == stream.n_chunks:
                # everything dirty (first sync / full update): one bulk copy
                _copy_bytes(stream.buffer, data)
                stream.digests = list(dev_digests)
                stream.states = [ChunkState.CLEAN] * stream.n_chunks
                stats.chunks_fetched = stream.n_chunks
                stats.bytes_fetched = stream.nbytes
                stats.fetch_us += (time.perf_counter() - t_fetch) * 1e6
                return stats
            fetch = self._make_chunk_fetcher(data, stream, changed)
            for i in changed:
                lo, hi = i * cb, min(stream.nbytes, (i + 1) * cb)
                fetch(lo, hi)
                stream.digests[i] = dev_digests[i]
                stream.states[i] = ChunkState.CLEAN
                stats.chunks_fetched += 1
                stats.bytes_fetched += hi - lo
        stats.fetch_us += (time.perf_counter() - t_fetch) * 1e6
        return stats

    def _make_chunk_fetcher(self, data: Any, stream: _ShardStream, changed: list[int]):
        """Per-chunk device->host fetch into the shadow buffer: only dirty
        bytes cross the wire.

        When most chunks changed a single bulk fetch is cheaper than many
        small copies (the paper's exponential read-ahead argument,
        degenerated to its endpoint); below that threshold, chunks are
        copied individually from byte-range views of the device tensor.
        """
        buf = stream.buffer
        if (
            isinstance(data, torch.Tensor)
            and stream.n_chunks > 1
            and len(changed) <= stream.n_chunks // 2
        ):
            return lambda lo, hi: _copy_bytes(buf, data, lo, hi)
        host = leaf_bytes(data)

        def fetch(lo: int, hi: int) -> None:
            buf[lo:hi] = host[lo:hi]

        return fetch

    def _device_digests(self, data: Any, stream: _ShardStream) -> list[int]:
        """Per-chunk u64 digests: a tensor is digested where it lives (the
        CUDA kernel on the card, its plain version on the CPU); only host
        leaves (numpy arrays, scalars) are hashed with ``chunk_digest_np``."""
        if isinstance(data, torch.Tensor):
            from repro_torch.kernels.ops import chunk_digests, digests_to_u64

            d = digests_to_u64(chunk_digests(data, self.chunk_bytes))
            return [int(x) for x in d]
        host = leaf_bytes(data)
        cb = self.chunk_bytes
        return [
            chunk_digest_np(host[i * cb : min(stream.nbytes, (i + 1) * cb)])
            for i in range(stream.n_chunks)
        ]

    # -- upload (the write-back path: SendDataToRealPages) ---------------------
    def upload(self, state: Any):
        """Push HOST_DIRTY chunks back to the device (paper:
        ``SendDataToRealPages()``).

        Only the device proxy's replay path uses this, and the proxy is not
        ported yet: it comes with the proxy slice of the port.
        """
        raise NotImplementedError(
            "ShadowStateManager.upload waits for the device-proxy slice of "
            "the PyTorch port"
        )

    # -- snapshot access ----------------------------------------------------------
    def snapshot(self) -> dict[tuple[str, int], dict]:
        """The current shadow: {(path, ordinal): {start, stop, bytes}}.

        ``digests`` carries the per-chunk shadow digests where known
        (negative entries are the -1 "never computed" / -2 "backfill
        pending" sentinels): the persist path uses a known digest instead
        of re-hashing the chunk, so a delta sync is followed by a delta
        digest bill, not a full-state rescan.
        """
        out = {}
        for key, s in self._streams.items():
            if s.buffer is None:
                raise RuntimeError(f"stream {key} never synced")
            out[key] = {
                "start": s.start, "stop": s.stop, "data": s.buffer,
                "digests": list(s.digests),
            }
        return out

    def set_digests(
        self,
        key: tuple[str, int],
        digests: list[int],
        *,
        generation: int | None = None,
    ) -> None:
        """Backfill digests computed during persist (phase 2).

        ``generation`` (when given) must match the buffer generation the
        persist snapshotted: a backfill racing a re-registration would
        otherwise install the *old* generation's digests into fresh
        streams, and a later delta persist would silently reuse chunks
        against the wrong baseline.
        """
        if generation is not None and generation != self.generation:
            return
        s = self._streams.get(key)
        if s is not None and len(digests) == s.n_chunks:
            s.digests = list(digests)
