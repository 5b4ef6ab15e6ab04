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
    CUDA call -> SendDataToRealPages()  upload(): HOST_DIRTY chunks pushed
                                        back to device (proxy replay path)

The digest compare runs *on device*: the hand-written CUDA
``chunk_digest`` kernel digests all dirty card tensors in one grouped call
per device, and only one digest table per device crosses to the host
before any data does, so clean chunks cost nothing to skip — the same
economy CRUM gets from not faulting untouched pages. CPU tensors
(``ops.host_chunk_digests`` routes them) and host values are hashed with
the host oracle ``chunk_digest_np`` over their bytes (the same bits).

The device proxy (``repro_torch.proxy``) runs this manager in reverse: its
shadow buffers ARE the data-plane table (``segment_factory``), ``sync``
moves device -> table and ``upload`` table -> device, and a step program
that digests its own output hands those digests to ``sync``
(``device_digests``) so the boundary scans nothing.

A managed space (``repro_torch.uvm``) replaces the conservative
all-chunks mark with its page-granular write history
(``mark_device_step(marks)``): the marked chunks are fetched without a
digest compare, and fused digests, when given, narrow them further.

Leaves are tensors (one shard each: the whole leaf), host values (numpy
arrays and scalars), or :class:`HostShardView` windows — the slice of a
leaf one rank of a cluster persists (``repro_torch.coord``). A view's data
is a torch view of the card tensor, so the window's digests join the same
grouped ``chunk_digest`` launch as every other leaf of the sync and only
its changed chunks cross to the host. Byte views of tensors come from
``t.reshape(-1).view(torch.uint8)`` (``utils.dtypes.byte_view``), because a
dtype view refuses 0-d tensors.
"""
from __future__ import annotations

import concurrent.futures as cf
import enum
import mmap
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.chunking import (
    DEFAULT_CHUNK_BYTES,
    chunk_digest_np,
    num_chunks,
)
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.dtypes import DTYPE_NAMES, byte_view, leaf_nbytes, torch_dtype
from repro_torch.utils.timing import Timings
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes, unflatten_from_paths


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
    # True: the current DEVICE_DIRTY marks are page-granular truth (a
    # managed space's write history), so the next sync fetches them
    # without a digest compare
    precise: bool = False


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
    # phase breakdown: time spent hashing device chunks vs moving bytes —
    # fused digesting (digests computed inside the step) drives digest_us
    # to zero
    digest_us: float = 0.0
    fetch_us: float = 0.0
    # the part of fetch_us a first sync spends allocating its buffers and
    # faulting their pages in, or waiting for a buffer made ahead (the rest
    # is the copy); buffers_ahead counts the streams whose buffer was made
    # ahead (see ShadowStateManager.prepare)
    alloc_us: float = 0.0
    prefault_us: float = 0.0
    buffers_ahead: int = 0
    # chunks whose digest the step already supplied (no boundary scan)
    chunks_prehashed: int = 0
    # which sync epoch produced this image (see begin_sync_epoch)
    epoch: int = 0

    def merge(self, other: "SyncStats") -> None:
        self.chunks_total += other.chunks_total
        self.chunks_fetched += other.chunks_fetched
        self.bytes_total += other.bytes_total
        self.bytes_fetched += other.bytes_fetched
        self.leaves += other.leaves
        self.changed.update(other.changed)
        self.digest_us += other.digest_us
        self.fetch_us += other.fetch_us
        self.alloc_us += other.alloc_us
        self.prefault_us += other.prefault_us
        self.buffers_ahead += other.buffers_ahead
        self.chunks_prehashed += other.chunks_prehashed


@dataclass
class UploadStats:
    """What ``upload()`` pushed host->device (paper: SendDataToRealPages)."""

    chunks_uploaded: int = 0
    bytes_uploaded: int = 0
    leaves_touched: int = 0
    # per-stream bytes pushed, keyed (path, shard_ordinal) — the proxy
    # replay path reports these so recovery cost is attributable per leaf
    per_stream: dict[tuple[str, int], int] = field(default_factory=dict)


class HostShardView:
    """The global index window of a leaf that one rank owns and persists.

    In the cluster every rank holds the full replicated state but
    *persists* only its window (``checkpoint.sharded.host_slice_plan``).
    ``shape`` and ``dtype`` describe the **global** leaf — what the merged
    manifest records; ``data`` is this rank's window: a torch view of the
    card tensor (a dim-0 window of a contiguous leaf is itself contiguous,
    so nothing is copied), a numpy array, or None when the rank owns
    nothing of the leaf (the owner's hostmeta supplies it at merge time).
    ``dtype`` is a torch dtype when ``data`` is a tensor (or the type has
    no numpy twin, bfloat16), else a numpy dtype; ``dtype_name`` is the
    manifest's name for it either way.
    """

    __slots__ = ("data", "start", "stop", "_shape", "dtype_name")

    def __init__(self, data, *, start=None, stop=None,
                 global_shape=None, dtype=None):
        if data is not None and not isinstance(data, torch.Tensor):
            data = np.ascontiguousarray(data)
        self.data = data
        self.start = list(start) if start is not None else None
        self.stop = list(stop) if stop is not None else None
        if global_shape is None:
            if data is None:
                raise ValueError("unowned HostShardView needs global_shape")
            global_shape = data.shape
        self._shape = tuple(int(d) for d in global_shape)
        if dtype is None:
            if data is None:
                raise ValueError("unowned HostShardView needs dtype")
            dtype = data.dtype
        if isinstance(dtype, torch.dtype):
            self.dtype_name = DTYPE_NAMES[dtype]
        else:
            self.dtype_name = dtype if isinstance(dtype, str) else np.dtype(dtype).name

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape

    @property
    def dtype(self):
        if isinstance(self.data, torch.Tensor) or self.dtype_name == "bfloat16":
            return torch_dtype(self.dtype_name)  # numpy has no bfloat16
        return np.dtype(self.dtype_name)


def _owned_host_shards(leaf: Any):
    """(ordinal, start, stop, data) for the shards this process owns.

    A tensor is one shard: the whole leaf (the port runs on one card); a
    :class:`HostShardView` is its window, or nothing when unowned.
    """
    if isinstance(leaf, HostShardView):
        if leaf.data is None:
            return []
        ndim = len(leaf.data.shape)
        start = leaf.start if leaf.start is not None else [0] * ndim
        stop = leaf.stop if leaf.stop is not None else list(leaf.data.shape)
        return [(0, list(start), list(stop), leaf.data)]
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
        segment_factory: Callable[[tuple[str, int], int], np.ndarray] | None = None,
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
        # Pluggable buffer allocation: (key, nbytes) -> u8 array. The device
        # proxy passes a factory that maps file-backed MAP_SHARED segments,
        # making the shadow buffers themselves the cross-process data plane
        # (step inputs/outputs never pickle through the control pipe).
        self.segment_factory = segment_factory
        self.timings = timings or Timings()
        self._streams: dict[tuple[str, int], _ShardStream] = {}
        self._mmaps: list[mmap.mmap] = []
        self._registered = False
        # first-sync buffers made ahead by prepare(): key -> (nbytes, future
        # of (mmap or None, buffer))
        self._ahead: dict[tuple[str, int], tuple[int, cf.Future]] = {}
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
        # sync epochs: each begin_sync_epoch() names one step-boundary
        # image, carried through SyncStats.epoch
        self.sync_epoch = 0

    def _new_buffer(self, nbytes: int) -> tuple[mmap.mmap | None, np.ndarray]:
        if self.shared_buffers and nbytes > 0:
            mm = mmap.mmap(-1, nbytes)  # anonymous + MAP_SHARED on POSIX
            return mm, np.frombuffer(mm, dtype=np.uint8, count=nbytes)
        return None, np.empty(nbytes, np.uint8)

    def _alloc_buffer(self, nbytes: int, key: tuple[str, int] | None = None) -> np.ndarray:
        if self.segment_factory is not None and key is not None:
            return self.segment_factory(key, nbytes)
        mm, buf = self._new_buffer(nbytes)
        if mm is not None:
            self._mmaps.append(mm)
        return buf

    @staticmethod
    def _fault(buf: np.ndarray) -> None:
        # Fault every fresh page in on torch's intra-op threads: a
        # device-to-host copy into never-touched pages faults them one at a
        # time on the copying thread (on the H100's host, ~11 s of a 12-16 s
        # first fetch of 4.94 GB; ~2.5 s on 8 threads, then ~0.4 s of copy)
        torch.from_numpy(buf).zero_()

    def _faulted_buffer(self, nbytes: int) -> tuple[mmap.mmap | None, np.ndarray]:
        mm, buf = self._new_buffer(nbytes)
        self._fault(buf)
        return mm, buf

    # -- first-sync buffers, made ahead --------------------------------------------
    def prepare(self, state: Any, pool: cf.Executor) -> None:
        """Make the first sync's buffers for ``state``'s layout on ``pool``,
        off the blocking path: allocated and faulted in, leaf by leaf in
        the state's order. The first sync takes each one whose stream has
        the same size: a buffer being faulted is waited for, one not yet
        started is made by the sync itself. A no-op once this manager has
        synced, and for segment buffers (their factory maps files)."""
        if self._registered or self._ahead or self.segment_factory is not None:
            return
        for path, leaf in flatten_with_paths(state)[0].items():
            for ordinal, _start, _stop, data in _owned_host_shards(leaf):
                nbytes = leaf_nbytes(data)
                if nbytes > 0:
                    self._ahead[(path, ordinal)] = (
                        nbytes, pool.submit(self._faulted_buffer, nbytes))

    def _take_ahead(self, stream: "_ShardStream") -> cf.Future | None:
        """The stream's buffer made ahead (a future of (mmap, buffer)), or
        None: none was, its size differs, or it had not started (then it is
        cancelled and the caller makes it)."""
        ahead = self._ahead.pop((stream.path, stream.shard_ordinal), None)
        if ahead is None:
            return None
        nbytes, fut = ahead
        if fut.cancel() or nbytes != stream.nbytes:
            return None  # a started one of the wrong size is dropped when done
        return fut

    def drop_ahead(self) -> None:
        """Cancel and release the buffers made ahead that no sync took."""
        ahead, self._ahead = self._ahead, {}
        for _nbytes, fut in ahead.values():
            fut.cancel()

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
    def mark_device_step(self, marks: dict[str, list[int]] | None = None) -> None:
        """Paper: a CUDA call may mutate real pages -> mark shadows stale.

        Without ``marks`` every CLEAN chunk becomes DEVICE_DIRTY (the
        conservative behaviour: any step may have touched any byte, and the
        next sync's digest compare finds which did). With ``marks`` —
        ``{path: chunk indices}`` from a managed space's page-granular
        write history — a path present in the dict gets *exactly* those
        chunks marked, flagged ``precise`` so the next sync fetches them
        without a digest scan; paths absent from the dict (host-side leaves
        outside the managed space) stay conservative.
        """
        for (path, _ordinal), s in self._streams.items():
            idx = marks.get(path) if marks is not None else None
            if idx is not None:
                for i in idx:
                    if 0 <= i < s.n_chunks and s.states[i] is ChunkState.CLEAN:
                        s.states[i] = ChunkState.DEVICE_DIRTY
                s.precise = True
            else:
                s.states = [
                    ChunkState.DEVICE_DIRTY if st is ChunkState.CLEAN else st
                    for st in s.states
                ]
                s.precise = False

    def mark_host_write(self, path: str) -> None:
        """Paper: write fault on a shadow page -> HOST_DIRTY."""
        for (p, _), s in self._streams.items():
            if p == path:
                s.states = [ChunkState.HOST_DIRTY] * s.n_chunks

    def mark_host_chunks(self, path: str, indices: list[int], *, ordinal: int = 0) -> None:
        """Chunk-granular host-write marks (the proxy's delta-UPLOAD path):
        only the listed chunks will be pushed by the next ``upload()``."""
        s = self._streams.get((path, ordinal))
        if s is None:
            raise KeyError(f"no stream for {(path, ordinal)}")
        for i in indices:
            if 0 <= i < s.n_chunks:
                s.states[i] = ChunkState.HOST_DIRTY

    # -- sync (the read-fault path, batched) ------------------------------------
    def begin_sync_epoch(self) -> int:
        """Open a new sync epoch and return its number.

        An epoch names one step-boundary image: the caller issues
        ``begin_sync_epoch()`` at the boundary and runs ``sync(state,
        epoch=...)`` against the boundary state, and the epoch rides the
        sync's stats.
        """
        self.sync_epoch += 1
        return self.sync_epoch

    def sync(
        self,
        state: Any,
        *,
        epoch: int | None = None,
        device_digests: dict[str, list[int]] | None = None,
    ) -> SyncStats:
        """Bring the shadow up to date with the device; returns transfer stats.

        Only chunks whose device digest differs from the shadow digest are
        materialized on host — CRUM's read-fault economy at chunk scale.
        Every tensor stream that needs digests is digested first, in one
        grouped call per device whose table crosses to the host in one copy;
        then each stream compares and fetches. A leaf that appears after the
        first sync re-registers the state before any stream syncs, so every
        stream is fetched whole (the reference re-registers partway and
        drops the shadow of the leaves before the new one).

        ``device_digests`` ({path: per-chunk u64 digests}) are digests the
        step program already computed as a fused final pass: a listed path
        of the right chunk count skips the digest pass and compares the
        supplied digests against the shadow's (``chunks_prehashed``); a
        :class:`HostShardView` window never takes them (they index the
        whole leaf's chunks, not the window's).
        """
        tr = obs_trace.get()
        t0 = time.perf_counter() if tr is not None else 0.0
        flat, _ = flatten_with_paths(state)
        # per leaf, its shards as ((path, ordinal), data)
        leaves = [
            [((path, ordinal), data)
             for ordinal, _start, _stop, data in _owned_host_shards(leaf)]
            for path, leaf in flat.items()
        ]
        shards = [shard for leaf in leaves for shard in leaf]
        if not self._registered or any(key not in self._streams for key, _ in shards):
            # first sync, or a new leaf appeared: register (all chunks dirty)
            self.register(state)
        windows = {path for path, leaf in flat.items()
                   if isinstance(leaf, HostShardView)}
        known = {}
        for key, _data in shards:
            if key[0] in windows:
                continue
            k = (device_digests or {}).get(key[0])
            if k is not None and len(k) == self._streams[key].n_chunks:
                known[key] = [int(d) for d in k]
        stats = SyncStats(epoch=epoch if epoch is not None else self.sync_epoch)
        digests = self._tensor_digests(
            [(key, data) for key, data in shards if key not in known], stats)
        for leaf in leaves:
            for key, data in leaf:
                stats.merge(self._sync_stream(
                    self._streams[key], data, digests.get(key), known.get(key)))
            stats.leaves += 1
        if self._ahead:
            self.drop_ahead()  # made for a layout this state does not have
        if tr is not None:
            tr.complete("shadow.sync", t0, epoch=stats.epoch,
                        chunks_fetched=stats.chunks_fetched,
                        bytes_fetched=stats.bytes_fetched,
                        prehashed=stats.chunks_prehashed)
        return stats

    def _tensor_digests(
        self, shards: list[tuple[tuple[str, int], Any]], stats: SyncStats
    ) -> dict[tuple[str, int], list[int]]:
        """Digests of every tensor stream this sync compares (one with a
        DEVICE_DIRTY chunk; on a first sync only when its digests are not
        deferred) through ``ops.host_chunk_digests`` — card tensors in one
        grouped kernel call per device, CPU tensors with the numpy oracle —
        timed once into ``stats.digest_us``. Host values hash in
        :meth:`_sync_stream`."""
        wanted = []
        for key, data in shards:
            stream = self._streams[key]
            if not isinstance(data, torch.Tensor):
                continue
            if stream.buffer is None:
                if not self.defer_first_digests:
                    wanted.append((key, data))
            elif not stream.precise and ChunkState.DEVICE_DIRTY in stream.states:
                wanted.append((key, data))
        if not wanted:
            return {}
        from repro_torch.kernels.ops import host_chunk_digests

        t0 = time.perf_counter()
        with self.timings.measure("shadow/digest"):
            digests = host_chunk_digests([d for _, d in wanted], self.chunk_bytes)
        stats.digest_us += (time.perf_counter() - t0) * 1e6
        return {key: d for (key, _), d in zip(wanted, digests)}

    def _sync_stream(
        self, stream: _ShardStream, data: Any, dev_digests: list[int] | None,
        known: list[int] | None = None,
    ) -> SyncStats:
        """Sync one stream; ``dev_digests`` are its tensor's device digests
        from this sync's grouped call (None for a host leaf, which is hashed
        here with ``chunk_digest_np``), ``known`` the step's fused digests."""
        stats = SyncStats(
            chunks_total=stream.n_chunks, bytes_total=stream.nbytes
        )
        if stream.buffer is None:
            # first sync: everything must move regardless — bulk copy; the
            # digest pass is skipped when a persist phase will backfill it
            stream.precise = False
            t0 = time.perf_counter()
            with self.timings.measure("shadow/fetch"):
                ahead = self._take_ahead(stream)
                if ahead is None:
                    stream.buffer = self._alloc_buffer(
                        stream.nbytes, (stream.path, stream.shard_ordinal)
                    )
                t_alloc = time.perf_counter()
                if ahead is not None:
                    mm, stream.buffer = ahead.result()  # waits while faulting
                    if mm is not None:
                        self._mmaps.append(mm)
                    stats.buffers_ahead = 1
                elif self.segment_factory is None:
                    self._fault(stream.buffer)
                t_fault = time.perf_counter()
                _copy_bytes(stream.buffer, data)
                stream.states = [ChunkState.CLEAN] * stream.n_chunks
                stats.chunks_fetched = stream.n_chunks
                stats.bytes_fetched = stream.nbytes
                stats.changed[(stream.path, stream.shard_ordinal)] = list(
                    range(stream.n_chunks)
                )
            stats.fetch_us += (time.perf_counter() - t0) * 1e6
            stats.alloc_us += (t_alloc - t0) * 1e6
            stats.prefault_us += (t_fault - t_alloc) * 1e6
            if known is not None:
                stream.digests = list(known)
                stats.chunks_prehashed += stream.n_chunks
            elif self.defer_first_digests:
                stream.digests = [-2] * stream.n_chunks  # pending backfill
            elif dev_digests is not None:
                stream.digests = list(dev_digests)
            else:
                stream.digests = self._host_digests(data, stream, stats)
            return stats
        dirty = [
            i for i, st in enumerate(stream.states)
            if st is ChunkState.DEVICE_DIRTY
        ]
        precise, stream.precise = stream.precise, False
        if not dirty:
            return stats
        if known is not None:
            # fused digests: the step already hashed the chunks, so the
            # compare is bookkeeping (no digest time) — and it composes
            # with page-granular marks: only chunks both marked dirty AND
            # hash-changed are fetched; shadow digests still unknown (a
            # deferred first sync) count as changed
            dev_digests = known
            changed = [i for i in dirty
                       if stream.digests[i] < 0 or known[i] != stream.digests[i]]
            stats.chunks_prehashed += len(dirty)
        elif precise:
            # page-granular marks are authoritative: fetch exactly them, no
            # digest scan over the (mostly clean) rest of the leaf — the
            # whole point of the UVM dirty-bit integration
            dev_digests = None
            changed = dirty
        else:
            if dev_digests is None:
                dev_digests = self._host_digests(data, stream, stats)
            changed = [i for i in dirty if dev_digests[i] != stream.digests[i]]
        # unchanged-but-marked chunks are clean after the compare
        changed_set = set(changed)
        for i in dirty:
            if i not in changed_set:
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
                stream.digests = (list(dev_digests) if dev_digests is not None
                                  else self._fetched_digests(stream, changed))
                stream.states = [ChunkState.CLEAN] * stream.n_chunks
                stats.chunks_fetched = stream.n_chunks
                stats.bytes_fetched = stream.nbytes
                stats.fetch_us += (time.perf_counter() - t_fetch) * 1e6
                return stats
            fetch = self._make_chunk_fetcher(data, stream, changed)
            for i in changed:
                lo, hi = i * cb, min(stream.nbytes, (i + 1) * cb)
                fetch(lo, hi)
                stream.states[i] = ChunkState.CLEAN
                stats.chunks_fetched += 1
                stats.bytes_fetched += hi - lo
            new = (dev_digests if dev_digests is not None
                   else dict(zip(changed, self._fetched_digests(stream, changed))))
            for i in changed:
                stream.digests[i] = new[i]
        stats.fetch_us += (time.perf_counter() - t_fetch) * 1e6
        return stats

    def _fetched_digests(self, stream: _ShardStream, changed: list[int]) -> list[int]:
        """Shadow digests of chunks a precise sync fetched without a
        compare: hashed from the shadow bytes with ``chunk_digest_np``, as
        the reference does — or, when a persist phase backfills digests
        (``defer_first_digests``), left to it (-2) as a first sync leaves
        them, so the blocking phase hashes nothing."""
        if self.defer_first_digests:
            return [-2] * len(changed)
        cb = self.chunk_bytes
        with self.timings.measure("shadow/digest"):
            return [chunk_digest_np(stream.buffer[i * cb : min(stream.nbytes, (i + 1) * cb)])
                    for i in changed]

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

    def _host_digests(self, data: Any, stream: _ShardStream, stats: SyncStats) -> list[int]:
        """Per-chunk u64 digests of a host value (numpy array or scalar)
        with ``chunk_digest_np``, timed into ``stats.digest_us``."""
        t0 = time.perf_counter()
        with self.timings.measure("shadow/digest"):
            host = leaf_bytes(data)
            cb = self.chunk_bytes
            digests = [
                chunk_digest_np(host[i * cb : min(stream.nbytes, (i + 1) * cb)])
                for i in range(stream.n_chunks)
            ]
        stats.digest_us += (time.perf_counter() - t0) * 1e6
        return digests

    # -- upload (the write-back path: SendDataToRealPages) ---------------------
    def upload(self, state: Any) -> tuple[Any, UploadStats]:
        """Push HOST_DIRTY chunks back to the device; returns (state', stats).

        The paper's ``SendDataToRealPages()``: shadow content that the host
        mutated is written back before the device computes again. Only
        HOST_DIRTY chunk byte-ranges move; untouched chunks cost nothing.
        A tensor leaf is patched in place, through a flat byte view; a leaf
        whose every chunk is dirty is rebuilt from the shadow bytes instead,
        never reading its stale device content, as the reference rebuilds
        it. Host (numpy) leaves come back as patched copies. This is the
        device proxy's replay data-push primitive: after a respawn the last
        synced snapshot lives in the (shared-segment) shadow buffers and is
        pushed into the fresh proxy's device state through this path.
        """
        if not self._registered:
            raise RuntimeError("upload() before register()")
        flat, treedef = flatten_with_paths(state)
        stats = UploadStats()
        new_flat = dict(flat)
        pushed: list[tuple[_ShardStream, list[int], Any]] = []
        for path, leaf in flat.items():
            stream = self._streams.get((path, 0))
            if stream is None:
                continue
            dirty = [i for i, st in enumerate(stream.states)
                     if st is ChunkState.HOST_DIRTY]
            if not dirty:
                continue
            stats.leaves_touched += 1
            with self.timings.measure("shadow/upload"):
                new_flat[path] = self._upload_leaf(stream, leaf, dirty, stats)
            out = new_flat[path]
            pushed.append((stream, dirty,
                           out.data if isinstance(out, HostShardView) else out))
        self._upload_digests(pushed)
        return unflatten_from_paths(treedef, new_flat), stats

    def _upload_leaf(
        self, stream: _ShardStream, leaf: Any, dirty: list[int], stats: UploadStats
    ) -> Any:
        buf = self._stream_buffer(stream)
        cb = self.chunk_bytes
        full = len(dirty) == stream.n_chunks
        if isinstance(leaf, HostShardView):
            # a rank's window: patch its bytes in place (a card view writes
            # through into the replica it views), no rebuild
            if leaf.data is not None:
                data = leaf.data
                target = (byte_view(data) if isinstance(data, torch.Tensor)
                          else data.reshape(-1).view(np.uint8))
                for i in dirty:
                    lo, hi = i * cb, min(stream.nbytes, (i + 1) * cb)
                    src = buf[lo:hi]
                    if isinstance(data, torch.Tensor):
                        target[lo:hi].copy_(torch.from_numpy(src))
                    else:
                        target[lo:hi] = src
            out = leaf
        elif isinstance(leaf, torch.Tensor):
            if full:
                # everything dirty: rebuild straight from the shadow bytes
                out = torch.empty(leaf.shape, dtype=leaf.dtype, device=leaf.device)
                byte_view(out).copy_(torch.from_numpy(buf))
            else:
                out = leaf if leaf.is_contiguous() else leaf.contiguous()
                target = byte_view(out)
                for i in dirty:
                    lo, hi = i * cb, min(stream.nbytes, (i + 1) * cb)
                    target[lo:hi].copy_(torch.from_numpy(buf[lo:hi]))
        else:
            arr = np.asarray(leaf)
            if full:
                out = buf.view(arr.dtype).reshape(arr.shape).copy()
            else:
                out = np.array(arr)  # host copy, patched
                target = out.reshape(-1).view(np.uint8)
                for i in dirty:
                    lo, hi = i * cb, min(stream.nbytes, (i + 1) * cb)
                    target[lo:hi] = buf[lo:hi]
        pushed = sum(min(stream.nbytes, (i + 1) * cb) - i * cb for i in dirty)
        for i in dirty:
            stream.states[i] = ChunkState.CLEAN
        key = (stream.path, stream.shard_ordinal)
        stats.chunks_uploaded += len(dirty)
        stats.bytes_uploaded += pushed
        stats.per_stream[key] = stats.per_stream.get(key, 0) + pushed
        return out

    def _upload_digests(self, pushed: list[tuple[_ShardStream, list[int], Any]]) -> None:
        """Shadow digests of the chunks just uploaded: the uploaded tensors
        through ``ops.host_chunk_digests`` (card tensors in one grouped
        kernel call), host values from the shadow bytes (the same bits
        either way)."""
        tensors = [(s, d, leaf) for s, d, leaf in pushed
                   if isinstance(leaf, torch.Tensor)]
        if tensors:
            from repro_torch.kernels.ops import host_chunk_digests

            tables = host_chunk_digests([leaf for _, _, leaf in tensors],
                                        self.chunk_bytes)
            for (stream, dirty, _), table in zip(tensors, tables):
                for i in dirty:
                    stream.digests[i] = table[i]
        cb = self.chunk_bytes
        for stream, dirty, leaf in pushed:
            if isinstance(leaf, torch.Tensor):
                continue
            for i in dirty:
                lo, hi = i * cb, min(stream.nbytes, (i + 1) * cb)
                stream.digests[i] = chunk_digest_np(stream.buffer[lo:hi])

    def _stream_buffer(self, stream: _ShardStream) -> np.ndarray:
        if stream.buffer is None:
            # never synced: only meaningful when a segment factory can
            # attach existing shared content (the proxy replay path)
            if self.segment_factory is None:
                raise RuntimeError(
                    f"stream {(stream.path, stream.shard_ordinal)} has no "
                    "shadow content to upload"
                )
            stream.buffer = self._alloc_buffer(
                stream.nbytes, (stream.path, stream.shard_ordinal)
            )
        return stream.buffer

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

    def digest_table(self) -> dict[str, list[int]] | None:
        """Full-state per-chunk digest view: {path: [u64 digests]}.

        Only meaningful when every stream is a whole leaf (ordinal 0 — the
        proxy-service registration shape) and every digest is known:
        returns None if any digest still holds a negative sentinel, so
        callers never ship a partial table (divergence provenance rides
        the proxy's SYNCED ack).
        """
        out: dict[str, list[int]] = {}
        for (path, ordinal), s in self._streams.items():
            if ordinal != 0 or any(d < 0 for d in s.digests):
                return None
            out[path] = [int(d) for d in s.digests]
        return out or None

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
