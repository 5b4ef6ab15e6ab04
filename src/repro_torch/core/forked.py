"""ForkedCheckpointer — the paper's §3.3 forked checkpointing model.

CRUM's two phases, for PyTorch state on a CUDA card:

  phase 1  "drain the device"  : block the train loop only for
           (a) flushing the asynchronous CUDA launch queue (drain), and
           (b) syncing the shadow snapshot (digest-gated device->host
               transfer of dirty chunks only).
  phase 2  "forked child writes": the persist backend compresses and writes
           the immutable snapshot to stable storage *while training
           continues*.

Phase 2 is pluggable (``backend=``):

  ``thread``  a writer-pool thread persists the snapshot. The snapshot
              buffers are plain host memory the train loop never touches, so
              immutability is structural — but compression shares the
              parent's GIL and memory bandwidth, so a heavy persist can
              still steal cycles from the train loop.
  ``fork``    the paper's actual mechanism: ``os.fork()`` a child per
              checkpoint. Shadow buffers live in anonymous MAP_SHARED mmap
              segments (see ShadowStateManager), so the child sees the
              snapshot at zero copy cost; it compresses, writes chunks to
              the ChunkStore, commits the manifest, and streams
              CheckpointResult fields (bytes written, chunks reused, errors)
              back over a pipe. A supervisor thread per child reaps it and
              converts a non-zero exit into ``CheckpointResult.error``.
              ``max_pending`` bounds *live children* — the paper's
              one-forked-child-at-a-time discipline at N=1. The child
              touches no torch at all — only numpy, zlib and the store:
              a CUDA context does not survive ``fork``, and torch's thread
              pools can deadlock a forked child. Everything it reads is
              host memory the parent prepared before the fork.

In a cluster (``repro_torch.coord``) each rank's checkpointer runs in
*external-commit* mode: persist writes the rank's payload and its
``hostmeta-h*.msgpack`` fragment, never MANIFEST or COMMIT — those belong
to the coordinator, once every rank has acked (two-phase commit). Only a
round the coordinator confirms (``commit_confirmed``) becomes the base of
the next incremental delta; an aborted one (``commit_aborted``) never does.

Double buffering (max_pending+1 ShadowStateManagers) lets checkpoint N+1's
phase 1 begin while checkpoint N's phase 2 is still writing — after which
phase 1 blocks.

Blocking time (what the application observes) is accounted separately from
total persist time: the 40x headline of Table 2 is precisely
``blocking_time / naive_synchronous_time``.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import pickle
import struct
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Callable

from repro_torch.checkpoint.chunking import DEFAULT_CHUNK_BYTES, chunk_digest_np, iter_chunks
from repro_torch.checkpoint.codecs import DEFAULT_CODEC
from repro_torch.checkpoint.manifest import (
    LeafRecord,
    Manifest,
    ShardRecord,
    build_skeleton,
    commit_manifest,
    referenced_steps,
    write_hostmeta,
)
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.core.drain import drain
from repro_torch.core.shadow import ShadowStateManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.dtypes import dtype_name, leaf_shape
from repro_torch.utils.timing import Timings
from repro_torch.utils.tree import flatten_with_paths


@dataclass
class CheckpointResult:
    step: int
    blocking_s: float          # what the train loop paid (phase 1)
    persist_s: float = 0.0     # background write time (phase 2)
    bytes_snapshot: int = 0    # bytes moved device->host
    bytes_written: int = 0     # bytes written to storage (compressed)
    chunks_written: int = 0
    chunks_reused: int = 0     # delta references (incremental mode)
    # phase-1 sync economy (what the digest gate / page dirty bits saved):
    chunks_synced: int = 0     # chunks actually fetched device->host
    chunks_clean: int = 0      # chunks the sync proved (or knew) unchanged
    bytes_skipped: int = 0     # bytes the clean chunks did NOT move
    # phase-1 breakdown (microseconds): where the blocking time went —
    # digesting, fetching dirty chunks, the whole shadow sync, and — proxy
    # mode, not ported — how long the train loop stalled for the SYNCED ack
    sync_us: float = 0.0
    digest_us: float = 0.0
    fetch_us: float = 0.0
    stall_us: float = 0.0
    # of fetch_us: a first sync's buffer allocation and page faulting (or
    # its wait for buffers made ahead, buffers_ahead of them)
    alloc_us: float = 0.0
    prefault_us: float = 0.0
    buffers_ahead: int = 0
    error: str | None = None
    done: threading.Event = field(default_factory=threading.Event, repr=False)

    def wait(self, timeout: float | None = None) -> "CheckpointResult":
        if not self.done.wait(timeout):
            raise TimeoutError(f"checkpoint step {self.step} still pending")
        if self.error:
            raise RuntimeError(f"checkpoint step {self.step} failed: {self.error}")
        return self


@dataclass
class PersistJob:
    """Everything phase 2 needs, captured at the end of phase 1."""

    result: CheckpointResult
    buf_index: int
    shadow: ShadowStateManager
    snapshot: dict[tuple[str, int], dict]
    skeleton: Any
    shapes_dtypes: dict[str, tuple[list, str]]
    prev: Manifest | None
    meta: dict
    shadow_gen: int = 0        # buffer generation the snapshot belongs to
    # causal context the persist span parents to (None: tracing off)
    trace_ctx: dict | None = None


def _persist_image(
    store: ChunkStore,
    *,
    step: int,
    host: int,
    codec: str,
    chunk_bytes: int,
    fsync: bool,
    snapshot: dict[tuple[str, int], dict],
    skeleton: Any,
    shapes_dtypes: dict,
    prev: Manifest | None,
    meta: dict,
    counters: CheckpointResult,
    writer: "ChunkStore.Writer | None" = None,
    progress: Callable[[], None] | None = None,
    external_commit: bool = False,
) -> tuple[Manifest, dict[tuple[str, int], list[int]]]:
    """Compress + write one snapshot and commit (or stage) its manifest.

    Backend-agnostic phase 2: runs on a writer-pool thread (thread backend)
    or inside a forked child (fork backend). Mutates ``counters``
    (chunks/bytes written, chunks reused) as it goes and returns the
    committed manifest plus the per-stream chunk digests for shadow
    backfill. ``progress`` (if given) is called after each leaf so callers
    can stream counters while the image is still being written.

    With ``external_commit`` the image is *staged*, not committed: the
    host's manifest fragment lands as ``hostmeta-h*.msgpack`` and writing
    MANIFEST + COMMIT belongs to the cluster coordinator once every
    participant has acked (two-phase commit; see repro_torch.coord).
    """
    prev_map: dict[tuple, Any] = {}
    if prev is not None:
        for path, lv in prev.leaves.items():
            for s in lv.shards:
                for c in s.chunks:
                    prev_map[(path, tuple(s.start), tuple(s.stop), c.index)] = c

    manifest = Manifest(step=step, skeleton=skeleton, meta=dict(meta))
    digests_out: dict[tuple[str, int], list[int]] = {}
    if writer is None:
        writer = store.writer(step, host)
    try:
        by_path: dict[str, list] = {}
        for (path, ordinal), shard in sorted(snapshot.items()):
            shard = dict(shard)
            shard["ordinal"] = ordinal
            by_path.setdefault(path, []).append(shard)
        for path, (shape, dtype) in shapes_dtypes.items():
            lrec = LeafRecord(path=path, shape=shape, dtype=dtype)
            for shard in by_path.get(path, []):
                srec = ShardRecord(start=shard["start"], stop=shard["stop"])
                shard_digests: list[int] = []
                # digests the shadow already knows (maintained by sync and
                # upload) need not be re-hashed; negative entries are the
                # "unknown / backfill pending" sentinels and are recomputed
                known = shard.get("digests")
                for key, raw in iter_chunks(path, shard["data"], chunk_bytes):
                    if (
                        known is not None
                        and key.index < len(known)
                        and known[key.index] >= 0
                    ):
                        digest = known[key.index]
                    else:
                        digest = chunk_digest_np(raw)
                    shard_digests.append(digest)
                    old = prev_map.get(
                        (path, tuple(srec.start), tuple(srec.stop), key.index)
                    )
                    if (
                        old is not None
                        and old.digest == digest
                        and old.raw_len == len(raw)
                    ):
                        srec.chunks.append(old)
                        counters.chunks_reused += 1
                    else:
                        rec = writer.append(
                            raw, codec, index=key.index, digest=digest
                        )
                        srec.chunks.append(rec)
                        counters.chunks_written += 1
                        counters.bytes_written += rec.comp_len
                lrec.shards.append(srec)
                digests_out[(path, shard["ordinal"])] = shard_digests
            manifest.leaves[path] = lrec
            if progress is not None:
                progress()
    finally:
        writer.close(fsync=fsync)
    manifest.meta.update(
        chunks_written=counters.chunks_written,
        chunks_reused=counters.chunks_reused,
    )
    if external_commit:
        write_hostmeta(store.root, step, host, manifest)
    else:
        # directory durability tracks the payload fsync knob: without the
        # payload bytes being fsynced, fsyncing directory entries buys
        # nothing, and with them it completes the power-failure story
        commit_manifest(store.root, manifest, durable=fsync)
    return manifest, digests_out


# --------------------------------------------------------------------------
# Persist backends (phase 2 strategies)
# --------------------------------------------------------------------------

class PersistBackend:
    """Phase-2 strategy: how a finished snapshot reaches stable storage."""

    name: str = "?"
    # True: the backend reads snapshots from another process, so shadow
    # buffers must live in MAP_SHARED mmap segments that survive os.fork()
    # without COW page duplication (any forking plugin backend wants this)
    wants_shared_buffers: bool = False

    def __init__(self, checkpointer: "ForkedCheckpointer"):
        self.ck = checkpointer

    def submit(self, job: PersistJob) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Wait for in-flight persists and release backend resources."""

    def kill_pending(self) -> None:
        """Forcibly stop in-flight persists (no-op unless the backend owns
        other processes). A rank about to hard-exit on a hung persist
        calls this so no orphan keeps an fd on files a respawned
        incarnation will truncate and rewrite."""


class ThreadPersistBackend(PersistBackend):
    """Writer-pool threads in-process (the pre-fork emulation).

    Codecs release the GIL inside compress, so phase 2 overlaps the train
    loop — but it still shares the parent's scheduler and memory bandwidth.
    """

    name = "thread"

    def __init__(self, checkpointer: "ForkedCheckpointer"):
        super().__init__(checkpointer)
        workers = checkpointer.io_workers or min(8, (os.cpu_count() or 2))
        self._pool = cf.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="crum-writer"
        )

    def submit(self, job: PersistJob) -> None:
        self._pool.submit(self._run, job)

    def _run(self, job: PersistJob) -> None:
        ck, result = self.ck, job.result
        t0 = time.perf_counter()
        try:
            manifest, digests = _persist_image(
                ck.store,
                step=result.step,
                host=ck.host,
                codec=ck.codec,
                chunk_bytes=ck.chunk_bytes,
                fsync=ck.fsync,
                snapshot=job.snapshot,
                skeleton=job.skeleton,
                shapes_dtypes=job.shapes_dtypes,
                prev=job.prev,
                meta=job.meta,
                counters=result,
                external_commit=ck.external_commit,
            )
            for key, d in digests.items():
                job.shadow.set_digests(key, d, generation=job.shadow_gen)
            ck._note_manifest(manifest)
        except Exception as e:  # surfaced at wait()
            result.error = f"{type(e).__name__}: {e}"
        finally:
            result.persist_s = time.perf_counter() - t0
            tr = obs_trace.get()
            if tr is not None:
                tr.complete("ckpt.persist", t0, step=result.step,
                            backend="thread",
                            bytes_written=result.bytes_written,
                            **obs_trace.ctx_args(job.trace_ctx))
            ck._finish_job(job)

    def close(self) -> None:
        self._pool.shutdown(wait=True)


# ---- fork backend pipe protocol: u32-length-prefixed pickles --------------

def _send_msg(f: BinaryIO, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack("<I", len(data)))
    f.write(data)
    f.flush()


def _recv_msg(f: BinaryIO) -> Any | None:
    hdr = f.read(4)
    if len(hdr) < 4:
        return None  # EOF: child exited (or died) after its last message
    (n,) = struct.unpack("<I", hdr)
    data = f.read(n)
    if len(data) < n:
        return None  # truncated: child died mid-message
    return pickle.loads(data)


class ForkPersistBackend(PersistBackend):
    """True copy-on-write persistence: one ``os.fork()`` child per image.

    The paper's mechanism. The snapshot lives in MAP_SHARED mmap segments,
    so the fork costs no copy and the parent's ongoing training never
    triggers COW page duplication of the image. The child owns the whole
    compress+write+commit path (its own GIL, its own scheduler slice) and
    streams counters and the committed manifest back over a pipe; a
    supervisor thread reaps it and surfaces any failure — including a raw
    non-zero exit — as ``CheckpointResult.error``.
    """

    name = "fork"
    wants_shared_buffers = True

    def __init__(self, checkpointer: "ForkedCheckpointer"):
        if not hasattr(os, "fork"):
            raise RuntimeError(
                "persist backend 'fork' requires os.fork (POSIX); "
                "use backend='thread' on this platform"
            )
        super().__init__(checkpointer)
        self._cond = threading.Condition()
        self._live: dict[int, threading.Thread] = {}  # pid -> supervisor
        self._closed = False

    def submit(self, job: PersistJob) -> None:
        ck = self.ck
        # One continuous hold of _cond covers gate-check, pipe, fork and
        # registration, so (a) two concurrent submits can't both pass an
        # empty _live and overshoot max_pending — the paper's at-most-N
        # live children discipline — and (b) no sibling fork can run while
        # our write fd is open and leak it into an unrelated child, which
        # would rob the supervisor of EOF if our child dies silently.
        with self._cond:
            while len(self._live) >= ck.max_pending:
                self._cond.wait()
            if self._closed:
                raise RuntimeError("persist backend is closed")
            # built pre-fork, opened post-fork: child-safe writer handoff
            writer = ck.store.writer(job.result.step, ck.host, lazy=True)
            rfd, wfd = os.pipe()
            with warnings.catch_warnings():
                # Python warns that fork in a threaded process can deadlock;
                # the child never calls into torch or CUDA — it only
                # compresses host memory and writes files — so none of
                # their locks are taken.
                warnings.filterwarnings(
                    "ignore", message=".*fork", category=DeprecationWarning
                )
                pid = os.fork()
            if pid == 0:  # ---- child: persist and report, then _exit ------
                code = 0
                try:
                    os.close(rfd)
                    self._child_main(job, writer, wfd)
                except BaseException:
                    code = 1
                finally:
                    os._exit(code)
            # ---- parent ----------------------------------------------------
            os.close(wfd)
            t = threading.Thread(
                target=self._supervise, args=(pid, rfd, job),
                name=f"crum-fork-supervisor-{job.result.step}", daemon=True,
            )
            self._live[pid] = t
        t.start()

    def _child_main(self, job: PersistJob, writer, wfd: int) -> None:
        ck = self.ck
        counters = job.result  # the child's private copy of the result
        out = os.fdopen(wfd, "wb")
        t0 = time.perf_counter()
        err: str | None = None
        manifest = digests = None
        # the child inherits the parent's registry at fork: snapshot now so
        # only what THIS persist adds ships back over the result pipe
        reg_base = obs_metrics.REGISTRY.counters_snapshot()

        def stream_counters() -> None:
            _send_msg(out, {
                "kind": "progress",
                "chunks_written": counters.chunks_written,
                "chunks_reused": counters.chunks_reused,
                "bytes_written": counters.bytes_written,
            })

        try:
            manifest, digests = _persist_image(
                ck.store,
                step=counters.step,
                host=ck.host,
                codec=ck.codec,
                chunk_bytes=ck.chunk_bytes,
                fsync=ck.fsync,
                snapshot=job.snapshot,
                skeleton=job.skeleton,
                shapes_dtypes=job.shapes_dtypes,
                prev=job.prev,
                meta=job.meta,
                counters=counters,
                writer=writer,
                progress=stream_counters,
                external_commit=ck.external_commit,
            )
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
        tr = obs_trace.get()
        if tr is not None:
            # emitted in the forked child: the tracer notices the pid
            # change and writes a shard of its own — the merged timeline
            # shows the COW persist running beside the training steps
            tr.complete("ckpt.persist", t0, step=counters.step,
                        backend="fork", error=err,
                        bytes_written=counters.bytes_written,
                        **obs_trace.ctx_args(job.trace_ctx))
        obs_metrics.REGISTRY.inc("ckpt_fork_persists_total")
        obs_metrics.REGISTRY.inc("ckpt_fork_bytes_written",
                                 counters.bytes_written)
        obs_metrics.REGISTRY.inc("ckpt_fork_chunks_written",
                                 counters.chunks_written)
        final: dict[str, Any] = {
            "kind": "final",
            "error": err,
            "persist_s": time.perf_counter() - t0,
            "chunks_written": counters.chunks_written,
            "chunks_reused": counters.chunks_reused,
            "bytes_written": counters.bytes_written,
            "registry_delta": obs_metrics.counter_delta(
                reg_base, obs_metrics.REGISTRY.counters_snapshot()
            ),
        }
        if err is None:
            final["manifest"] = manifest.to_bytes()
            final["digests"] = digests
        _send_msg(out, final)
        out.close()

    def _supervise(self, pid: int, rfd: int, job: PersistJob) -> None:
        ck, result = self.ck, job.result
        t0 = time.perf_counter()
        final: dict | None = None
        try:
            with os.fdopen(rfd, "rb") as pipe:
                while True:
                    msg = _recv_msg(pipe)
                    if msg is None:
                        break
                    if msg["kind"] == "progress":
                        result.chunks_written = msg["chunks_written"]
                        result.chunks_reused = msg["chunks_reused"]
                        result.bytes_written = msg["bytes_written"]
                    elif msg["kind"] == "final":
                        final = msg
        except Exception as e:
            result.error = f"persist pipe error: {type(e).__name__}: {e}"
        _, status = os.waitpid(pid, 0)
        exit_code = os.waitstatus_to_exitcode(status)
        try:
            if final is not None:
                result.chunks_written = final["chunks_written"]
                result.chunks_reused = final["chunks_reused"]
                result.bytes_written = final["bytes_written"]
                result.persist_s = final["persist_s"]
                # fold the child's counter delta into this process's
                # registry — child metrics ride the pipe they always rode
                obs_metrics.REGISTRY.merge_counters(
                    final.get("registry_delta") or {}
                )
                if final["error"]:
                    result.error = final["error"]
                else:
                    for key, d in final["digests"].items():
                        job.shadow.set_digests(key, d, generation=job.shadow_gen)
                    ck._note_manifest(Manifest.from_bytes(final["manifest"]))
            if result.error is None and final is None:
                result.error = (
                    f"persist child (pid {pid}) died before reporting "
                    f"(exit code {exit_code})"
                )
            elif result.error is None and exit_code != 0:
                result.error = (
                    f"persist child (pid {pid}) exited with code {exit_code}"
                )
        finally:
            if result.persist_s == 0.0:
                result.persist_s = time.perf_counter() - t0
            with self._cond:
                self._live.pop(pid, None)
                self._cond.notify_all()
            ck._finish_job(job)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            threads = list(self._live.values())
        for t in threads:
            t.join()

    def kill_pending(self) -> None:
        import signal

        with self._cond:
            pids = list(self._live)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


_PERSIST_BACKENDS: dict[str, Callable[["ForkedCheckpointer"], PersistBackend]] = {
    ThreadPersistBackend.name: ThreadPersistBackend,
    ForkPersistBackend.name: ForkPersistBackend,
}


def register_persist_backend(
    name: str, factory: Callable[["ForkedCheckpointer"], PersistBackend],
    *, replace: bool = False,
) -> None:
    """Plugin point: later scaling work (multi-host persist, remote object
    stores, incremental GC offload) registers here."""
    if name in _PERSIST_BACKENDS and not replace:
        raise ValueError(f"persist backend {name!r} already registered")
    _PERSIST_BACKENDS[name] = factory


def list_persist_backends() -> list[str]:
    return sorted(_PERSIST_BACKENDS)


def make_persist_backend(name: str, checkpointer: "ForkedCheckpointer") -> PersistBackend:
    try:
        factory = _PERSIST_BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown persist backend {name!r}; have {sorted(_PERSIST_BACKENDS)}"
        ) from None
    return factory(checkpointer)


# --------------------------------------------------------------------------
# The checkpointer
# --------------------------------------------------------------------------

class ForkedCheckpointer:
    def __init__(
        self,
        store: ChunkStore,
        *,
        codec: str = DEFAULT_CODEC,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        io_workers: int | None = None,
        max_pending: int = 1,
        incremental: bool = True,
        host: int = 0,
        fsync: bool = False,
        backend: str = "thread",
        external_commit: bool = False,
        dirty_source: Any = None,
        timings: Timings | None = None,
    ):
        self.store = store
        self.codec = codec
        self.chunk_bytes = int(chunk_bytes)
        self.incremental = incremental
        self.host = host
        self.fsync = fsync
        self.io_workers = io_workers
        self.max_pending = max(1, int(max_pending))
        # external_commit: persist writes hostmeta-h*.msgpack only; the
        # cluster coordinator merges hostmetas and owns MANIFEST + COMMIT.
        # Incremental deltas then base on *cluster-committed* images only:
        # a staged manifest becomes the delta base via commit_confirmed(),
        # never implicitly (an aborted round's chunks may be overwritten by
        # the retry).
        self.external_commit = external_commit
        # dirty_source: page-granular dirty history (a ManagedSpace adapter:
        # tick() + dirty_chunk_marks_since(tick, chunk_bytes)). When set,
        # phase 1 marks exactly the chunks written since THIS buffer's last
        # sync — page-delta sync instead of whole-leaf digest scans.
        self.dirty_source = dirty_source
        self.timings = timings or Timings()
        self._pending: list[CheckpointResult] = []
        self._prev_manifest: Manifest | None = None
        self._staged: dict[int, Manifest] = {}  # step -> unconfirmed manifest
        self._lock = threading.Lock()
        self.backend = make_persist_backend(backend, self)
        self._buffers = [
            ShadowStateManager(
                chunk_bytes=chunk_bytes,
                defer_first_digests=True,  # persist backfills via set_digests
                shared_buffers=self.backend.wants_shared_buffers,
                timings=self.timings,
            )
            for _ in range(self.max_pending + 1)
        ]
        # one condition variable guards buffer ownership: acquisition is a
        # claim-under-lock, not the old busy-event scan that let two waiters
        # race for the buffer freed by the oldest pending checkpoint
        self._buf_cond = threading.Condition()
        self._buf_busy = [False] * len(self._buffers)
        # per-buffer dirty-source watermark: buffer i's shadow content is
        # current as of tick _buf_tick[i]; each buffer diffs against its OWN
        # last sync (double buffering means buffers alternate checkpoints)
        self._buf_tick = [-1] * len(self._buffers)
        # steps whose payload an in-flight (uncommitted) delta persist still
        # references — GC must not collect them out from under the child
        self._inflight_bases: dict[int, set[int]] = {}
        # one thread makes the first syncs' buffers ahead (prepare)
        self._ahead_pool: cf.ThreadPoolExecutor | None = None

    def prepare(self, state: Any) -> None:
        """Make every snapshot buffer's first-sync buffers for ``state``'s
        layout on a background thread, in the order the checkpoints will
        take them, so a first sync's blocking is its copy and not its page
        faults (:meth:`ShadowStateManager.prepare`). Call it once the
        state exists, before the first checkpoint."""
        if self._ahead_pool is None:
            self._ahead_pool = cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="crum-prefault")
        for shadow in self._buffers:
            shadow.prepare(state, self._ahead_pool)

    # -- the checkpoint entry point ------------------------------------------
    def save_async(
        self,
        step: int,
        state: Any,
        *,
        meta: dict | None = None,
        trace_ctx: dict | None = None,
    ) -> CheckpointResult:
        """Phase 1 inline (blocking, fast); phase 2 on the persist backend.

        With a ``dirty_source``, phase 1 marks exactly the chunks written
        since this buffer's last sync and fetches them without a digest
        compare. ``trace_ctx`` is the caller's round context: phase 1
        records a child span of it and the persist (even across a fork) a
        grandchild."""
        result = CheckpointResult(step=step, blocking_s=0.0)
        with self.timings.measure("ckpt/blocking") as _:
            t0 = time.perf_counter()
            # pick a free snapshot buffer (waits if all are persisting)
            buf_i = self._acquire_buffer()
            shadow = self._buffers[buf_i]
            marks = None
            now_tick = None
            if self.dirty_source is not None:
                # capture the tick BEFORE reading state: a write racing the
                # capture lands after it and stays dirty for the next sync
                now_tick = self.dirty_source.tick()
                marks = self.dirty_source.dirty_chunk_marks_since(
                    self._buf_tick[buf_i], self.chunk_bytes
                )
            with self.timings.measure("ckpt/drain"):
                drain(state)
            with self.timings.measure("ckpt/snapshot"):
                shadow.mark_device_step(marks)
                t_sync = time.perf_counter()
                stats = shadow.sync(state)
                result.sync_us = (time.perf_counter() - t_sync) * 1e6
            result.digest_us = stats.digest_us
            result.fetch_us = stats.fetch_us
            result.alloc_us = stats.alloc_us
            result.prefault_us = stats.prefault_us
            result.buffers_ahead = stats.buffers_ahead
            if now_tick is not None:
                self._buf_tick[buf_i] = now_tick
            skeleton = build_skeleton(state)
            shapes_dtypes = {
                p: (leaf_shape(l), dtype_name(l))
                for p, l in flatten_with_paths(state)[0].items()
            }
            result.bytes_snapshot = stats.bytes_fetched
            result.chunks_synced = stats.chunks_fetched
            result.chunks_clean = stats.chunks_total - stats.chunks_fetched
            result.bytes_skipped = stats.bytes_total - stats.bytes_fetched
            result.blocking_s = time.perf_counter() - t0
            pctx = obs_trace.child_span(trace_ctx)
            tr = obs_trace.get()
            if tr is not None:
                tr.complete("ckpt.phase1", t0, step=step,
                            chunks_synced=result.chunks_synced,
                            bytes_snapshot=result.bytes_snapshot,
                            **obs_trace.ctx_args(pctx))

        job = PersistJob(
            result=result,
            buf_index=buf_i,
            shadow=shadow,
            snapshot=shadow.snapshot(),
            skeleton=skeleton,
            shapes_dtypes=shapes_dtypes,
            prev=self._prev_manifest if self.incremental else None,
            meta=meta or {},
            shadow_gen=shadow.generation,
            trace_ctx=obs_trace.child_span(pctx),
        )
        # phase 2 (possibly a fork child) reads this buffer generation: a
        # re-registration must retire, not release, it until the job is done
        shadow.pin()
        self._reap()
        with self._lock:
            self._pending.append(result)
            if job.prev is not None:
                # the delta being written references the base image's chunk
                # payloads: GC must keep them until this persist resolves
                self._inflight_bases[id(job)] = (
                    {job.prev.step} | referenced_steps(job.prev)
                )
        try:
            self.backend.submit(job)
        except BaseException as e:
            # never strand the claimed buffer or leave a result that can't
            # complete (close()/wait_all() would hang on it)
            result.error = f"persist submit failed: {type(e).__name__}: {e}"
            with self._lock:
                self._inflight_bases.pop(id(job), None)
            shadow.unpin()
            self._release_buffer(buf_i)
            result.done.set()
            raise
        return result

    # -- buffer ownership ------------------------------------------------------
    def _acquire_buffer(self) -> int:
        with self._buf_cond:
            while True:
                for i, busy in enumerate(self._buf_busy):
                    if not busy:
                        self._buf_busy[i] = True
                        return i
                # all buffers persisting: wait for a release (bounded pipeline)
                self._buf_cond.wait()

    def _release_buffer(self, i: int) -> None:
        with self._buf_cond:
            self._buf_busy[i] = False
            self._buf_cond.notify_all()

    def _reap(self) -> None:
        with self._lock:
            self._pending = [r for r in self._pending if not r.done.is_set()]

    # -- backend callbacks -------------------------------------------------------
    def _note_manifest(self, manifest: Manifest) -> None:
        with self._lock:
            if self.external_commit:
                self._staged[manifest.step] = manifest
                return
            if self._prev_manifest is None or manifest.step >= self._prev_manifest.step:
                self._prev_manifest = manifest

    # -- external (coordinator-driven) commit ------------------------------------
    def commit_confirmed(self, step: int) -> None:
        """Coordinator committed ``step``: promote it to the delta base."""
        with self._lock:
            m = self._staged.pop(step, None)
            if m is not None and (
                self._prev_manifest is None or m.step >= self._prev_manifest.step
            ):
                self._prev_manifest = m

    def commit_aborted(self, step: int) -> None:
        """Coordinator aborted ``step``: its staged image is never a base."""
        with self._lock:
            self._staged.pop(step, None)

    def _finish_job(self, job: PersistJob) -> None:
        """Common phase-2 epilogue: timing, buffer release, completion."""
        self.timings.add("ckpt/persist", job.result.persist_s)
        obs_metrics.absorb_checkpoint_result(job.result)
        with self._lock:
            self._inflight_bases.pop(id(job), None)
        job.shadow.unpin()
        self._release_buffer(job.buf_index)
        job.result.done.set()

    def inflight_delta_bases(self) -> set[int]:
        """Steps an uncommitted in-flight delta persist still reads from.

        ``trainer._gc`` passes these to the policy as extra pins: without
        them a GC planned between submit and commit could collect a base
        image whose chunks the pending manifest will reference.
        """
        with self._lock:
            out: set[int] = set()
            for bases in self._inflight_bases.values():
                out |= bases
            return out

    # -- lifecycle ---------------------------------------------------------------
    def wait_all(self, timeout: float | None = None) -> list[CheckpointResult]:
        with self._lock:
            pending = list(self._pending)
        return [r.wait(timeout) for r in pending]

    def pending(self) -> int:
        self._reap()
        with self._lock:
            return len(self._pending)

    def close(self) -> None:
        """Drain in-flight persists (without raising on failed ones) and
        release backend resources."""
        with self._lock:
            pending = list(self._pending)
        for r in pending:
            r.done.wait()
        self.backend.close()
        if self._ahead_pool is not None:
            for shadow in self._buffers:
                shadow.drop_ahead()
            self._ahead_pool.shutdown(wait=True, cancel_futures=True)

    # -- synchronous baseline (the paper's "naive" strategy) -----------------------
    def save_sync(self, step: int, state: Any, *, meta: dict | None = None) -> CheckpointResult:
        """Naive strategy: the application blocks for the full write."""
        r = self.save_async(step, state, meta=meta)
        r.wait()
        r.blocking_s += r.persist_s
        return r
