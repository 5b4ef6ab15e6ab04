"""ChunkStore — per-host chunk payload files + read path + GC.

Each host appends its compressed chunks to a single ``data-h<host>.bin``
per checkpoint step (one sequential stream per host: the I/O pattern the
paper's forked child produces). Reads are random-access by (file, offset,
comp_len) from the manifest, with a small decompression cache so elastic
restore does not decompress a chunk once per overlapping target shard.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict

from repro_torch.chaos.faults import CHAOS_ENV, check_disk_quota
from repro_torch.checkpoint.codecs import get_codec
from repro_torch.checkpoint.manifest import ChunkRecord, step_dir


def host_data_file(step: int, host: int) -> str:
    """Path of a host's payload file, relative to the checkpoint root."""
    return os.path.join(f"step_{step:08d}", f"data-h{host:04d}.bin")


class ChunkStore:
    def __init__(self, root: str, *, cache_chunks: int = 256):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._cache: OrderedDict[tuple, bytes] = OrderedDict()
        self._cache_max = cache_chunks
        self._lock = threading.Lock()
        self.bytes_read = 0
        self.chunks_read = 0

    # -- write path ---------------------------------------------------------
    class Writer:
        """Sequential appender for one host's payload file.

        With ``lazy=True`` construction records only the target path and the
        file descriptor is opened on first ``append``. This is the child-safe
        handoff for the fork persist backend: the parent builds the Writer
        (cheap, no fd) before ``os.fork()`` and only the child ever opens the
        file, so parent and child never share an fd offset.
        """

        def __init__(self, store: "ChunkStore", step: int, host: int,
                     *, lazy: bool = False):
            self.host = int(host)
            self.relpath = host_data_file(step, host)
            self._abspath = os.path.join(store.root, self.relpath)
            self._f = None
            self._off = 0
            if not lazy:
                self._open()

        def _open(self) -> None:
            os.makedirs(os.path.dirname(self._abspath), exist_ok=True)
            self._f = open(self._abspath, "wb")

        def append(self, raw: bytes, codec_name: str, *, index: int,
                   digest: int) -> ChunkRecord:
            if self._f is None:
                self._open()
            comp = get_codec(codec_name).compress(raw)
            if os.environ.get(CHAOS_ENV):
                # chaos shim: an armed disk_full fault turns this append
                # into ENOSPC mid-persist (one environment lookup otherwise)
                check_disk_quota(self.host, len(comp), self._off)
            rec = ChunkRecord(
                index=index, raw_len=len(raw), digest=digest,
                codec=codec_name, file=self.relpath,
                file_offset=self._off, comp_len=len(comp),
            )
            self._f.write(comp)
            self._off += len(comp)
            return rec

        def close(self, *, fsync: bool = True) -> None:
            if self._f is None:  # lazy writer that never wrote
                return
            self._f.flush()
            if fsync:
                os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def writer(self, step: int, host: int = 0, *, lazy: bool = False
               ) -> "ChunkStore.Writer":
        return ChunkStore.Writer(self, step, host, lazy=lazy)

    # -- read path ------------------------------------------------------------
    def read_chunk(self, rec: ChunkRecord) -> bytes:
        key = (rec.file, rec.file_offset, rec.comp_len)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        with open(os.path.join(self.root, rec.file), "rb") as f:
            f.seek(rec.file_offset)
            comp = f.read(rec.comp_len)
        if len(comp) != rec.comp_len:
            raise IOError(
                f"short read for {rec.file}@{rec.file_offset}: "
                f"{len(comp)} < {rec.comp_len}"
            )
        raw = get_codec(rec.codec).decompress(comp)
        if len(raw) != rec.raw_len:
            raise IOError(f"decompressed length mismatch for {rec.file}")
        with self._lock:
            self.bytes_read += len(raw)
            self.chunks_read += 1
            self._cache[key] = raw
            while len(self._cache) > self._cache_max:
                self._cache.popitem(last=False)
        return raw

    # -- garbage collection ----------------------------------------------------
    def gc(self, keep_steps: list[int], *, pin_referenced: bool = True) -> list[int]:
        """Delete committed step dirs not in ``keep_steps``.

        Never deletes a step that a surviving delta manifest references.
        Policy callers already pass the transitive closure (see
        policy.gc_keep), but the store re-derives it itself
        (``pin_referenced``) as a safety net: a caller with a naive keep
        list — or a manifest committed between the caller's plan and this
        collection — must not strand an incremental chain. Safe against a
        concurrent collector on the same root (two trainers, or trainer +
        cluster coordinator): a step another GC got to first is simply
        skipped.
        """
        from repro_torch.checkpoint.manifest import (
            committed_steps,
            load_manifest_if_committed,
            referenced_steps,
        )
        removed = []
        keep = set(keep_steps)
        committed = committed_steps(self.root)
        if pin_referenced:
            # closure over the manifests that will survive: anything they
            # reference survives too (and transitively its own references)
            frontier = [s for s in committed if s in keep]
            while frontier:
                m = load_manifest_if_committed(self.root, frontier.pop())
                if m is None:
                    continue
                for ref in referenced_steps(m):
                    if ref not in keep:
                        keep.add(ref)
                        frontier.append(ref)
        for s in committed:
            if s in keep:
                continue
            d = step_dir(self.root, s)
            try:
                # remove COMMIT first so a crash mid-GC leaves an uncommitted
                # (hence invisible) directory rather than a corrupt one.
                os.remove(os.path.join(d, "COMMIT"))
            except FileNotFoundError:
                continue  # a racing collector owns this step now
            try:
                for name in os.listdir(d):
                    try:
                        os.remove(os.path.join(d, name))
                    except FileNotFoundError:
                        pass
                os.rmdir(d)
            except (FileNotFoundError, NotADirectoryError):
                pass
            removed.append(s)
        return removed
