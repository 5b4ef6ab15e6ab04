"""Data plane: per-leaf byte tables shared (or streamed) app <-> proxy.

The control pipe carries only tiny MessagePack frames; bulk state crosses
process boundaries through a :class:`StateTable` — the allocation table
(``layout``: path -> file, byte size, shape, dtype) plus one byte buffer
per device-state leaf. Two concrete tables exist:

``SegmentTable``
    file-backed MAP_SHARED mmap segments (preferring ``/dev/shm`` so the
    pages are RAM-backed), mapped by both the application and the proxy.
    Because the files outlive any one proxy incarnation, a respawned local
    proxy attaches the same pages and replay's data push is a segment
    read, not a transfer.

``PrivateTable``
    plain process-private numpy buffers with the identical read/write API:
    each side's terminal of the *streamed* transport
    (``repro_torch.remote.transport``).

Either table hands ``factory`` to a ``ShadowStateManager(segment_factory=
...)`` so shadow buffers ARE the table's buffers.

Every hop is a byte copy: leaves are written as their C-order bytes and
read back by viewing those bytes. The layout's dtype strings are the
reference's (``"bfloat16"``), so either package attaches the other's
table. numpy has no bfloat16 type without ``ml_dtypes``, so
:meth:`StateTable.read_state` returns bfloat16 leaves as CPU tensors over
copies of the table's bytes and every other leaf as a numpy array, as the
reference does.
"""
from __future__ import annotations

import mmap
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.obs.leakcheck import shm_name_prefix
from repro_torch.utils.dtypes import dtype_name, leaf_nbytes, leaf_shape
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes, unflatten_from_paths


def default_segment_dir(prefix: str | None = None) -> str:
    """A fresh directory for segment files, RAM-backed when possible.

    The default name, ``crum-proxy-<pid>-<ancestors>-...``, carries the
    creating pid and its ancestors, so ``obs.leakcheck`` counts the
    directory as its run's even after the run lets go of it and its creator
    is killed.
    """
    base = "/dev/shm" if os.path.isdir("/dev/shm") and os.access(
        "/dev/shm", os.W_OK
    ) else None
    return tempfile.mkdtemp(prefix=prefix or shm_name_prefix("proxy"), dir=base)


class SharedSegment:
    """One MAP_SHARED mapping of one segment file."""

    def __init__(self, path: str, nbytes: int, *, create: bool):
        self.path = path
        self.nbytes = int(nbytes)
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create and os.fstat(fd).st_size != self.nbytes:
                os.ftruncate(fd, self.nbytes)
            if self.nbytes > 0:
                self._mm = mmap.mmap(fd, self.nbytes, mmap.MAP_SHARED)
            else:  # zero-length leaves still need a (trivial) buffer
                self._mm = None
        finally:
            os.close(fd)  # the mapping keeps the pages; the fd is done

    def view(self) -> np.ndarray:
        if self._mm is None:
            return np.empty(0, np.uint8)
        return np.frombuffer(self._mm, dtype=np.uint8, count=self.nbytes)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:  # a numpy view is still alive; GC frees it
                pass
            self._mm = None


def _leaf_from_bytes(raw: np.ndarray, spec: dict) -> Any:
    """A leaf of the layout's dtype and shape over the bytes ``raw``."""
    shape = tuple(spec["shape"])
    if spec["dtype"] == "bfloat16":
        if not raw.nbytes:  # an empty byte view refuses a dtype view
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    return raw.view(np.dtype(spec["dtype"])).reshape(shape)


class StateTable:
    """Layout + chunk/state access over one byte buffer per leaf.

    The application side *creates* it from a state tree (recording the
    treedef so synced state can be rebuilt); the proxy side *attaches* to
    an existing layout. Storage is subclass-provided via :meth:`view`.
    """

    kind = "?"

    def __init__(self, workdir: str | None = None):
        self.workdir = workdir
        self.layout: dict[str, dict[str, Any]] = {}
        self._treedef = None
        # cumulative bytes this side has written INTO the table — the
        # data-plane half of "bytes on the wire"
        self.bytes_written = 0

    # -- storage (subclass) ----------------------------------------------------
    def view(self, path: str) -> np.ndarray:
        """The u8 byte buffer backing one leaf."""
        raise NotImplementedError

    def _alloc(self, path: str, fname: str, nbytes: int) -> np.ndarray:
        """Create storage for one leaf; returns its u8 view."""
        raise NotImplementedError

    # -- application side ------------------------------------------------------
    @classmethod
    def create(cls, state: Any, **kw) -> "StateTable":
        """Allocate one buffer per leaf and fill it with the leaf bytes."""
        t = cls(**kw)
        flat, treedef = flatten_with_paths(state)
        t._treedef = treedef
        for i, (path, leaf) in enumerate(flat.items()):
            nbytes = leaf_nbytes(leaf)
            fname = f"seg-{i:04d}.bin"
            t.layout[path] = {
                "file": fname,
                "nbytes": nbytes,
                "shape": [int(d) for d in leaf_shape(leaf)],
                "dtype": dtype_name(leaf),
            }
            buf = t._alloc(path, fname, nbytes)
            if nbytes:
                buf[:] = leaf_bytes(leaf)
                t.bytes_written += nbytes
        return t

    def _checked_bytes(self, path: str, leaf: Any) -> np.ndarray:
        spec = self.layout.get(path)
        if spec is None:
            raise KeyError(f"leaf {path!r} not in table layout")
        nbytes = leaf_nbytes(leaf)
        if nbytes != spec["nbytes"]:
            raise ValueError(
                f"leaf {path!r} is {nbytes}B, buffer is "
                f"{spec['nbytes']}B — re-register for shape changes"
            )
        return leaf_bytes(leaf)

    def write_state(self, state: Any) -> int:
        """Overwrite buffer content with ``state``'s bytes; returns bytes."""
        flat, _ = flatten_with_paths(state)
        total = 0
        for path, leaf in flat.items():
            raw = self._checked_bytes(path, leaf)
            if raw.nbytes:
                self.view(path)[:] = raw
            total += int(raw.nbytes)
        self.bytes_written += total
        return total

    def write_chunks(
        self, state: Any, chunks: dict[str, list[int]], chunk_bytes: int
    ) -> int:
        """Overwrite only the given chunk byte-ranges of each leaf's
        buffer — the delta half of a chunk-delta UPLOAD. Returns bytes
        actually written (what crossed the data plane)."""
        flat, _ = flatten_with_paths(state)
        cb = int(chunk_bytes)
        total = 0
        for path, idxs in chunks.items():
            if path not in self.layout:
                raise KeyError(f"leaf {path!r} not in table layout")
            raw = self._checked_bytes(path, flat[path])
            if not idxs or not raw.nbytes:
                continue
            view = self.view(path)
            for i in idxs:
                lo, hi = i * cb, min(int(raw.nbytes), (i + 1) * cb)
                if i < 0 or lo >= hi:
                    raise IndexError(f"chunk {i} outside leaf {path!r}")
                view[lo:hi] = raw[lo:hi]
                total += hi - lo
        self.bytes_written += total
        return total

    def write_range(self, path: str, lo: int, data) -> int:
        """Splice raw bytes at offset ``lo`` of one leaf's buffer — the
        receive half of a streamed chunk frame. Returns bytes written."""
        spec = self.layout.get(path)
        if spec is None:
            raise KeyError(f"leaf {path!r} not in table layout")
        data = np.frombuffer(data, np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)
        ) else np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        hi = lo + data.nbytes
        if lo < 0 or hi > spec["nbytes"]:
            raise ValueError(
                f"range [{lo}, {hi}) outside leaf {path!r} "
                f"({spec['nbytes']}B)"
            )
        if data.nbytes:
            self.view(path)[lo:hi] = data
            self.bytes_written += int(data.nbytes)
        return int(data.nbytes)

    def chunk_bytes_of(self, path: str, index: int, chunk_bytes: int) -> np.ndarray:
        """The current bytes of one chunk (a buffer view, zero-copy)."""
        nbytes = self.layout[path]["nbytes"]
        lo, hi = index * chunk_bytes, min(nbytes, (index + 1) * chunk_bytes)
        if index < 0 or lo >= hi:
            raise IndexError(f"chunk {index} outside leaf {path!r}")
        return self.view(path)[lo:hi]

    def all_chunks(self, chunk_bytes: int) -> dict[str, list[int]]:
        """{path: every chunk index} — the full-state chunk map."""
        cb = int(chunk_bytes)
        return {
            p: list(range(-(-s["nbytes"] // cb))) if s["nbytes"] else []
            for p, s in self.layout.items()
        }

    def read_state(self) -> Any:
        """Rebuild the state tree from current buffer content (copies)."""
        if self._treedef is None:
            raise RuntimeError("read_state() needs the creating side's treedef")
        leaves = {
            path: _leaf_from_bytes(self.view(path).copy(), spec)
            for path, spec in self.layout.items()
        }
        return unflatten_from_paths(self._treedef, leaves)

    # -- proxy side ------------------------------------------------------------
    @classmethod
    def attach(cls, layout: dict[str, dict], **kw) -> "StateTable":
        t = cls(**kw)
        t.layout = {p: dict(s) for p, s in layout.items()}
        return t

    # -- both sides ------------------------------------------------------------
    def factory(self, key: tuple[str, int], nbytes: int) -> np.ndarray:
        """``ShadowStateManager.segment_factory`` adapter (shard 0 only —
        proxy device state is one stream per leaf)."""
        path, ordinal = key
        if ordinal != 0:
            raise ValueError("proxy state tables are single-shard (ordinal 0)")
        spec = self.layout[path]
        if int(nbytes) != spec["nbytes"]:
            raise ValueError(
                f"shadow stream {key} wants {nbytes}B, buffer holds "
                f"{spec['nbytes']}B"
            )
        return self.view(path)

    def total_bytes(self) -> int:
        return sum(s["nbytes"] for s in self.layout.values())

    def close(self, *, unlink: bool = False) -> None:
        pass


class SegmentTable(StateTable):
    """File-backed MAP_SHARED segments — the zero-copy local data plane."""

    kind = "segment"

    def __init__(self, workdir: str | None = None):
        owns = workdir is None
        super().__init__(workdir or default_segment_dir())
        self._segments: dict[str, SharedSegment] = {}
        self._owns_dir = owns

    def _alloc(self, path: str, fname: str, nbytes: int) -> np.ndarray:
        seg = SharedSegment(
            os.path.join(self.workdir, fname), nbytes, create=True
        )
        self._segments[path] = seg
        return seg.view()

    @classmethod
    def attach(cls, workdir: str, layout: dict[str, dict]) -> "SegmentTable":
        return super().attach(layout, workdir=workdir)

    def view(self, path: str) -> np.ndarray:
        seg = self._segments.get(path)
        if seg is None:
            spec = self.layout[path]
            seg = SharedSegment(
                os.path.join(self.workdir, spec["file"]),
                spec["nbytes"],
                create=False,
            )
            self._segments[path] = seg
        return seg.view()

    def close(self, *, unlink: bool = False) -> None:
        for seg in self._segments.values():
            seg.close()
        self._segments.clear()
        if unlink:
            if self._owns_dir:
                shutil.rmtree(self.workdir, ignore_errors=True)
            else:
                for spec in self.layout.values():
                    try:
                        os.unlink(os.path.join(self.workdir, spec["file"]))
                    except OSError:
                        pass


class PrivateTable(StateTable):
    """Process-private buffers — each side's terminal of the streamed
    transport. Nothing is shared: bytes arrive/leave as chunk frames."""

    kind = "private"

    def __init__(self, workdir: str | None = None):
        super().__init__(workdir)
        self._buffers: dict[str, np.ndarray] = {}

    def _alloc(self, path: str, fname: str, nbytes: int) -> np.ndarray:
        buf = np.zeros(nbytes, np.uint8)
        self._buffers[path] = buf
        return buf

    def view(self, path: str) -> np.ndarray:
        buf = self._buffers.get(path)
        if buf is None:
            buf = np.zeros(self.layout[path]["nbytes"], np.uint8)
            self._buffers[path] = buf
        return buf

    def close(self, *, unlink: bool = False) -> None:
        self._buffers.clear()
