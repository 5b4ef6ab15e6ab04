"""ManagedSpace — the managed (UVM) address space backing a state tree.

The public face of the paging subsystem. One space owns:

  - a host backing buffer per leaf (the managed allocation): one CPU uint8
    tensor holding the leaf's bytes, padded to whole pages — pageable host
    memory, mapped on Linux with ``MADV_DONTFORK``: the fork persist child
    reads only the shadow, so it gets no copy of the backing, and the
    pager's write-backs while a child persists take no copy-on-write
    faults,
  - one :class:`PageTable` per leaf (residency / dirty / access bits),
  - one :class:`DeviceArena` bounded by ``device_capacity_bytes`` on
    ``device`` — the hard budget that makes oversubscription mean
    something,
  - the :class:`Pager` that migrates pages on fault and writes dirty
    victims back on eviction.

Access model (the reference's, ``repro.uvm.space``):

    read_leaf / read_state    device access: faults every touched page in
                              (windowed, pinned, budget-respecting) and
                              returns the leaf assembled from the frames,
                              a tensor on the arena's device — what the
                              step's kernels see (the reference returns
                              host arrays that jit places later).
    write_leaf / write_state  device write access: write-allocates frames
                              (no stale h2d copy), marks wb_dirty and
                              stamps the page's write_tick.
    peek_leaf / peek_state    coherent host read WITHOUT migration (the
                              cudaMemcpy-from-managed path): host backing
                              overlaid with any newer device frames, as CPU
                              tensors. The checkpoint sync reads through
                              this.
    load_leaf / load_state    host overwrite (restore/upload): device
                              frames are invalidated (superseded, not
                              dropped), all pages become epoch-dirty.

A tensor leaf reads back as a tensor (on the arena's device, or on the CPU
for a peek); a numpy leaf reads back as a numpy array, so host step
programs keep their types. A meta tensor registers its shape and dtype
with zero bytes (a proxy registers the structure an upload fills).

Dirty history is tick-based, not a single clearable bit: every write
stamps ``write_tick``; ``dirty_chunk_marks_since(tick)`` answers "which
checkpoint chunks changed after T?" for any T, so multiple shadow buffers
(the forked checkpointer's double buffering) can each diff against their
own last-sync tick without stepping on each other.
"""
from __future__ import annotations

import mmap
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.utils.dtypes import byte_view, dtype_name
from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths
from repro_torch.uvm.advice import Advice
from repro_torch.uvm.pagetable import PageTable, Residency
from repro_torch.uvm.pager import (
    DeviceArena,
    Pager,
    PagingStats,
    consecutive,
    make_eviction_policy,
)

DEFAULT_PAGE_BYTES = 64 << 10  # 64 KiB — x86 UVM's effective fault granule


def _leaf_u8(leaf: Any) -> torch.Tensor:
    """A leaf's C-order bytes as a flat uint8 tensor (where they live)."""
    if isinstance(leaf, torch.Tensor):
        return byte_view(leaf)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8))


def _host_buffer(nbytes: int) -> torch.Tensor:
    """A zeroed CPU uint8 buffer for a region's host backing: an anonymous
    private mapping a forked child does not inherit (``MADV_DONTFORK``)
    where the platform has it."""
    if nbytes and hasattr(mmap, "MADV_DONTFORK"):
        mm = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
        mm.madvise(mmap.MADV_DONTFORK)
        return torch.frombuffer(mm, dtype=torch.uint8)  # holds mm alive
    return torch.zeros(nbytes, dtype=torch.uint8)


class _Region:
    __slots__ = ("path", "shape", "dtype", "dtype_name", "is_tensor", "nbytes",
                 "host_t", "host", "host2d", "table")

    def __init__(self, path: str, leaf: Any, page_bytes: int):
        self.path = path
        self.is_tensor = isinstance(leaf, torch.Tensor)
        if self.is_tensor:
            self.shape = tuple(leaf.shape)
            self.dtype = leaf.dtype
            nbytes = leaf.numel() * leaf.element_size()
        else:
            leaf = np.asarray(leaf)
            self.shape = tuple(leaf.shape)
            self.dtype = leaf.dtype
            nbytes = int(leaf.nbytes)
        self.dtype_name = dtype_name(leaf)
        self.nbytes = nbytes
        self.table = PageTable(path, nbytes, page_bytes)
        self.host_t = _host_buffer(self.table.n_pages * page_bytes)
        if nbytes and not (self.is_tensor and leaf.device.type == "meta"):
            self.host_t[:nbytes].copy_(_leaf_u8(leaf))
        self.host = self.host_t[:nbytes].numpy()  # the leaf's bytes
        self.host2d = self.host_t.view(self.table.n_pages, page_bytes)

    def as_leaf(self, raw: torch.Tensor) -> Any:
        """Bytes -> this leaf's type: a tensor where they are, or numpy."""
        if self.is_tensor:
            if raw.numel() == 0:
                return torch.empty(self.shape, dtype=self.dtype, device=raw.device)
            return raw.view(self.dtype).reshape(self.shape)
        return raw.cpu().numpy().view(self.dtype).reshape(self.shape)

    def check(self, leaf: Any, what: str) -> None:
        n = (leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
             else int(np.asarray(leaf).nbytes))
        if n != self.nbytes or dtype_name(leaf) != self.dtype_name:
            raise ValueError(
                f"{what} of {n}B {dtype_name(leaf)} into leaf {self.path!r} "
                f"({self.nbytes}B {self.dtype_name}) — re-register for reshapes"
            )


class ManagedSpace:
    def __init__(
        self,
        device_capacity_bytes: int,
        *,
        page_bytes: int = DEFAULT_PAGE_BYTES,
        eviction_policy: str = "lru",
        fault_window_pages: int = 32,
        promote_threshold: int = 0,
        promote_window: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device_capacity_bytes = int(device_capacity_bytes)
        self.page_bytes = int(page_bytes)
        self.policy_name = eviction_policy
        # access-counter promotion (Volta-style): with threshold N > 1, a
        # HOST page *read* is served remotely (no migration) until it has
        # been read N times within ``promote_window`` ticks — only then is
        # it promoted to a device frame. 0/1 = classic first-touch
        # migration. Writes always migrate (write-allocate).
        self.promote_threshold = int(promote_threshold)
        self.promote_window = int(promote_window)
        self.arena = DeviceArena(self.device_capacity_bytes, self.page_bytes,
                                 device=device)
        self.device = self.arena.device
        self.pager = Pager(
            arena=self.arena,
            policy=make_eviction_policy(eviction_policy, self.arena.n_frames),
            host_of=self._host_of,
        )
        # windowed access: pages pinned per window so faulting page k+1
        # cannot evict page k before its bytes are copied out
        self.fault_window = max(1, min(int(fault_window_pages), self.arena.n_frames))
        self._regions: dict[str, _Region] = {}
        self._treedef = None
        self._tick = 0

    # -- plumbing ---------------------------------------------------------------
    def _host_of(self, table: PageTable) -> torch.Tensor:
        return self._regions[table.path].host2d

    def table(self, path: str) -> PageTable:
        return self._regions[path].table

    def paths(self) -> list[str]:
        return list(self._regions)

    @property
    def stats(self) -> PagingStats:
        return self.pager.stats

    def stats_dict(self) -> dict:
        d = self.pager.stats.as_dict()
        d.update(
            device_capacity_bytes=self.device_capacity_bytes,
            page_bytes=self.page_bytes,
            policy=self.policy_name,
            promote_threshold=self.promote_threshold,
            resident_bytes=self.device_bytes_resident(),
            total_bytes=self.total_bytes(),
        )
        return d

    def tick(self) -> int:
        """Current write clock; writes after a reader captures this value
        are guaranteed a strictly larger ``write_tick``."""
        return self._tick

    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self._regions.values())

    def device_bytes_resident(self) -> int:
        return self.arena.resident_frames * self.page_bytes

    def oversubscription_ratio(self) -> float:
        cap = self.device_capacity_bytes
        return (self.total_bytes() / cap) if cap else float("inf")

    # -- registration -----------------------------------------------------------
    def register(self, state: Any) -> None:
        """Back every leaf of ``state`` with a managed region.

        Content starts HOST-resident (pages migrate on first device
        access) and epoch-dirty relative to any tick before registration,
        so a checkpoint consumer that has never synced sees everything.
        """
        flat, treedef = flatten_with_paths(state)
        if self.arena.resident_frames:
            for r in self._regions.values():
                self.pager.invalidate_table(r.table)
        self._regions = {
            path: _Region(path, leaf, self.page_bytes)
            for path, leaf in flat.items()
        }
        self._treedef = treedef
        self._note_advice()
        # registration replaces ALL content: stamp every page at a fresh
        # tick so consumers holding a pre-registration watermark see
        # everything dirty (the tick clock itself survives re-registration)
        self._tick += 1
        for r in self._regions.values():
            r.table.write_tick[:] = self._tick

    # -- device access (faulting) ----------------------------------------------
    def _windows(self, lo_page: int, hi_page: int) -> Iterator[tuple[int, int]]:
        for w_lo in range(lo_page, hi_page, self.fault_window):
            yield w_lo, min(hi_page, w_lo + self.fault_window)

    def _split_promotion(
        self, table: PageTable, pages: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(migrate, remote) page split under the promotion threshold.

        Resident pages always go to ``migrate`` (they're hits); HOST pages
        whose windowed access count is still below the threshold are served
        remotely — the count advances here, so the Nth read promotes.
        """
        host = table.residency[pages] == Residency.HOST
        if not host.any():
            return pages, pages[:0]
        cold = pages[host]
        if self.promote_window:
            stale = self._tick - table.access_tick[cold] > self.promote_window
            table.access_count[cold[stale]] = 0
        # counting THIS access: crossing the threshold promotes now
        promote = table.access_count[cold] + 1 >= self.promote_threshold
        remote = cold[~promote]
        table.access_count[remote] += 1
        table.access_tick[remote] = self._tick
        self.pager.stats.promotions += int(promote.sum())
        return np.concatenate([pages[~host], cold[promote]]), remote

    def _frames_to_rows(self, out2d: torch.Tensor, rows: list[int],
                        fids: list[int]) -> None:
        """``out2d[rows] = frames[fids]`` — one slice copy for consecutive
        runs, else one gather."""
        frames = self.arena.frames
        if consecutive(rows) and consecutive(fids):
            out2d[rows[0] : rows[-1] + 1].copy_(frames[fids[0] : fids[-1] + 1])
        else:
            idx = torch.tensor(fids, device=frames.device)
            out2d[torch.tensor(rows, device=out2d.device)] = (
                frames.index_select(0, idx).to(out2d.device))

    def read_range(self, path: str, lo: int, hi: int) -> torch.Tensor:
        """Device read of byte range [lo, hi): fault in, return the bytes
        (a uint8 tensor on the arena's device).

        With ``promote_threshold`` > 1, cold (HOST) pages below the
        threshold are read *remotely* — bytes served from host backing
        with no migration, the Volta access-counter behaviour — so a
        once-touched page never costs a frame or an eviction.
        """
        region = self._regions[path]
        table = region.table
        pb = self.page_bytes
        p_lo, p_hi = table.pages_for_range(lo, hi)
        out2d = torch.empty((p_hi - p_lo, pb), dtype=torch.uint8, device=self.device)
        read_mostly = bool(table.advice & Advice.READ_MOSTLY)
        if self.promote_threshold > 1:
            # access epoch: promotion windows are tick-based, so reads
            # must advance the clock (writes already do)
            self._tick += 1
        stats = self.pager.stats
        for w_lo, w_hi in self._windows(p_lo, p_hi):
            pages = np.arange(w_lo, w_hi)
            if self.promote_threshold > 1:
                pages, remote = self._split_promotion(table, pages)
            else:
                remote = pages[:0]
            if pages.size:
                self.pager.fault_in(
                    table, pages, write=False, tick=self._tick,
                    pin=True, read_mostly=read_mostly,
                )
                self._frames_to_rows(out2d, (pages - p_lo).tolist(),
                                     table.frame[pages].tolist())
            if remote.size:
                out2d[torch.tensor(remote - p_lo, device=self.device)] = (
                    region.host2d[torch.from_numpy(remote)].to(self.device))
                for p in remote.tolist():
                    s_lo, s_hi = table.page_span(p)
                    c_lo, c_hi = max(s_lo, lo), min(s_hi, hi)
                    if c_lo < c_hi:
                        stats.remote_reads += 1
                        stats.remote_read_bytes += c_hi - c_lo
            self.pager.unpin_all()
        base = p_lo * pb
        return out2d.reshape(-1)[lo - base : hi - base]

    def write_range(self, path: str, lo: int, data: Any) -> None:
        """Device write at byte offset ``lo``: write-allocate + dirty.
        ``data`` is a tensor (on any device) or a numpy array."""
        region = self._regions[path]
        table = region.table
        data = _leaf_u8(data)
        hi = lo + data.numel()
        if hi > region.nbytes:
            raise ValueError(
                f"write of {data.numel()}B at {lo} overruns {path!r} "
                f"({region.nbytes}B)"
            )
        if data.numel() == 0:
            return
        frames = self.arena.frames
        data = data.to(frames.device)
        pb = self.page_bytes
        self._tick += 1
        p_lo, p_hi = table.pages_for_range(lo, hi)
        for w_lo, w_hi in self._windows(p_lo, p_hi):
            full, parts = [], []
            for p in range(w_lo, w_hi):
                s_lo, s_hi = table.page_span(p)
                full_overwrite = lo <= s_lo and hi >= s_hi
                self.pager.fault_in(
                    table, [p], write=True, tick=self._tick,
                    overwrite=full_overwrite, pin=True, flush=False,
                )
                if full_overwrite and s_hi - s_lo == pb:
                    full.append(p)
                else:
                    parts.append((p, max(s_lo, lo), min(s_hi, hi), s_lo))
            self.pager.flush()  # write-backs out, partial pages' fills in
            if full:  # consecutive pages of the window
                src = data[full[0] * pb - lo : (full[-1] + 1) * pb - lo].view(-1, pb)
                fids = table.frame[full[0] : full[-1] + 1].tolist()
                if consecutive(fids):
                    frames[fids[0] : fids[-1] + 1].copy_(src)
                else:
                    frames.index_copy_(0, torch.tensor(fids, device=frames.device), src)
            for p, c_lo, c_hi, s_lo in parts:
                fid = int(table.frame[p])
                frames[fid, c_lo - s_lo : c_hi - s_lo].copy_(data[c_lo - lo : c_hi - lo])
            self.pager.unpin_all()

    def read_leaf(self, path: str) -> Any:
        region = self._regions[path]
        return region.as_leaf(self.read_range(path, 0, region.nbytes))

    def write_leaf(self, path: str, arr: Any) -> None:
        region = self._regions[path]
        region.check(arr, "write")
        self.write_range(path, 0, arr)

    def read_state(self) -> Any:
        """Fault the whole tree in (device access) and assemble it."""
        leaves = {p: self.read_leaf(p) for p in self._regions}
        return unflatten_from_paths(self._treedef, leaves)

    def write_state(self, state: Any) -> None:
        flat, _ = flatten_with_paths(state)
        for path, leaf in flat.items():
            self.write_leaf(path, leaf)

    # -- coherent host access (no migration) -------------------------------------
    def peek_range(self, path: str, lo: int, hi: int) -> torch.Tensor:
        """Coherent host read without migration: backing bytes overlaid
        with device frames that are newer (wb_dirty), as a CPU uint8
        tensor; the newer frames cross in one gather."""
        region = self._regions[path]
        table = region.table
        pb = self.page_bytes
        if lo == hi:
            return torch.empty(0, dtype=torch.uint8)
        p_lo, p_hi = table.pages_for_range(lo, hi)
        out2d = region.host2d[p_lo:p_hi].clone()
        dirty = np.flatnonzero(table.wb_dirty[p_lo:p_hi]) + p_lo
        if dirty.size:
            self._frames_to_rows(out2d, (dirty - p_lo).tolist(),
                                 table.frame[dirty].tolist())
        base = p_lo * pb
        return out2d.reshape(-1)[lo - base : hi - base]

    def peek_leaf(self, path: str) -> Any:
        region = self._regions[path]
        return region.as_leaf(self.peek_range(path, 0, region.nbytes))

    def peek_state(self) -> Any:
        leaves = {p: self.peek_leaf(p) for p in self._regions}
        return unflatten_from_paths(self._treedef, leaves)

    # -- host overwrite (restore / upload) ---------------------------------------
    def load_range(self, path: str, lo: int, data: Any) -> None:
        """Host overwrite of byte range [lo, lo+len): the targeted form of
        :meth:`load_leaf` a chunk-delta upload uses, so only the touched
        pages become epoch-dirty. Fully-covered resident pages are
        invalidated (superseded); partially-covered ones are evicted first
        (write-back) so their untouched bytes survive the splice."""
        region = self._regions[path]
        table = region.table
        data = _leaf_u8(data)
        hi = lo + data.numel()
        if hi > region.nbytes:
            raise ValueError(
                f"load of {data.numel()}B at {lo} overruns {path!r} "
                f"({region.nbytes}B)"
            )
        if data.numel() == 0:
            return
        p_lo, p_hi = table.pages_for_range(lo, hi)
        for p in range(p_lo, p_hi):
            if table.residency[p] == Residency.HOST:
                continue
            s_lo, s_hi = table.page_span(p)
            if lo <= s_lo and hi >= s_hi:
                self.pager.invalidate_page(table, p)
            else:
                self.pager.evict(int(table.frame[p]))
        region.host_t[lo:hi].copy_(data)
        self._tick += 1
        table.write_tick[p_lo:p_hi] = self._tick

    def load_leaf(self, path: str, arr: Any) -> None:
        """Overwrite the host backing; device frames are superseded."""
        region = self._regions[path]
        n = (arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor)
             else int(np.asarray(arr).nbytes))
        if n != region.nbytes:
            raise ValueError(f"load of {n}B into {path!r} ({region.nbytes}B)")
        self.pager.invalidate_table(region.table)
        if n:
            region.host_t[:n].copy_(_leaf_u8(arr))
        self._tick += 1
        region.table.write_tick[:] = self._tick

    def load_state(self, state: Any) -> None:
        flat, _ = flatten_with_paths(state)
        for path, leaf in flat.items():
            self.load_leaf(path, leaf)

    # -- hints -------------------------------------------------------------------
    def _note_advice(self) -> None:
        mask = 0
        for r in self._regions.values():
            mask |= int(r.table.advice)
        self.pager.advice_mask = mask

    def advise(self, path: str, advice: Advice) -> None:
        self._regions[path].table.advice = int(advice)
        self._note_advice()

    def prefetch_pages(self, path: str, lo_page: int, hi_page: int) -> int:
        """Migrate [lo_page, hi_page) h2d ahead of access; returns pages moved."""
        table = self._regions[path].table
        hi_page = min(hi_page, table.n_pages)
        pages = np.arange(lo_page, hi_page)
        pages = pages[table.residency[pages] == Residency.HOST]
        if pages.size:
            self.pager.fault_in(
                table, pages, write=False, tick=self._tick, prefetch=True,
                read_mostly=bool(table.advice & Advice.READ_MOSTLY),
            )
        return int(pages.size)

    def prefetch(self, path: str, lo_page: int = 0, hi_page: int | None = None) -> int:
        table = self._regions[path].table
        return self.prefetch_pages(
            path, lo_page, table.n_pages if hi_page is None else hi_page
        )

    # -- checkpoint integration ----------------------------------------------------
    def dirty_pages_since(self, path: str, tick: int) -> np.ndarray:
        return self._regions[path].table.dirty_pages_since(tick)

    def dirty_chunk_marks_since(
        self, tick: int, chunk_bytes: int
    ) -> dict[str, list[int]]:
        """{path: sorted chunk indices} dirtied strictly after ``tick``.

        Every registered path appears (clean -> empty list): the shadow
        treats absence as "unknown, be conservative", presence as an
        authoritative page-granular answer.
        """
        out: dict[str, list[int]] = {}
        cb = int(chunk_bytes)
        for path, region in self._regions.items():
            table = region.table
            pages = table.dirty_pages_since(tick)
            if pages.size == 0:
                out[path] = []
                continue
            # each dirty page's [first, last] chunk (an empty region's one
            # page covers chunk 0), merged
            lo = pages * table.page_bytes
            hi = np.minimum(table.nbytes, lo + table.page_bytes)
            first = lo // cb
            last = (np.maximum(hi, lo + 1) - 1) // cb
            if np.array_equal(first, last):
                chunks = np.unique(first)
            else:
                chunks = np.unique(np.concatenate([
                    np.arange(a, b + 1)
                    for a, b in zip(first.tolist(), last.tolist())]))
            out[path] = chunks.tolist()
        return out

    def as_dirty_source(self, prefix: str = "") -> "SpaceDirtySource":
        return SpaceDirtySource(self, prefix)

    # -- verification ---------------------------------------------------------------
    def check_invariants(self) -> None:
        resident = 0
        for region in self._regions.values():
            region.table.check_invariants()
            resident += region.table.device_pages().size
        if resident != self.arena.resident_frames:
            raise RuntimeError(
                f"frame accounting skew: tables hold {resident}, arena says "
                f"{self.arena.resident_frames}"
            )
        if resident * self.page_bytes > self.device_capacity_bytes:
            raise RuntimeError("device budget exceeded")


class SpaceDirtySource:
    """Adapter: a ManagedSpace as a ForkedCheckpointer ``dirty_source``.

    ``prefix`` maps space-local leaf paths to the checkpointed tree's
    paths (the trainer registers ``state['device']``, so its leaves appear
    under ``device/`` in the full state).
    """

    def __init__(self, space: ManagedSpace, prefix: str = ""):
        self.space = space
        self.prefix = prefix

    def tick(self) -> int:
        return self.space.tick()

    def dirty_chunk_marks_since(
        self, tick: int, chunk_bytes: int
    ) -> dict[str, list[int]]:
        marks = self.space.dirty_chunk_marks_since(tick, chunk_bytes)
        return {self.prefix + p: v for p, v in marks.items()}
