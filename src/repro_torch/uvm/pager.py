"""Fault-driven host<->device migration under a hard frame budget.

The device is a bounded frame arena: ``capacity_bytes`` divided into page
frames, one ``torch.uint8`` tensor of shape ``(n_frames, page_bytes)`` on
an explicit device (the card by default), each row holding the actual
bytes of whichever page is resident. A device access to a non-resident
page is a fault: the pager takes a frame (evicting a victim when the arena
is full, writing the victim back to its host backing first if its device
copy is newer) and migrates the page's bytes host -> device. On the card a
fault is a real H2D copy and a write-back a real D2H copy.

The per-page state machine, the counters and the victim order are the
reference's (``repro.uvm.pager``). The byte moves are not made page by
page: one ``fault_in`` call decides every page's fate first, in the order
the per-page loop would, and queues the moves; :meth:`Pager.flush` then
moves the victims' write-backs in one D2H copy and the faulted pages in
one H2D copy (a plain slice copy where the frames and the pages are both
consecutive, else one gather or scatter through ``index_select`` /
``index_copy_``). Write-backs move before fills, so a frame reused in the
same window is read before it is refilled.

Eviction policies (``cudaMemAdvise`` §: UVM's LRU vs the Volta+ access
counters):

    lru     strict least-recently-used over resident frames
    clock   access-counter clock (second chance): a frame touched since the
            hand last passed gets its reference bit cleared and is skipped
            once; cold frames are evicted on first encounter

Pages advised PREFERRED_HOST are evicted preferentially; PREFERRED_DEVICE
pages are passed over while any unadvised victim exists.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.uvm.advice import Advice
from repro_torch.uvm.pagetable import PageTable, Residency

# plain ints for the per-page loop: enum arithmetic costs microseconds a page
_HOST, _DEVICE, _BOTH = int(Residency.HOST), int(Residency.DEVICE), int(Residency.BOTH)
_PREFER_HOST, _PREFER_DEVICE = int(Advice.PREFERRED_HOST), int(Advice.PREFERRED_DEVICE)


@dataclass
class PagingStats:
    """Counters the benchmarks and round logs report."""

    faults_read: int = 0
    faults_write: int = 0
    hits: int = 0               # device accesses to already-resident pages
    prefetches: int = 0         # pages migrated ahead of a fault
    evictions: int = 0
    writebacks: int = 0         # evictions that had to copy d2h first
    invalidations: int = 0      # frames dropped by load/overwrite (no copy)
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    resident_high_water: int = 0  # peak resident bytes
    # access-counter promotion (Volta-style): a cold read is served
    # *remotely* (device reads host memory over the bus, no migration)
    # until the page's access count within the window crosses the
    # threshold — then it is promoted to a device frame
    remote_reads: int = 0
    remote_read_bytes: int = 0
    promotions: int = 0         # migrations triggered by crossing the threshold

    @property
    def faults(self) -> int:
        return self.faults_read + self.faults_write

    def as_dict(self) -> dict:
        d = {k: int(getattr(self, k)) for k in (
            "faults_read", "faults_write", "hits", "prefetches", "evictions",
            "writebacks", "invalidations", "h2d_bytes", "d2h_bytes",
            "resident_high_water", "remote_reads", "remote_read_bytes",
            "promotions",
        )}
        d["faults"] = self.faults
        return d

    def canonical(self) -> dict:
        """Registry-form counters: the one snake_case scheme every layer
        emits through (``uvm_<metric>``; see repro_torch.obs.metrics)."""
        return {f"uvm_{k}": v for k, v in self.as_dict().items()}


class EvictionPolicy:
    """Victim selection over device frames. Frames are identified by index
    into the arena; the pager reports inserts/accesses/releases."""

    name = "?"

    def note_insert(self, fid: int) -> None:
        raise NotImplementedError

    def note_access(self, fid: int) -> None:
        raise NotImplementedError

    def forget(self, fid: int) -> None:
        raise NotImplementedError

    def pick_victim(self, eligible: Callable[[int], bool]) -> int | None:
        """A frame id with ``eligible(fid)`` true, or None if none is."""
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    """Strict LRU: evict the least recently accessed eligible frame."""

    name = "lru"

    def __init__(self):
        self._order: OrderedDict[int, None] = OrderedDict()

    def note_insert(self, fid: int) -> None:
        self._order[fid] = None
        self._order.move_to_end(fid)

    def note_access(self, fid: int) -> None:
        if fid in self._order:
            self._order.move_to_end(fid)

    def forget(self, fid: int) -> None:
        self._order.pop(fid, None)

    def pick_victim(self, eligible: Callable[[int], bool]) -> int | None:
        for fid in self._order:  # oldest first
            if eligible(fid):
                return fid
        return None


class ClockPolicy(EvictionPolicy):
    """Access-counter clock (second chance). Referenced frames survive one
    pass of the hand; a frame untouched between passes is evicted."""

    name = "clock"

    def __init__(self, n_frames: int):
        self.ref = np.zeros(n_frames, np.bool_)
        self.live = np.zeros(n_frames, np.bool_)
        self._hand = 0

    def note_insert(self, fid: int) -> None:
        self.live[fid] = True
        self.ref[fid] = True

    def note_access(self, fid: int) -> None:
        self.ref[fid] = True

    def forget(self, fid: int) -> None:
        self.live[fid] = False
        self.ref[fid] = False

    def pick_victim(self, eligible: Callable[[int], bool]) -> int | None:
        n = len(self.live)
        # two full sweeps: the first may only clear reference bits
        for _ in range(2 * n):
            fid = self._hand
            self._hand = (self._hand + 1) % n
            if not self.live[fid] or not eligible(fid):
                continue
            if self.ref[fid]:
                self.ref[fid] = False  # second chance
                continue
            return fid
        # everything referenced+eligible was given its chance: fall back to
        # the first eligible frame so eviction always terminates
        for fid in range(n):
            if self.live[fid] and eligible(fid):
                return fid
        return None


def make_eviction_policy(name: str, n_frames: int) -> EvictionPolicy:
    if name == "lru":
        return LRUPolicy()
    if name == "clock":
        return ClockPolicy(n_frames)
    raise ValueError(f"unknown eviction policy {name!r}; have ['clock', 'lru']")


class DeviceArena:
    """The device memory: ``n_frames`` page-sized byte frames in one
    ``(n_frames, page_bytes)`` uint8 tensor on ``device``."""

    def __init__(self, capacity_bytes: int, page_bytes: int, *,
                 device: str | torch.device = "cuda"):
        if capacity_bytes < page_bytes:
            raise ValueError(
                f"device capacity {capacity_bytes}B is smaller than one page "
                f"({page_bytes}B) — nothing could ever be resident"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device arena on {str(device)!r} asked for but no CUDA device "
                "is available (pass device='cpu' to page on the CPU)"
            )
        self.page_bytes = int(page_bytes)
        self.n_frames = int(capacity_bytes) // self.page_bytes
        self.frames = torch.zeros((self.n_frames, self.page_bytes),
                                  dtype=torch.uint8, device=self.device)
        self.owner: list[tuple[PageTable, int] | None] = [None] * self.n_frames
        self.free: list[int] = list(range(self.n_frames - 1, -1, -1))

    @property
    def resident_frames(self) -> int:
        return self.n_frames - len(self.free)


def consecutive(a: list[int]) -> bool:
    """Whether ``a`` (non-empty) is one ascending run of consecutive
    integers: then its rows move as one slice."""
    return a[-1] - a[0] == len(a) - 1 and all(
        y - x == 1 for x, y in zip(a, a[1:]))


@dataclass
class Pager:
    """The fault/evict/write-back state machine over one arena.

    ``host_of`` maps a PageTable to its host backing: a CPU uint8 tensor of
    shape ``(n_pages, page_bytes)`` (the tail page padded) — supplied by the
    ManagedSpace that owns the regions. ``advice_mask`` is the OR of every
    region's advice; the eviction passes that no frame could pass are
    skipped (each such pass would return None and move nothing: it leaves
    an LRU order as it was and walks a clock's hand round twice, back to
    where it was), so the victim is the reference's without a scan of the
    whole arena per eviction.
    """

    arena: DeviceArena
    policy: EvictionPolicy
    host_of: Callable[[PageTable], torch.Tensor]
    stats: PagingStats = field(default_factory=PagingStats)
    advice_mask: int = 0
    _pinned: set = field(default_factory=set)
    # queued byte moves: (fid, table, page) write-backs, then fills
    _wb: list = field(default_factory=list)
    _fill: list = field(default_factory=list)
    _fill_fids: set = field(default_factory=set)
    _batching: bool = False

    # -- faulting ---------------------------------------------------------------
    def fault_in(
        self,
        table: PageTable,
        pages,
        *,
        write: bool,
        tick: int,
        prefetch: bool = False,
        overwrite: bool = False,
        pin: bool = False,
        read_mostly: bool = False,
        flush: bool = True,
    ) -> None:
        """Make ``pages`` device-resident; count faults/hits/migrations.

        ``overwrite`` is the write-allocate fast path: the caller is about
        to overwrite the whole page, so the stale h2d copy is skipped.
        ``pin`` keeps the faulted frames ineligible for eviction until
        :meth:`unpin_all` — used while a windowed reader copies them out.
        ``flush=False`` leaves this call's byte moves queued for the
        caller's :meth:`flush` (a writer batching a window page by page).
        """
        stats, arena, policy = self.stats, self.arena, self.policy
        residency, frame = table.residency, table.frame
        self._batching = True
        try:
            if not isinstance(pages, list):
                pages = np.atleast_1d(pages).tolist()
            for p in pages:
                res = residency[p]
                if res != _HOST:
                    fid = int(frame[p])
                    if not prefetch:
                        stats.hits += 1
                    policy.note_access(fid)
                    if write and res == _BOTH:
                        # a write collapses read-mostly duplication: the host
                        # copy is stale from here until write-back
                        residency[p] = _DEVICE
                else:
                    fid = self._take_frame()
                    arena.owner[fid] = (table, p)
                    frame[p] = fid
                    if not (write and overwrite):
                        self._fill.append((fid, table, p))
                        self._fill_fids.add(fid)
                        stats.h2d_bytes += table.page_nbytes(p)
                    if prefetch:
                        stats.prefetches += 1
                    elif write:
                        stats.faults_write += 1
                    else:
                        stats.faults_read += 1
                    residency[p] = _BOTH if (not write and read_mostly) else _DEVICE
                    policy.note_insert(fid)
                    resident = arena.resident_frames * arena.page_bytes
                    if resident > stats.resident_high_water:
                        stats.resident_high_water = resident
                if write:
                    table.wb_dirty[p] = True
                    table.write_tick[p] = tick
                table.access_tick[p] = tick
                table.access_count[p] += 1
                if pin:
                    self._pinned.add(int(frame[p]))
        finally:
            self._batching = False
        if flush:
            self.flush()

    def unpin_all(self) -> None:
        self._pinned.clear()

    # -- byte moves ---------------------------------------------------------------
    def flush(self) -> None:
        """Move the queued bytes: every write-back (device -> host), then
        every fill (host -> device)."""
        if self._wb:
            wb, self._wb = self._wb, []
            self._write_back(wb)
        if self._fill:
            fill, self._fill = self._fill, []
            self._fill_fids = set()
            self._fill_frames(fill)

    def _write_back(self, wb: list) -> None:
        frames = self.arena.frames
        fids = [f for f, _, _ in wb]
        table0 = wb[0][1]
        pages = [p for _, _, p in wb]
        if all(t is table0 for _, t, _ in wb) and consecutive(fids) and consecutive(pages):
            host = self.host_of(table0)
            host[pages[0] : pages[-1] + 1].copy_(frames[fids[0] : fids[-1] + 1])
            return
        staged = frames.index_select(
            0, torch.tensor(fids, device=frames.device)).cpu().numpy()
        by_table: dict[int, tuple[PageTable, list, list]] = {}
        for row, (_, t, p) in enumerate(wb):
            by_table.setdefault(id(t), (t, [], []))
            by_table[id(t)][1].append(p)
            by_table[id(t)][2].append(row)
        for t, ps, rows in by_table.values():
            self.host_of(t).numpy()[ps] = staged[rows]

    def _fill_frames(self, fill: list) -> None:
        frames = self.arena.frames
        table = fill[0][1]  # one fault_in call: one table
        host = self.host_of(table)
        fids = [f for f, _, _ in fill]
        pages = [p for _, _, p in fill]
        if consecutive(fids) and consecutive(pages):
            frames[fids[0] : fids[-1] + 1].copy_(host[pages[0] : pages[-1] + 1])
            return
        rows = host.index_select(0, torch.tensor(pages))
        frames.index_copy_(
            0, torch.tensor(fids, device=frames.device), rows.to(frames.device))

    # -- eviction ---------------------------------------------------------------
    def _take_frame(self) -> int:
        if self.arena.free:
            return self.arena.free.pop()
        fid = self._pick_victim()
        if fid is None:
            raise RuntimeError(
                "device arena exhausted with every frame pinned — shrink the "
                "fault window or raise device_capacity_bytes"
            )
        self.evict(fid)
        return self.arena.free.pop()

    def _pick_victim(self) -> int | None:
        pinned = self._pinned
        owner = self.arena.owner

        def unpinned(fid: int) -> bool:
            return fid not in pinned

        # eviction preference: advised-host pages first, unadvised next,
        # advised-device pages only when nothing else remains
        def advised_host(fid: int) -> bool:
            if not unpinned(fid):
                return False
            o = owner[fid]
            return o is not None and bool(int(o[0].advice) & _PREFER_HOST)

        def not_device_preferred(fid: int) -> bool:
            if not unpinned(fid):
                return False
            o = owner[fid]
            return o is None or not bool(int(o[0].advice) & _PREFER_DEVICE)

        passes = []
        mask = int(self.advice_mask)
        if mask & _PREFER_HOST:
            passes.append(advised_host)
        if mask & _PREFER_DEVICE:
            passes += [not_device_preferred, unpinned]
        else:
            passes.append(unpinned)  # == not_device_preferred here
        for eligible in passes:
            fid = self.policy.pick_victim(eligible)
            if fid is not None:
                return fid
        return None

    def evict(self, fid: int) -> None:
        """Release one frame. A dirty page is ALWAYS written back first —
        the invariant the property tests pin down."""
        owner = self.arena.owner[fid]
        if owner is None:
            return
        table, p = owner
        if table.wb_dirty[p]:
            if fid in self._fill_fids:
                # the frame's fill is still queued: move it before reading
                self.flush()
            self._wb.append((fid, table, p))
            table.wb_dirty[p] = False
            self.stats.writebacks += 1
            self.stats.d2h_bytes += table.page_nbytes(p)
        table.residency[p] = _HOST
        table.frame[p] = -1
        self.policy.forget(fid)
        self.arena.owner[fid] = None
        self.arena.free.append(fid)
        self.stats.evictions += 1
        if not self._batching:
            self.flush()

    def evict_table(self, table: PageTable) -> None:
        """Write back and release every frame ``table`` holds."""
        self._batching = True
        try:
            for p in table.device_pages().tolist():
                self.evict(int(table.frame[p]))
        finally:
            self._batching = False
        self.flush()

    def invalidate_page(self, table: PageTable, page: int) -> None:
        """Drop one page's frame WITHOUT write-back — only valid when the
        caller is about to overwrite that page's host backing (load /
        restore): the device copy is superseded, not lost."""
        if table.residency[page] == Residency.HOST:
            return
        fid = int(table.frame[page])
        table.wb_dirty[page] = False
        table.residency[page] = Residency.HOST
        table.frame[page] = -1
        self.policy.forget(fid)
        self.arena.owner[fid] = None
        self.arena.free.append(fid)
        self.stats.invalidations += 1

    def invalidate_table(self, table: PageTable) -> None:
        """Whole-region :meth:`invalidate_page` (load_state/re-register)."""
        for p in table.device_pages().tolist():
            self.invalidate_page(table, int(p))
