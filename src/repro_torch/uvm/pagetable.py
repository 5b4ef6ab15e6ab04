"""Page table — per-page residency, dirty and access bits for one region.

CRUM operates on CUDA's managed (UVM) address space: every allocation is a
run of pages that migrate between host and device on demand, and the
checkpointer's unit of work is the page, not the allocation. This module is
that bookkeeping layer, one :class:`PageTable` per managed region (= one
pytree leaf):

    residency   HOST / DEVICE / BOTH      (BOTH = read-mostly duplication:
                                           both copies valid, host readable
                                           without a migration)
    wb_dirty    device copy is newer than the host backing page; an eviction
                MUST write it back (the driver's dirty bit)
    write_tick  monotonic tick of the last write fault — the page-granular
                dirty *history* the checkpoint sync consumes ("which pages
                changed since tick T?"), deliberately never cleared by
                eviction: write-back makes host bytes current but the page
                is still dirty relative to an older checkpoint.
    access_*    LRU / access-counter inputs for the eviction policies.

All bits are numpy arrays so range operations (fault a window, query a
dirty epoch) are vectorized; the per-page state machine itself lives in
``pager.py``. The reference's module (``repro.uvm.pagetable``), copied: the
bits are bookkeeping, not device data, and stay numpy in the port.
"""
from __future__ import annotations

import enum

import numpy as np


class Residency(enum.IntEnum):
    HOST = 0     # only the host backing page is valid
    DEVICE = 1   # page lives in a device frame; host copy stale iff wb_dirty
    BOTH = 2     # duplicated (cudaMemAdviseSetReadMostly): both copies valid


class PageTableError(RuntimeError):
    """An operation violated the page-table state machine."""


class PageTable:
    """Residency/dirty/access bits for one contiguous byte region."""

    __slots__ = (
        "path", "nbytes", "page_bytes", "n_pages",
        "residency", "frame", "wb_dirty",
        "write_tick", "access_tick", "access_count",
        "advice",
    )

    def __init__(self, path: str, nbytes: int, page_bytes: int):
        if page_bytes <= 0:
            raise ValueError(f"page_bytes must be positive, got {page_bytes}")
        self.path = path
        self.nbytes = int(nbytes)
        self.page_bytes = int(page_bytes)
        self.n_pages = max(1, -(-self.nbytes // self.page_bytes))
        n = self.n_pages
        self.residency = np.full(n, Residency.HOST, np.int8)
        self.frame = np.full(n, -1, np.int64)       # device frame id or -1
        self.wb_dirty = np.zeros(n, np.bool_)       # needs write-back
        self.write_tick = np.zeros(n, np.int64)     # last write-fault tick
        self.access_tick = np.zeros(n, np.int64)    # last access tick (LRU)
        self.access_count = np.zeros(n, np.int64)   # faults+hits (counters)
        self.advice = 0                             # advice.Advice flags

    # -- geometry --------------------------------------------------------------
    def page_nbytes(self, page: int) -> int:
        """Valid bytes in ``page`` (the tail page may be partial)."""
        lo = page * self.page_bytes
        return max(0, min(self.nbytes, lo + self.page_bytes) - lo)

    def page_span(self, page: int) -> tuple[int, int]:
        lo = page * self.page_bytes
        return lo, min(self.nbytes, lo + self.page_bytes)

    def pages_for_range(self, lo: int, hi: int) -> tuple[int, int]:
        """[lo_page, hi_page) covering byte range [lo, hi)."""
        if not 0 <= lo <= hi <= max(self.nbytes, 1):
            raise ValueError(
                f"byte range [{lo}, {hi}) outside region of {self.nbytes}B"
            )
        if lo == hi:
            return 0, 0
        return lo // self.page_bytes, -(-hi // self.page_bytes)

    # -- queries ---------------------------------------------------------------
    def device_pages(self) -> np.ndarray:
        """Indices of pages holding a device frame (DEVICE or BOTH)."""
        return np.flatnonzero(self.residency != Residency.HOST)

    def device_bytes(self) -> int:
        pages = self.device_pages()
        if pages.size == 0:
            return 0
        full = int(pages.size) * self.page_bytes
        if pages[-1] == self.n_pages - 1:
            full -= self.page_bytes - self.page_nbytes(self.n_pages - 1)
        return full

    def dirty_pages_since(self, tick: int) -> np.ndarray:
        """Pages written strictly after ``tick`` (checkpoint dirty epoch)."""
        return np.flatnonzero(self.write_tick > tick)

    # -- verification (tests / property checks) --------------------------------
    def check_invariants(self) -> None:
        """Raise PageTableError on any inconsistent per-page state."""
        host = self.residency == Residency.HOST
        if np.any(self.frame[host] != -1):
            raise PageTableError(f"{self.path}: HOST page holds a frame")
        if np.any(self.wb_dirty[host]):
            raise PageTableError(
                f"{self.path}: HOST page marked write-back dirty "
                "(a dirty page was dropped without write-back)"
            )
        if np.any(self.frame[~host] < 0):
            raise PageTableError(f"{self.path}: resident page without a frame")
        both = self.residency == Residency.BOTH
        if np.any(self.wb_dirty[both]):
            raise PageTableError(
                f"{self.path}: duplicated (BOTH) page cannot be dirty — a "
                "write must collapse the duplication first"
            )
