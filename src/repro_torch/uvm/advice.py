"""cudaMemAdvise / cudaMemPrefetchAsync-style hints for managed regions.

UVM's performance story (UVMBench; CRUM §2) is dominated by whether the
application tells the driver what it knows:

    READ_MOSTLY         read faults *duplicate* the page (residency BOTH):
                        the host keeps a valid copy, so a later host read —
                        e.g. the checkpoint sync — costs no migration. A
                        write collapses the duplication (pager.fault_in).
    PREFERRED_HOST      evict these pages first; the device copy is a
                        transient.
    PREFERRED_DEVICE    evict these pages last; hot working set.

``PrefetchStream`` is the cudaMemPrefetchAsync analogue: enqueued ranges
migrate in batches ahead of the faults that would otherwise pay the
latency, counted as prefetches (not faults) in the paging stats.

The reference's module (``repro.uvm.advice``), copied: it is framework-free.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Advice(enum.IntFlag):
    NONE = 0
    READ_MOSTLY = 1
    PREFERRED_HOST = 2
    PREFERRED_DEVICE = 4


@dataclass
class PrefetchStream:
    """An ordered queue of (path, lo_page, hi_page) prefetch requests.

    ``enqueue`` records intent; ``drain(space)`` issues the migrations in
    ``batch_pages``-sized slices so a huge prefetch cannot monopolize the
    arena (each batch may evict the previous one under oversubscription —
    exactly the self-defeating prefetch the benchmark can demonstrate).
    """

    batch_pages: int = 64
    _queue: list[tuple[str, int, int]] = field(default_factory=list)

    def enqueue(self, path: str, lo_page: int = 0, hi_page: int | None = None) -> None:
        self._queue.append((path, int(lo_page), -1 if hi_page is None else int(hi_page)))

    def __len__(self) -> int:
        return len(self._queue)

    def drain(self, space) -> int:
        """Issue everything queued against ``space``; returns pages moved."""
        moved = 0
        queue, self._queue = self._queue, []
        for path, lo, hi in queue:
            table = space.table(path)
            hi = table.n_pages if hi < 0 else min(hi, table.n_pages)
            for batch_lo in range(lo, hi, self.batch_pages):
                batch_hi = min(hi, batch_lo + self.batch_pages)
                moved += space.prefetch_pages(path, batch_lo, batch_hi)
        return moved
