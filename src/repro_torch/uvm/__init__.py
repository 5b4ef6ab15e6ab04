"""Managed-memory (UVM) paging subsystem — CRUM's actual substrate.

The paper checkpoints CUDA *unified memory*: allocations whose pages
migrate between host and device on demand, letting the working set exceed
device memory. This package models that layer explicitly, on the card —
page-granular residency and dirty bits (``pagetable``), fault-driven
migration between host backing and a bounded arena of device frames with
pluggable eviction (``pager``), memadvise/prefetch hints (``advice``), and
the tree-facing facade with a hard ``device_capacity_bytes`` budget
(``space``). The checkpoint stack reads dirty history from here (page-delta
sync instead of whole-leaf digest scans) and the device proxy routes
step/sync/upload through it so a proxy can host state larger than its
device budget. The port of ``repro.uvm``: the same names and counters.
"""
from repro_torch.uvm.advice import Advice, PrefetchStream
from repro_torch.uvm.pagetable import PageTable, PageTableError, Residency
from repro_torch.uvm.pager import (
    ClockPolicy,
    DeviceArena,
    EvictionPolicy,
    LRUPolicy,
    Pager,
    PagingStats,
    make_eviction_policy,
)
from repro_torch.uvm.space import (
    DEFAULT_PAGE_BYTES,
    ManagedSpace,
    SpaceDirtySource,
)

EVICTION_POLICIES = ("lru", "clock")

__all__ = [
    "Advice", "PrefetchStream",
    "PageTable", "PageTableError", "Residency",
    "ClockPolicy", "DeviceArena", "EvictionPolicy", "LRUPolicy",
    "Pager", "PagingStats", "make_eviction_policy",
    "DEFAULT_PAGE_BYTES", "ManagedSpace", "SpaceDirtySource",
    "EVICTION_POLICIES",
]
