"""RestoreManager — restart protocol (paper §3.4) + lazy restore (§4.2).

Eager restore re-creates the full state: read the manifest, assemble each
leaf's global array from its stored shards, and place it on the device the
caller names for its path (``device_for``) — the paper's "replay the
allocations, transfer the data back". The manifest is the same format the
JAX reference writes, so either package restores the other's images.

Lazy restore returns a mapping that materializes leaves on first access and
prefetches ahead in manifest order with an exponentially growing window —
the paper's read-fault heuristic: the first fault reads one page, each
subsequent fault on the same region doubles the read-ahead. Serving
restarts benefit: the params a server touches materialize on demand rather
than stalling on the whole image.

Proxy restart (``restore_into_proxy``) re-creates the device state inside
a device proxy instead of this process. Not ported yet: ``restore_elastic``
(the cluster slice).
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manifest import (
    Manifest,
    committed_steps,
    latest_committed_step,
    load_manifest,
    skeleton_fill,
)
from repro_torch.checkpoint.sharded import restore_leaf, verify_manifest
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.utils.timing import Timings

# (path, global shape) -> target device, or None to keep the leaf on the host.
# Lazy restore places leaves from its reader threads, so a CUDA device should
# carry its index: a bare "cuda" means each thread's current device.
DeviceFor = Callable[[str, tuple[int, ...]], "torch.device | str | None"]


class LazyLeaves:
    """Dict-like view over a manifest; leaves materialize on first read.

    Exponential read-ahead: after ``k`` consecutive accesses that hit the
    prefetch frontier, the window grows as 1, 2, 4, ... up to
    ``max_readahead`` leaves submitted to a background reader.
    """

    def __init__(
        self,
        store: ChunkStore,
        manifest: Manifest,
        device_for: DeviceFor | None,
        *,
        max_readahead: int = 32,
        timings: Timings | None = None,
    ):
        self._store = store
        self._manifest = manifest
        self._device_for = device_for or (lambda p, s: None)
        self._order = list(manifest.leaves.keys())
        self._pos = {p: i for i, p in enumerate(self._order)}
        self._cache: dict[str, Any] = {}
        self._futures: dict[str, cf.Future] = {}
        self._window = 1
        self._max_window = max_readahead
        self._frontier = 0
        self._last_idx = -1
        self._lock = threading.Lock()
        self._pool = cf.ThreadPoolExecutor(max_workers=4, thread_name_prefix="crum-read")
        self.timings = timings or Timings()
        self.loads = 0

    def keys(self) -> list[str]:
        return list(self._order)

    def _materialize(self, path: str) -> Any:
        lrec = self._manifest.leaves[path]
        with self.timings.measure("restore/leaf"):
            leaf = restore_leaf(
                self._store, lrec, self._device_for(path, tuple(lrec.shape))
            )
        return leaf

    def __getitem__(self, path: str) -> Any:
        # claim-under-lock: concurrent first accesses to the same leaf must
        # materialize it exactly once. The first claimant registers a future
        # (so peers wait on it) and runs the read itself; peers — and reads
        # already prefetched by the pool — block on fut.result().
        owner = False
        with self._lock:
            if path in self._cache:
                return self._cache[path]
            fut = self._futures.get(path)
            if fut is None:
                fut = cf.Future()
                self._futures[path] = fut
                owner = True
                self.loads += 1
        if owner:
            try:
                fut.set_result(self._materialize(path))
            except BaseException as e:
                fut.set_exception(e)
        try:
            leaf = fut.result()
        except BaseException:
            # a failed read (owner or pool prefetch) must not poison the
            # leaf: drop the future so the next access retries materialize
            with self._lock:
                if self._futures.get(path) is fut:
                    self._futures.pop(path)
            raise
        with self._lock:
            self._cache[path] = leaf
            self._futures.pop(path, None)
        self._read_ahead(path)
        return leaf

    def _read_ahead(self, touched: str) -> None:
        """Grow and schedule the prefetch window past the touched leaf."""
        with self._lock:
            i = self._pos[touched]
            if i >= self._last_idx:
                # forward progress: double the window (paper's heuristic)
                self._window = min(self._window * 2, self._max_window)
            else:  # backward jump: new region, reset the stride
                self._window = 1
                self._frontier = 0
            self._last_idx = i
            lo = max(self._frontier, i + 1)
            hi = min(len(self._order), i + 1 + self._window)
            to_fetch = [
                p
                for p in self._order[lo:hi]
                if p not in self._cache and p not in self._futures
            ]
            for p in to_fetch:
                self._futures[p] = self._pool.submit(self._materialize, p)
                self.loads += 1
            self._frontier = max(self._frontier, hi)

    def as_tree(self) -> Any:
        """Force everything and return the full tree."""
        leaves = {p: self[p] for p in self._order}
        return skeleton_fill(self._manifest.skeleton, leaves)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class RestoreManager:
    def __init__(self, store: ChunkStore, *, timings: Timings | None = None):
        self.store = store
        self.timings = timings or Timings()

    def available_steps(self) -> list[int]:
        return committed_steps(self.store.root)

    def _pick_manifest(self, step: int | None) -> Manifest:
        """Load the requested (or newest committed) manifest.

        The pick/load pair races with GC: the step chosen as newest can be
        collected before its manifest read. Re-scan on miss instead of
        surfacing a spurious FileNotFoundError to the caller.
        """
        if step is not None:
            return load_manifest(self.store.root, step)
        for _ in range(8):
            step = latest_committed_step(self.store.root)
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.store.root}"
                )
            try:
                return load_manifest(self.store.root, step)
            except (FileNotFoundError, NotADirectoryError):
                continue
        raise FileNotFoundError(
            f"committed checkpoints under {self.store.root} kept "
            "vanishing mid-read (GC racing restore)"
        )

    def restore(
        self,
        *,
        step: int | None = None,
        device_for: DeviceFor | None = None,
        lazy: bool = False,
        verify: bool = False,
    ) -> tuple[Any, Manifest]:
        """Restore the newest (or given) committed checkpoint.

        Returns (state, manifest); in lazy mode state is a LazyLeaves whose
        ``as_tree()`` gives the tree. A leaf whose ``device_for`` is a
        device comes back as a tensor there; the others stay on the host
        (see ``checkpoint.sharded.restore_leaf``).
        """
        manifest = self._pick_manifest(step)
        if verify:
            with self.timings.measure("restore/verify"):
                verify_manifest(self.store, manifest)
        if lazy:
            return (
                LazyLeaves(self.store, manifest, device_for, timings=self.timings),
                manifest,
            )
        device_for = device_for or (lambda p, s: None)
        with self.timings.measure("restore/eager"):
            leaves = {
                path: restore_leaf(
                    self.store, lrec, device_for(path, tuple(lrec.shape))
                )
                for path, lrec in manifest.leaves.items()
            }
            state = skeleton_fill(manifest.skeleton, leaves)
        return state, manifest

    # -- proxy restart (paper §3.4: replay allocations, push data back) ---------
    def restore_into_proxy(
        self,
        runner,
        *,
        step: int | None = None,
        device_for: DeviceFor | None = None,
        verify: bool = False,
    ) -> tuple[Any, Manifest]:
        """Restore a committed image and re-create device state in a proxy.

        The paper's restart protocol for the proxy architecture: read the
        image, then replay the logged allocations into a fresh proxy process
        and transfer the data back through it. ``runner`` is a
        ``repro_torch.proxy.ProxyRunner``; a fresh runner is started with
        the restored device state (program + register + upload replayed
        from scratch), a running one gets the state pushed over its data
        plane. The leaves stay on the host (``device_for`` None): the
        application that runs a proxy never touches the card. Returns
        (state, manifest) exactly like :meth:`restore`.
        """
        state, manifest = self.restore(
            step=step, device_for=device_for, verify=verify
        )
        with self.timings.measure("restore/proxy_push"):
            if getattr(runner, "started", False):
                runner.push(state["device"])
            else:
                runner.start(
                    device_state=state["device"], base_step=int(manifest.step)
                )
        return state, manifest
