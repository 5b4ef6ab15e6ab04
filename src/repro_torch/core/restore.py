"""RestoreManager — restart protocol (paper §3.4), eager mode.

Eager restore re-creates the full state: read the manifest, assemble each
leaf's global array from its stored shards, and place it on the device the
caller names for its path (``device_for``) — the paper's "replay the
allocations, transfer the data back". The manifest is the same format the
JAX reference writes, so either package restores the other's images.

Not ported yet: lazy restore (``LazyLeaves``, the exponential read-ahead of
§4.2), ``restore_into_proxy`` (the proxy slice) and ``restore_elastic``
(the cluster slice).
"""
from __future__ import annotations

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

# (path, global shape) -> target device, or None to keep the leaf on the host
DeviceFor = Callable[[str, tuple[int, ...]], "torch.device | str | None"]


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

        Returns (state, manifest). A leaf whose ``device_for`` is a device
        comes back as a tensor there; the others stay on the host (see
        ``checkpoint.sharded.restore_leaf``).
        """
        if lazy:
            raise NotImplementedError(
                "lazy restore (LazyLeaves) is not ported to PyTorch yet"
            )
        manifest = self._pick_manifest(step)
        if verify:
            with self.timings.measure("restore/verify"):
                verify_manifest(self.store, manifest)
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
