"""Checkpoint cadence + retention policy.

The paper motivates cadence from DUE rates (§2.2): more failures => more
frequent checkpoints => blocking time matters more. The policy layer decides
*when* (steps / wall-clock / preemption signal) and *what to keep*
(keep_last N, keep_every K), including the transitive closure of delta
references so GC never strands an incremental checkpoint's base chunks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.checkpoint.manifest import (  # noqa: F401  (re-exported; it lives
    Manifest,                            # with the manifest format now)
    referenced_steps,
)


@dataclass
class CheckpointPolicy:
    interval_steps: int = 0          # 0 = disabled
    interval_secs: float = 0.0       # 0 = disabled
    keep_last: int = 2
    keep_every: int = 0              # additionally keep every K-th step
    _last_time: float = field(default_factory=time.monotonic)
    _preempt: bool = False

    def should_checkpoint(self, step: int) -> bool:
        if self._preempt:
            return True
        if self.interval_steps and step > 0 and step % self.interval_steps == 0:
            return True
        if self.interval_secs and (time.monotonic() - self._last_time) >= self.interval_secs:
            return True
        return False

    def notify_checkpointed(self, step: int) -> None:
        self._last_time = time.monotonic()
        self._preempt = False

    def request_preempt_checkpoint(self) -> None:
        """Hook for SIGTERM/preemption notice: checkpoint at the next step."""
        self._preempt = True

    def run_gc(self, store, *, extra_keep=()) -> list[int]:
        """Scan, plan and collect under this policy; returns removed steps.

        Tolerates a concurrent collector on the same root end to end: steps
        that vanish between the scan and the manifest read are treated as
        already collected (see load_manifest_if_committed), and the
        store-side deletion skips steps a racing GC got to first.

        ``extra_keep`` pins additional steps (and their delta closure) —
        the trainer passes the bases of in-flight incremental persists,
        whose manifests are not on disk yet and so invisible to the scan.
        """
        from repro_torch.checkpoint.manifest import (
            committed_steps,
            load_manifest_if_committed,
        )

        committed = committed_steps(store.root)
        manifests = {
            s: m
            for s in committed
            if (m := load_manifest_if_committed(store.root, s)) is not None
        }
        if not manifests:
            return []
        keep = self.gc_keep(sorted(manifests), manifests, extra_keep=extra_keep)
        if set(keep) == set(manifests):
            return []
        return store.gc(keep)

    def gc_keep(
        self,
        committed: list[int],
        manifests: dict[int, Manifest],
        *,
        extra_keep=(),
    ) -> list[int]:
        """Which steps to keep: keep_last + keep_every + delta closure."""
        keep: set[int] = set()
        for s in sorted(committed)[-self.keep_last :] if self.keep_last else []:
            keep.add(s)
        if self.keep_every:
            keep.update(s for s in committed if s % self.keep_every == 0)
        keep.update(s for s in extra_keep if s in committed)
        # transitive closure over delta references
        frontier = list(keep)
        while frontier:
            s = frontier.pop()
            m = manifests.get(s)
            if m is None:
                continue
            for ref in referenced_steps(m):
                if ref not in keep and ref in committed:
                    keep.add(ref)
                    frontier.append(ref)
        return sorted(keep)
