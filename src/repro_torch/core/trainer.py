"""CheckpointedTrainer — the paper's technique as a first-class feature.

Wraps any ``train_step(device_state, batch) -> (device_state, metrics)``
over PyTorch tensors with CRUM-style fault tolerance:

  - forked (two-phase async) checkpointing on a cadence policy,
  - incremental persistence (digest-delta against the previous image),
  - restart: newest committed image -> device state placed on the card,
    data iterator replayed,
  - preemption-triggered checkpoint.

State layout (a plain dict tree; everything checkpointable):

    {"device": {...tensors...},            # params / opt state / step
     "host":   {"step": np.int64, "data": {...iterator state...}}}

Only the inline device runner is ported: the step runs in this process.
The proxy runner (``device_runner="proxy"``) and managed memory
(``device_capacity_bytes``) come with later slices of the port and raise
here.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.checkpoint.codecs import DEFAULT_CODEC
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.core.forked import CheckpointResult, ForkedCheckpointer
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.restore import DeviceFor, RestoreManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.timing import Timings

DEVICE_RUNNERS = ("inline",)


class CheckpointedTrainer:
    def __init__(
        self,
        train_step: Callable[[Any, Any], tuple[Any, Any]] | None,
        *,
        store_root: str,
        policy: CheckpointPolicy | None = None,
        codec: str = DEFAULT_CODEC,
        chunk_bytes: int = 4 << 20,
        incremental: bool = True,
        io_workers: int | None = None,
        host: int = 0,
        backend: str = "thread",
        device_runner: str = "inline",
        device_capacity_bytes: int | None = None,
        timings: Timings | None = None,
    ):
        if device_runner not in DEVICE_RUNNERS:
            raise NotImplementedError(
                f"device_runner {device_runner!r} is not ported to PyTorch "
                f"yet; have {DEVICE_RUNNERS}"
            )
        if device_capacity_bytes:
            raise NotImplementedError(
                "managed-memory (UVM) training is not ported to PyTorch yet"
            )
        self.train_step = train_step
        self.device_runner = device_runner
        self.store = ChunkStore(store_root)
        self.policy = policy or CheckpointPolicy(interval_steps=100)
        self.timings = timings or Timings()
        self.checkpointer = ForkedCheckpointer(
            self.store,
            codec=codec,
            chunk_bytes=chunk_bytes,
            incremental=incremental,
            io_workers=io_workers,
            host=host,
            backend=backend,
            timings=self.timings,
        )
        self.restorer = RestoreManager(self.store, timings=self.timings)
        self.results: list[CheckpointResult] = []

    # -- restart ----------------------------------------------------------------
    def resume_or(
        self,
        init_fn: Callable[[], Any],
        *,
        device_for: DeviceFor | None = None,
        verify: bool = False,
    ) -> tuple[Any, int]:
        """Restore the newest committed state or build a fresh one.

        ``device_for(path, shape)`` names the device each restored leaf goes
        to (None keeps it on the host). Returns (state, start_step).
        """
        steps = self.restorer.available_steps()
        if not steps:
            state = init_fn()
            start = int(np.asarray(_get(state, "host", "step", default=0)))
            return state, start
        state, _manifest = self.restorer.restore(
            step=steps[-1], device_for=device_for, verify=verify
        )
        start = int(np.asarray(state["host"]["step"]))
        return state, start

    # -- the train loop -----------------------------------------------------------
    def run(
        self,
        state: Any,
        batches: Iterator[Any] | None = None,
        *,
        num_steps: int,
        start_step: int = 0,
        on_metrics: Callable[[int, Any], None] | None = None,
        stop: Callable[[], bool] | None = None,
    ) -> Any:
        """``stop`` (checked after each step's checkpoint decision) ends
        the loop early — the preemption hook for callers that delegate
        their loop here instead of hand-rolling one."""
        if batches is None:
            raise ValueError("inline device runner needs a batches iterator")
        step = start_step
        tr = obs_trace.get()
        for _ in range(num_steps):
            batch = next(batches)
            t0 = time.perf_counter() if tr is not None else 0.0
            with self.timings.measure("train/step"):
                state["device"], metrics = self.train_step(state["device"], batch)
            step += 1
            if tr is not None:
                tr.complete("app.step", t0, step=step)
            state["host"]["step"] = np.int64(step)
            if on_metrics is not None:
                on_metrics(step, metrics)
            if self.policy.should_checkpoint(step):
                self.checkpoint_now(step, state)
            if stop is not None and stop():
                break
        return state

    def checkpoint_now(self, step: int, state: Any) -> CheckpointResult:
        r = self.checkpointer.save_async(step, state, meta={"wall": time.time()})
        self.results.append(r)
        self.policy.notify_checkpointed(step)
        self._gc()
        return r

    def _gc(self) -> None:
        # pin the bases of in-flight incremental persists: their manifests
        # are not on disk yet, so the policy's scan alone cannot see that
        # an older step's chunks are still referenced
        self.policy.run_gc(
            self.store, extra_keep=self.checkpointer.inflight_delta_bases()
        )

    # -- teardown ---------------------------------------------------------------
    def finish(self) -> list[CheckpointResult]:
        # wait on THIS trainer's results, not the checkpointer's pending
        # list: a persist that completed before the next save_async's reap
        # has already left that list, and wait_all() alone would silently
        # return fewer results than checkpoints taken
        self.checkpointer.wait_all()
        for r in self.results:
            r.done.wait()
        self.checkpointer.close()
        self._gc()  # in-flight persists have committed by now
        obs_metrics.dump_if_enabled("app")
        return list(self.results)


def _get(tree: Any, *keys: str, default=None) -> Any:
    node = tree
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node
