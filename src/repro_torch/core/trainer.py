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

Device-runner axis (``device_runner=``): ``inline`` executes the step
function in-process (the default, above); ``proxy`` is the paper's actual
architecture — compute runs in a separate restartable proxy process
(``repro_torch.proxy.ProxyRunner``) built from a replayable ``program``
spec, the app holds only the host mirror and never touches the card, and
``state["device"]`` is refreshed from the proxy at every sync/checkpoint
boundary. A killed proxy is respawned and its API log replayed
transparently mid-``run()``.

Managed-memory axis (``device_capacity_bytes=``): when set, the device
state lives in a ``repro_torch.uvm.ManagedSpace`` — host backing plus a
bounded arena of page frames on ``device`` — so training states *larger
than the device budget* work: each step faults its working set in
(evicting and writing back under pressure), computes on the assembled card
tensors and write-allocates the results back, and the checkpointer
consumes the space's page-granular dirty history (page-delta sync instead
of whole-leaf digest scans). In proxy mode the budget applies inside the
proxy process instead.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.checkpoint.codecs import DEFAULT_CODEC
from repro_torch.checkpoint.store import ChunkStore
from repro_torch.core.forked import CheckpointResult, ForkedCheckpointer
from repro_torch.core.policy import CheckpointPolicy
from repro_torch.core.restore import DeviceFor, RestoreManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.timing import Timings

DEVICE_RUNNERS = ("inline", "proxy")


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
        program: dict | None = None,
        proxy_opts: dict | None = None,
        device_capacity_bytes: int | None = None,
        page_bytes: int | None = None,
        eviction_policy: str = "lru",
        promote_threshold: int = 0,
        promote_window: int = 0,
        device: str | torch.device = "cuda",
        timings: Timings | None = None,
    ):
        """``device`` is where an inline managed space keeps its frames
        (the card unless the caller asks for the CPU)."""
        if device_runner not in DEVICE_RUNNERS:
            raise ValueError(
                f"unknown device_runner {device_runner!r}; have {DEVICE_RUNNERS}"
            )
        self.train_step = train_step
        self.device_runner = device_runner
        self.store = ChunkStore(store_root)
        self.policy = policy or CheckpointPolicy(interval_steps=100)
        self.timings = timings or Timings()
        self.device_capacity_bytes = (
            int(device_capacity_bytes) if device_capacity_bytes else None
        )
        self.page_bytes = page_bytes
        self.eviction_policy = eviction_policy
        self.promote_threshold = int(promote_threshold)
        self.promote_window = int(promote_window)
        self.device = device
        self.space = None  # ManagedSpace, created on first run() when capped
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
        self.runner = None
        if device_runner == "proxy":
            if program is None:
                raise ValueError("device_runner='proxy' needs a program spec")
            from repro_torch.proxy import ProxyRunner

            popts = dict(proxy_opts or {})
            if self.device_capacity_bytes is not None:
                # the budget applies where the device state lives: inside
                # the proxy process
                popts.setdefault(
                    "device_capacity_bytes", self.device_capacity_bytes
                )
                if page_bytes is not None:
                    popts.setdefault("page_bytes", int(page_bytes))
                popts.setdefault("eviction_policy", eviction_policy)
                popts.setdefault("promote_threshold", self.promote_threshold)
                popts.setdefault("promote_window", self.promote_window)
            self.runner = ProxyRunner(program, chunk_bytes=chunk_bytes, **popts)

    # -- managed memory -----------------------------------------------------------
    def _ensure_space(self, device_state: Any) -> None:
        """Back ``device_state`` with a ManagedSpace (inline managed mode)
        and hand its dirty history to the checkpointer."""
        from repro_torch.uvm import DEFAULT_PAGE_BYTES, ManagedSpace

        if self.space is None:
            self.space = ManagedSpace(
                self.device_capacity_bytes,
                page_bytes=self.page_bytes or DEFAULT_PAGE_BYTES,
                eviction_policy=self.eviction_policy,
                promote_threshold=self.promote_threshold,
                promote_window=self.promote_window,
                device=self.device,
            )
        self.space.register(device_state)
        # state["device"] leaves appear under the "device/" prefix in the
        # checkpointed tree; marks must use those paths
        self.checkpointer.dirty_source = self.space.as_dirty_source("device/")

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
        to (None keeps it on the host); in inline managed mode the device
        leaves come back as CPU tensors for the space's host backing. In
        proxy mode the (restored or fresh) device state is pushed into a
        freshly-started proxy instead —
        the paper's restart protocol of replaying allocations and
        transferring data back through the proxy — and ``state["device"]``
        is its host mirror. Returns (state, start_step).
        """
        steps = self.restorer.available_steps()
        if not steps:
            state = init_fn()
            start = int(np.asarray(_get(state, "host", "step", default=0)))
            if self.runner is not None:
                state["device"] = self.runner.start(
                    device_state=state.get("device"), base_step=start
                )
            return state, start
        if self.runner is not None:
            state, _manifest = self.restorer.restore_into_proxy(
                self.runner, step=steps[-1], device_for=device_for, verify=verify
            )
        else:
            if self.device_capacity_bytes is not None:
                # managed: the device leaves land in the space's host
                # backing, so they come back as CPU tensors (not onto the
                # card and back, and never as numpy: the step takes tensors)
                place = device_for or (lambda p, s: None)

                def device_for(path, shape, place=place):
                    return "cpu" if path.startswith("device/") else place(path, shape)

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
        if self.runner is not None:
            if batches is not None:
                raise ValueError(
                    "device_runner='proxy' derives batches inside the step "
                    "program (deterministic in the step number — that is "
                    "what makes replay bit-identical); a batches iterator "
                    "here would be silently ignored"
                )
            return self._run_proxied(
                state, num_steps=num_steps, start_step=start_step,
                on_metrics=on_metrics, stop=stop,
            )
        if batches is None:
            raise ValueError("inline device runner needs a batches iterator")
        managed = self.device_capacity_bytes is not None
        if managed:
            self._ensure_space(state["device"])
        self.checkpointer.prepare(state)
        step = start_step
        tr = obs_trace.get()
        for _ in range(num_steps):
            batch = next(batches)
            t0 = time.perf_counter() if tr is not None else 0.0
            with self.timings.measure("train/step"):
                if managed:
                    # device access: fault the working set in under the
                    # budget, compute, write-allocate the results back
                    with self.timings.measure("train/page_in"):
                        dev = self.space.read_state()
                    dev, metrics = self.train_step(dev, batch)
                    with self.timings.measure("train/page_out"):
                        self.space.write_state(dev)
                else:
                    state["device"], metrics = self.train_step(
                        state["device"], batch
                    )
            step += 1
            if tr is not None:
                tr.complete("app.step", t0, step=step)
            state["host"]["step"] = np.int64(step)
            if on_metrics is not None:
                on_metrics(step, metrics)
            if self.policy.should_checkpoint(step):
                if managed:
                    # coherent host view, no migrations: the sync source
                    state["device"] = self.space.peek_state()
                self.checkpoint_now(step, state)
            if stop is not None and stop():
                break
        if managed:
            state["device"] = self.space.peek_state()
        return state

    def _run_proxied(
        self,
        state: Any,
        *,
        num_steps: int,
        start_step: int,
        on_metrics: Callable[[int, Any], None] | None,
        stop: Callable[[], bool] | None = None,
    ) -> Any:
        """Proxy mode: forward pipelined STEP calls; checkpoint boundaries
        issue a pipelined epoch SYNC and keep stepping — the SYNCED ack is
        polled opportunistically each iteration and only *collected*
        (blocking) when the next boundary needs the data plane, so the
        boundary stall overlaps with the following steps' compute. Batches
        are program-internal (deterministic in the step number) — that
        determinism is what makes kill-replay bit-identical."""
        step = start_step
        synced_at = start_step - 1
        pending: tuple[int, int] | None = None  # (epoch, boundary step)
        tr = obs_trace.get()
        for _ in range(num_steps):
            step += 1
            t0 = time.perf_counter() if tr is not None else 0.0
            with self.timings.measure("train/step"):
                self.runner.step(step)
            if tr is not None:
                tr.complete("app.step", t0, step=step)
            state["host"]["step"] = np.int64(step)
            if pending is not None:
                res = self.runner.sync_poll(pending[0])
                if res is not None:
                    synced_at = self._commit_boundary(
                        state, pending[1], res, on_metrics
                    )
                    pending = None
            if self.policy.should_checkpoint(step):
                if pending is not None:
                    # one epoch in flight at a time: the data plane must be
                    # mirrored before the next SYNC rewrites it
                    synced_at = self._collect_boundary(
                        state, pending, on_metrics
                    )
                with self.timings.measure("train/proxy_sync_begin"):
                    pending = (self.runner.sync_begin(), step)
                if tr is not None:
                    tr.instant("app.sync_begin", epoch=pending[0], step=step)
            if stop is not None and stop():
                break
        if pending is not None:
            synced_at = self._collect_boundary(state, pending, on_metrics)
        if synced_at != step:
            with self.timings.measure("train/proxy_sync"):
                state["device"], info = self.runner.sync_state()
            if on_metrics is not None:
                on_metrics(step, info.get("metrics", {}))
        return state

    def _collect_boundary(
        self,
        state: Any,
        pending: tuple[int, int],
        on_metrics: Callable[[int, Any], None] | None,
    ) -> int:
        with self.timings.measure("train/proxy_sync"):
            res = self.runner.sync_collect(pending[0])
        return self._commit_boundary(state, pending[1], res, on_metrics)

    def _commit_boundary(
        self,
        state: Any,
        boundary: int,
        res: tuple[Any, dict],
        on_metrics: Callable[[int, Any], None] | None,
    ) -> int:
        """SYNCED{epoch} for a checkpoint boundary arrived: checkpoint the
        boundary image under the boundary's step number (the loop may have
        run ahead of it — the whole point of the overlap)."""
        device, info = res
        state["device"] = device
        ck_state = dict(state)
        ck_state["host"] = dict(state["host"])
        ck_state["host"]["step"] = np.int64(boundary)
        if on_metrics is not None:
            on_metrics(boundary, info.get("metrics", {}))
        r = self.checkpoint_now(boundary, ck_state)
        r.stall_us = float(info.get("stall_us", 0.0))
        return boundary

    def materialize(self, state: Any) -> Any:
        """Refresh ``state["device"]`` from the managed space (no-op when
        unmanaged). Callers outside :meth:`run` — preemption handlers, the
        launch CLI — use this before ``checkpoint_now``."""
        if self.space is not None:
            state["device"] = self.space.peek_state()
        return state

    def paging_stats(self) -> dict | None:
        """The managed space's fault/eviction/migration counters."""
        return self.space.stats_dict() if self.space is not None else None

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
        if self.runner is not None:
            self.runner.close()
        self._gc()  # in-flight persists have committed by now
        if self.space is not None:
            obs_metrics.absorb_paging(self.space.stats_dict())
        obs_metrics.dump_if_enabled("app")
        return list(self.results)


def _get(tree: Any, *keys: str, default=None) -> Any:
    node = tree
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node
