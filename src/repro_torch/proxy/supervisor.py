"""ProxyRunner — supervised, restartable proxied execution.

The process-level half of the proxy subsystem: owns the durable API log,
the data-plane transport (``repro_torch.remote.transport``: shared
segments locally, streamed chunk frames cross-host), and the current
:class:`DeviceProxy` incarnation. Any transport failure is treated as proxy death and answered
with the paper's restart protocol, mid-training:

    1. spend one unit of the restart budget (``core.failure.RestartBudget``),
    2. bring up a fresh proxy — respawn locally, or ask the
       ``endpoint_provider`` for a (possibly different) proxy endpoint
       (jittered backoff between attempts so a crash-looping endpoint is
       not hammered),
    3. replay the API log: PROGRAM, REGISTER, then push the last synced
       snapshot back through the transport (UPLOAD — served by
       ``ShadowStateManager.upload`` on the proxy side),
    4. re-issue every logged STEP after the last SYNC.

Deterministic step programs make the recovered state bit-identical to an
uninterrupted run, so training simply continues.

The application never holds device state: ``start(None)`` asks the
program for its init on the host (torch programs build it on the CPU with
an explicit generator), and the mirror of every acknowledged sync is host
memory — numpy arrays, and CPU tensors for bfloat16 leaves.

Torn-sync hazard (CRAC's "streams in flight"): a SIGKILL mid-SYNC can
leave data-plane bytes mixed between two steps (segments half-written, or
only some streamed CHUNKS frames applied), so the transport table alone is
not a safe replay source. The runner therefore keeps a host-side mirror of
the last *acknowledged* sync (``sync_state()`` returns it to the caller
anyway — checkpointing needs the copy) and rewrites the table from that
mirror before the replay UPLOAD.
"""
from __future__ import annotations

import os
import random
import time
from typing import Any, Callable

import numpy as np

from repro_torch.core.failure import RestartBudget
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.proxy.api_log import ApiLog
from repro_torch.proxy.client import DeviceProxy
from repro_torch.proxy.protocol import ProxyDiedError
from repro_torch.utils.dtypes import dtype_name
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

# NOTE: repro_torch.remote.transport is imported lazily (start()): it builds
# on repro_torch.proxy.segments, so a module-level import here would cycle
# through the package __init__ while remote.transport itself is mid-import.

# first step of the jittered backoff between respawn attempts (seconds)
RESPAWN_BACKOFF_S = 0.05


class ProxyRunner:
    """The trainer-facing device runner for ``device_runner="proxy"``."""

    def __init__(
        self,
        program_spec: dict[str, Any],
        *,
        workdir: str | None = None,
        log_path: str | None = None,
        chunk_bytes: int = 1 << 20,
        transport: str = "segment",
        compress: bool | None = None,
        train_dict: bool = False,
        fused_digests: bool = False,
        endpoint_provider: Callable[..., tuple[str, int]] | None = None,
        device_capacity_bytes: int | None = None,
        page_bytes: int | None = None,
        eviction_policy: str = "lru",
        promote_threshold: int = 0,
        promote_window: int = 0,
        max_restarts: int = 3,
        max_pipeline: int = 64,
        sync_timeout_s: float = 120.0,
        op_timeout_s: float = 120.0,
    ):
        # managed-memory mode: the proxy hosts its device state in a paged
        # ManagedSpace under this budget (REGISTER carries the fields)
        self.device_capacity_bytes = (
            int(device_capacity_bytes) if device_capacity_bytes else None
        )
        self.page_bytes = page_bytes
        if self.device_capacity_bytes is not None:
            from repro_torch.uvm import DEFAULT_PAGE_BYTES

            pb = int(page_bytes or DEFAULT_PAGE_BYTES)
            if self.device_capacity_bytes < pb:
                raise ValueError(
                    f"device capacity {self.device_capacity_bytes}B is smaller "
                    f"than one page ({pb}B) — nothing could ever be resident"
                )
        self.eviction_policy = eviction_policy
        self.promote_threshold = int(promote_threshold)
        self.promote_window = int(promote_window)
        self.program_spec = dict(program_spec)
        self.chunk_bytes = int(chunk_bytes)
        self.transport_kind = transport
        self.compress = compress
        # stream transport: train a zstd dictionary on the initial state's
        # chunks and ship it in REGISTER — small-chunk frames compress
        # against shared context instead of starting cold every time
        self.train_dict = bool(train_dict)
        # fused digesting: every proxied STEP ends with a chunk-digest
        # pass, so SYNC boundaries compare ready-made hashes (no scan)
        self.fused_digests = bool(fused_digests)
        # placement seam: when set, incarnations connect OUT to whatever
        # endpoint the provider names (provider(failed=True) after a death
        # reports the loss and may return a different host — the
        # reschedule-and-replay path). None = spawn a local child process.
        self.endpoint_provider = endpoint_provider
        self.sync_timeout_s = sync_timeout_s
        self._proxy_opts = dict(max_pipeline=max_pipeline, op_timeout_s=op_timeout_s)
        self.budget = RestartBudget(max_restarts, what="device proxy")
        self.transport = None  # ChunkTransport, created by start()
        self._explicit_workdir = workdir
        self._log_path = log_path
        self._owned_log_dir: str | None = None
        self.log: ApiLog | None = None
        self.proxy: DeviceProxy | None = None
        self.started = False
        self.last_synced_step = 0
        self.last_digest: str | None = None
        # pipelined epoch syncs: monotonically increasing epoch counter and
        # the (at most one) issued-but-unacked epoch:
        #   epoch -> (boundary step, _steps_since_sync at issue time)
        # Serialized on purpose: the data-plane table is rewritten by every
        # SYNC, so the mirror of epoch N must be captured before epoch N+1
        # is allowed to touch the table.
        self._sync_epoch = 0
        self._pending_epochs: dict[int, tuple[int, int]] = {}
        self._last_issued_step = 0
        self._last_state: Any = None  # host mirror of the last acked sync
        # STEP frames issued since the last acked sync/upload: while any
        # are outstanding the proxy's device state has moved PAST the
        # mirror, so a chunk-delta push diffed against the mirror would
        # under-upload — push() falls back to a full upload then
        self._steps_since_sync = 0
        self.recoveries: list[dict[str, Any]] = []
        # causal trace context installed by the caller for the current
        # checkpoint window. While set, every
        # outgoing STEP/SYNC/UPLOAD/REGISTER frame carries a fresh child
        # context so the proxy's spans join the round's causal tree; None
        # (tracing off, or no round in flight) keeps frames byte-identical
        # to the pre-ctx wire format.
        self.trace_ctx: dict | None = None

    def _paging_fields(self) -> dict[str, Any]:
        """REGISTER's managed-memory fields (the reference's names)."""
        return {
            "device_capacity_bytes": self.device_capacity_bytes,
            "page_bytes": self.page_bytes,
            "eviction_policy": self.eviction_policy,
            "promote_threshold": self.promote_threshold,
            "promote_window": self.promote_window,
        }

    def _frame_ctx(self) -> dict | None:
        """A child context for one outgoing frame (None when untraced)."""
        if self.trace_ctx is None:
            return None
        return obs_trace.child_span(self.trace_ctx)

    # -- lifecycle ---------------------------------------------------------------
    def start(self, device_state: Any = None, *, base_step: int = 0) -> Any:
        """Bring up the proxy and create device state in it.

        ``device_state=None`` asks the program for a fresh init, built on
        the host in this process (both sides share the registry, so the
        layout is known without a round-trip; the proxy allocates the
        structure on its device and the upload fills it). A restored state
        (the RestoreManager proxy path) is pushed as-is. Returns the host
        mirror of the state.
        """
        if self.started:
            raise RuntimeError("ProxyRunner already started; use push()")
        from repro_torch.remote.transport import default_log_dir, make_transport

        if device_state is None:
            from repro_torch.proxy.programs import host_program

            device_state = host_program(self.program_spec).init_state()
        self.transport = make_transport(
            self.transport_kind,
            device_state,
            self.chunk_bytes,
            workdir=self._explicit_workdir,
            compress=self.compress,
            train_dict=self.train_dict,
        )
        log_path = self._log_path
        if log_path is None:
            log_dir = self.transport.table.workdir or self._explicit_workdir
            if log_dir is None:
                log_dir = self._owned_log_dir = default_log_dir()
            log_path = os.path.join(log_dir, "API_LOG.bin")
        self.log = ApiLog(log_path, truncate=True)
        self.log.append({"call": "program", "spec": self.program_spec})
        self.log.append({
            "call": "register",
            **self.transport.register_fields(),
            "chunk_bytes": self.chunk_bytes,
            **self._paging_fields(),
            "fused_digests": self.fused_digests,
        })
        self.log.append({"call": "upload", "step": int(base_step), "paths": None})
        self.last_synced_step = int(base_step)
        self._last_issued_step = int(base_step)
        self._last_state = self.transport.read_state()
        self._steps_since_sync = 0
        self._spawn_and_replay(upload_only=True)
        self.started = True
        return self._last_state

    def push(self, device_state: Any) -> dict[str, Any]:
        """Overwrite proxy device state (restore path on a live runner).

        Delta-aware: when the last acked sync mirror is structurally
        compatible with ``device_state``, only the chunk ranges whose bytes
        differ are rewritten into the data plane and named in the UPLOAD
        frame — bytes on the wire scale with dirty chunks, not state size.
        Returns the proxy's UPLOAD ack ({bytes_uploaded, chunks_uploaded}).
        """
        self._require_started()
        # an UPLOAD record is a positional watermark that clears everything
        # before it from the replay tail — collect any in-flight epoch sync
        # first so its ack (and mirror) are not silently dropped
        self._drain_pending()
        chunks = (
            self._chunk_delta(device_state)
            if self._steps_since_sync == 0 else None
        )
        self.transport.stage(device_state, chunks)
        self._last_state = self.transport.read_state()
        self.log.append({
            "call": "upload", "step": self.last_synced_step, "paths": None,
            "chunks": chunks,
        })
        try:
            reply = self.proxy.upload(
                step=self.last_synced_step,
                chunks=chunks,
                payload_frames=self.transport.payload_frames(chunks),
                ctx=self._frame_ctx(),
            )
        except ProxyDiedError:
            # recovery rewrites the data plane from the (already updated)
            # mirror and replays a FULL upload — the pushed state lands
            self._recover()
            return {"op": "UPLOAD", "replayed": True}
        self._steps_since_sync = 0  # device == mirror again
        return reply

    def _chunk_delta(self, new_state: Any) -> dict[str, list[int]] | None:
        """{path: chunk indices} whose bytes differ from the last acked
        sync mirror; None when no mirror (or the tree changed shape) and a
        full rewrite is required."""
        if self._last_state is None:
            return None
        old, _ = flatten_with_paths(self._last_state)
        new, _ = flatten_with_paths(new_state)
        if old.keys() != new.keys():
            return None
        cb = self.chunk_bytes
        delta: dict[str, list[int]] = {}
        for path, leaf in new.items():
            if dtype_name(old[path]) != dtype_name(leaf):
                return None
            a, b = leaf_bytes(old[path]), leaf_bytes(leaf)
            if a.nbytes != b.nbytes:
                return None
            if a.nbytes == 0:
                continue
            diff = np.flatnonzero(a != b)
            if diff.size:
                delta[path] = np.unique(diff // cb).tolist()
        return delta

    def close(self) -> None:
        if self.proxy is not None:
            self.proxy.close()
            self.proxy = None
        if self.log is not None:
            self.log.close()
        if self.transport is not None:
            self.transport.close(unlink=True)
            self.transport = None
        if self._owned_log_dir is not None:
            import shutil

            shutil.rmtree(self._owned_log_dir, ignore_errors=True)
            self._owned_log_dir = None
        self.started = False

    # -- the pipelined call stream -------------------------------------------------
    def step(self, step: int) -> None:
        """Forward one train step; returns immediately (pipelined)."""
        self._require_started()
        self.log.append({"call": "step", "step": int(step)})
        self._steps_since_sync += 1
        self._last_issued_step = int(step)
        try:
            self.proxy.step(int(step), ctx=self._frame_ctx())
        except ProxyDiedError:
            self._recover()  # the log already holds this step: replay runs it

    def drain(self) -> None:
        """Pipeline barrier (``core.drain.drain(runner=...)`` hook)."""
        self._require_started()
        try:
            self.proxy.flush()
        except ProxyDiedError:
            self._recover()

    def sync_state(self) -> tuple[Any, dict[str, Any]]:
        """Blocking sync: issue an epoch SYNC and immediately collect it.

        The compat barrier — ``sync_begin()`` + ``sync_collect()`` with no
        overlap in between. The returned state is a host-side copy (safe to
        checkpoint, safe to keep as the recovery mirror). ``info`` carries
        the proxy's step, state digest, per-sync transfer stats and last
        step metrics.
        """
        return self.sync_collect(self.sync_begin())

    def sync_begin(self) -> int:
        """Issue a pipelined SYNC at the current step boundary; returns its
        epoch. The caller keeps stepping and later matches the ack with
        ``sync_poll``/``sync_collect`` — the proxy still executes the sync
        in pipeline order, so the captured image is exactly the state at
        this boundary."""
        self._require_started()
        self._drain_pending()  # serialize: one in-flight epoch at a time
        self._sync_epoch += 1
        epoch = self._sync_epoch
        self.log.append({
            "call": "sync_begin",
            "epoch": epoch,
            "step": self._last_issued_step,
        })
        self._pending_epochs[epoch] = (
            self._last_issued_step, self._steps_since_sync,
        )
        try:
            self.proxy.sync_begin(epoch, ctx=self._frame_ctx())
        except ProxyDiedError:
            self._recover()  # replay re-issues this SYNC at its boundary
        return epoch

    def sync_poll(self, epoch: int) -> tuple[Any, dict[str, Any]] | None:
        """Non-blocking: (state, info) if SYNCED{epoch} has arrived, else
        None. Proxy death during the poll triggers recovery (which re-issues
        the pending sync) and reports None — poll again later."""
        self._require_started()
        try:
            msg = self.proxy.poll_synced(epoch)
        except ProxyDiedError:
            self._recover()
            return None
        if msg is None:
            return None
        return self._finish_sync(epoch, msg, stall_us=0.0)

    def sync_collect(
        self, epoch: int, *, timeout: float | None = None
    ) -> tuple[Any, dict[str, Any]]:
        """Block until SYNCED{epoch} arrives; returns (state, info). The
        blocked wall time is reported as ``info["stall_us"]`` — the number
        the pipelined trainer drives toward zero."""
        self._require_started()
        t0 = time.perf_counter()
        while True:
            try:
                msg = self.proxy.collect_synced(
                    epoch, timeout=timeout or self.sync_timeout_s
                )
                break
            except ProxyDiedError:
                self._recover()  # replay re-issued the SYNC: collect again
        stall_us = (time.perf_counter() - t0) * 1e6
        return self._finish_sync(epoch, msg, stall_us=stall_us)

    def _drain_pending(self) -> None:
        for epoch in sorted(self._pending_epochs):
            self.sync_collect(epoch)

    def _finish_sync(
        self, epoch: int, msg: dict[str, Any], *, stall_us: float
    ) -> tuple[Any, dict[str, Any]]:
        """SYNCED{epoch} arrived: capture the mirror, make the boundary a
        replay watermark (the ack record), rebase the stale-step counter."""
        boundary, steps_at_begin = self._pending_epochs.pop(epoch)
        self.last_synced_step = int(msg.get("step", boundary))
        self.last_digest = msg.get("digest")
        self.log.append({
            "call": "sync",
            "step": self.last_synced_step,
            "digest": self.last_digest,
            "epoch": epoch,
        })
        self._last_state = self.transport.read_state()
        # steps issued while this sync was in flight are PAST the mirror
        self._steps_since_sync = max(
            0, self._steps_since_sync - steps_at_begin
        )
        info = {
            "step": self.last_synced_step,
            "digest": self.last_digest,
            "epoch": epoch,
            "stall_us": stall_us,
            "metrics": msg.get("metrics", {}),
            "chunks_synced": msg.get("chunks_synced", 0),
            "bytes_synced": msg.get("bytes_synced", 0),
            "restarts": self.budget.count,
            "transport": self.transport.stats(),
        }
        for key in (
            "wire_bytes", "raw_bytes", "paging", "phase_us", "chunk_digests",
        ):
            if key in msg:
                info[key] = msg[key]
        # one registry absorbs the whole SYNCED summary — paging counters,
        # wire counters and phase breakdown ride the frame they always rode
        obs_metrics.absorb_sync_info(info)
        tr = obs_trace.get()
        if tr is not None and stall_us:
            # backdated span: the boundary stalled [now - stall_us, now]
            tr.complete(
                "app.sync_stall",
                time.perf_counter() - stall_us / 1e6,
                epoch=epoch,
                step=self.last_synced_step,
                **obs_trace.ctx_args(self._frame_ctx()),
            )
        return self._last_state, info

    # -- failure drills ------------------------------------------------------------
    def kill(self) -> int | None:
        """SIGKILL the current incarnation (drills/benchmarks); returns pid."""
        pid = self.proxy.pid if self.proxy else None
        if self.proxy is not None:
            self.proxy.kill()
        return pid

    @property
    def restarts(self) -> int:
        return self.budget.count

    @property
    def segments(self):
        """The data-plane table (historical name kept for callers/tests)."""
        return self.transport.table if self.transport is not None else None

    # -- respawn + replay ------------------------------------------------------------
    def _require_started(self) -> None:
        if not self.started or self.proxy is None:
            raise RuntimeError("ProxyRunner is not started")

    def _next_endpoint(self, *, failed: bool) -> tuple[str, int] | None:
        if self.endpoint_provider is None:
            return None
        return self.endpoint_provider(failed=failed)

    def _spawn_and_replay(
        self, *, upload_only: bool = False, failed: bool = False
    ) -> list[int]:
        """Bring up a fresh incarnation from the API log (+ the mirror);
        returns the step numbers replayed."""
        endpoint = self._next_endpoint(failed=failed)
        self.proxy = DeviceProxy(endpoint=endpoint, **self._proxy_opts).start()
        self.proxy.on_data = self.transport.on_chunks
        self.proxy.send_program(self.program_spec)
        # correlation IDs ride the REGISTER frame: the service tags its
        # step/sync spans with this incarnation number, so a merged trace
        # separates pre-kill execution from post-respawn replay
        tr = obs_trace.get()
        self.proxy.register(
            **self.transport.register_fields(),
            chunk_bytes=self.chunk_bytes,
            **self._paging_fields(),
            fused_digests=self.fused_digests,
            obs={
                "inc": self.budget.count,
                "run": tr.run_id if tr is not None else None,
                "dir": tr.obs_dir if tr is not None else None,
                # re-attach marker: a respawned incarnation registers under
                # the *current* round's context, so its spans (including
                # the replayed frames below) join the retried round's tree
                # instead of floating free
                "ctx": self._frame_ctx(),
            },
        )
        self.proxy.upload(
            step=self.last_synced_step,
            payload_frames=self.transport.payload_frames(None),
            ctx=self._frame_ctx(),
        )
        if upload_only:
            return []
        _prog, _reg, actions = self.log.replay_actions()
        steps = []
        for a in actions:
            if a[0] == "step":
                self.proxy.step(a[1], ctx=self._frame_ctx())
                steps.append(a[1])
            else:  # ("sync", epoch, step): unacked epoch sync — re-issue at
                # the same boundary so its SYNCED{epoch} is still collectable
                self.proxy.sync_begin(a[1], ctx=self._frame_ctx())
        return steps

    def _recover(self) -> None:
        """The kill-replay path: bring up a fresh incarnation (possibly on
        a different endpoint), rewrite the data plane from the last acked
        sync, replay logged steps past it. A fresh incarnation dying
        *during* the replay spends more budget and retries — with a
        jittered backoff so a flapping endpoint is not hammered — rather
        than aborting while budget remains."""
        t0 = time.perf_counter()
        attempt = 0
        tr = obs_trace.get()
        if tr is not None:
            tr.begin("proxy.respawn", resumed_from=self.last_synced_step)
        try:
            steps = self._recover_loop(attempt)
        finally:
            if tr is not None:
                tr.end("proxy.respawn")
        obs_metrics.REGISTRY.inc("proxy_restarts")
        if tr is not None:
            tr.instant("proxy.replayed", steps=len(steps),
                       inc=self.budget.count,
                       resumed_from=self.last_synced_step)
        # the fresh incarnation re-executed exactly the steps past the
        # last watermark: the mirror is stale by that many steps again
        self._steps_since_sync = len(steps)
        self.recoveries.append({
            "recovery_s": time.perf_counter() - t0,
            "replayed_steps": len(steps),
            "resumed_from_step": self.last_synced_step,
            "endpoint": getattr(self.proxy, "endpoint", None),
        })

    def _recover_loop(self, attempt: int) -> list[int]:
        while True:
            self.budget.spend(f"last synced step {self.last_synced_step}")
            old = self.proxy
            self.proxy = None
            if old is not None:
                old.close(graceful=False)
            if attempt:
                # full jitter, exponentially widening, capped at ~2s: avoid
                # thundering back onto an endpoint that just died under load
                time.sleep(random.uniform(
                    0.0, min(RESPAWN_BACKOFF_S * (2 ** attempt), 2.0)
                ))
            attempt += 1
            # a SIGKILL mid-SYNC may have torn the data-plane bytes (half-
            # written segments, or only some streamed frames applied):
            # restore them from the host mirror before the replay upload
            if self._last_state is not None:
                self.transport.stage(self._last_state, None)
            try:
                return self._spawn_and_replay(failed=True)
            except ProxyDiedError:
                # the fresh incarnation died too: release its socket (and
                # local process, if any) before the next attempt
                if self.proxy is not None:
                    self.proxy.close(graceful=False)
                    self.proxy = None
                continue
