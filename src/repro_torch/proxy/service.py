"""The proxy process: owns device state, executes forwarded API calls.

This is the paper's proxy half of the split: the application process stays
device-clean (checkpointable with ordinary host-memory tools) while this
process holds the device state — the step program's tensors on the card —
and executes the pipelined call stream. The shadow machinery is reused in
reverse: a ``ShadowStateManager`` whose buffers ARE the data-plane table
gives

  - ``sync``:   device -> table, digest-gated so unchanged chunks never
                recopy (the paper's read-fault economy on the data plane),
  - ``upload``: table -> device, HOST_DIRTY chunks only, written into the
                device tensors in place — the replay data-push primitive
                after a respawn or restore.

A REGISTER with ``device_capacity_bytes`` hosts the device state in a
paged ``repro_torch.uvm.ManagedSpace`` on the program's device instead:
STEP faults the state in, steps and writes it back; SYNC marks exactly the
chunks the space saw written since the last SYNC and fetches them from the
space's coherent host view; a chunk-delta UPLOAD splices only its ranges.

The data plane is a transport decision made at REGISTER time
(``repro_torch.remote.transport``): ``segment`` attaches the app's
MAP_SHARED files (local, zero-copy); ``stream`` keeps a private table and
moves UPLOAD/SYNC payloads as CHUNKS frames on this very connection.

Every incarnation applies the train CLI's determinism settings before its
first CUDA call (``proxy_entry``, or a proxy-host daemon's
``serve_forever`` for all its sessions): a bitwise replay depends on them,
and a spawned child inherits none of them. A daemon runs several sessions
on threads of one process, so a session counts the kernel launches of its
own thread (``thread_launches``), never the process's.

The service exits on EOF (application gone), SHUTDOWN, or a SIGKILL drill;
it keeps no durable state of its own — everything needed to rebuild it
lives in the application's API log plus the application-side mirror.
"""
from __future__ import annotations

import os
import socket
import time
from typing import Any

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.proxy.protocol import (
    MSG_CHUNKS,
    MSG_ERR,
    MSG_FLUSH,
    MSG_FLUSHED,
    MSG_OK,
    MSG_PROGRAM,
    MSG_REGISTER,
    MSG_SHUTDOWN,
    MSG_STEP,
    MSG_SYNC,
    MSG_SYNCED,
    MSG_UPLOAD,
    ProxyServiceConfig,
    connect,
)


def deterministic_torch() -> None:
    """The train CLI's determinism settings: deterministic algorithms, no
    TF32, a fixed cuBLAS workspace (read when cuBLAS first initialises, so
    set before the first CUDA call)."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def proxy_entry(cfg: ProxyServiceConfig) -> int:
    """Process entry point (multiprocessing spawn target, local mode)."""
    deterministic_torch()
    if cfg.obs_dir:
        obs_trace.enable(cfg.obs_dir, "proxy", run_id=cfg.obs_run,
                         set_env=False)
    else:
        obs_trace.enable_from_env("proxy")
    conn = connect((cfg.host, cfg.port), timeout=60.0)
    conn.settimeout(cfg.sock_timeout_s)
    service = ProxyService(conn)
    try:
        service.serve()
    finally:
        conn.close()
        obs_metrics.dump_if_enabled("proxy")
    return 0


class ProxyService:
    """One proxy session over one connection."""

    def __init__(self, conn):
        self.conn = conn
        self.program = None
        self.table = None            # data-plane StateTable (segment/private)
        self.transport = "segment"
        self.shadow = None
        self.dstate: Any = None
        # managed-memory mode (REGISTER with device_capacity_bytes): the
        # device state lives in a ManagedSpace under a hard frame budget —
        # the proxy can host a state larger than its device budget, and
        # sync fetches page deltas instead of digest-scanning every leaf
        self.space = None
        self._space_sync_tick = -1
        self._win_page_us = [0.0, 0.0]  # (page-in, page-out) this window
        self._win_flash = 0  # flash_attention launches this window
        self.last_step = 0
        self.last_metrics: dict = {}
        # fused digesting (REGISTER fused_digests=True): every STEP ends
        # with a chunk-digest pass over the new state, so the SYNC boundary
        # compares ready-made hashes instead of re-scanning the state
        self.fused_digests = False
        self._last_digests: dict[str, list[int]] | None = None
        # trained zstd dictionary for streamed CHUNKS frames (REGISTER zdict)
        self._zdict: bytes | None = None
        # per-window accounting, reset at every SYNC: how the wall time
        # between two sync boundaries split between stepping and boundary
        # work, and the chunk_digest kernel launches this session's steps
        # made (reported in SYNCED phase_us): each step's time, whether the
        # window holds this incarnation's first step (its warm-up)
        self._win_step_us: list[float] = []
        self._win_warm_up = False
        self._stepped = False
        self._win_launches = 0
        # incarnation number (REGISTER obs field): tags every step/sync
        # span so a merged trace separates replayed work from first runs
        self._obs_inc = 0

    def serve(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except (socket.timeout, TimeoutError):
                continue
            except (OSError, ValueError):
                return  # connection torn down under us
            if msg is None:  # application died or closed: this incarnation ends
                return
            if not self._dispatch(msg):
                return

    def _dispatch(self, msg: dict) -> bool:
        mtype = msg.get("type")
        try:
            if mtype == MSG_PROGRAM:
                self._on_program(msg)
            elif mtype == MSG_REGISTER:
                self._on_register(msg)
            elif mtype == MSG_UPLOAD:
                self._on_upload(msg)
            elif mtype == MSG_STEP:
                # pipelined: no reply — the app is already issuing the next call
                self._on_step(msg)
            elif mtype == MSG_FLUSH:
                self.conn.send(MSG_FLUSHED, seq=msg.get("seq", 0),
                               step=self.last_step)
            elif mtype == MSG_SYNC:
                self._on_sync(msg)
            elif mtype == MSG_SHUTDOWN:
                return False
            else:
                self.conn.send(MSG_ERR, op=str(mtype), error="unknown message")
        except Exception as e:  # surface per-call failures, stay alive
            if mtype in (MSG_STEP, MSG_PROGRAM):
                # a failed step poisons the pipeline, and a program that
                # cannot build on its device leaves nothing to serve: end
                # the session loudly (the app sees ProxyDiedError)
                raise
            self.conn.send(
                MSG_ERR, op=str(mtype), error=f"{type(e).__name__}: {e}"
            )
        return True

    def _step_fn(self, dstate: Any, step: int) -> tuple[Any, dict]:
        """One step, with the fused digest pass when registered for it."""
        if self.fused_digests:
            from repro_torch.kernels.chunk_digest import thread_launches

            before = thread_launches()
            dstate, metrics, self._last_digests = self.program.step_with_digests(
                dstate, step, self.shadow.chunk_bytes
            )
            self._win_launches += thread_launches() - before
            return dstate, metrics
        return self.program.step(dstate, step)

    def _on_step(self, msg: dict) -> None:
        from repro_torch.kernels.flash_attention import thread_launches

        t0 = time.perf_counter()
        flash_before = thread_launches()
        if self.space is not None:
            # device access through the pager: fault the working set in
            # under the budget, step, write-allocate the results back
            dstate = self.space.read_state()
            t1 = time.perf_counter()
            dstate, self.last_metrics = self._step_fn(dstate, int(msg["step"]))
            t2 = time.perf_counter()
            self.space.write_state(dstate)
            self._win_page_us[0] += (t1 - t0) * 1e6
            self._win_page_us[1] += (time.perf_counter() - t2) * 1e6
        else:
            self.dstate, self.last_metrics = self._step_fn(
                self.dstate, int(msg["step"]))
        self._win_flash += thread_launches() - flash_before
        self._win_warm_up |= not self._stepped
        self._stepped = True
        self.last_step = int(msg["step"])
        self._win_step_us.append((time.perf_counter() - t0) * 1e6)
        tr = obs_trace.get()
        if tr is not None:
            # the frame's ctx names THIS span (sender minted the child id)
            tr.complete("proxy.step", t0, step=self.last_step,
                        inc=self._obs_inc,
                        **obs_trace.ctx_args(msg.get("ctx")))

    # -- state-creating calls (the replayed ones) ------------------------------
    def _on_program(self, msg: dict) -> None:
        from repro_torch.proxy.programs import make_program

        self.program = make_program(msg["spec"])
        self.conn.send(MSG_OK, op=MSG_PROGRAM)

    def _on_register(self, msg: dict) -> None:
        from repro_torch.core.shadow import ShadowStateManager
        from repro_torch.remote.transport import make_proxy_table

        capacity = msg.get("device_capacity_bytes")
        space = None
        if capacity:
            # built first: a budget below one page is refused before the
            # data plane is attached
            from repro_torch.uvm import DEFAULT_PAGE_BYTES, ManagedSpace

            space = ManagedSpace(
                int(capacity),
                page_bytes=int(msg.get("page_bytes") or DEFAULT_PAGE_BYTES),
                eviction_policy=msg.get("eviction_policy") or "lru",
                promote_threshold=int(msg.get("promote_threshold") or 0),
                promote_window=int(msg.get("promote_window") or 0),
                device=getattr(self.program, "device", "cpu"),
            )
        obs = msg.get("obs") or {}
        self._obs_inc = int(obs.get("inc") or 0)
        if obs.get("dir"):
            obs_trace.enable(obs["dir"], "proxy", run_id=obs.get("run"),
                             set_env=False)
        if obs.get("ctx"):
            # re-attach marker: a respawned incarnation registering under
            # an open round shows up *inside* that round's causal tree
            obs_trace.instant("proxy.register", inc=self._obs_inc,
                              **obs_trace.ctx_args(obs["ctx"]))
        self.transport = msg.get("transport", "segment")
        self.table = make_proxy_table(msg)
        self.fused_digests = bool(msg.get("fused_digests"))
        self._last_digests = None
        zd = msg.get("zdict")
        self._zdict = bytes(zd) if zd else None
        self.shadow = ShadowStateManager(
            chunk_bytes=int(msg.get("chunk_bytes", 1 << 20)),
            segment_factory=self.table.factory,
        )
        # the program defines the structure; the upload fills the content
        if space is not None:
            # shapes and dtypes only: the space's host backing starts zero
            # and the upload fills it
            meta = getattr(self.program, "meta_state", self.program.empty_state)()
            space.register(meta)
            self.space = space
            self._space_sync_tick = -1
            self.dstate = None  # authoritative bytes live in the space
            self.shadow.register(meta)
        else:
            self.space = None
            self.dstate = self.program.empty_state()
            self.shadow.register(self.dstate)
        self.last_step = 0
        self.conn.send(MSG_OK, op=MSG_REGISTER)

    def _on_upload(self, msg: dict) -> None:
        t0 = time.perf_counter()
        # streamed transport: the payload follows the UPLOAD frame as
        # exactly n_frames CHUNKS frames — land them in the table first,
        # then ingest from the table exactly like the segment path
        n_frames = int(msg.get("n_frames") or 0)
        if n_frames:
            from repro_torch.remote.transport import recv_chunk_frames

            recv_chunk_frames(
                self.conn, n_frames, self.table, self.shadow.chunk_bytes,
                dict_bytes=self._zdict,
            )
        # a host push changed device bytes outside any step: digests the
        # last step emitted no longer describe the state
        self._last_digests = None
        chunks = msg.get("chunks")
        if self.space is not None and chunks is not None:
            self._delta_upload_into_space(msg, chunks)
            tr = obs_trace.get()
            if tr is not None:
                tr.complete("proxy.upload", t0, step=self.last_step,
                            inc=self._obs_inc, delta=True,
                            **obs_trace.ctx_args(msg.get("ctx")))
            return
        state = self.dstate
        if self.space is not None:
            # every leaf is rebuilt from the table, so the targets need no
            # content: fresh tensors on the program's device, where the
            # upload digests them (one grouped kernel call on the card);
            # a partial upload patches the space's coherent view
            state = (self.program.empty_state() if msg.get("paths") is None
                     else self.space.peek_state())
        if chunks is not None:
            # delta form: only the listed chunk ranges are stale
            for p, idxs in chunks.items():
                self.shadow.mark_host_chunks(p, [int(i) for i in idxs])
        else:
            paths = msg.get("paths")
            if paths is None:
                from repro_torch.utils.tree import flatten_with_paths

                paths = list(flatten_with_paths(state)[0])
            for p in paths:
                self.shadow.mark_host_write(p)
        state, stats = self.shadow.upload(state)
        state = self.program.on_restore(state)
        if self.space is not None:
            self.space.load_state(state)
        else:
            self.dstate = state
        self.last_step = int(msg.get("step", self.last_step))
        self.conn.send(
            MSG_OK,
            op=MSG_UPLOAD,
            bytes_uploaded=stats.bytes_uploaded,
            chunks_uploaded=stats.chunks_uploaded,
        )
        tr = obs_trace.get()
        if tr is not None:
            tr.complete("proxy.upload", t0, step=self.last_step,
                        inc=self._obs_inc,
                        bytes_uploaded=stats.bytes_uploaded,
                        **obs_trace.ctx_args(msg.get("ctx")))

    def _delta_upload_into_space(self, msg: dict, chunks: dict) -> None:
        """Chunk-delta upload into a paged device: splice ONLY the uploaded
        byte ranges into the managed space, so untouched pages keep their
        write history and the next page-delta SYNC stays a delta.

        No ``on_restore`` here: a delta targets a live, already-adapted
        state and is bytes-identical by construction (the full-upload path
        keeps the adaptation hook).
        """
        from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

        cb = self.shadow.chunk_bytes
        touched = {}
        for p, idxs in chunks.items():
            self.shadow.mark_host_chunks(p, [int(i) for i in idxs])
            # a flat {full-path: leaf} dict flattens back to the same path
            # strings, so the shadow finds its streams
            touched[p] = self.space.peek_leaf(p)
        patched, stats = self.shadow.upload(touched)
        flat, _ = flatten_with_paths(patched)
        for p, leaf in flat.items():
            raw = leaf_bytes(leaf)
            for i in sorted(int(i) for i in chunks[p]):
                lo, hi = i * cb, min(raw.nbytes, (i + 1) * cb)
                self.space.load_range(p, lo, raw[lo:hi])
        self.last_step = int(msg.get("step", self.last_step))
        self.conn.send(
            MSG_OK,
            op=MSG_UPLOAD,
            bytes_uploaded=stats.bytes_uploaded,
            chunks_uploaded=stats.chunks_uploaded,
        )

    def _on_sync(self, msg: dict | None = None) -> None:
        from repro_torch.utils.tree import tree_digest

        t0 = time.perf_counter()
        ctx = (msg or {}).get("ctx")
        epoch = (msg or {}).get("epoch")
        # fused digests describe the state after the last executed step —
        # exactly the boundary this (pipeline-ordered) SYNC captures
        device_digests = self._last_digests if self.fused_digests else None
        fields: dict[str, Any] = {}
        if self.space is not None:
            # page-delta sync: mark exactly the chunks written since the
            # last SYNC (the space's write-tick history), captured before
            # the peek so nothing can fall between
            tick = self.space.tick()
            marks = self.space.dirty_chunk_marks_since(
                self._space_sync_tick, self.shadow.chunk_bytes
            )
            t_peek = time.perf_counter()
            state = self.space.peek_state()
            peek_us = (time.perf_counter() - t_peek) * 1e6
            self.shadow.mark_device_step(marks)
            stats = self.shadow.sync(state, device_digests=device_digests)
            self._space_sync_tick = tick
            fields["paging"] = self.space.stats_dict()
        else:
            self.shadow.mark_device_step()
            stats = self.shadow.sync(self.dstate, device_digests=device_digests)
        if self.transport == "stream":
            # the app side cannot see this table: ship exactly the chunks
            # this sync materialized as CHUNKS frames ahead of the SYNCED
            from repro_torch.remote.transport import encode_chunk_frames

            changed = {
                path: idxs
                for (path, ordinal), idxs in stats.changed.items()
                if ordinal == 0 and idxs
            }
            t_wire = time.perf_counter()
            wctx = obs_trace.child_span(ctx)
            frames, raw, wire = encode_chunk_frames(
                self.table, changed, self.shadow.chunk_bytes,
                dict_bytes=self._zdict, ctx=wctx,
            )
            for frame in frames:
                self.conn.send(MSG_CHUNKS, **frame)
            tr = obs_trace.get()
            if tr is not None:
                tr.complete("proxy.wire", t_wire, frames=len(frames),
                            wire_bytes=wire, raw_bytes=raw,
                            **obs_trace.ctx_args(wctx))
            fields["wire_bytes"] = wire
            fields["raw_bytes"] = raw
        if epoch is not None:
            fields["epoch"] = int(epoch)
        # divergence provenance: the per-chunk digest table of the synced
        # state (fused digests when the step emitted them, else the shadow
        # scan's) rides the ack — size-capped so a pathological chunk
        # count cannot blow the control-frame limit
        digest_table = (
            self._last_digests
            if self.fused_digests and self._last_digests is not None
            else self.shadow.digest_table()
        )
        if digest_table and sum(map(len, digest_table.values())) <= 65536:
            fields["chunk_digests"] = {
                p: [int(d) for d in v] for p, v in digest_table.items()
            }
        sync_us = (time.perf_counter() - t0) * 1e6
        # the state digest over the table's bytes: after the sync they are
        # the device state's bytes, already on the host (no second copy
        # off the card); the same paths and bytes as tree_digest(state)
        t_digest = time.perf_counter()
        digest = tree_digest({p: self.table.view(p) for p in self.table.layout})
        fields["phase_us"] = {
            "step": round(sum(self._win_step_us), 1),
            "steps": len(self._win_step_us),
            "step_each": [round(t, 1) for t in self._win_step_us],
            "warm_up": self._win_warm_up,
            "digest": round(stats.digest_us, 1),
            "fetch": round(stats.fetch_us, 1),
            "sync": round(sync_us, 1),
            "state_digest": round((time.perf_counter() - t_digest) * 1e6, 1),
            "prehashed_chunks": stats.chunks_prehashed,
            "digest_launches": self._win_launches,
            "flash_launches": self._win_flash,
        }
        if self.space is not None:
            fields["phase_us"].update(
                page_in=round(self._win_page_us[0], 1),
                page_out=round(self._win_page_us[1], 1),
                peek=round(peek_us, 1))
            self._win_page_us = [0.0, 0.0]
        self._win_step_us = []
        self._win_warm_up = False
        self._win_launches = 0
        self._win_flash = 0
        self.conn.send(
            MSG_SYNCED,
            step=self.last_step,
            digest=digest,
            metrics={k: float(v) for k, v in (self.last_metrics or {}).items()},
            chunks_synced=stats.chunks_fetched,
            bytes_synced=stats.bytes_fetched,
            **fields,
        )
        tr = obs_trace.get()
        if tr is not None:
            tr.complete(
                "proxy.sync", t0, step=self.last_step,
                inc=self._obs_inc,
                epoch=fields.get("epoch"),
                chunks_synced=stats.chunks_fetched,
                bytes_synced=stats.bytes_fetched,
                **obs_trace.ctx_args(ctx),
            )
