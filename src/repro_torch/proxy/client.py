"""DeviceProxy — the application-side handle on ONE proxy incarnation.

Transport-only: brings up the proxy process and speaks the protocol. Two
placement modes:

  local (default)   spawn the proxy process (multiprocessing *spawn*: the
                    child starts clean, so CUDA lives only there and the
                    application never creates a CUDA context) and accept
                    its loopback connection.
  endpoint=(h, p)   connect OUT to a proxy endpoint that serves the
                    proxy session remotely (the reference's proxy-host
                    daemon; not ported yet) — no child process exists
                    here, and liveness is the connection itself.

Pipelining lives here — ``step()`` is fire-and-forget with an auto-flush
watermark so the app runs ahead of the proxy exactly like ``core/drain.py``
describes the card's launch queue — but *durability and replay do not*: the
API log and respawn policy belong to ``ProxyRunner`` (supervisor.py), so a
dead incarnation is simply dropped and a new DeviceProxy attached to the
same data plane.

Every transport failure raises :class:`ProxyDiedError` — and closes the
socket first, so a dropped incarnation never leaks its fd; callers that
can replay (the runner) catch it, everyone else propagates it.
"""
from __future__ import annotations

import multiprocessing as mp
import socket
import time
from typing import Any, Callable

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
    Connection,
    ProxyDiedError,
    ProxyServiceConfig,
    connect,
)
from repro_torch.proxy.service import proxy_entry


class DeviceProxy:
    def __init__(
        self,
        *,
        endpoint: tuple[str, int] | None = None,
        start_timeout_s: float = 120.0,
        op_timeout_s: float = 120.0,
        max_pipeline: int = 64,
        name: str = "crum-proxy",
    ):
        self.endpoint = tuple(endpoint) if endpoint is not None else None
        # spawn, never fork: CUDA lives only in the child
        self.ctx = mp.get_context("spawn")
        self.start_timeout_s = start_timeout_s
        self.op_timeout_s = op_timeout_s
        self.max_pipeline = int(max_pipeline)
        self.name = name
        self.proc: mp.Process | None = None
        self.conn: Connection | None = None
        self.inflight = 0  # STEP frames sent since the last barrier
        self._seq = 0
        # streamed transport: CHUNKS frames arriving ahead of a SYNCED
        # reply are handed here (the runner wires its transport's ingest)
        self.on_data: Callable[[dict], None] | None = None
        # pipelined epoch SYNCs: SYNCED{epoch} frames that arrive while we
        # are waiting for something else are parked here until collected —
        # the asynchronous half of the non-barrier sync path
        self._synced: dict[int, dict] = {}
        # inflight watermark at each epoch's SYNC frame: once SYNCED{epoch}
        # arrives, everything sent before that SYNC has executed
        self._sync_marks: dict[int, int] = {}

    # -- lifecycle ---------------------------------------------------------------
    def start(self) -> "DeviceProxy":
        if self.endpoint is not None:
            try:
                self.conn = connect(self.endpoint, timeout=self.start_timeout_s)
            except OSError as e:
                raise ProxyDiedError(
                    f"proxy endpoint {self.endpoint} unreachable: {e}"
                ) from e
            self.conn.settimeout(1.0)
            return self
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        host, port = listener.getsockname()
        tr = obs_trace.get()
        cfg = ProxyServiceConfig(
            host=host, port=port,
            obs_dir=tr.obs_dir if tr is not None else None,
            obs_run=tr.run_id if tr is not None else None,
        )
        self.proc = self.ctx.Process(
            target=proxy_entry, args=(cfg,), name=self.name, daemon=True
        )
        self.proc.start()
        listener.settimeout(self.start_timeout_s)
        try:
            sock, _ = listener.accept()
        except socket.timeout:
            # the spawned child never connected: reap it, don't leak it
            self.proc.kill()
            self.proc.join(timeout=10)
            self.proc = None
            raise ProxyDiedError(
                f"proxy did not connect within {self.start_timeout_s}s"
            ) from None
        finally:
            listener.close()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.conn = Connection(sock)
        self.conn.settimeout(1.0)
        return self

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        if self.endpoint is not None:
            return self.conn is not None
        return self.proc is not None and self.proc.is_alive()

    def kill(self) -> None:
        """Hard-kill the incarnation (failure drills: SIGKILL mid-pipeline).

        Endpoint mode has no local process to signal; the connection is
        severed instead."""
        if self.proc is not None and self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10)
        elif self.endpoint is not None and self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self, *, graceful: bool = True) -> None:
        if self.conn is not None:
            if graceful and self.alive():
                try:
                    self.conn.send(MSG_SHUTDOWN)
                except OSError:
                    pass
            self.conn.close()
            self.conn = None
        if self.proc is not None:
            self.proc.join(timeout=10)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout=10)
            self.proc = None

    # -- transport helpers --------------------------------------------------------
    def _die(self, why: str, cause: BaseException | None = None) -> "ProxyDiedError":
        """Close the socket (resource hygiene: every death branch releases
        its fd) and build the error for the caller to raise."""
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        obs_trace.instant("proxy.died", why=why)
        err = ProxyDiedError(why)
        err.__cause__ = cause
        return err

    def _send(self, mtype: str, **fields: Any) -> None:
        if self.conn is None:
            raise ProxyDiedError("proxy connection is closed")
        try:
            self.conn.send(mtype, **fields)
        except OSError as e:
            raise self._die(f"send({mtype}) failed: {e}", e)

    def _recv_reply(self, want: str, *, timeout: float | None = None) -> dict:
        deadline = time.monotonic() + (timeout or self.op_timeout_s)
        while True:
            if time.monotonic() > deadline:
                raise self._die(
                    f"no {want} reply within {timeout or self.op_timeout_s}s "
                    f"(proxy {'alive' if self.alive() else 'dead'})"
                )
            if self.conn is None:
                raise ProxyDiedError("proxy connection is closed")
            try:
                msg = self.conn.recv()
            except (socket.timeout, TimeoutError):
                if not self.alive():
                    raise self._die(f"proxy died while waiting for {want}")
                continue
            except OSError as e:
                raise self._die(f"recv failed: {e}", e)
            if msg is None:
                raise self._die(f"proxy EOF while waiting for {want}")
            mtype = msg.get("type")
            if mtype == MSG_CHUNKS and self.on_data is not None:
                # streamed-transport payload ahead of its SYNCED
                self.on_data(msg)
                continue
            if mtype == MSG_ERR:
                raise RuntimeError(
                    f"proxy call {msg.get('op')} failed: {msg.get('error')}"
                )
            if mtype == MSG_SYNCED and msg.get("epoch") is not None:
                # a pipelined epoch sync completed while we waited for
                # something else: park it for collect_synced() — an epoch
                # SYNCED never answers a barrier sync
                self._synced[int(msg["epoch"])] = msg
                continue
            if mtype == want:
                return msg
            # stale frame from before a died-and-replayed call: drop it

    def _call(self, mtype: str, *, reply: str = MSG_OK, **fields: Any) -> dict:
        self._send(mtype, **fields)
        return self._recv_reply(reply)

    # -- the proxied API -----------------------------------------------------------
    def send_program(self, spec: dict) -> None:
        self._call(MSG_PROGRAM, spec=spec)

    def register(self, **fields: Any) -> None:
        """REGISTER with the transport/layout/paging fields the runner's
        transport and config assembled (see protocol docstring)."""
        self._call(MSG_REGISTER, **fields)
        self.inflight = 0

    def upload(
        self,
        *,
        step: int,
        paths: list[str] | None = None,
        chunks: dict[str, list[int]] | None = None,
        payload_frames: list[dict] | None = None,
        ctx: dict | None = None,
    ) -> dict:
        """Full upload (``paths``/None) or chunk-delta (``chunks``: only
        those chunk ranges are ingested). ``payload_frames`` (streamed
        transport) are sent immediately after the UPLOAD frame."""
        n_frames = len(payload_frames) if payload_frames is not None else 0
        if ctx is None:  # untraced frames stay byte-identical
            self._send(
                MSG_UPLOAD, step=step, paths=paths, chunks=chunks,
                n_frames=n_frames,
            )
        else:
            self._send(
                MSG_UPLOAD, step=step, paths=paths, chunks=chunks,
                n_frames=n_frames, ctx=ctx,
            )
        for frame in payload_frames or ():
            self._send(MSG_CHUNKS, **frame)
        return self._recv_reply(MSG_OK)

    def step(self, step: int, *, ctx: dict | None = None) -> None:
        """Pipelined: returns as soon as the frame is written. Auto-flushes
        at the watermark so the app never runs unboundedly ahead. ``ctx``
        (optional causal context) names the span the service's handler
        will emit for this frame."""
        if ctx is None:  # untraced frames stay byte-identical
            self._send(MSG_STEP, step=int(step))
        else:
            self._send(MSG_STEP, step=int(step), ctx=ctx)
        self.inflight += 1
        if self.inflight >= self.max_pipeline:
            self.flush()

    def flush(self) -> dict:
        """Pipeline barrier: the proxy has executed everything sent so far."""
        self._seq += 1
        self._send(MSG_FLUSH, seq=self._seq)
        msg = self._recv_reply(MSG_FLUSHED)
        self.inflight = 0
        return msg

    def sync(self, *, timeout: float | None = None) -> dict:
        """Flush + device->data-plane sync; returns the SYNCED frame. On
        the streamed transport the payload CHUNKS frames are handed to
        ``on_data`` before this returns."""
        self._send(MSG_SYNC)
        msg = self._recv_reply(MSG_SYNCED, timeout=timeout)
        self.inflight = 0
        return msg

    # -- pipelined epoch sync -----------------------------------------------------
    def sync_begin(self, epoch: int, *, ctx: dict | None = None) -> None:
        """Issue SYNC{epoch} fire-and-forget: the proxy executes it in
        pipeline order (after everything sent so far), and the matching
        SYNCED{epoch} is collected later — the app keeps stepping instead
        of stalling on the boundary."""
        if ctx is None:  # untraced frames stay byte-identical
            self._send(MSG_SYNC, epoch=int(epoch))
        else:
            self._send(MSG_SYNC, epoch=int(epoch), ctx=ctx)
        self._sync_marks[int(epoch)] = self.inflight

    def poll_synced(self, epoch: int) -> dict | None:
        """Non-blocking: the parked SYNCED{epoch} if it has arrived (or
        arrives within a sub-millisecond drain of the socket), else None."""
        epoch = int(epoch)
        if epoch not in self._synced and self.conn is not None:
            old = self.conn.sock.gettimeout()
            try:
                self.conn.settimeout(0.0005)
                while epoch not in self._synced:
                    try:
                        msg = self.conn.recv()
                    except (socket.timeout, TimeoutError):
                        break
                    except OSError as e:
                        raise self._die(f"recv failed: {e}", e)
                    if msg is None:
                        raise self._die("proxy EOF while polling SYNCED")
                    self._absorb(msg)
            finally:
                if self.conn is not None:
                    self.conn.settimeout(old)
        if epoch not in self._synced:
            return None
        return self._take_synced(epoch)

    def collect_synced(self, epoch: int, *, timeout: float | None = None) -> dict:
        """Block until SYNCED{epoch} arrives and return it."""
        epoch = int(epoch)
        deadline = time.monotonic() + (timeout or self.op_timeout_s)
        while epoch not in self._synced:
            if time.monotonic() > deadline:
                raise self._die(
                    f"no SYNCED(epoch={epoch}) within "
                    f"{timeout or self.op_timeout_s}s "
                    f"(proxy {'alive' if self.alive() else 'dead'})"
                )
            if self.conn is None:
                raise ProxyDiedError("proxy connection is closed")
            try:
                msg = self.conn.recv()
            except (socket.timeout, TimeoutError):
                if not self.alive():
                    raise self._die(
                        f"proxy died while waiting for SYNCED(epoch={epoch})"
                    )
                continue
            except OSError as e:
                raise self._die(f"recv failed: {e}", e)
            if msg is None:
                raise self._die(
                    f"proxy EOF while waiting for SYNCED(epoch={epoch})"
                )
            self._absorb(msg)
        return self._take_synced(epoch)

    def _absorb(self, msg: dict) -> None:
        """Route one frame received outside a _recv_reply() wait."""
        mtype = msg.get("type")
        if mtype == MSG_CHUNKS and self.on_data is not None:
            self.on_data(msg)
        elif mtype == MSG_SYNCED and msg.get("epoch") is not None:
            self._synced[int(msg["epoch"])] = msg
        elif mtype == MSG_ERR:
            raise RuntimeError(
                f"proxy call {msg.get('op')} failed: {msg.get('error')}"
            )
        # anything else (stale FLUSHED/OK from a replayed call): drop

    def _take_synced(self, epoch: int) -> dict:
        msg = self._synced.pop(epoch)
        # everything sent before that SYNC frame has now executed
        mark = self._sync_marks.pop(epoch, 0)
        self.inflight = max(0, self.inflight - mark)
        return msg
