"""Coordinator wire protocol: u32-length-prefixed MessagePack frames over TCP.

The framing and message vocabulary of the reference's
``repro.coord.protocol``, byte for byte:
a little-endian u32 payload length, then the payload packed as
``msgpack.packb(msg, use_bin_type=True)`` packs it — here by the port's own
codec (``checkpoint.msgpack_lite``), so the same dict gives the same bytes
in either package and a peer of one package reads frames of the other.
The device proxy (``repro_torch.proxy``) speaks this framing, and so does
the cluster (``repro_torch.coord``): ranks connect to the coordinator on
loopback and speak the vocabulary below. Payloads are primitive-only maps —
bulk data (chunk payloads, hostmetas) never crosses the socket, it goes
through the shared checkpoint root. With tracing on, a frame may also carry
``ctx`` (the causal trace context); PERSIST_DONE may carry
``chunk_digests`` ({path: [u64, ...]}) so a divergence alert can name the
first forked chunk.

Rank -> coordinator::

    JOIN          {host, pid, restored_from}   first frame on a connection
    HEARTBEAT     {host, step, wt?, metrics?}  liveness; ``wt`` the sender's
                                               wall clock, ``metrics`` its
                                               registry delta
                                               (``repro_torch.obs.live``)
    READY         {host, step}                 at a checkpoint boundary
    PERSIST_DONE  {host, step, hostmeta, persist_s, blocking_s,
                   bytes_written, chunks_written, chunks_reused,
                   state_digest?}
    PERSIST_FAIL  {host, step, error}
    FINISHED      {host, step, digest}         training loop complete

Side channels (any connection, no JOIN)::

    PROXY_ENDPOINT {op: "register" | "acquire", ...}   proxy placement
    METRICS        {op: "snapshot"}                    live telemetry readout

Coordinator -> rank::

    WELCOME       {host, n_hosts, latest_committed}
    DRAIN         {step}           all participants ready: persist now
    COMMIT        {step}           merged MANIFEST durable; image visible
    ABORT         {step, reason}   round void; previous image stands
    SHUTDOWN      {}
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Any

from repro_torch.checkpoint.msgpack_lite import packb, unpackb

MSG_JOIN = "JOIN"
MSG_WELCOME = "WELCOME"
MSG_HEARTBEAT = "HEARTBEAT"
MSG_READY = "READY"
MSG_DRAIN = "DRAIN"
MSG_PERSIST_DONE = "PERSIST_DONE"
MSG_PERSIST_FAIL = "PERSIST_FAIL"
MSG_COMMIT = "COMMIT"
MSG_ABORT = "ABORT"
MSG_FINISHED = "FINISHED"
MSG_SHUTDOWN = "SHUTDOWN"
MSG_PROXY_ENDPOINT = "PROXY_ENDPOINT"
MSG_METRICS = "METRICS"

_LEN = struct.Struct("<I")
MAX_FRAME = 16 << 20  # a control frame this large is a protocol bug


def send_frame(sock: socket.socket, msg: dict[str, Any]) -> None:
    data = packb(msg)
    if len(data) > MAX_FRAME:
        raise ValueError(f"frame too large ({len(data)} bytes)")
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        piece = sock.recv(n - len(buf))
        if not piece:  # peer closed (or died): clean EOF signal
            return None
        buf.extend(piece)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> dict[str, Any] | None:
    """One frame, or None on EOF. socket timeouts propagate to the caller."""
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError(f"corrupt frame header ({n} bytes)")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    return unpackb(data)


class Connection:
    """A framed, send-locked socket (several threads may send).

    ``recv`` keeps partial-frame progress across socket timeouts: callers
    poll with a short timeout (to interleave deadline checks), and a frame
    whose bytes straddle a timeout must not be torn — losing a half-read
    header would desync the stream and misparse payload bytes as lengths.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self._rbuf = bytearray()
        self._need: int | None = None  # pending frame's payload length

    def send(self, msg_type: str, **fields: Any) -> None:
        frame = {"type": msg_type, **fields}
        with self._send_lock:
            send_frame(self.sock, frame)

    def _read_exact(self, n: int) -> bytes | None:
        """n buffered bytes, None on EOF; socket.timeout leaves progress
        in the buffer so the next call resumes mid-frame."""
        while len(self._rbuf) < n:
            piece = self.sock.recv(max(65536, n - len(self._rbuf)))
            if not piece:
                return None
            self._rbuf.extend(piece)
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def recv(self) -> dict[str, Any] | None:
        if self._need is None:
            hdr = self._read_exact(_LEN.size)
            if hdr is None:
                return None
            (n,) = _LEN.unpack(hdr)
            if n > MAX_FRAME:
                raise ValueError(f"corrupt frame header ({n} bytes)")
            self._need = n
        data = self._read_exact(self._need)
        if data is None:
            return None
        self._need = None
        return unpackb(data)

    def settimeout(self, t: float | None) -> None:
        self.sock.settimeout(t)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def connect(addr: tuple[str, int], *, timeout: float = 10.0) -> Connection:
    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return Connection(sock)
