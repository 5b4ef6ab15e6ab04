"""ChunkTransport — how device-state bytes cross the app/proxy boundary.

The PyTorch port of the reference's ``repro.remote.transport``; frames,
layouts and codecs are the same, so either package's table reads the
other's frames. Codec ``zstd`` is optional, as in the reference: without
the ``zstandard`` package frames travel raw and no dictionary is trained.

The proxy control plane (``repro_torch.proxy.protocol``) is already
location-transparent: tiny msgpack frames over TCP. What pins a proxy to
the application's machine is the *data* plane — file-backed MAP_SHARED
segments both processes mmap. This module abstracts that into a transport
axis:

``segment``
    the existing local path: bulk bytes move through a shared
    :class:`~repro_torch.proxy.segments.SegmentTable`; UPLOAD/SYNC control
    frames carry no payload. Zero-copy, but both ends must share a
    filesystem (same host).

``stream``
    the cross-host path: UPLOAD/SYNC payloads travel as length-prefixed
    CHUNKS frames *on the control connection itself*, each frame a batch
    of ``[path, chunk_index, raw_len]`` entries plus their concatenated
    bytes (optionally zstd-compressed per frame). Both ends keep a
    :class:`~repro_torch.proxy.segments.PrivateTable` as their local terminal.
    Steady-state wire bytes scale with *dirty chunks* (the shadow
    manager's digest compare decides what is dirty), not with state size.

The application side drives a :class:`ChunkTransport`; the proxy side uses
the module-level helpers (:func:`make_proxy_table`,
:func:`recv_chunk_frames`, :func:`encode_chunk_frames`) from inside the
service dispatch loop.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np

from repro_torch.proxy.segments import PrivateTable, SegmentTable, StateTable

# payload batching target per CHUNKS frame — far under protocol.MAX_FRAME,
# large enough that framing overhead stays negligible
FRAME_PAYLOAD_BYTES = 1 << 20

TRANSPORTS = ("segment", "stream")


def _zstd():
    try:
        import zstandard

        return zstandard
    except ImportError:
        return None


def train_chunk_dict(
    table: StateTable,
    chunk_bytes: int,
    *,
    dict_bytes: int = 16 << 10,
    max_samples: int = 2048,
) -> bytes | None:
    """Train a zstd dictionary on the table's current chunk population.

    Small-chunk regimes (many tiny leaves, sub-kilobyte dirty ranges) give
    a cold per-frame compressor almost nothing to work with; a trained
    dictionary ships the shared context once, in REGISTER, and every later
    CHUNKS frame compresses against it. Returns the dictionary bytes, or
    None when zstandard is unavailable or the samples are too small/too
    uniform to train on (callers fall back to plain per-frame zstd).
    """
    zstd = _zstd()
    if zstd is None:
        return None
    samples = []
    for path, idx in table.all_chunks(chunk_bytes).items():
        for i in idx:
            samples.append(table.chunk_bytes_of(path, i, chunk_bytes).tobytes())
            if len(samples) >= max_samples:
                break
        if len(samples) >= max_samples:
            break
    try:
        return zstd.train_dictionary(int(dict_bytes), samples).as_bytes()
    except Exception:
        return None  # too few/too small samples — not an error, just no dict


def encode_chunk_frames(
    table: StateTable,
    chunks: dict[str, list[int]],
    chunk_bytes: int,
    *,
    compress: bool | None = None,
    dict_bytes: bytes | None = None,
    ctx: dict | None = None,
) -> tuple[list[dict], int, int]:
    """Pack the given chunks' current table bytes into CHUNKS frame dicts.

    Coalescing: entries accumulate across leaves until ~FRAME_PAYLOAD_BYTES
    of payload, so many small dirty chunks ride one frame instead of one
    frame each. Returns (frames, raw_bytes, wire_bytes): ``raw_bytes`` is
    the payload before compression, ``wire_bytes`` what actually rides the
    connection. ``compress=None`` auto-enables zstd when the package is
    importable — the receiving side decodes per the frame's ``codec``
    field, so both ends must have it (they share this codebase's
    environment). ``dict_bytes`` (a trained dictionary both ends hold, see
    :func:`train_chunk_dict`) switches the codec to ``zstd-dict``.
    ``ctx`` (optional causal context, ``obs.trace``) is stamped on every
    frame so a data-plane stream is attributable to the SYNC/UPLOAD span
    that produced it; None (tracing off) keeps frames byte-identical.
    """
    zstd = _zstd() if compress in (None, True) else None
    if compress is True and zstd is None:
        raise RuntimeError("compress=True but zstandard is not installed")
    cctx = None
    codec_name = "zstd"
    if zstd is not None:
        if dict_bytes:
            cctx = zstd.ZstdCompressor(
                level=1, dict_data=zstd.ZstdCompressionDict(dict_bytes)
            )
            codec_name = "zstd-dict"
        else:
            cctx = zstd.ZstdCompressor(level=1)

    frames: list[dict] = []
    items: list[list] = []
    parts: list[bytes] = []
    pending = 0
    raw_total = wire_total = 0

    def flush() -> None:
        nonlocal items, parts, pending, wire_total
        if not items:
            return
        data = b"".join(parts)
        codec = "raw"
        if cctx is not None:
            packed = cctx.compress(data)
            if len(packed) < len(data):
                data, codec = packed, codec_name
        frame = {"codec": codec, "items": items, "data": data}
        if ctx is not None:
            frame["ctx"] = ctx
        frames.append(frame)
        wire_total += len(data)
        items, parts, pending = [], [], 0

    for path in sorted(chunks):
        for i in sorted(int(x) for x in chunks[path]):
            piece = table.chunk_bytes_of(path, i, chunk_bytes)
            n = int(piece.nbytes)
            items.append([path, i, n])
            parts.append(piece.tobytes())
            pending += n
            raw_total += n
            if pending >= FRAME_PAYLOAD_BYTES:
                flush()
    flush()
    return frames, raw_total, wire_total


def apply_chunk_frame(
    table: StateTable, msg: dict, chunk_bytes: int, *,
    dict_bytes: bytes | None = None,
) -> tuple[int, int]:
    """Splice one CHUNKS frame's payload into the table.

    Returns (raw_bytes, wire_bytes) applied.
    """
    data = msg["data"]
    wire = len(data)
    codec = msg.get("codec")
    if codec in ("zstd", "zstd-dict"):
        zstd = _zstd()
        if zstd is None:
            raise RuntimeError(
                "received a zstd CHUNKS frame but zstandard is not installed"
            )
        if codec == "zstd-dict":
            if not dict_bytes:
                raise RuntimeError(
                    "received a zstd-dict CHUNKS frame but no trained "
                    "dictionary was registered on this end"
                )
            dctx = zstd.ZstdDecompressor(
                dict_data=zstd.ZstdCompressionDict(dict_bytes)
            )
        else:
            dctx = zstd.ZstdDecompressor()
        data = dctx.decompress(data)
    off = 0
    cb = int(chunk_bytes)
    for path, index, raw_len in msg["items"]:
        table.write_range(path, int(index) * cb, data[off : off + int(raw_len)])
        off += int(raw_len)
    if off != len(data):
        raise ValueError(
            f"CHUNKS frame payload is {len(data)}B but items claim {off}B"
        )
    return off, wire


def recv_chunk_frames(
    conn, n_frames: int, table: StateTable, chunk_bytes: int, *,
    dict_bytes: bytes | None = None,
) -> int:
    """Consume exactly ``n_frames`` CHUNKS frames from ``conn`` into the
    table (the proxy side of a streamed UPLOAD). Returns raw bytes applied.
    Raises ``ConnectionError`` on EOF mid-payload (torn upload: the caller
    dies and the app-side runner replays)."""
    import socket

    from repro_torch.proxy.protocol import MSG_CHUNKS

    total = 0
    for _ in range(int(n_frames)):
        while True:
            try:
                msg = conn.recv()
                break
            except (socket.timeout, TimeoutError):
                continue
        if msg is None:
            raise ConnectionError("EOF mid-UPLOAD payload")
        if msg.get("type") != MSG_CHUNKS:
            raise ValueError(
                f"expected CHUNKS payload frame, got {msg.get('type')!r}"
            )
        raw, _ = apply_chunk_frame(table, msg, chunk_bytes, dict_bytes=dict_bytes)
        total += raw
    return total


def make_proxy_table(msg: dict) -> StateTable:
    """The proxy-side table for a REGISTER frame's transport fields."""
    kind = msg.get("transport", "segment")
    if kind == "stream":
        return PrivateTable.attach(msg["layout"])
    if kind == "segment":
        return SegmentTable.attach(msg["workdir"], msg["layout"])
    raise ValueError(f"unknown transport {kind!r}; have {TRANSPORTS}")


class ChunkTransport:
    """Application-side data plane for one registered device state.

    Owns the app's :class:`StateTable` (the mirror the runner reads back
    after SYNC) and knows how to move bytes toward the proxy (``stage`` +
    ``payload_frames``) and how to ingest the proxy's SYNC payload
    (``on_chunks``). Wire counters separate payload that rode the TCP
    connection (``wire_tx``/``wire_rx``) from bytes written into a shared
    data plane (``table.bytes_written`` covers both sides' view of that).
    """

    kind = "?"

    def __init__(self, table: StateTable, chunk_bytes: int):
        self.table = table
        self.chunk_bytes = int(chunk_bytes)
        self.wire_tx = 0      # payload bytes sent on the connection
        self.wire_rx = 0      # payload bytes received on the connection
        self.raw_tx = 0       # pre-compression payload bytes sent
        self.raw_rx = 0
        self.frames_tx = 0    # CHUNKS frames sent (proves coalescing:
        self.frames_rx = 0    # many dirty chunks, few frames)
        self.chunks_tx = 0
        self.chunks_rx = 0

    # -- app -> proxy -----------------------------------------------------------
    def stage(self, state: Any, chunks: dict[str, list[int]] | None) -> int:
        """Write ``state`` (or just ``chunks`` of it) into the mirror table."""
        if chunks is None:
            return self.table.write_state(state)
        return self.table.write_chunks(state, chunks, self.chunk_bytes)

    def payload_frames(
        self, chunks: dict[str, list[int]] | None
    ) -> list[dict] | None:
        """CHUNKS frames to send right after the UPLOAD control frame
        (None: the data plane is shared, nothing rides the wire)."""
        return None

    # -- proxy -> app -----------------------------------------------------------
    def on_chunks(self, msg: dict) -> None:
        """A CHUNKS frame arrived ahead of SYNCED (streamed transport)."""
        raise RuntimeError(
            f"{self.kind} transport does not expect CHUNKS frames"
        )

    def read_state(self) -> Any:
        return self.table.read_state()

    # -- plumbing ---------------------------------------------------------------
    def register_fields(self) -> dict:
        """Transport fields for REGISTER (and the API log's register record)."""
        raise NotImplementedError

    def stats(self) -> dict:
        return {
            "transport": self.kind,
            "wire_tx": self.wire_tx,
            "wire_rx": self.wire_rx,
            "raw_tx": self.raw_tx,
            "raw_rx": self.raw_rx,
            "frames_tx": self.frames_tx,
            "frames_rx": self.frames_rx,
            "chunks_tx": self.chunks_tx,
            "chunks_rx": self.chunks_rx,
            "data_plane_bytes": self.table.bytes_written,
        }

    def canonical_stats(self) -> dict:
        """Registry-form counters: the one snake_case scheme every layer
        emits through (``transport_<metric>``; see repro_torch.obs.metrics)."""
        return {
            f"transport_{k}": v
            for k, v in self.stats().items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }

    def close(self, *, unlink: bool = False) -> None:
        self.table.close(unlink=unlink)


class SegmentChunkTransport(ChunkTransport):
    """Local zero-copy transport over shared MAP_SHARED segments."""

    kind = "segment"

    def register_fields(self) -> dict:
        return {
            "transport": "segment",
            "workdir": self.table.workdir,
            "layout": self.table.layout,
        }


class StreamChunkTransport(ChunkTransport):
    """Cross-host transport: payloads as CHUNKS frames on the connection."""

    kind = "stream"

    def __init__(self, table: StateTable, chunk_bytes: int, *,
                 compress: bool | None = None,
                 zdict: bytes | None = None):
        super().__init__(table, chunk_bytes)
        self.compress = compress
        # trained zstd dictionary shared with the proxy via REGISTER; both
        # directions' CHUNKS frames compress against it (codec zstd-dict)
        self.zdict = zdict

    def payload_frames(
        self, chunks: dict[str, list[int]] | None
    ) -> list[dict]:
        if chunks is None:
            chunks = self.table.all_chunks(self.chunk_bytes)
        frames, raw, wire = encode_chunk_frames(
            self.table, chunks, self.chunk_bytes, compress=self.compress,
            dict_bytes=self.zdict,
        )
        self.raw_tx += raw
        self.wire_tx += wire
        self.frames_tx += len(frames)
        self.chunks_tx += sum(len(f["items"]) for f in frames)
        return frames

    def on_chunks(self, msg: dict) -> None:
        raw, wire = apply_chunk_frame(
            self.table, msg, self.chunk_bytes, dict_bytes=self.zdict
        )
        self.raw_rx += raw
        self.wire_rx += wire
        self.frames_rx += 1
        self.chunks_rx += len(msg["items"])

    def register_fields(self) -> dict:
        fields = {"transport": "stream", "layout": self.table.layout}
        if self.zdict:
            fields["zdict"] = self.zdict
        return fields


def make_transport(
    kind: str,
    state: Any,
    chunk_bytes: int,
    *,
    workdir: str | None = None,
    compress: bool | None = None,
    train_dict: bool = False,
) -> ChunkTransport:
    """Application-side factory: build the table from ``state`` and wrap it.

    ``train_dict=True`` (stream only) trains a zstd dictionary on the
    initial state's chunks and ships it to the proxy in REGISTER.
    """
    if kind == "segment":
        return SegmentChunkTransport(
            SegmentTable.create(state, workdir=workdir), chunk_bytes
        )
    if kind == "stream":
        table = PrivateTable.create(state, workdir=workdir)
        zdict = (
            train_chunk_dict(table, chunk_bytes) if train_dict else None
        )
        return StreamChunkTransport(
            table, chunk_bytes, compress=compress, zdict=zdict,
        )
    raise ValueError(f"unknown transport {kind!r}; have {TRANSPORTS}")


def default_log_dir(prefix: str = "crum-proxy-log-") -> str:
    """A directory for the API log when no segment workdir exists (the
    streamed transport has no files of its own)."""
    return tempfile.mkdtemp(prefix=prefix)


def endpoint_arg(value: str) -> tuple[str, int]:
    """Parse a ``host:port`` CLI argument."""
    host, _, port = value.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"expected host:port, got {value!r}")
    return host, int(port)
