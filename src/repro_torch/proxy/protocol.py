"""Device-proxy wire protocol (paper §3: application <-> proxy process).

CRUM's application process is "device-clean": it never owns device state;
every device API call is forwarded to the proxy. The control plane is
u32-length-prefixed MessagePack frames over loopback TCP — the framing of
``repro_torch.coord.protocol`` (``Connection``/``send_frame``/``recv_frame``
are re-exported from there), byte-identical to the reference's — while the
data plane is file-backed MAP_SHARED mmap segments
(``repro_torch.proxy.segments``): step inputs and outputs never cross the
socket, only tiny control frames do.

When tracing is enabled, REGISTER/STEP/SYNC/UPLOAD (and streamed CHUNKS)
frames may carry an optional ``ctx`` field — ``{"trace", "span",
"parent"}``, the causal context (``obs.trace``) under which the proxy-side
service emits its span. The field is absent when tracing is off; the
untraced frames are byte-identical.

Application -> proxy::

    PROGRAM   {spec}                 construct the step program (replayable;
                                     the spec names the device)
    REGISTER  {layout, chunk_bytes,  attach the data plane; allocate device
               transport?,           state. ``transport`` is ``"segment"``
               workdir?, zdict?,     (shared MAP_SHARED files, needs
               fused_digests?,       ``workdir``) or ``"stream"`` (payloads
               device_capacity_bytes?, travel as CHUNKS frames over this
               page_bytes?,          connection). ``device_capacity_bytes``
               eviction_policy?,     hosts the device state in a paged
               promote_threshold?,   ``repro_torch.uvm.ManagedSpace`` under
               promote_window?}      that budget (managed memory)
    UPLOAD    {paths, step, chunks?, ingest data-plane bytes into device
               n_frames?}            state. ``chunks`` ({path: [chunk
                                     indices]}) is the delta form: only
                                     those chunk ranges move. Streamed
                                     transport: the payload follows as
                                     exactly ``n_frames`` CHUNKS frames
    CHUNKS    {codec, items, data}   one data-plane frame (streamed
                                     transport): ``items`` is a list of
                                     [path, chunk_index, raw_len] and
                                     ``data`` their concatenated bytes
    STEP      {step}                 run one train step — pipelined, NO reply
    FLUSH     {seq}                  pipeline barrier (control-plane only)
    SYNC      {epoch?}               device state -> data plane at this
                                     point in the pipeline. With ``epoch``
                                     the call is pipelined like STEP and
                                     the SYNCED{epoch} ack is matched
                                     asynchronously; without it, a barrier
    SHUTDOWN  {}                     clean exit

Proxy -> application::

    OK        {op, ...}              ack for PROGRAM/REGISTER/UPLOAD
    ERR       {op, error}            the call failed; proxy stays up
    FLUSHED   {seq, step}            pipeline empty up to ``seq``
    CHUNKS    {codec, items, data}   streamed transport: dirty-chunk
                                     payload of the in-progress SYNC
    SYNCED    {step, digest, metrics, chunks_synced, bytes_synced,
               epoch?, phase_us?, chunk_digests?, wire_bytes?, paging?}
                                     ``paging``: a managed proxy's
                                     ``ManagedSpace.stats_dict()``;
                                     ``phase_us`` breaks the window down
                                     ({step, steps, digest, fetch, sync,
                                     state_digest} microseconds, with
                                     page_in, page_out and peek for a
                                     managed proxy; ``prehashed_chunks``;
                                     ``digest_launches`` and
                                     ``flash_launches``: the
                                     ``chunk_digest`` and
                                     ``flash_attention`` kernel launches
                                     the window's steps made)

STEP carrying no reply is the proxying economy the paper measures: the app
runs ahead of the proxy exactly like PyTorch's asynchronous launches run
ahead of the card (see ``core/drain.py``); SYNC is the flush.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.coord.protocol import (  # noqa: F401  (re-exported framing)
    Connection,
    connect,
    recv_frame,
    send_frame,
)

MSG_PROGRAM = "PROGRAM"
MSG_REGISTER = "REGISTER"
MSG_UPLOAD = "UPLOAD"
MSG_CHUNKS = "CHUNKS"
MSG_STEP = "STEP"
MSG_FLUSH = "FLUSH"
MSG_SYNC = "SYNC"
MSG_SHUTDOWN = "SHUTDOWN"

MSG_OK = "OK"
MSG_ERR = "ERR"
MSG_FLUSHED = "FLUSHED"
MSG_SYNCED = "SYNCED"


class ProxyDiedError(RuntimeError):
    """The proxy process is gone (EOF/broken pipe/timeout past liveness)."""


@dataclass
class ProxyServiceConfig:
    """Everything a fresh proxy incarnation needs to come up and connect.

    Deliberately minimal: program, layout and data arrive as *replayed API
    calls* over the connection, never as spawn arguments — that is what
    makes a respawned proxy reconstructible from the API log alone. The
    device is named by the program spec, not here.
    """

    host: str
    port: int
    sock_timeout_s: float = 1.0
    # observability (not part of the replayable state — a respawn works
    # with or without it): where to write this incarnation's trace shard
    obs_dir: str | None = None
    obs_run: str | None = None
