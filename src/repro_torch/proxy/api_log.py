"""The durable API log — CRUM §3.4 / CRAC's replayable call record.

Every state-creating proxy call the application issues (program
construction, register, upload, step) is appended here *before* it is
sent, so the log is always a superset of what the proxy has executed.
Restart = replay: a fresh proxy gets the PROGRAM and REGISTER calls
re-issued, the last synced snapshot pushed back through the data plane
(UPLOAD), and every STEP after the last SYNC re-executed — deterministic
step programs make the result bit-identical to the uninterrupted run.

Records are u32-length-prefixed MessagePack maps (the wire framing applied
to a file), packed by the port's own codec byte for byte as the reference
packs them, so a log written by either package replays through the other.
A ``call`` field discriminates::

    {"call": "program",    "spec": {...}}
    {"call": "register",   "layout": {...}, "chunk_bytes": int, "workdir": str}
    {"call": "upload",     "step": int, "paths": [..] | None}   None = all
    {"call": "step",       "step": int}
    {"call": "sync_begin", "epoch": int, "step": int}
    {"call": "sync",       "step": int, "digest": str, "epoch": int?}

SYNC records are write-side only (the proxy never reads them): they mark
the replay low-water line — everything at or before the last synced step
is already captured in the data plane's bytes.

Pipelined epoch syncs split into two records because issue and ack are no
longer the same moment: ``sync_begin`` is appended when the SYNC{epoch}
frame is issued (its position marks the step boundary inside the call
stream), and the ``sync`` ack record — appended only once SYNCED{epoch}
arrived and the mirror was captured — makes that boundary a replay
watermark. An issued-but-unacked epoch sync is NOT a watermark; replay
re-executes the steps before it and re-issues the SYNC at the same
position, so the application can still collect the ack after a kill.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Iterator

from repro_torch.checkpoint.msgpack_lite import packb, unpackb
from repro_torch.obs import metrics as obs_metrics

_LEN = struct.Struct("<I")
MAX_RECORD = 64 << 20  # a single log record this large is a bug


class ApiLog:
    """Append-only call log; survives proxy death (each record is flushed
    to the file before its call is sent)."""

    def __init__(self, path: str, *, truncate: bool = False):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "wb" if truncate else "ab")

    def append(self, record: dict[str, Any]) -> None:
        data = packb(record)
        if len(data) > MAX_RECORD:
            raise ValueError(f"API log record too large ({len(data)} bytes)")
        self._f.write(_LEN.pack(len(data)) + data)
        self._f.flush()
        obs_metrics.REGISTRY.inc("apilog_records_total")
        obs_metrics.REGISTRY.inc("apilog_bytes_total", len(data))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    # -- read side -------------------------------------------------------------
    def records(self) -> list[dict[str, Any]]:
        return list(iter_records(self.path))

    def last_synced_step(self) -> int:
        """The replay low-water line: newest SYNC record's step (0 if none)."""
        last = 0
        for rec in iter_records(self.path):
            if rec.get("call") == "sync":
                last = int(rec["step"])
        return last

    def replay_plan(self) -> tuple[dict | None, dict | None, list[int]]:
        """(program_spec, register_record, steps_to_replay): the step-only
        view of :meth:`replay_actions`."""
        program, register, actions = self.replay_actions()
        return program, register, [a[1] for a in actions if a[0] == "step"]

    def replay_actions(
        self,
    ) -> tuple[dict | None, dict | None, list[tuple]]:
        """(program_spec, register_record, ordered replay actions).

        Actions are the calls a fresh proxy must re-execute, in pipeline
        order, on top of the pushed mirror: ``("step", n)`` and
        ``("sync", epoch, step)`` (an issued-but-unacked epoch sync that
        must be re-issued at the same boundary so its SYNCED{epoch} can
        still be collected).

        Watermarks are *positional*: an upload or an un-epoched sync record
        captures the device state at that point — everything before it is
        in the mirror. An epoch sync's ack record instead clears up to *its
        own sync_begin position*: the mirror holds the epoch-boundary image,
        so steps issued while that sync was in flight still replay.
        """
        program = register = None
        actions: list[tuple] = []
        for rec in iter_records(self.path):
            call = rec.get("call")
            if call == "program":
                program = rec.get("spec")
            elif call == "register":
                register = rec
                actions = []
            elif call == "upload":
                actions = []  # snapshot watermark: earlier calls captured
            elif call == "step":
                actions.append(("step", int(rec["step"])))
            elif call == "sync_begin":
                actions.append(
                    ("sync", int(rec["epoch"]), int(rec.get("step", 0)))
                )
            elif call == "sync":
                epoch = rec.get("epoch")
                if epoch is None:
                    actions = []  # barrier sync: positional watermark
                    continue
                for i, a in enumerate(actions):
                    if a[0] == "sync" and a[1] == int(epoch):
                        del actions[: i + 1]
                        break
        return program, register, actions


def iter_records(path: str) -> Iterator[dict[str, Any]]:
    """Stream records; a torn tail (crash mid-append) ends iteration
    cleanly — every fully-written record before it is still replayable."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_LEN.size)
            if len(hdr) < _LEN.size:
                return
            (n,) = _LEN.unpack(hdr)
            if n > MAX_RECORD:
                return  # corrupt length: treat as torn tail
            data = f.read(n)
            if len(data) < n:
                return
            yield unpackb(data)
