"""Versioned, typed CLUSTER_LOG.jsonl — the coordinator's journal schema.

The coordinator's append-only journal used to be raw ``json.dumps``
lines with ad-hoc shapes; consumers (restore, reschedule, tests,
post-mortems) each re-parsed them by hand. This module formalizes it:

* every line carries ``schema: "crum-cluster-log/1"`` plus ``event`` and
  ``t`` (wall-clock seconds),
* :class:`JournalWriter` is the single write path (thread-safe, one
  flushed line per record — same torn-tail tolerance as before),
* :func:`read_journal` parses lines back into typed records, one
  dataclass per event kind, tolerating torn tails and unknown kinds
  (forward compatibility: new fields land in ``extra``).

Legacy schema-less lines parse fine — ``schema`` defaults to the v1
label, since v1 *is* the formalization of the legacy shape.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field, fields

JOURNAL_SCHEMA = "crum-cluster-log/1"

__all__ = [
    "JOURNAL_SCHEMA",
    "JournalWriter",
    "read_journal",
    "parse_record",
    "JournalRecord",
    "RoundLine",
    "JoinLine",
    "DeathLine",
    "FinishedLine",
    "ShutdownLine",
    "ProxyEndpointLine",
    "ProxyPlacementLine",
    "ProxyHostDeathLine",
    "AlertLine",
    "InjectLine",
    "alerts",
]


class JournalWriter:
    """Append-only journal writer; one ``os.write`` per line (atomic on
    O_APPEND), so concurrent writers never interleave and a SIGKILL tears
    at most the final line."""

    def __init__(self, path: str, *, schema: str = JOURNAL_SCHEMA):
        self.path = path
        self.schema = schema
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )

    def write(self, event: str, **fields) -> None:
        line = {
            "schema": self.schema,
            "event": event,
            "t": time.time(),
            **fields,
        }
        data = (json.dumps(line, default=str) + "\n").encode("utf-8")
        with self._lock:
            try:
                os.write(self._fd, data)
            except OSError:
                pass  # journaling must never take the coordinator down

    def close(self) -> None:
        with self._lock:
            fd, self._fd = self._fd, -1  # -1: EBADF on late writes, never
            try:                         # a reused fd belonging to someone else
                os.close(fd)
            except OSError:
                pass


# -- typed records ----------------------------------------------------------


@dataclass
class JournalRecord:
    event: str = ""
    t: float = 0.0
    schema: str = JOURNAL_SCHEMA
    extra: dict = field(default_factory=dict)


@dataclass
class RoundLine(JournalRecord):
    """One checkpoint round attempt — committed or aborted."""

    step: int = -1
    status: str = ""
    reason: str = ""
    participants: list = field(default_factory=list)
    acked: list = field(default_factory=list)
    stragglers: list = field(default_factory=list)
    commit_s: float = 0.0
    round_s: float = 0.0
    persist_s_max: float = 0.0
    bytes_written: int = 0
    chunks_synced: int = 0
    chunks_clean: int = 0
    bytes_skipped: int = 0
    sync_us: float = 0.0
    digest_us: float = 0.0
    fetch_us: float = 0.0
    stall_us: float = 0.0

    @property
    def committed(self) -> bool:
        return self.status == "committed"


@dataclass
class JoinLine(JournalRecord):
    host: int = -1
    pid: int | None = None
    restored_from: int | None = None
    latest_committed: int | None = None


@dataclass
class DeathLine(JournalRecord):
    host: int = -1
    reason: str = ""
    latest_committed: int | None = None


@dataclass
class FinishedLine(JournalRecord):
    host: int = -1
    step: int | None = None
    digest: str = ""


@dataclass
class ShutdownLine(JournalRecord):
    finished: list = field(default_factory=list)


@dataclass
class ProxyEndpointLine(JournalRecord):
    name: str = ""
    addr: str = ""
    port: int = 0


@dataclass
class ProxyPlacementLine(JournalRecord):
    worker: int = -1
    name: str = ""
    rescheduled: bool = False


@dataclass
class ProxyHostDeathLine(JournalRecord):
    name: str = ""
    worker: int = -1


@dataclass
class InjectLine(JournalRecord):
    """One planned fault injection (``crum-inject/1``, INJECT_LOG.jsonl).

    Written *before* the fault fires — the injection journal is the
    ground truth the soak verdict engine joins against the cluster
    journal: every injection must produce its expected evidence
    (``expect``), and every alert must be explained by some injection.
    """

    schema: str = "crum-inject/1"
    kind: str = ""
    target: str = ""
    seq: int = -1
    until: float | None = None
    params: dict = field(default_factory=dict)
    expect: dict = field(default_factory=dict)


@dataclass
class AlertLine(JournalRecord):
    """One SLO-watchdog rule violation (``repro_torch.obs.watch.Alert``)."""

    kind: str = ""
    severity: str = ""
    host: int | None = None
    step: int | None = None
    value: float | None = None
    limit: float | None = None
    message: str = ""
    chunk: str | None = None
    chunk_index: int | None = None
    alert_schema: str = ""


RECORD_TYPES: dict[str, type[JournalRecord]] = {
    "round": RoundLine,
    "join": JoinLine,
    "death": DeathLine,
    "finished": FinishedLine,
    "shutdown": ShutdownLine,
    "proxy_endpoint": ProxyEndpointLine,
    "proxy_placement": ProxyPlacementLine,
    "proxy_host_death": ProxyHostDeathLine,
    "alert": AlertLine,
    "inject": InjectLine,
}


def parse_record(doc: dict) -> JournalRecord:
    """One journal line (already JSON-decoded) → typed record.

    Unknown event kinds fall back to the generic :class:`JournalRecord`;
    unknown fields of known kinds land in ``extra`` — readers of v1
    survive writers of v1.1.
    """
    cls = RECORD_TYPES.get(doc.get("event", ""), JournalRecord)
    known = {f.name for f in fields(cls)} - {"extra"}
    kw = {k: v for k, v in doc.items() if k in known}
    rec = cls(**kw)
    rec.extra = {k: v for k, v in doc.items() if k not in known}
    return rec


def read_journal(path: str) -> list[JournalRecord]:
    """Parse a CLUSTER_LOG.jsonl; skips torn/corrupt lines (SIGKILL tail)."""
    out: list[JournalRecord] = []
    try:
        f = open(path, encoding="utf-8", errors="replace")
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if isinstance(doc, dict):
                out.append(parse_record(doc))
    return out


def rounds(path: str) -> list[RoundLine]:
    return [r for r in read_journal(path) if isinstance(r, RoundLine)]


def alerts(path: str) -> list[AlertLine]:
    return [r for r in read_journal(path) if isinstance(r, AlertLine)]
