"""The injection engine — every fault is a journal line *first*.

The reference's ``repro.chaos.injectors``, framework-free, copied: the formats it reads
and writes are the reference's.

The soak verdict (:mod:`repro_torch.obs.soak`) can only demand that "every
alert explains itself" if the injections themselves are evidence:
:class:`InjectionEngine` writes a versioned ``crum-inject/1`` line to
``INJECT_LOG.jsonl`` — kind, target, wall-clock time, and the
*expected-evidence spec* — **before** the fault fires, plus a trace
instant so the injection is visible on the merged timeline. Then, and
only then, the fault itself: a SIGKILL, a SIGSTOP window, a torn control
frame, or an armed sentinel (:mod:`repro_torch.chaos.faults`) for the faults
that must fire inside another process.

The expected-evidence spec is the contract the verdict engine enforces:

``any``
    evidence tokens of which at least one must appear within
    ``window_s`` of the injection (``alert:<kind>`` — an AlertLine;
    ``journal:<what>`` — a cluster-journal fact, see
    :func:`repro_torch.obs.soak.match_token`),
``all``
    tokens that must *all* appear (the disk-full drill demands both the
    abort and the later commit: abort-not-corrupt),
``explains``
    alert kinds this injection accounts for inside its window — any
    alert not claimed by some injection's ``explains`` fails the run.
"""
from __future__ import annotations

import os
import signal
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

from repro_torch.chaos import faults
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.journal import JournalWriter

INJECT_SCHEMA = "crum-inject/1"

#: alert kinds that any disruptive injection may plausibly ripple into:
#: a kill lands mid-round (round_abort), several kills in a row trip
#: abort_rate, and the recovery window shows up as stalls/stragglers
_RIPPLE = ("round_abort", "abort_rate", "stall_ratio", "straggler",
           "heartbeat_skew")

__all__ = ["INJECT_SCHEMA", "ClusterHandles", "InjectionEngine"]


@dataclass
class ClusterHandles:
    """Live handles ``run_cluster(chaos=...)`` passes to the hook."""

    coordinator: object          # repro_torch.coord.coordinator.Coordinator
    supervisor: object           # repro_torch.coord.supervisor.ClusterSupervisor
    daemons: list = field(default_factory=list)  # ProxyHostHandle per host
    root: str = ""


class InjectionEngine:
    """Journal-first fault injection against a live cluster."""

    def __init__(self, handles: ClusterHandles, journal_path: str,
                 *, chaos_dir: str | None = None):
        self.h = handles
        self.journal = JournalWriter(journal_path, schema=INJECT_SCHEMA)
        self.chaos_dir = chaos_dir or faults.chaos_dir()
        self.seq = 0
        self.injected: list[dict] = []
        self._lock = threading.Lock()
        self._timers: list[threading.Timer] = []
        self._stopped_daemons: set[int] = set()
        self._armed: set[str] = set()

    # -- the journal-first discipline --------------------------------------

    def _record(self, kind: str, target: str, *, until: float | None,
                params: dict, expect: dict) -> dict:
        with self._lock:
            self.seq += 1
            seq = self.seq
        doc = dict(kind=kind, target=target, seq=seq, until=until,
                   params=params, expect=expect)
        # the line lands before the fault: a SIGKILLed-to-death run still
        # holds the full intent record for every fault that ever fired
        self.journal.write("inject", **doc)
        tr = obs_trace.get()
        if tr is not None:
            tr.instant(f"chaos.{kind}", target=target, seq=seq)
        self.injected.append(doc)
        return doc

    # -- injectors ---------------------------------------------------------

    def kill_worker(self, host: int, *, window_s: float = 90.0) -> dict:
        """SIGKILL one worker process: the classic death drill."""
        host = int(host)
        doc = self._record(
            "kill_worker", f"host:{host}", until=None,
            params={"host": host},
            expect={
                "window_s": window_s,
                "host": host,
                "any": ["alert:worker_death", "journal:death"],
                "explains": ["worker_death", *_RIPPLE],
            },
        )
        p = self.h.supervisor.procs.get(host)
        if p is not None and p.is_alive():
            try:
                os.kill(p.pid, signal.SIGKILL)
            except OSError:
                pass  # lost the race with a natural death: still evidenced
        return doc

    def kill_proxy_host(self, index: int, *, window_s: float = 120.0) -> dict:
        """SIGKILL one proxy-host daemon: cross-host reschedule drill."""
        d = self.h.daemons[int(index)]
        doc = self._record(
            "kill_proxy_host", f"proxy_host:{d.name}", until=None,
            params={"index": int(index), "name": d.name},
            expect={
                "window_s": window_s,
                "any": ["journal:proxy_host_death",
                        "alert:proxy_host_death",
                        "journal:proxy_placement_rescheduled"],
                "explains": ["proxy_host_death", "worker_death", *_RIPPLE],
            },
        )
        d.kill()
        return doc

    def partition(self, index: int, window_s: float = 20.0,
                  *, evidence_window_s: float = 150.0) -> dict:
        """SIGSTOP a proxy-host daemon for ``window_s`` seconds.

        The network-partition stand-in: the daemon's sockets stay open
        but nothing answers, exactly what a coordinator↔proxy-host
        partition looks like from the worker side. The window must
        outlast the proxy client's op timeout or nothing detects it —
        the *worker* then declares the endpoint dead and is rescheduled
        onto a survivor; SIGCONT arrives too late to matter.
        """
        d = self.h.daemons[int(index)]
        until = time.time() + float(window_s)
        doc = self._record(
            "partition", f"proxy_host:{d.name}", until=until,
            params={"index": int(index), "name": d.name,
                    "window_s": float(window_s)},
            expect={
                "window_s": evidence_window_s,
                "any": ["journal:proxy_host_death",
                        "alert:proxy_host_death",
                        "journal:proxy_placement_rescheduled"],
                "explains": ["proxy_host_death", "worker_death", *_RIPPLE],
            },
        )
        try:
            os.kill(d.pid, signal.SIGSTOP)
            self._stopped_daemons.add(int(index))
        except OSError:
            return doc
        t = threading.Timer(float(window_s), self._heal_partition, (index,))
        t.daemon = True
        t.start()
        self._timers.append(t)
        return doc

    def _heal_partition(self, index: int) -> None:
        d = self.h.daemons[int(index)]
        try:
            os.kill(d.pid, signal.SIGCONT)
        except OSError:
            pass
        self._stopped_daemons.discard(int(index))

    def torn_frame(self, *, window_s: float = 120.0) -> dict:
        """Open a connection to the coordinator, send a valid length
        prefix plus a *partial* payload, and hang up.

        This is the protocol-robustness probe: EOF mid-frame must be
        treated as a dead peer (ignored — the connection never joined),
        not poison the event loop. Its evidence is *liveness*: a round
        commits after the torn frame, and it explains nothing — any
        alert near it must have another cause.
        """
        addr = self.h.coordinator.address
        doc = self._record(
            "torn_frame", "coordinator", until=None, params={},
            expect={
                "window_s": window_s,
                "any": ["journal:round_committed"],
                "explains": [],
            },
        )
        try:
            with socket.create_connection(addr, timeout=5.0) as s:
                # claim 64 payload bytes, deliver 10, vanish: the reader
                # is now mid-frame at EOF
                s.sendall(struct.pack("<I", 64) + b"\x00" * 10)
        except OSError:
            pass
        return doc

    def disk_full(self, host: int, *, quota_bytes: int = 1,
                  duration_s: float = 8.0,
                  window_s: float = 180.0) -> dict:
        """Arm the store-writer quota: the next persist on ``host`` hits
        ENOSPC mid-stream. Abort-not-corrupt: the expected evidence is
        the aborted round **and** a later committed one (after the
        sentinel self-expires, the retry overwrites the partial file).
        """
        host = int(host)
        until = time.time() + float(duration_s)
        doc = self._record(
            "disk_full", f"host:{host}", until=until,
            params={"host": host, "quota_bytes": int(quota_bytes),
                    "duration_s": float(duration_s)},
            expect={
                "window_s": window_s,
                "all": ["journal:round_aborted_persist",
                        "journal:round_committed"],
                "explains": ["round_abort", "abort_rate", "stall_ratio",
                             "straggler"],
            },
        )
        faults.arm("disk_full", duration_s=duration_s,
                   directory=self.chaos_dir, host=host,
                   quota_bytes=int(quota_bytes))
        self._armed.add("disk_full")
        return doc

    def clock_skew(self, host: int, *, skew_s: float = 120.0,
                   duration_s: float = 6.0,
                   window_s: float = 60.0) -> dict:
        """Arm the heartbeat wall-clock skew shim on one worker."""
        host = int(host)
        until = time.time() + float(duration_s)
        doc = self._record(
            "clock_skew", f"host:{host}", until=until,
            params={"host": host, "skew_s": float(skew_s),
                    "duration_s": float(duration_s)},
            expect={
                "window_s": window_s,
                "host": host,
                "any": ["alert:clock_skew"],
                "explains": ["clock_skew"],
            },
        )
        faults.arm("clock_skew", duration_s=duration_s,
                   directory=self.chaos_dir, host=host, skew_s=float(skew_s))
        self._armed.add("clock_skew")
        return doc

    # -- dispatch ----------------------------------------------------------

    KINDS = ("kill_worker", "kill_proxy_host", "partition", "torn_frame",
             "disk_full", "clock_skew")

    def inject(self, kind: str, **params) -> dict:
        if kind not in self.KINDS:
            raise ValueError(f"unknown injection kind {kind!r}")
        return getattr(self, kind)(**params)

    def stop(self) -> None:
        """Cancel pending windows and heal everything still broken."""
        for t in self._timers:
            t.cancel()
        for i in list(self._stopped_daemons):
            self._heal_partition(i)
        for kind in list(self._armed):
            faults.disarm(kind, directory=self.chaos_dir)
            self._armed.discard(kind)
        self.journal.close()
