"""Failure detection + straggler mitigation for checkpoint I/O at scale.

At thousands of nodes the paper's failure model (GPU DUEs) is joined by
host-level failure modes: a host that stops heartbeating mid-checkpoint,
and stragglers whose storage writes stall the commit. Mechanisms:

  - HeartbeatMonitor: per-host liveness with a miss threshold; the
    coordinator refuses to commit a manifest while a participating host is
    dead (restart picks the previous committed step — correctness comes
    from the commit protocol, not from luck).
  - StragglerPolicy: per-host persist durations; hosts beyond
    ``multiplier`` x median are flagged, and their shard assignments can be
    rebalanced to buddy hosts for the *next* checkpoint (write paths are
    content-addressed, so any host may persist any chunk it holds a replica
    of — replicated leaves give natural buddies).
  - PreemptionHandler: SIGTERM -> policy.request_preempt_checkpoint().

In this container everything runs single-host; the classes are exercised
by simulation in tests (multi-host wiring is keyed by process index).
"""
from __future__ import annotations

import signal
import statistics
import threading
import time
from dataclasses import dataclass, field


class RestartBudget:
    """How many times one supervised process may die before we give up.

    Shared by the cluster supervisor (per-host worker respawns) and the
    device-proxy supervisor (proxy respawn + API-log replay): both convert
    "died again" into either a respawn or a loud, attributable failure.
    """

    def __init__(self, max_restarts: int = 3, *, what: str = "process"):
        self.max_restarts = int(max_restarts)
        self.what = what
        self.count = 0

    def spend(self, detail: str = "") -> int:
        """Record one death; raises once the budget is exhausted."""
        self.count += 1
        if self.count > self.max_restarts:
            suffix = f" ({detail})" if detail else ""
            raise RuntimeError(
                f"{self.what} died {self.count} times{suffix}; giving up"
            )
        return self.count

    @property
    def remaining(self) -> int:
        return max(0, self.max_restarts - self.count)


class HeartbeatMonitor:
    def __init__(self, hosts: list[int], *, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self._last: dict[int, float] = {h: time.monotonic() for h in hosts}
        self._lock = threading.Lock()

    def beat(self, host: int, at: float | None = None) -> None:
        with self._lock:
            self._last[host] = time.monotonic() if at is None else at

    # dynamic membership: the cluster coordinator adds a host at JOIN and
    # removes it when its connection drops (it re-adds on rejoin), so a
    # dead host stops counting against liveness once it has been kicked.
    def add_host(self, host: int) -> None:
        self.beat(host)

    def remove_host(self, host: int) -> None:
        with self._lock:
            self._last.pop(host, None)

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return sorted(
                h for h, t in self._last.items() if now - t > self.timeout_s
            )

    def all_alive(self, now: float | None = None) -> bool:
        return not self.dead_hosts(now)


@dataclass
class StragglerPolicy:
    """Flag hosts whose checkpoint-persist durations are outliers."""

    multiplier: float = 3.0
    min_samples: int = 3
    history: dict[int, list[float]] = field(default_factory=dict)

    def record(self, host: int, persist_s: float) -> None:
        self.history.setdefault(host, []).append(persist_s)

    def _latest(self) -> dict[int, float]:
        return {h: v[-1] for h, v in self.history.items() if v}

    def stragglers(self) -> list[int]:
        latest = self._latest()
        if len(latest) < self.min_samples:
            return []
        med = statistics.median(latest.values())
        if med <= 0:
            return []
        return sorted(h for h, v in latest.items() if v > self.multiplier * med)

    def rebalance(self, assignments: dict[int, list], buddies: dict[int, int]) -> dict[int, list]:
        """Move a straggler's shard list onto its buddy for the next round."""
        out = {h: list(v) for h, v in assignments.items()}
        for s in self.stragglers():
            b = buddies.get(s)
            if b is None or b == s or b not in out:
                continue
            out[b].extend(out[s])
            out[s] = []
        return out


class PreemptionHandler:
    """SIGTERM -> checkpoint-now; the paper's 'checkpoint before the failure'."""

    def __init__(self, policy):
        self.policy = policy
        self.received = threading.Event()
        self._prev = None

    def install(self) -> "PreemptionHandler":
        def _handler(signum, frame):
            self.received.set()
            self.policy.request_preempt_checkpoint()

        self._prev = signal.signal(signal.SIGTERM, _handler)
        return self

    def uninstall(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None
