"""fd / shared-memory-segment leak audit — the soak-run exit criterion.

The stack opens a lot of kernel objects per proxy incarnation: sockets,
MAP_SHARED segment fds, ``/dev/shm`` arenas, API-log fds, trace shards.
A soak harness exits on "zero fd/segment leaks after an
N-minute run"; this helper is that check, reusable from any drill:

    with LeakCheck(tolerance=2) as lc:
        ... 20 kill/respawn cycles ...
    # raises AssertionError naming the leaked fds / segments

Snapshots are taken from ``/proc/self/fd`` (symlink targets, so the
report names *what* leaked, not just how many) and the ``/dev/shm``
listing. On platforms without ``/proc`` the check degrades to a no-op
rather than a false failure.

For *live* monitoring the before/after context manager is the wrong
shape — a watchdog wants a cheap point-in-time count plus a trend over a
window. :func:`sample` is that light snapshot (counts only, no symlink
resolution) and :class:`PeriodicAudit` the rate-limited window over it;
the SLO watchdog's leak-trend rule and long-running drills share them.
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable

__all__ = ["ResourceSnapshot", "LeakCheck", "sample", "watchdog_sample",
           "PeriodicAudit"]

_FD_DIR = "/proc/self/fd"
_SHM_DIR = "/dev/shm"

# fd targets the observability stack itself owns (trace shards, metric
# snapshots, the cluster journal, live-metrics stream, merged report):
# the watchdog's leak-trend rule must not count these, or enabling obs
# on a long run trips the very alert it is there to power
_OBS_FD_BASENAMES = ("CLUSTER_LOG.jsonl", "merged.trace.json")
_OBS_FD_PREFIXES = ("trace-", "metrics-", "live_metrics.json")


def _is_obs_fd(target: str) -> bool:
    base = os.path.basename(target.split(" ", 1)[0])
    if base in _OBS_FD_BASENAMES:
        return True
    return any(base.startswith(p) for p in _OBS_FD_PREFIXES)


def sample(*, exclude_obs: bool = False) -> dict:
    """Point-in-time resource counts: ``{supported, fd, shm}``.

    Cheaper than :meth:`ResourceSnapshot.capture` (two listdirs, no
    readlink per fd) — safe to call on a periodic tick. ``supported`` is
    False on platforms without ``/proc`` (counts are then 0, and any
    consumer should treat the audit as a no-op rather than a leak).

    ``exclude_obs=True`` resolves each fd's symlink and drops the ones
    the observability plane itself holds open (trace shards, the
    journal, live-metrics files), reporting them separately as
    ``fd_obs``; the watchdog's fd-leak trend uses this so tracing a run
    does not read as a leak.
    """
    try:
        entries = os.listdir(_FD_DIR)
    except OSError:
        return {"supported": False, "fd": 0, "shm": 0}
    fd = len(entries)
    fd_obs = 0
    if exclude_obs:
        for entry in entries:
            try:
                target = os.readlink(f"{_FD_DIR}/{entry}")
            except OSError:
                continue  # the listdir fd itself / raced closes
            if _is_obs_fd(target):
                fd_obs += 1
        fd -= fd_obs
    try:
        shm = len(os.listdir(_SHM_DIR))
    except OSError:
        shm = 0
    out = {"supported": True, "fd": fd, "shm": shm}
    if exclude_obs:
        out["fd_obs"] = fd_obs
    return out


def watchdog_sample() -> dict:
    """The SLO watchdog's default sampler: obs-owned fds excluded."""
    return sample(exclude_obs=True)


class PeriodicAudit:
    """Rate-limited :func:`sample` window with a growth-trend readout.

    ``maybe_sample()`` takes at most one sample per ``interval_s`` and
    keeps the last ``window`` of them; ``trend(key)`` reports growth
    across the full window *only when it is monotonically non-shrinking*
    — a transient burst that is reclaimed reads as no trend, a steady
    climb (the actual leak signature) reads as its total growth.
    """

    def __init__(self, interval_s: float = 2.0, window: int = 5,
                 sampler: Callable[[], dict] | None = None):
        self.interval_s = float(interval_s)
        self.window = int(window)
        self.sampler = sampler or sample
        self.samples: deque = deque(maxlen=self.window)
        self._last_t: float | None = None

    def maybe_sample(self, now: float | None = None) -> dict | None:
        """One sample if the interval elapsed, else None."""
        now = time.monotonic() if now is None else now
        if self._last_t is not None and now - self._last_t < self.interval_s:
            return None
        self._last_t = now
        s = self.sampler()
        if s.get("supported"):
            self.samples.append(s)
        return s

    def trend(self, key: str) -> int | None:
        """Monotonic growth of ``key`` over the window; None until the
        window is full, 0 when any sample shrank (not a steady leak)."""
        if len(self.samples) < self.window:
            return None
        vals = [int(s.get(key, 0)) for s in self.samples]
        if any(b < a for a, b in zip(vals, vals[1:])):
            return 0
        return vals[-1] - vals[0]


class ResourceSnapshot:
    def __init__(self, fds: dict[int, str] | None, shm: set[str] | None):
        self.fds = fds
        self.shm = shm

    @classmethod
    def capture(cls) -> "ResourceSnapshot":
        fds: dict[int, str] | None = None
        try:
            fds = {}
            for entry in os.listdir(_FD_DIR):
                try:
                    fds[int(entry)] = os.readlink(f"{_FD_DIR}/{entry}")
                except OSError:
                    pass  # the listdir fd itself / raced closes
        except OSError:
            fds = None
        shm: set[str] | None = None
        try:
            shm = set(os.listdir(_SHM_DIR))
        except OSError:
            shm = None
        return cls(fds, shm)

    @property
    def supported(self) -> bool:
        return self.fds is not None


class LeakCheck:
    """Before/after resource audit; assert no growth at exit."""

    def __init__(self, tolerance: int = 0, shm_tolerance: int = 0):
        self.tolerance = tolerance
        self.shm_tolerance = shm_tolerance
        self.before: ResourceSnapshot | None = None
        self.after: ResourceSnapshot | None = None

    def start(self) -> "LeakCheck":
        self.before = ResourceSnapshot.capture()
        return self

    def stop(self) -> "LeakCheck":
        self.after = ResourceSnapshot.capture()
        return self

    def diff(self) -> dict:
        assert self.before is not None, "call start() first"
        if self.after is None:
            self.stop()
        b, a = self.before, self.after
        if not (b.supported and a.supported):
            return {"supported": False, "fd_growth": 0, "new_fds": [],
                    "shm_growth": 0, "new_shm": []}
        new_fds = sorted(
            f"{n} -> {tgt}"
            for n, tgt in a.fds.items()
            if n not in b.fds
        )
        new_shm = sorted((a.shm or set()) - (b.shm or set()))
        return {
            "supported": True,
            "fd_growth": len(a.fds) - len(b.fds),
            "new_fds": new_fds,
            "shm_growth": len(a.shm or ()) - len(b.shm or ()),
            "new_shm": new_shm,
        }

    def assert_no_growth(self, note: str = "") -> None:
        d = self.diff()
        if not d["supported"]:
            return
        prefix = f"[leakcheck{': ' + note if note else ''}] "
        assert d["fd_growth"] <= self.tolerance, (
            prefix + f"fd count grew by {d['fd_growth']} "
            f"(> tolerance {self.tolerance}); new fds: {d['new_fds']}"
        )
        assert d["shm_growth"] <= self.shm_tolerance, (
            prefix + f"/dev/shm grew by {d['shm_growth']} "
            f"(> tolerance {self.shm_tolerance}); new: {d['new_shm']}"
        )

    def __enter__(self) -> "LeakCheck":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        if exc_type is None:
            self.assert_no_growth()
        return False
