"""fd / shared-memory-segment leak audit — the soak-run exit criterion.

The stack opens a lot of kernel objects per proxy incarnation: sockets,
MAP_SHARED segment fds, ``/dev/shm`` arenas, API-log fds, trace shards.
A soak harness exits on "zero fd/segment leaks after an
N-minute run"; this helper is that check, reusable from any drill:

    with LeakCheck(tolerance=2) as lc:
        ... 20 kill/respawn cycles ...
    # raises AssertionError naming the leaked fds / segments

Snapshots are taken from ``/proc/self/fd`` (symlink targets, so the
report names *what* leaked, not just how many) and from the ``/dev/shm``
entries **of this run**: the reference counts the whole machine's
``/dev/shm``, which other processes (other runs, other tests) write to at
the same time. An entry is the run's when a process of the run — this one
or a descendant — maps it or holds it open, or when its name carries such a
process's pid (the port names its own entries
``crum-<kind>-<pid>-<ancestors>-``, see :func:`shm_entry_lineage`). A
process killed mid-run leaves its entries behind, and they stay the run's:
every capture remembers the pids it saw in the run and the entries it
counted, and a name's ancestors reach back to the live part of the run even
when its creator was never seen alive. On platforms without ``/proc`` the
check degrades to a no-op rather than a false failure.

For *live* monitoring the before/after context manager is the wrong
shape — a watchdog wants a cheap point-in-time count plus a trend over a
window. :func:`sample` is that light snapshot (counts only, no symlink
resolution) and :class:`PeriodicAudit` the rate-limited window over it;
the SLO watchdog's leak-trend rule and long-running drills share them.
"""
from __future__ import annotations

import os
import re
import time
from collections import deque
from typing import Callable

__all__ = ["ResourceSnapshot", "LeakCheck", "sample", "watchdog_sample",
           "PeriodicAudit", "run_pids", "run_shm_entries",
           "shm_entry_lineage", "shm_name_prefix"]

_FD_DIR = "/proc/self/fd"
_PROC = "/proc"
_SHM_DIR = "/dev/shm"
# the port's own /dev/shm names: crum-<kind>-<pid>-[<ancestors>-]<anything>,
# the ancestors being the creator's parent, grandparent, ... joined by dots
_SHM_PID = re.compile(r"^crum-[a-z]+(?:-[a-z]+)*-(\d+)-(?:(\d+(?:\.\d+)*)-)?")
_LINEAGE_DEPTH = 8  # ancestors a name carries: deeper than any run's tree

# what earlier captures of this process saw of its run: the pids, each with
# its start time (a killed rank's or proxy's pid is no longer live, and may
# be reused by a stranger), and the entries they counted (a dead process's
# unnamed entry is no longer held)
_seen_pids: dict[int, int] = {}
_seen_shm: set[str] = set()


def _forget() -> None:
    """A forked child is a run of its own: it starts with no memory."""
    global _seen_shm
    _seen_pids.clear()
    _seen_shm = set()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_forget)


def shm_entry_lineage(name: str) -> tuple[int, ...]:
    """The creating pid and the ancestors a port name carries, nearest
    first; empty for a name that is not the port's."""
    m = _SHM_PID.match(name)
    if not m:
        return ()
    return (int(m.group(1)),) + tuple(int(p) for p in (m.group(2) or "").split(".") if p)


def _stat(pid: int) -> tuple[int, int] | None:
    """A live process's (parent pid, start time); None once it exited."""
    try:
        with open(f"{_PROC}/{pid}/stat", "rb") as f:
            stat = f.read()
        # the name field may hold spaces and parentheses: the fields after
        # its closing parenthesis start with the state, then the parent pid;
        # the start time is field 22 of the whole line
        fields = stat[stat.rindex(b")") + 2:].split()
        return int(fields[1]), int(fields[19])
    except (OSError, ValueError, IndexError):
        return None  # exited, or no /proc


def shm_name_prefix(kind: str) -> str:
    """``crum-<kind>-<pid>-<ancestors>-``: a ``/dev/shm`` name prefix that
    :func:`run_shm_entries` attributes to any run this process is part of,
    even after this process and its parent are gone."""
    lineage, pid = [], os.getppid()
    while pid > 1 and len(lineage) < _LINEAGE_DEPTH:
        lineage.append(str(pid))
        pid = (_stat(pid) or (0, 0))[0]
    tail = ".".join(lineage) + "-" if lineage else ""
    return f"crum-{kind}-{os.getpid()}-{tail}"


def _run_tree() -> dict[int, int]:
    """This process and its live descendants, each with its start time."""
    children: dict[int, list[int]] = {}
    starts: dict[int, int] = {}
    try:
        entries = os.listdir(_PROC)
    except OSError:
        return {os.getpid(): 0}
    for entry in entries:
        if not entry.isdigit():
            continue
        st = _stat(int(entry))
        if st is not None:
            children.setdefault(st[0], []).append(int(entry))
            starts[int(entry)] = st[1]
    tree: dict[int, int] = {}
    todo = [os.getpid()]
    while todo:
        pid = todo.pop()
        if pid not in tree:
            tree[pid] = starts.get(pid, 0)
            todo.extend(children.get(pid, ()))
    return tree


def run_pids() -> set[int]:
    """This process and its live descendants (parent links in ``/proc``)."""
    return set(_run_tree())


def _seen(pid: int) -> bool:
    """Whether ``pid`` is a process an earlier capture saw in the run: dead
    now, or alive since the same start (not a stranger reusing the pid)."""
    start = _seen_pids.get(pid)
    if start is None:
        return False
    st = _stat(pid)
    return st is None or st[1] == start


def _held_shm(pid: int) -> set[str]:
    """Top-level ``/dev/shm`` entries a process maps or holds open."""
    prefix = _SHM_DIR + "/"
    held: set[str] = set()
    try:
        with open(f"{_PROC}/{pid}/maps") as f:
            for line in f:
                i = line.find(prefix)
                if i >= 0:
                    held.add(line[i + len(prefix):].split("/", 1)[0].split(" ", 1)[0].rstrip("\n"))
    except OSError:
        pass
    try:
        fds = os.listdir(f"{_PROC}/{pid}/fd")
    except OSError:
        fds = []
    for fd in fds:
        try:
            target = os.readlink(f"{_PROC}/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith(prefix):
            held.add(target[len(prefix):].split("/", 1)[0].split(" ", 1)[0])
    return held


def run_shm_entries(pids: set[int] | None = None) -> set[str] | None:
    """The ``/dev/shm`` entries of this run (None without ``/dev/shm``).

    An entry counts when one of ``pids`` maps it or holds it open, or when
    its port name's creator or one of its ancestors is one of them. By
    default ``pids`` is every pid any capture of this process has seen in
    its run (:func:`run_pids`, dead ones included), and an entry an earlier
    capture counted counts for as long as it exists; an explicit ``pids``
    is taken as it is, with no memory.
    """
    global _seen_shm
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return None
    remember = pids is None
    if remember:
        tree = _run_tree()
        _seen_pids.update(tree)
        live, ours = set(tree), _seen
    else:
        live, ours = pids, pids.__contains__
    held: set[str] = set()
    for pid in live:
        held |= _held_shm(pid)
    mine = {n for n in names if n in held
            or any(ours(p) for p in shm_entry_lineage(n))
            or (remember and n in _seen_shm)}
    if remember:
        _seen_shm = set(mine)  # entries since removed drop out
    return mine

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

    Cheaper than :meth:`ResourceSnapshot.capture` (no readlink per fd of
    this process) — safe to call on a periodic tick. ``shm`` counts this
    run's entries (:func:`run_shm_entries`), not the machine's. ``supported`` is
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
    shm = len(run_shm_entries() or ())
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
        return cls(fds, run_shm_entries())

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
