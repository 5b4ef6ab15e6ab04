"""Cross-process fault arming — sentinel files under ``$CRUM_CHAOS_DIR``.

The reference's ``repro.chaos.faults``, framework-free, copied: the formats it reads
and writes are the reference's.

The injection engine runs in the launcher process, but several faults
must fire *inside* another process entirely: the disk-full quota lands
in a worker's (or its forked persist child's) store writer, the clock
skew in a worker's heartbeat thread. Those processes are ``spawn``
children that inherit the environment, so the handshake is:

* the soak driver exports ``CRUM_CHAOS_DIR=<run_dir>/chaos``,
* :func:`arm` atomically writes ``<dir>/<kind>.json`` describing the
  fault (target host, parameters, expiry),
* the in-tree shim calls :func:`active` at its natural cadence and
  applies the fault while the sentinel matches.

The shims guard on the environment variable first: when it is unset
(every production run, every tier-1 test) the whole check is one dict
lookup — no stat, no open, no import-time cost.

Sentinels are self-expiring (``until`` wall-clock seconds) so a fault
window closes even if the injecting process dies mid-window.
"""
from __future__ import annotations

import errno
import json
import os
import time

CHAOS_ENV = "CRUM_CHAOS_DIR"

__all__ = ["CHAOS_ENV", "arm", "disarm", "active", "chaos_dir",
           "check_disk_quota"]


def chaos_dir() -> str | None:
    """The armed-fault directory, or None (chaos disabled)."""
    return os.environ.get(CHAOS_ENV) or None


def _path(d: str, kind: str) -> str:
    return os.path.join(d, f"{kind}.json")


def arm(kind: str, *, duration_s: float | None = None,
        directory: str | None = None, **params) -> str:
    """Arm ``kind`` for ``duration_s`` seconds (None = until disarmed).

    Returns the sentinel path. The write is atomic (tmp + rename) so a
    shim polling mid-arm sees either the old fault or the new one,
    never a torn JSON document.
    """
    d = directory or chaos_dir()
    if not d:
        raise RuntimeError(f"{CHAOS_ENV} is not set and no directory given")
    os.makedirs(d, exist_ok=True)
    doc = {
        "kind": kind,
        "armed_at": time.time(),
        "until": (time.time() + duration_s) if duration_s else None,
        "params": params,
    }
    path = _path(d, kind)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def disarm(kind: str, *, directory: str | None = None) -> None:
    d = directory or chaos_dir()
    if not d:
        return
    try:
        os.remove(_path(d, kind))
    except OSError:
        pass


def active(kind: str, *, host: int | None = None,
           directory: str | None = None) -> dict | None:
    """The armed parameters for ``kind``, or None.

    Zero-cost when chaos is disabled (one env lookup). ``host`` filters
    host-targeted faults: a sentinel whose params carry a ``host`` only
    matches that host; a sentinel without one matches everybody.
    """
    d = directory or chaos_dir()
    if not d:
        return None
    try:
        with open(_path(d, kind)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    until = doc.get("until")
    if until is not None and time.time() > until:
        return None  # self-expired: the window closed
    params = doc.get("params") or {}
    target = params.get("host")
    if host is not None and target is not None and int(target) != int(host):
        return None
    return params


def check_disk_quota(host: int, would_write: int, written: int) -> None:
    """The store-writer shim: raise ENOSPC when an armed ``disk_full``
    fault's byte quota would be exceeded by this append.

    ``written`` is the bytes this writer already wrote; the quota is
    per-file, which models a filesystem running out of space partway
    through a host's payload stream. One env lookup when disabled.
    """
    if not os.environ.get(CHAOS_ENV):
        return
    params = active("disk_full", host=host)
    if params is None:
        return
    quota = int(params.get("quota_bytes", 0))
    if written + would_write > quota:
        raise OSError(
            errno.ENOSPC,
            f"chaos disk_full: quota {quota}B exceeded "
            f"(written={written}B, appending {would_write}B)",
        )
