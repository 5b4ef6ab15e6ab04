"""Live telemetry plane — streaming cluster metrics while the run runs.

The trace and metrics files are post-hoc: trace shards and ``metrics-*.json``
dumps are only merged by the reference's ``repro.obs.report`` after the run ends. This
module is the *live* half:

* **Worker side** — :class:`HeartbeatPiggyback` computes the per-process
  :class:`~repro_torch.obs.metrics.Registry` counter delta since the last
  heartbeat and rides it on the HEARTBEAT frame the worker already
  sends. Zero extra syscalls: the payload travels inside the same
  framed ``sendall`` as the heartbeat itself (the reference's ``benchmarks/obs_overhead``
  pins the collect cost; a unit test pins the one-frame property).
* **Coordinator side** — :class:`LiveAggregator` folds those deltas into
  a bounded in-memory time-series store (:class:`SeriesStore`, one ring
  buffer per ``(host, metric)``), deduplicated by per-host sequence
  number so a re-delivered delta (heartbeat retry, re-JOIN replay) is
  idempotent. The aggregator snapshots periodically to the run dir
  (``live_metrics.json``) and is served over the coordinator's existing
  TCP listener (``METRICS`` side-channel frame) — the reference's ``repro.obs.top``
  renders either source.

Malformed payloads (a worker SIGKILLed mid-send tears the *frame*, which
the length-prefixed protocol already rejects; a buggy or hostile worker
could still send garbage *values*) must never poison the store or the
coordinator event loop: ``ingest`` validates every key and value and
drops what it cannot use.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from repro_torch.obs import metrics as obs_metrics

LIVE_SCHEMA = "crum-live-metrics/1"

#: hard caps keeping one misbehaving worker from ballooning coordinator
#: memory: metrics tracked per host, points kept per (host, metric)
MAX_METRICS_PER_HOST = 256
DEFAULT_RING = 240

#: tiered downsampling: every raw append also folds into one open bucket
#: per tier (seconds); completed buckets land in their own ring. The raw
#: ring covers the last ~2 minutes at heartbeat cadence; the 10s tier
#: covers ~40 minutes and the 60s tier ~4 hours — a soak run's whole
#: history stays in memory at bounded cost, and trend consumers
#: (the reference's ``repro.obs.top``, the soak verdict's leak check) read the rollups
#: instead of a raw ring that has long since wrapped.
ROLLUP_TIERS = (10.0, 60.0)

#: piggyback payload budget — a HEARTBEAT frame stays a control frame.
#: Deltas beyond the key budget are *deferred*, not dropped: an uncounted
#: key stays out of the baseline snapshot, so its whole value rides the
#: next heartbeat's delta.
MAX_PIGGYBACK_KEYS = 96

__all__ = [
    "LIVE_SCHEMA",
    "SeriesStore",
    "HeartbeatPiggyback",
    "LiveAggregator",
]


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class SeriesStore:
    """Bounded time-series: one ring buffer of (t, value) per (host, metric).

    Appends are O(1) and memory is hard-bounded: ``ring`` points per
    series, ``MAX_METRICS_PER_HOST`` series per host. All methods are
    thread-safe (the coordinator event loop appends while the METRICS
    side channel snapshots).
    """

    def __init__(self, ring: int = DEFAULT_RING,
                 rollups: tuple = ROLLUP_TIERS,
                 rollup_ring: int = DEFAULT_RING):
        self.ring = int(ring)
        self.rollups = tuple(float(r) for r in rollups)
        self.rollup_ring = int(rollup_ring)
        self._lock = threading.Lock()
        self._series: dict[tuple[int, str], deque] = {}
        # completed buckets per (host, metric, tier); each point is
        # [bucket_t, last, min, max, n] — last-value downsampling with a
        # min/max envelope, so a spike inside a bucket stays visible
        self._rolled: dict[tuple[int, str, float], deque] = {}
        # the in-progress bucket per (host, metric, tier):
        # [bucket_t, last, min, max, n]
        self._open: dict[tuple[int, str, float], list] = {}

    def append(self, host: int, metric: str, t: float, value: float) -> bool:
        key = (int(host), str(metric))
        t, value = float(t), float(value)
        with self._lock:
            q = self._series.get(key)
            if q is None:
                if sum(1 for h, _ in self._series if h == key[0]) \
                        >= MAX_METRICS_PER_HOST:
                    return False  # per-host series budget exhausted
                q = self._series[key] = deque(maxlen=self.ring)
            q.append((t, value))
            for tier in self.rollups:
                rkey = (key[0], key[1], tier)
                bucket = (t // tier) * tier
                cur = self._open.get(rkey)
                if cur is None or cur[0] != bucket:
                    if cur is not None:
                        rq = self._rolled.get(rkey)
                        if rq is None:
                            rq = self._rolled[rkey] = deque(
                                maxlen=self.rollup_ring
                            )
                        rq.append(cur)
                    self._open[rkey] = [bucket, value, value, value, 1]
                else:
                    cur[1] = value
                    cur[2] = min(cur[2], value)
                    cur[3] = max(cur[3], value)
                    cur[4] += 1
        return True

    def rollup(self, host: int, metric: str, tier: float
               ) -> list[list[float]]:
        """Completed buckets plus the provisional open one, oldest first.

        Each point is ``[bucket_t, last, min, max, n]``. The open bucket
        rides along so short runs (shorter than one tier) still expose a
        point — it is provisional: its values may still move until the
        bucket closes.
        """
        rkey = (int(host), str(metric), float(tier))
        with self._lock:
            out = [list(p) for p in self._rolled.get(rkey, ())]
            cur = self._open.get(rkey)
            if cur is not None:
                out.append(list(cur))
        return out

    def series(self, host: int, metric: str) -> list[tuple[float, float]]:
        with self._lock:
            return list(self._series.get((int(host), metric), ()))

    def latest(self, host: int, metric: str) -> float | None:
        with self._lock:
            q = self._series.get((int(host), metric))
            return q[-1][1] if q else None

    def hosts(self) -> list[int]:
        with self._lock:
            return sorted({h for h, _ in self._series})

    def metrics(self, host: int | None = None) -> list[str]:
        with self._lock:
            return sorted({
                m for h, m in self._series if host is None or h == host
            })

    def snapshot(self) -> dict:
        """The whole store as a JSON-ready dict (host keys stringified)."""
        with self._lock:
            out: dict[str, dict[str, list]] = {}
            for (h, m), q in self._series.items():
                out.setdefault(str(h), {})[m] = [
                    [round(t, 3), v] for t, v in q
                ]
        return out

    def rollup_snapshot(self) -> dict:
        """All rollup tiers as a JSON-ready dict:
        ``{tier: {host: {metric: [[t, last, min, max, n], ...]}}}``."""
        with self._lock:
            out: dict[str, dict[str, dict[str, list]]] = {}
            for (h, m, tier), q in self._rolled.items():
                pts = [list(p) for p in q]
                cur = self._open.get((h, m, tier))
                if cur is not None:
                    pts.append(list(cur))
                out.setdefault(f"{tier:g}", {}) \
                   .setdefault(str(h), {})[m] = pts
            for (h, m, tier), cur in self._open.items():
                tiers = out.setdefault(f"{tier:g}", {})
                metrics = tiers.setdefault(str(h), {})
                if m not in metrics:  # open bucket with no completed ones
                    metrics[m] = [list(cur)]
        return out

    def drop_host(self, host: int) -> None:
        with self._lock:
            for key in [k for k in self._series if k[0] == int(host)]:
                del self._series[key]
            for key in [k for k in self._rolled if k[0] == int(host)]:
                del self._rolled[key]
            for key in [k for k in self._open if k[0] == int(host)]:
                del self._open[key]


class HeartbeatPiggyback:
    """Worker-side delta collector for the HEARTBEAT metrics field.

    Each ``collect()`` returns ``{"seq", "counters", "gauges"}`` where
    ``counters`` is the registry delta since the previous collect and
    ``gauges`` the current gauge values. ``seq`` increases by one per
    collect; the aggregator discards any payload whose seq it has
    already applied, which makes redelivery idempotent.
    """

    def __init__(self, reg: obs_metrics.Registry | None = None,
                 max_keys: int = MAX_PIGGYBACK_KEYS):
        self.reg = reg or obs_metrics.REGISTRY
        self.max_keys = int(max_keys)
        self.seq = 0
        self._last: dict[str, float] = {}

    def collect(self) -> dict | None:
        snap = self.reg.counters_snapshot()
        delta = obs_metrics.counter_delta(self._last, snap)
        gauges = self.reg.gauges_snapshot()
        if len(delta) > self.max_keys:
            # defer the overflow: keys beyond the budget are left out of
            # the baseline too, so their full delta rides the next beat
            kept = dict(sorted(delta.items())[: self.max_keys])
            snap = dict(self._last)
            for k, v in kept.items():
                snap[k] = snap.get(k, 0) + v
            delta = kept
        if len(gauges) > self.max_keys:
            gauges = dict(sorted(gauges.items())[: self.max_keys])
        if not delta and not gauges and self.seq:
            return None  # nothing new: the heartbeat rides bare
        self.seq += 1
        self._last = snap
        return {"seq": self.seq, "counters": delta, "gauges": gauges}


class LiveAggregator:
    """Coordinator-side sink: HEARTBEAT piggybacks -> bounded series.

    Counters accumulate (the series records the running per-host total);
    gauges record the latest value. ``ingest`` is defensive end to end —
    whatever arrives in the frame, the event loop survives it.
    """

    def __init__(self, ring: int = DEFAULT_RING,
                 snapshot_path: str | None = None,
                 snapshot_every_s: float = 5.0):
        self.store = SeriesStore(ring=ring)
        self.snapshot_path = snapshot_path
        self.snapshot_every_s = float(snapshot_every_s)
        self._last_seq: dict[int, int] = {}
        self._totals: dict[tuple[int, str], float] = {}
        self._last_snapshot: float | None = None
        self.ingested = 0
        self.dropped = 0

    def reset_host(self, host: int) -> None:
        """A (re)JOIN starts a fresh incarnation: its seq counter restarts
        and its counter totals start over from the new process's zero."""
        self._last_seq.pop(int(host), None)
        for key in [k for k in self._totals if k[0] == int(host)]:
            del self._totals[key]

    def ingest(self, host: int, payload, t: float | None = None) -> bool:
        """Apply one piggyback payload; returns False when dropped
        (duplicate seq, malformed shape, or no payload at all)."""
        if not isinstance(payload, dict):
            if payload is not None:
                self.dropped += 1
            return False
        try:
            host = int(host)
            seq = payload.get("seq")
            if not isinstance(seq, int) or seq <= 0:
                self.dropped += 1
                return False
            if seq <= self._last_seq.get(host, 0):
                self.dropped += 1  # redelivery: already applied
                return False
            t = time.time() if t is None else float(t)
            counters = payload.get("counters")
            if isinstance(counters, dict):
                for k, v in counters.items():
                    if isinstance(k, str) and _is_num(v):
                        key = (host, k)
                        total = self._totals.get(key, 0.0) + float(v)
                        self._totals[key] = total
                        self.store.append(host, k, t, total)
            gauges = payload.get("gauges")
            if isinstance(gauges, dict):
                for k, v in gauges.items():
                    if isinstance(k, str) and _is_num(v):
                        self.store.append(host, k, t, float(v))
            self._last_seq[host] = seq
            self.ingested += 1
            return True
        except Exception:
            # live telemetry must never take the coordinator down
            self.dropped += 1
            return False

    def observe(self, host: int, metric: str, value: float,
                t: float | None = None) -> None:
        """Coordinator-local series (round durations, alert counts) share
        the same bounded store as the piggybacked worker metrics."""
        if _is_num(value):
            self.store.append(
                host, metric, time.time() if t is None else t, float(value)
            )

    # -- serving -----------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "schema": LIVE_SCHEMA,
            "t": time.time(),
            "hosts": self.store.hosts(),
            "series": self.store.snapshot(),
            "rollups": self.store.rollup_snapshot(),
            "ingested": self.ingested,
            "dropped": self.dropped,
        }

    def write_snapshot(self, path: str | None = None) -> str | None:
        path = path or self.snapshot_path
        if not path:
            return None
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        return path

    def maybe_snapshot(self, now: float | None = None) -> str | None:
        """Periodic run-dir snapshot (called from the coordinator tick)."""
        if not self.snapshot_path:
            return None
        now = time.monotonic() if now is None else now
        if (
            self._last_snapshot is not None
            and now - self._last_snapshot < self.snapshot_every_s
        ):
            return None
        self._last_snapshot = now
        return self.write_snapshot()


def read_snapshot(path: str) -> dict | None:
    """Load a ``live_metrics.json`` (tolerates a torn mid-replace write)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None
