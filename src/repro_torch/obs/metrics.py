"""One metrics registry for the whole stack — counters/gauges/histograms.

Before this module, every layer kept its own stats in its own shape:
``PagingStats.as_dict()`` (uvm), ``ChunkTransport.stats()`` (remote),
``CheckpointResult`` fields (core), SYNCED ``info`` dicts (proxy),
``RoundRecord`` (coord). The registry absorbs them all under one
snake_case naming scheme:

    <layer>_<metric>     e.g. uvm_faults_read, transport_wire_tx,
                              ckpt_bytes_written, proxy_restarts,
                              coord_rounds_committed

Absorption rides the channels the data already crosses: SYNCED info
frames (proxy → app), the fork-child result pipe (child counter deltas →
supervisor), PERSIST_DONE (worker → coordinator). No new wire traffic.

Always-on and allocation-light: incrementing a counter is a dict add
under a lock. Per-process snapshots are dumped to
``metrics-<process>-<pid>.json`` in the obs dir when tracing is enabled;
``repro.obs.report`` (the reference package; the shard format is shared) merges them per run.
"""
from __future__ import annotations

import json
import os
import threading

from repro_torch.obs import trace

METRICS_SCHEMA = "crum-metrics/1"

# ---------------------------------------------------------------------------
# Pinned public key sets. These names are consumed across layer boundaries —
# by benchmarks/gate.py rows, RoundRecord, SYNCED info consumers and the
# canonical registry mapping below. tests/obs/test_naming.py pins them;
# changing a producer without updating the pin (and every consumer) is a
# cross-layer break, which is exactly what the test is for.
# ---------------------------------------------------------------------------

PAGING_STAT_KEYS = frozenset(
    {
        "faults_read",
        "faults_write",
        "hits",
        "prefetches",
        "evictions",
        "writebacks",
        "invalidations",
        "h2d_bytes",
        "d2h_bytes",
        "resident_high_water",
        "remote_reads",
        "remote_read_bytes",
        "promotions",
        "faults",
    }
)

TRANSPORT_STAT_KEYS = frozenset(
    {
        "transport",
        "wire_tx",
        "wire_rx",
        "raw_tx",
        "raw_rx",
        "frames_tx",
        "frames_rx",
        "chunks_tx",
        "chunks_rx",
        "data_plane_bytes",
    }
)

# SYNCED / ProxyRunner.sync_state() info dict — the proxy data-plane summary.
SYNC_INFO_KEYS = frozenset(
    {
        "step",
        "digest",
        "metrics",
        "chunks_synced",
        "bytes_synced",
        "restarts",
        "transport",
        "epoch",
        "stall_us",
        "wire_bytes",
        "raw_bytes",
        "paging",
        "phase_us",
    }
)

# Per-round coordinator journal record (RoundRecord.as_dict()).
ROUND_RECORD_KEYS = frozenset(
    {
        "step",
        "status",
        "reason",
        "participants",
        "acked",
        "stragglers",
        "commit_s",
        "round_s",
        "persist_s_max",
        "bytes_written",
        "chunks_synced",
        "chunks_clean",
        "bytes_skipped",
        "sync_us",
        "digest_us",
        "fetch_us",
        "stall_us",
    }
)

# Row fields benchmarks/gate.py reads from BENCH_results.json.
GATE_ROW_KEYS = frozenset(
    {
        "overhead_pct",
        "stall_ratio",
        "boundary_scan_gone",
        "bit_identical",
        "boundary_bit_identical",
        "us_per_call",
    }
)

_HIST_CAP = 8192


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class Registry:
    """Counters (monotonic adds), gauges (latest wins), histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self._hists: dict[str, list[float]] = {}

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.setdefault(name, [])
            h.append(float(value))
            if len(h) >= _HIST_CAP:  # decimate: halve, keep the spread
                del h[::2]

    # -- snapshots ---------------------------------------------------------

    def counters_snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def gauges_snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self.gauges)

    def hist_summary(self, name: str) -> dict[str, float]:
        with self._lock:
            vals = sorted(self._hists.get(name, []))
        return {
            "count": len(vals),
            "sum": sum(vals),
            "p50": _percentile(vals, 0.50),
            "p99": _percentile(vals, 0.99),
            "max": vals[-1] if vals else 0.0,
        }

    def snapshot(self) -> dict:
        with self._lock:
            hist_names = list(self._hists)
            doc = {
                "schema": METRICS_SCHEMA,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
            }
        doc["hists"] = {n: self.hist_summary(n) for n in hist_names}
        return doc

    def merge_counters(self, delta: dict[str, float]) -> None:
        """Fold a child process's counter delta in (fork-pipe shipping)."""
        for k, v in delta.items():
            if isinstance(v, (int, float)):
                self.inc(k, v)

    def dump(self, path: str, *, process: str | None = None) -> None:
        doc = self.snapshot()
        doc["process"] = process
        doc["pid"] = os.getpid()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, default=str)
        os.replace(tmp, path)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self._hists.clear()


REGISTRY = Registry()


def counter_delta(
    before: dict[str, float], after: dict[str, float]
) -> dict[str, float]:
    """What a child process added between two counter snapshots."""
    out: dict[str, float] = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def dump_if_enabled(process: str, reg: Registry | None = None) -> str | None:
    """Write this process's snapshot into the obs dir (if tracing is on)."""
    tr = trace.get()
    if tr is None:
        return None
    path = os.path.join(
        tr.obs_dir, f"metrics-{process}-{os.getpid()}.json"
    )
    try:
        (reg or REGISTRY).dump(path, process=process)
    except OSError:
        return None
    return path


# ---------------------------------------------------------------------------
# Canonical absorption — scattered per-layer stat dicts map into the one
# registry under the one naming scheme. Producers keep their local shapes
# (as_dict()/stats() are public API); the registry is the merge point.
# ---------------------------------------------------------------------------


def absorb_paging(stats: dict, reg: Registry | None = None) -> None:
    """uvm ``PagingStats.as_dict()`` / ``ManagedSpace.stats_dict()``.

    Paging counters are cumulative per space, so they land as gauges
    (latest wins) — re-absorbing every SYNC boundary is idempotent.
    """
    reg = reg or REGISTRY
    for k, v in stats.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            reg.set(f"uvm_{k}", v)


def absorb_transport(stats: dict, reg: Registry | None = None) -> None:
    """remote ``ChunkTransport.stats()`` — cumulative wire counters."""
    reg = reg or REGISTRY
    for k, v in stats.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            reg.set(f"transport_{k}", v)


def absorb_sync_info(info: dict, reg: Registry | None = None) -> None:
    """Proxy SYNCED / ``sync_state()`` info dict, app side."""
    reg = reg or REGISTRY
    reg.inc("proxy_syncs_total")
    reg.inc("proxy_chunks_synced", info.get("chunks_synced") or 0)
    reg.inc("proxy_bytes_synced", info.get("bytes_synced") or 0)
    if info.get("stall_us") is not None:
        reg.observe("proxy_sync_stall_us", info["stall_us"])
    if info.get("wire_bytes") is not None:
        reg.set("proxy_wire_bytes", info["wire_bytes"])
    if info.get("raw_bytes") is not None:
        reg.set("proxy_raw_bytes", info["raw_bytes"])
    phase = info.get("phase_us") or {}
    for k, v in phase.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            reg.observe(f"proxy_phase_{k}_us", v)
    paging = info.get("paging")
    if isinstance(paging, dict):
        absorb_paging(paging, reg)
    transport = info.get("transport")
    if isinstance(transport, dict):
        absorb_transport(transport, reg)


def absorb_checkpoint_result(res, reg: Registry | None = None) -> None:
    """``core.forked.CheckpointResult`` — per-checkpoint phase stats."""
    reg = reg or REGISTRY
    reg.inc("ckpt_checkpoints_total")
    if getattr(res, "error", None):
        reg.inc("ckpt_errors_total")
    for field in (
        "bytes_written",
        "chunks_written",
        "chunks_reused",
        "chunks_synced",
        "chunks_clean",
        "bytes_skipped",
    ):
        v = getattr(res, field, None)
        if isinstance(v, (int, float)):
            reg.inc(f"ckpt_{field}", v)
    for field in ("blocking_s", "persist_s"):
        v = getattr(res, field, None)
        if isinstance(v, (int, float)):
            reg.observe(f"ckpt_{field}", v)
    for field in ("sync_us", "digest_us", "fetch_us", "stall_us"):
        v = getattr(res, field, None)
        if isinstance(v, (int, float)):
            reg.observe(f"ckpt_{field}", v)


def absorb_round(rec: dict, reg: Registry | None = None) -> None:
    """Coordinator journal ``round`` record (RoundRecord shape)."""
    reg = reg or REGISTRY
    reg.inc("coord_rounds_total")
    status = rec.get("status")
    if status == "committed":
        reg.inc("coord_rounds_committed")
    elif status:
        reg.inc("coord_rounds_aborted")
    for field in ("commit_s", "round_s", "persist_s_max"):
        v = rec.get(field)
        if isinstance(v, (int, float)):
            reg.observe(f"coord_{field}", v)
    for field in ("bytes_written", "chunks_synced", "chunks_clean",
                  "bytes_skipped"):
        v = rec.get(field)
        if isinstance(v, (int, float)):
            reg.inc(f"coord_{field}", v)
