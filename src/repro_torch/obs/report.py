"""Run-dir reporter — merge shards into one Perfetto trace + summary
(the reference's ``repro.obs.report``, framework-free, copied).

    PYTHONPATH=src python -m repro_torch.obs.report <run_dir>
    PYTHONPATH=src python -m repro_torch.obs.report <run_dir> --check   # CI

Inputs found under ``<run_dir>`` (the ``--obs-dir`` of a run):

* ``trace-<process>-<pid>.jsonl`` — per-process trace_event shards,
* ``metrics-<process>-<pid>.json`` — per-process registry snapshots,
* ``CLUSTER_LOG.jsonl`` — coordinator journal (also looked up one level
  up, where ``launch/cluster`` keeps it) — journal records become
  instants on a synthetic "cluster-journal" track so commits/deaths line
  up against the process timelines.

Outputs: ``<run_dir>/merged.trace.json`` (open in https://ui.perfetto.dev
or chrome://tracing) and a text summary — per-span p50/p99, stall ratio,
fault/eviction rates, wire vs dirty bytes.

``--check`` additionally validates the merged trace against the
trace_event schema (required keys per phase, balanced ``B``/``E``
nesting per (pid, tid) in every shard) and exits non-zero on violation.

Kill drills SIGKILL processes mid-run, so the reporter tolerates the
gaps they leave — a traced process with no metrics dump, a dump torn
mid-replace — and *names* them (``missing_metrics``/``corrupt_metrics``
in the summary) instead of failing. ``--summary-json FILE`` writes the
whole summary as machine-readable JSON (the CI artifact).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.obs.journal import read_journal

# Synthetic pid for the journal track — far outside real pid ranges.
JOURNAL_PID = 99999999

_REQUIRED = ("name", "ph", "ts")
_PHASES = {"B", "E", "X", "i", "I", "C", "M", "s", "t", "f"}


def load_shards(run_dir: str) -> tuple[list[dict], list[str]]:
    """All events from every trace-*.jsonl shard; skips torn lines."""
    events: list[dict] = []
    shards = sorted(glob.glob(os.path.join(run_dir, "trace-*.jsonl")))
    for path in shards:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # torn tail (SIGKILL mid-write)
                if isinstance(ev, dict):
                    ev["_shard"] = os.path.basename(path)
                    events.append(ev)
    return events, shards


def find_journal(run_dir: str, explicit: str | None = None) -> str | None:
    for cand in (
        explicit,
        os.path.join(run_dir, "CLUSTER_LOG.jsonl"),
        os.path.join(os.path.dirname(os.path.abspath(run_dir)),
                     "CLUSTER_LOG.jsonl"),
    ):
        if cand and os.path.exists(cand):
            return cand
    return None


def journal_events(journal_path: str) -> list[dict]:
    """Coordinator journal records → instants on a synthetic track."""
    out: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": JOURNAL_PID,
            "tid": 0,
            "ts": 0,
            "args": {"name": "cluster-journal"},
        }
    ]
    for rec in read_journal(journal_path):
        args = {k: v for k, v in vars(rec).items()
                if k not in ("extra", "schema") and v not in (None, [], "")}
        args.update(rec.extra)
        out.append(
            {
                "name": f"journal.{rec.event}",
                "ph": "i",
                "s": "p",
                "pid": JOURNAL_PID,
                "tid": 0,
                "ts": int(rec.t * 1e6),
                "args": args,
            }
        )
    return out


def _shard_id(path: str, prefix: str, suffix: str) -> str | None:
    """``<prefix><process>-<pid><suffix>`` -> ``<process>-<pid>``."""
    name = os.path.basename(path)
    if not (name.startswith(prefix) and name.endswith(suffix)):
        return None
    return name[len(prefix):len(name) - len(suffix)]


def merge_metrics(run_dir: str) -> dict:
    """Sum per-process registry snapshots into one run-level view.

    Kill drills leave gaps: a SIGKILLed process traced events but never
    reached its atexit metrics dump, and a dump torn mid-replace is
    unparseable. Both are *expected* in failure drills, so the merge
    proceeds over what exists — but the gaps are named in the result
    (``missing_metrics`` / ``corrupt_metrics``) so a report over a run
    that should have been clean can be gated on them.
    """
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    processes: list[str] = []
    corrupt: list[str] = []
    seen: set[str] = set()
    for path in sorted(glob.glob(os.path.join(run_dir, "metrics-*.json"))):
        sid = _shard_id(path, "metrics-", ".json")
        if sid is not None:
            seen.add(sid)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            corrupt.append(os.path.basename(path))
            continue
        processes.append(str(doc.get("process") or
                             os.path.basename(path)))
        for k, v in (doc.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        for k, v in (doc.get("gauges") or {}).items():
            if isinstance(v, (int, float)):
                # gauges are per-process cumulative values: sum across
                # processes gives the run total (e.g. uvm_faults per space)
                gauges[k] = gauges.get(k, 0) + v
    # a trace shard with no metrics twin = that process died before its
    # final dump (SIGKILL drill, crash) — a gap, not a reporter error
    missing = sorted(
        sid
        for path in glob.glob(os.path.join(run_dir, "trace-*.jsonl"))
        if (sid := _shard_id(path, "trace-", ".jsonl")) is not None
        and sid not in seen
    )
    return {
        "counters": counters, "gauges": gauges, "processes": processes,
        "missing_metrics": missing, "corrupt_metrics": corrupt,
    }


# -- validation -------------------------------------------------------------


def validate_events(events: list[dict]) -> list[str]:
    """trace_event schema + nesting problems (empty list = valid)."""
    problems: list[str] = []
    stacks: dict[tuple, list[str]] = {}
    for i, ev in enumerate(events):
        where = f"event {i} ({ev.get('_shard', '?')})"
        for k in _REQUIRED:
            if k not in ev:
                problems.append(f"{where}: missing {k!r}")
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        if ph != "M" and ("pid" not in ev or "tid" not in ev):
            problems.append(f"{where}: missing pid/tid")
            continue
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"{where}: X event without numeric dur")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append(
                    f"{where}: orphaned E {ev.get('name')!r} on {key}"
                )
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed B events on {key}: {stack}")
    return problems


# -- summary ----------------------------------------------------------------


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def span_durations(events: list[dict]) -> dict[str, list[float]]:
    """Per-name duration samples (µs) from X events and matched B/E pairs."""
    durs: dict[str, list[float]] = {}
    open_b: dict[tuple, list[dict]] = {}
    for ev in sorted(events, key=lambda e: e.get("ts", 0)):
        ph = ev.get("ph")
        if ph == "X":
            durs.setdefault(ev.get("name", "?"), []).append(
                float(ev.get("dur", 0))
            )
        elif ph == "B":
            open_b.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
        elif ph == "E":
            stack = open_b.get((ev.get("pid"), ev.get("tid")))
            if stack:
                b = stack.pop()
                durs.setdefault(b.get("name", "?"), []).append(
                    float(ev.get("ts", 0)) - float(b.get("ts", 0))
                )
    return durs


def summary_dict(events: list[dict], metrics: dict) -> dict:
    """The run summary as data — one source for text AND --summary-json."""
    durs = span_durations(events)
    spans = {}
    for name in sorted(durs):
        vals = sorted(durs[name])
        spans[name] = {
            "count": len(vals),
            "p50_us": round(_pct(vals, 0.5), 1),
            "p99_us": round(_pct(vals, 0.99), 1),
            "total_ms": round(sum(vals) / 1e3, 3),
        }

    c = metrics.get("counters", {})
    g = metrics.get("gauges", {})
    derived: dict = {}
    step_total = sum(durs.get("app.step", [])) or sum(
        durs.get("proxy.step", [])
    )
    stall_total = sum(durs.get("app.sync_stall", []))
    if step_total:
        derived["stall_ratio"] = round(stall_total / step_total, 4)
    steps = len(durs.get("proxy.step", [])) or len(durs.get("app.step", []))
    if steps:
        derived["uvm_faults_per_step"] = round(
            g.get("uvm_faults", 0) / steps, 2)
        derived["uvm_evictions_per_step"] = round(
            g.get("uvm_evictions", 0) / steps, 2)
    wire = g.get("transport_wire_tx", 0) + g.get("transport_wire_rx", 0)
    dirty = c.get("proxy_bytes_synced", 0) or c.get("ckpt_bytes_written", 0)
    if wire or dirty:
        derived["wire_bytes"] = int(wire)
        derived["dirty_bytes"] = int(dirty)
        if dirty:
            derived["wire_vs_dirty_x"] = round(wire / dirty, 3)
    if c.get("proxy_restarts", 0):
        derived["proxy_restarts"] = int(c["proxy_restarts"])
    if c.get("coord_rounds_total", 0):
        derived["coord_rounds"] = int(c["coord_rounds_total"])
        derived["coord_rounds_committed"] = int(
            c.get("coord_rounds_committed", 0))
    if c.get("watch_alerts_total", 0):
        derived["watch_alerts"] = int(c["watch_alerts_total"])
    return {
        "schema": "crum-obs-summary/1",
        "spans": spans,
        "derived": derived,
        "counters": c,
        "gauges": g,
        "processes": metrics.get("processes", []),
        "missing_metrics": metrics.get("missing_metrics", []),
        "corrupt_metrics": metrics.get("corrupt_metrics", []),
    }


def summarize(events: list[dict], metrics: dict) -> str:
    doc = summary_dict(events, metrics)
    lines: list[str] = []
    lines.append(f"{'span':<28}{'count':>8}{'p50_us':>12}{'p99_us':>12}"
                 f"{'total_ms':>12}")
    for name, s in doc["spans"].items():
        lines.append(
            f"{name:<28}{s['count']:>8}{s['p50_us']:>12.0f}"
            f"{s['p99_us']:>12.0f}{s['total_ms']:>12.1f}"
        )
    d = doc["derived"]
    lines.append("")
    lines.append("derived:")
    if "stall_ratio" in d:
        lines.append(
            f"  stall_ratio            {d['stall_ratio']:.4f}  "
            f"(sync stall / step time)"
        )
    if "uvm_faults_per_step" in d:
        lines.append(f"  uvm_faults_per_step    "
                     f"{d['uvm_faults_per_step']:.2f}")
        lines.append(f"  uvm_evictions_per_step "
                     f"{d['uvm_evictions_per_step']:.2f}")
    if "wire_bytes" in d:
        ratio = (f"  ({d['wire_vs_dirty_x']:.3f}x)"
                 if "wire_vs_dirty_x" in d else "")
        lines.append(
            f"  wire_bytes vs dirty    {d['wire_bytes']} / "
            f"{d.get('dirty_bytes', 0)}{ratio}"
        )
    if "proxy_restarts" in d:
        lines.append(f"  proxy_restarts         {d['proxy_restarts']}")
    if "coord_rounds" in d:
        lines.append(
            f"  coord_rounds           {d['coord_rounds']} "
            f"({d['coord_rounds_committed']} committed)"
        )
    if "watch_alerts" in d:
        lines.append(f"  watch_alerts           {d['watch_alerts']}")
    if doc["processes"]:
        lines.append(
            f"  metric sources         {', '.join(doc['processes'])}"
        )
    if doc["missing_metrics"]:
        lines.append(
            f"  MISSING metric shards  {', '.join(doc['missing_metrics'])} "
            f"(process died before its final dump)"
        )
    if doc["corrupt_metrics"]:
        lines.append(
            f"  CORRUPT metric shards  {', '.join(doc['corrupt_metrics'])}"
        )
    return "\n".join(lines)


# -- entry point ------------------------------------------------------------


def merge(run_dir: str, journal: str | None = None,
          out: str | None = None) -> tuple[str, list[dict], dict]:
    events, shards = load_shards(run_dir)
    try:
        # causal-context spans become Perfetto flow arrows; lazy import —
        # critpath imports this module for shard loading
        from repro_torch.obs.critpath import flow_events

        events.extend(flow_events(events))
    except Exception:
        pass  # a malformed ctx must not take the whole report down
    jpath = find_journal(run_dir, journal)
    if jpath:
        events.extend(journal_events(jpath))
    events.sort(key=lambda e: e.get("ts", 0))
    metrics = merge_metrics(run_dir)
    out = out or os.path.join(run_dir, "merged.trace.json")
    doc = {
        "traceEvents": [
            {k: v for k, v in ev.items() if k != "_shard"} for ev in events
        ],
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": "crum-trace/1",
            "shards": [os.path.basename(s) for s in shards],
            "journal": jpath,
            "metrics": metrics,
        },
    }
    with open(out, "w") as f:
        json.dump(doc, f, default=str)
    return out, events, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run_dir", help="obs dir holding trace-*.jsonl shards")
    ap.add_argument("--journal", default=None,
                    help="explicit CLUSTER_LOG.jsonl path")
    ap.add_argument("--out", default=None,
                    help="merged trace path (default <run_dir>/merged.trace.json)")
    ap.add_argument("--check", action="store_true",
                    help="validate trace_event schema + span nesting; "
                         "exit non-zero on violation")
    ap.add_argument("--summary-json", metavar="FILE", default=None,
                    help="also write the summary (spans + derived + "
                         "merged metrics + shard gaps) as JSON")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.run_dir):
        print(f"[obs] no such run dir: {args.run_dir}", file=sys.stderr)
        return 2
    out, events, metrics = merge(args.run_dir, args.journal, args.out)
    n_shard_events = sum(1 for e in events if "_shard" in e)
    print(f"[obs] merged {n_shard_events} events -> {out}")
    print(summarize(events, metrics))
    if args.summary_json:
        with open(args.summary_json, "w") as f:
            json.dump(summary_dict(events, metrics), f, indent=2,
                      default=str)
        print(f"[obs] wrote summary to {args.summary_json}")
    if args.check:
        problems = validate_events(events)
        if problems:
            for p in problems[:50]:
                print(f"[obs] INVALID: {p}", file=sys.stderr)
            print(f"[obs] trace validation FAILED "
                  f"({len(problems)} problem(s))", file=sys.stderr)
            return 1
        print(f"[obs] trace validation OK ({n_shard_events} events, "
              f"{len(metrics.get('processes', []))} metric shards)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
