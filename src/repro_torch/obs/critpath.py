"""Per-round causal trees, critical path, and latency attribution.

The reference's ``repro.obs.critpath``, framework-free, copied: the formats it reads
and writes are the reference's.

    PYTHONPATH=src python -m repro_torch.obs.critpath <run_dir>
    PYTHONPATH=src python -m repro_torch.obs.critpath <run_dir> --check   # CI

Spans traced with a causal context (``trace``/``span``/``parent`` args —
see :mod:`repro_torch.obs.trace`) are stitched here into one tree per
checkpoint round: the coordinator's ``coord.round`` span is the
deterministic root (``root_span_id("round:<step>")``), every worker's
``worker.round`` hangs off it, and proxy/persist/commit spans hang off
those. Over each *committed* round this module computes:

* the **critical path** — from the round root, repeatedly descend into
  the child subtree that finishes last; the spans on that walk are what
  actually bounded the round's latency, and ``critical_host`` names the
  host that held the round open,
* a **phase decomposition** — the round window is swept into pinned
  buckets (step compute, sync, sync stall, wire/codec, phase-1
  snapshot, persist, commit quorum) plus a ``wait`` residual, both as a
  union across hosts (sums to the round span by construction) and per
  host; ``--check`` asserts the round span agrees with the journaled
  ``round_s`` within 5 %,
* **orphan subtrees** — spans whose parent chain dead-ends in a missing
  id. A SIGKILLed process leaves exactly this signature (its children's
  frames landed, its own span never closed), so orphans are reported,
  and fail ``--check`` only when the journal recorded no deaths.

The JSON report (``--json FILE``) is versioned ``crum-critpath/1``.
:func:`flow_events` additionally renders every resolved parent→child
edge as Perfetto flow events (``s``/``f``); ``repro_torch.obs.report``
stitches them into the merged trace so the causal arrows show up in the
Perfetto UI.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.obs.journal import read_journal
from repro_torch.obs.report import find_journal, load_shards
from repro_torch.obs.trace import root_span_id, round_trace_id

CRITPATH_SCHEMA = "crum-critpath/1"

# round-latency buckets, most-specific first: when intervals overlap
# (ckpt.persist runs inside worker.round, proxy.wire inside proxy.sync)
# the sweep charges the sub-interval to the lowest-ranked active bucket
_PHASE_RANK: list[tuple[str, tuple[str, ...]]] = [
    ("commit", ("coord.commit",)),
    ("persist", ("ckpt.persist",)),
    ("phase1", ("ckpt.phase1",)),
    ("wire_codec", ("proxy.wire",)),
    ("sync_stall", ("app.sync_stall",)),
    ("sync", ("proxy.sync",)),
    ("step_compute", ("proxy.step", "app.step")),
]
_BUCKET_OF = {name: i for i, (_, names) in enumerate(_PHASE_RANK)
              for name in names}

# tolerance for the span-vs-journal agreement check: 5 % relative, with
# a 2 ms absolute floor so sub-millisecond rounds don't flap on jitter
CHECK_REL = 0.05
CHECK_ABS_S = 0.002

__all__ = [
    "CRITPATH_SCHEMA",
    "build_spans",
    "flow_events",
    "analyze",
    "main",
]


# -- span reconstruction ----------------------------------------------------


def build_spans(events: list[dict]) -> list[dict]:
    """Events → span dicts with causal identity.

    X events and matched B/E pairs become closed spans; an unclosed B
    (SIGKILL mid-span) becomes an open-ended span marked
    ``incomplete``; instants that carry a causal context become
    zero-duration nodes so acks/registrations appear in the tree.
    """
    spans: list[dict] = []
    open_b: dict[tuple, list[dict]] = {}

    def mk(ev: dict, end, args: dict, incomplete: bool = False) -> dict:
        args = args if isinstance(args, dict) else {}
        ts = float(ev.get("ts", 0))
        return {
            "name": ev.get("name", "?"),
            "pid": ev.get("pid"),
            "tid": ev.get("tid"),
            "shard": ev.get("_shard"),
            "ts": ts,
            "end": float(end) if end is not None else None,
            "args": args,
            "trace": args.get("trace"),
            "span": args.get("span"),
            "parent": args.get("parent"),
            "incomplete": incomplete,
        }

    for ev in sorted(events, key=lambda e: e.get("ts", 0)):
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "X":
            spans.append(mk(ev, float(ev.get("ts", 0)) +
                            float(ev.get("dur", 0)), ev.get("args") or {}))
        elif ph == "B":
            open_b.setdefault(key, []).append(ev)
        elif ph == "E":
            stack = open_b.get(key)
            if stack:
                b = stack.pop()
                args = {**(b.get("args") or {}), **(ev.get("args") or {})}
                spans.append(mk(b, ev.get("ts", 0), args))
        elif ph in ("i", "I"):
            args = ev.get("args") or {}
            if isinstance(args, dict) and args.get("span") is not None:
                spans.append(mk(ev, ev.get("ts", 0), args))
    for stack in open_b.values():
        for b in stack:  # process died inside the span: open-ended
            spans.append(mk(b, None, b.get("args") or {}, incomplete=True))
    return spans


def _traces(spans: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for s in spans:
        if s["trace"] is not None and s["span"] is not None:
            out.setdefault(s["trace"], []).append(s)
    return out


def _resolves(span: dict, parent_of: dict, ids: set) -> bool:
    """Does the parent chain reach a root without a missing link/cycle?"""
    cur, seen = span.get("parent"), set()
    while cur is not None:
        if cur in seen or cur not in ids:
            return False
        seen.add(cur)
        cur = parent_of.get(cur)
    return True


def _host_of(span: dict, by_id: dict) -> str:
    """Host attribution: coordinator spans are "coord"; everything else
    inherits the ``host`` arg from the nearest ancestor that has one
    (``worker.round`` carries it), falling back to the source shard."""
    if str(span["name"]).startswith("coord."):
        return "coord"
    cur, seen = span, set()
    while cur is not None:
        h = cur["args"].get("host")
        if h is not None:
            return str(h)
        p = cur.get("parent")
        if p is None or p in seen:
            break
        seen.add(p)
        cur = by_id.get(p)
    return str(span.get("shard") or "?")


# -- phase decomposition ----------------------------------------------------


def _sweep(intervals: list[tuple[int, float, float]],
           t0: float, t1: float) -> dict[str, float]:
    """Charge every sub-interval of [t0, t1] to the lowest-ranked active
    bucket (``wait`` when none is active). Sums to t1−t0 exactly."""
    pts = {t0, t1}
    clipped = []
    for rank, s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            clipped.append((rank, s, e))
            pts.update((s, e))
    order = sorted(pts)
    out = {name: 0.0 for name, _ in _PHASE_RANK}
    out["wait"] = 0.0
    for a, b in zip(order, order[1:]):
        active = [r for r, s, e in clipped if s <= a and e >= b]
        out[_PHASE_RANK[min(active)][0] if active else "wait"] += b - a
    return out


def _phase_intervals(spans: list[dict]) -> list[tuple[int, float, float, str]]:
    out = []
    for s in spans:
        rank = _BUCKET_OF.get(s["name"])
        if rank is None or s["end"] is None:
            continue
        out.append((rank, s["ts"], s["end"], s.get("_host", "?")))
    return out


def _critical_path(root: dict, children: dict, by_id: dict) -> list[dict]:
    """Greedy descent into the child that finishes last."""
    path: list[dict] = []
    cur, seen = root, set()
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        end = cur["end"] if cur["end"] is not None else cur["ts"]
        path.append({
            "name": cur["name"],
            "host": cur.get("_host", "?"),
            "ts_us": round(cur["ts"], 1),
            "dur_us": round(end - cur["ts"], 1),
            "incomplete": cur["incomplete"],
        })
        kids = children.get(cur["span"]) or []
        kids = [k for k in kids if id(k) not in seen]
        cur = max(
            kids,
            key=lambda k: k["end"] if k["end"] is not None else k["ts"],
            default=None,
        )
    return path


# -- the report -------------------------------------------------------------


def analyze(run_dir: str, journal: str | None = None) -> dict:
    """The full ``crum-critpath/1`` document for a run dir."""
    events, _ = load_shards(run_dir)
    spans = build_spans(events)
    traces = _traces(spans)
    jpath = find_journal(run_dir, journal)
    round_lines = []
    deaths = 0
    if jpath:
        for rec in read_journal(jpath):
            if rec.event == "round":
                round_lines.append(rec)
            elif rec.event == "death":
                deaths += 1

    rounds: list[dict] = []
    claimed: set[str] = set()
    for rl in round_lines:
        trace_id = round_trace_id(rl.step)
        claimed.add(trace_id)
        if rl.status != "committed":
            rounds.append({"step": rl.step, "status": rl.status,
                           "trace": trace_id})
            continue
        tspans = traces.get(trace_id, [])
        ids = {s["span"] for s in tspans}
        parent_of = {s["span"]: s.get("parent") for s in tspans}
        by_id: dict = {}
        for s in tspans:
            by_id.setdefault(s["span"], s)
        for s in tspans:
            s["_host"] = _host_of(s, by_id)
        root_id = root_span_id(trace_id)
        # a retried round opens one coord.round per attempt, all with the
        # same deterministic root id: the committed attempt is the one
        # whose window contains the journal line's commit timestamp
        t_us = rl.t * 1e6
        attempts = [s for s in tspans
                    if s["name"] == "coord.round" and s["span"] == root_id]
        attempt = None
        containing = [a for a in attempts if a["end"] is not None
                      and a["ts"] <= t_us <= a["end"]]
        if containing:
            attempt = containing[0]
        elif attempts:
            attempt = min(
                attempts,
                key=lambda a: abs((a["end"] if a["end"] is not None
                                   else a["ts"]) - t_us),
            )
        orphans = [s for s in tspans if not _resolves(s, parent_of, ids)]
        entry: dict = {
            "step": rl.step,
            "status": "committed",
            "trace": trace_id,
            "rooted": attempt is not None,
            "n_spans": len(tspans),
            "orphan_spans": len(orphans),
            "round_s": rl.round_s,
        }
        if attempt is not None and attempt["end"] is not None:
            t0, t1 = attempt["ts"], attempt["end"]
            entry["span_s"] = round((t1 - t0) / 1e6, 6)
            ivals = _phase_intervals(tspans)
            entry["phases_us"] = {
                k: round(v, 1)
                for k, v in _sweep([(r, s, e) for r, s, e, _ in ivals],
                                   t0, t1).items()
            }
            hosts = sorted({h for _, _, _, h in ivals})
            entry["per_host_us"] = {
                h: {k: round(v, 1)
                    for k, v in _sweep(
                        [(r, s, e) for r, s, e, hh in ivals if hh == h],
                        t0, t1).items() if k != "wait" and v > 0}
                for h in hosts
            }
            children: dict = {}
            for s in tspans:
                if s.get("parent") is not None:
                    children.setdefault(s["parent"], []).append(s)
            cp = _critical_path(attempt, children, by_id)
            entry["critical_path"] = cp
            entry["critical_host"] = cp[-1]["host"] if cp else None
        rounds.append(entry)

    # traces the journal never claimed: trailing windows (steps past the
    # last boundary) and rounds a killed coordinator never journaled
    stray = []
    for trace_id in sorted(set(traces) - claimed):
        tspans = traces[trace_id]
        ids = {s["span"] for s in tspans}
        parent_of = {s["span"]: s.get("parent") for s in tspans}
        n_orphans = sum(1 for s in tspans
                        if not _resolves(s, parent_of, ids))
        stray.append({"trace": trace_id, "n_spans": len(tspans),
                      "orphan_spans": n_orphans})

    return {
        "schema": CRITPATH_SCHEMA,
        "run_dir": run_dir,
        "journal": jpath,
        "deaths": deaths,
        "rounds": rounds,
        "orphans": stray,
    }


def check(doc: dict) -> list[str]:
    """--check rules; empty list = green."""
    problems: list[str] = []
    committed = [r for r in doc["rounds"] if r["status"] == "committed"]
    for r in committed:
        step = r["step"]
        if not r.get("rooted"):
            problems.append(
                f"round {step}: committed but no coord.round root span"
            )
            continue
        span_s, round_s = r.get("span_s"), r.get("round_s")
        if span_s is None:
            problems.append(f"round {step}: root span never closed")
        elif round_s and abs(span_s - round_s) > max(
            CHECK_REL * round_s, CHECK_ABS_S
        ):
            problems.append(
                f"round {step}: span {span_s:.4f}s vs journal "
                f"{round_s:.4f}s (> {CHECK_REL:.0%} apart)"
            )
        if r.get("orphan_spans") and not doc.get("deaths"):
            # orphans are the expected residue of kill drills; with no
            # journaled deaths they mean the propagation chain broke
            problems.append(
                f"round {step}: {r['orphan_spans']} orphan span(s) with "
                f"no journaled deaths"
            )
    return problems


# -- Perfetto flow stitching ------------------------------------------------


def flow_events(events: list[dict]) -> list[dict]:
    """Every resolved parent→child edge as an ``s``/``f`` flow pair, so
    the merged trace draws the causal arrows across processes."""
    spans = build_spans(events)
    by_id: dict = {}
    for s in spans:
        if s["span"] is not None:
            by_id.setdefault(s["span"], s)
    out: list[dict] = []
    for s in spans:
        p = s.get("parent")
        if s["span"] is None or p is None:
            continue
        parent = by_id.get(p)
        if parent is None or parent["pid"] is None or s["pid"] is None:
            continue  # orphan edge: nothing to draw to
        fid = format(int(s["span"]), "x")
        out.append({"name": "causal", "cat": "causal", "ph": "s",
                    "id": fid, "pid": parent["pid"],
                    "tid": parent["tid"], "ts": parent["ts"]})
        out.append({"name": "causal", "cat": "causal", "ph": "f",
                    "bp": "e", "id": fid, "pid": s["pid"],
                    "tid": s["tid"], "ts": s["ts"]})
    return out


# -- entry point ------------------------------------------------------------


def _fmt_round(r: dict) -> str:
    if r["status"] != "committed":
        return f"  round {r['step']:<6} {r['status']}"
    if "span_s" not in r:
        return (f"  round {r['step']:<6} committed  UNROOTED "
                f"({r.get('n_spans', 0)} spans)")
    phases = r.get("phases_us", {})
    top = sorted(phases.items(), key=lambda kv: -kv[1])[:3]
    top_s = " ".join(f"{k}={v / 1e3:.1f}ms" for k, v in top if v > 0)
    return (
        f"  round {r['step']:<6} committed  span={r['span_s']:.3f}s "
        f"journal={r['round_s']:.3f}s  orphans={r['orphan_spans']}  "
        f"critical={r.get('critical_host')}  {top_s}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.critpath", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run_dir", help="obs dir holding trace-*.jsonl shards")
    ap.add_argument("--journal", default=None,
                    help="explicit CLUSTER_LOG.jsonl path")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the crum-critpath/1 report as JSON")
    ap.add_argument("--check", action="store_true",
                    help="assert every committed round is rooted and its "
                         "phase sum agrees with the journal within 5%%")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.run_dir):
        print(f"[critpath] no such run dir: {args.run_dir}",
              file=sys.stderr)
        return 2
    doc = analyze(args.run_dir, args.journal)
    committed = [r for r in doc["rounds"] if r["status"] == "committed"]
    print(f"[critpath] {len(doc['rounds'])} journaled round(s), "
          f"{len(committed)} committed, {len(doc['orphans'])} stray "
          f"trace(s), {doc['deaths']} death(s)")
    for r in doc["rounds"]:
        print(_fmt_round(r))
    for o in doc["orphans"]:
        print(f"  stray {o['trace']:<12} {o['n_spans']} span(s), "
              f"{o['orphan_spans']} orphaned")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2, default=str)
        print(f"[critpath] wrote {args.json}")
    if args.check:
        problems = check(doc)
        if problems:
            for p in problems:
                print(f"[critpath] FAILED: {p}", file=sys.stderr)
            return 1
        print(f"[critpath] check OK ({len(committed)} committed round(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
