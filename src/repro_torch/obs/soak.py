"""Soak verdict engine — every alert must explain itself.

The reference's ``repro.obs.soak``, framework-free, copied: the formats it reads
and writes are the reference's.

``python -m repro_torch.obs.soak RUN_DIR --check`` joins the injection journal
(``INJECT_LOG.jsonl``, ``crum-inject/1``) against everything the run
recorded — cluster-journal lines, watchdog AlertLines, live metric
series (leak trends), the critical-path report and the driver summary —
and renders a versioned scorecard (``crum-soak/1``, ``soak.json``) of
hard booleans:

``all_injections_evidenced``
    every injection produced its expected evidence inside its window
    (an injection that left no trace means detection is broken),
``no_unexplained_alerts``
    every alert is claimed by some injection's ``explains`` list within
    that injection's window (an unexplained alert is either a false
    positive or a real, un-injected fault — both are failures),
``converged``
    the cluster finished in bit-identical lockstep with a committed
    checkpoint,
``leaks_flat``
    the coordinator's fd and /dev/shm series did not grow beyond the
    allowance across the whole run (the port's /dev/shm series counts
    its own run's entries: :mod:`repro_torch.obs.leakcheck`),
``critpath_ok``
    the merged trace passes ``repro_torch.obs.critpath.check`` (orphan
    subtrees only where deaths are journaled),
``envelope_ok``
    no committed round exceeded the duration envelope.

``pass`` is the conjunction. Exit status follows it under ``--check``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.obs.journal import (
    AlertLine,
    DeathLine,
    InjectLine,
    JoinLine,
    ProxyHostDeathLine,
    ProxyPlacementLine,
    RoundLine,
    read_journal,
)

SOAK_SCHEMA = "crum-soak/1"

__all__ = ["SOAK_SCHEMA", "match_token", "evidence_for", "explain_alerts",
           "verdict", "main"]


def _in_window(t: float, inj: InjectLine) -> bool:
    w = float(inj.expect.get("window_s", 120.0))
    return inj.t <= t <= inj.t + w


def _host_ok(inj: InjectLine, host) -> bool:
    want = inj.expect.get("host")
    if want is None or host is None:
        return True
    return int(host) == int(want)


def match_token(token: str, inj: InjectLine, records: list) -> list[str]:
    """Evidence descriptors for one token of one injection's spec.

    Tokens: ``alert:<kind>`` matches an AlertLine; ``journal:<what>``
    matches a cluster-journal fact — ``death``, ``join_restored``,
    ``proxy_host_death``, ``proxy_placement_rescheduled``,
    ``round_committed`` (a commit after the injection: liveness),
    ``round_aborted_persist`` (an abort whose reason names persist).
    All matches are time-boxed to the injection's window and, when the
    spec pins a ``host``, host-filtered.
    """
    out: list[str] = []
    for r in records:
        if not _in_window(r.t, inj):
            continue
        if token.startswith("alert:"):
            kind = token.split(":", 1)[1]
            if (isinstance(r, AlertLine) and r.kind == kind
                    and _host_ok(inj, r.host)):
                out.append(f"alert:{kind}@{r.t:.3f}")
        elif token == "journal:death":
            if isinstance(r, DeathLine) and _host_ok(inj, r.host):
                out.append(f"death:host{r.host}@{r.t:.3f}")
        elif token == "journal:join_restored":
            if (isinstance(r, JoinLine) and r.restored_from is not None
                    and _host_ok(inj, r.host)):
                out.append(f"join_restored:host{r.host}@{r.t:.3f}")
        elif token == "journal:proxy_host_death":
            if isinstance(r, ProxyHostDeathLine):
                out.append(f"proxy_host_death:{r.name}@{r.t:.3f}")
        elif token == "journal:proxy_placement_rescheduled":
            if isinstance(r, ProxyPlacementLine) and r.rescheduled:
                out.append(f"rescheduled:worker{r.worker}@{r.t:.3f}")
        elif token == "journal:round_committed":
            if isinstance(r, RoundLine) and r.committed:
                out.append(f"round_committed:step{r.step}@{r.t:.3f}")
        elif token == "journal:round_aborted_persist":
            if (isinstance(r, RoundLine) and r.status == "aborted"
                    and "persist" in (r.reason or "")):
                out.append(f"round_aborted_persist:step{r.step}@{r.t:.3f}")
    return out


def evidence_for(inj: InjectLine, records: list) -> dict:
    """Judge one injection: ``{"evidenced": bool, "matched": {...}}``."""
    matched: dict[str, list[str]] = {}
    any_tokens = list(inj.expect.get("any") or [])
    all_tokens = list(inj.expect.get("all") or [])
    for tok in any_tokens + all_tokens:
        matched[tok] = match_token(tok, inj, records)
    ok = True
    if any_tokens:
        ok = any(matched[t] for t in any_tokens)
    if ok and all_tokens:
        ok = all(matched[t] for t in all_tokens)
    return {"evidenced": ok, "matched": matched}


def explain_alerts(injections: list[InjectLine],
                   alerts: list[AlertLine]) -> list[dict]:
    """Attribute every alert to the injection that claims it (or None).

    An alert is explained when its kind appears in some injection's
    ``explains`` list and it fired inside that injection's window —
    kind + time matching, deliberately not host-strict: a worker kill's
    abort ripples to rounds, not hosts.
    """
    out = []
    for a in alerts:
        by = None
        for inj in injections:
            if a.kind in (inj.expect.get("explains") or ()) \
                    and _in_window(a.t, inj):
                by = inj.seq
                break
        out.append({
            "kind": a.kind, "severity": a.severity, "host": a.host,
            "step": a.step, "t": a.t, "message": a.message,
            "explained_by": by,
        })
    return out


# -- run-dir plumbing --------------------------------------------------------


def load_inject_log(run_dir: str) -> list[InjectLine]:
    path = os.path.join(run_dir, "INJECT_LOG.jsonl")
    return [r for r in read_journal(path) if isinstance(r, InjectLine)]


def find_cluster_journal(run_dir: str) -> str | None:
    from repro_torch.obs.report import find_journal

    for cand in (
        os.path.join(run_dir, "ckpt", "CLUSTER_LOG.jsonl"),
        os.path.join(run_dir, "CLUSTER_LOG.jsonl"),
    ):
        if os.path.exists(cand):
            return cand
    return find_journal(run_dir)


def _leak_trend(snap: dict | None, metric: str) -> float | None:
    """Net growth of a coordinator-local series over the whole run.

    Prefers the 10s rollup tier (the raw ring wraps on long soaks);
    falls back to the raw series. None = the series never appeared
    (leakcheck unsupported on this platform)."""
    if not snap:
        return None
    for tier in ("10", "60"):
        pts = ((snap.get("rollups") or {}).get(tier) or {}) \
            .get("-1", {}).get(metric)
        if pts:
            return float(pts[-1][1]) - float(pts[0][1])
    raw = (snap.get("series") or {}).get("-1", {}).get(metric)
    if raw:
        return float(raw[-1][1]) - float(raw[0][1])
    return None


def verdict(run_dir: str, *, round_envelope_s: float = 30.0,
            fd_allowance: int = 8, shm_allowance: int = 4) -> dict:
    """The full ``crum-soak/1`` scorecard for one soak run dir."""
    from repro_torch.obs import critpath as obs_critpath
    from repro_torch.obs import live as obs_live

    run_dir = os.path.abspath(run_dir)
    injections = load_inject_log(run_dir)
    jpath = find_cluster_journal(run_dir)
    records = read_journal(jpath) if jpath else []
    alerts = [r for r in records if isinstance(r, AlertLine)]
    rounds = [r for r in records if isinstance(r, RoundLine)]

    inj_rows = []
    for inj in injections:
        row = {"seq": inj.seq, "kind": inj.kind, "target": inj.target,
               "t": inj.t, "params": inj.params}
        row.update(evidence_for(inj, records))
        inj_rows.append(row)
    alert_rows = explain_alerts(injections, alerts)

    # convergence: the driver summary when present, else the journal
    summary = None
    try:
        with open(os.path.join(run_dir, "soak_run.json")) as f:
            summary = json.load(f)
    except (OSError, ValueError):
        pass
    if summary is not None:
        converged = bool(summary.get("lockstep")) \
            and summary.get("latest_committed") is not None
    else:
        committed = [r for r in rounds if r.committed]
        converged = bool(committed)

    obs_dir = os.path.join(run_dir, "obs")
    snap = obs_live.read_snapshot(
        os.path.join(obs_dir, "live_metrics.json")
    ) or obs_live.read_snapshot(
        os.path.join(run_dir, "ckpt", "live_metrics.json")
    )
    fd_growth = _leak_trend(snap, "coord_fd")
    shm_growth = _leak_trend(snap, "coord_shm")
    # an absent series is not a leak — leakcheck may be unsupported
    leaks_flat = (fd_growth is None or fd_growth <= fd_allowance) and \
                 (shm_growth is None or shm_growth <= shm_allowance)

    critpath_problems: list[str] = []
    critpath_ok = True
    if os.path.isdir(obs_dir) and jpath:
        try:
            doc = obs_critpath.analyze(obs_dir, journal=jpath)
            critpath_problems = obs_critpath.check(doc)
            critpath_ok = not critpath_problems
        except Exception as e:
            critpath_problems = [f"critpath analysis failed: {e}"]
            critpath_ok = False

    slow = [r for r in rounds
            if r.committed and r.round_s > round_envelope_s]

    checks = {
        "all_injections_evidenced": all(r["evidenced"] for r in inj_rows),
        "no_unexplained_alerts": all(
            a["explained_by"] is not None for a in alert_rows
        ),
        "converged": converged,
        "leaks_flat": leaks_flat,
        "critpath_ok": critpath_ok,
        "envelope_ok": not slow,
    }
    return {
        "schema": SOAK_SCHEMA,
        "run_dir": run_dir,
        "n_injections": len(inj_rows),
        "n_alerts": len(alert_rows),
        "injections": inj_rows,
        "alerts": alert_rows,
        "leak_growth": {"coord_fd": fd_growth, "coord_shm": shm_growth},
        "critpath_problems": critpath_problems,
        "slow_rounds": [{"step": r.step, "round_s": r.round_s}
                        for r in slow],
        "checks": checks,
        "pass": all(checks.values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.soak", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run_dir")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless every check passes")
    ap.add_argument("--out", default=None,
                    help="scorecard path (default RUN_DIR/soak.json)")
    ap.add_argument("--round-envelope-s", type=float, default=30.0)
    ap.add_argument("--fd-allowance", type=int, default=8)
    ap.add_argument("--shm-allowance", type=int, default=4)
    args = ap.parse_args(argv)

    doc = verdict(
        args.run_dir,
        round_envelope_s=args.round_envelope_s,
        fd_allowance=args.fd_allowance,
        shm_allowance=args.shm_allowance,
    )
    out = args.out or os.path.join(os.path.abspath(args.run_dir),
                                   "soak.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=2)

    for row in doc["injections"]:
        tick = "ok " if row["evidenced"] else "FAIL"
        hits = sum(len(v) for v in row["matched"].values())
        print(f"  [{tick}] #{row['seq']} {row['kind']} -> {row['target']} "
              f"({hits} evidence line(s))")
    unexplained = [a for a in doc["alerts"] if a["explained_by"] is None]
    for a in unexplained:
        print(f"  [FAIL] unexplained alert {a['kind']} "
              f"(host={a['host']}, t={a['t']:.3f}): {a['message']}")
    for name, ok in doc["checks"].items():
        print(f"  [{'ok ' if ok else 'FAIL'}] {name}")
    print(f"soak verdict: {'PASS' if doc['pass'] else 'FAIL'} "
          f"({doc['n_injections']} injections, {doc['n_alerts']} alerts) "
          f"-> {out}")
    if args.check and not doc["pass"]:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
