"""``python -m repro_torch.obs.top`` — the terminal live view of a cluster
run (PyTorch port).

The twin of ``repro.obs.top``, over the port's ``obs.live`` snapshot, its
journal and its coordinator's METRICS frame; it imports no framework, and
a run dir written by either package renders to the same text with
either. Two data sources, same rendering:

* ``--endpoint HOST:PORT`` — ask a *running* coordinator over its own
  TCP listener (the ``METRICS`` side-channel frame; no JOIN, so the view
  never participates in membership or rounds), refreshing every
  ``--interval`` seconds.
* ``--run-dir DIR`` — read the ``live_metrics.json`` snapshot the
  coordinator drops into the checkpoint root (plus ``alert`` lines from
  CLUSTER_LOG.jsonl), which also works after the run has ended.

``--once`` renders a single frame and exits — what CI and tests use;
without it the view loops until interrupted.

Rendering is pure (:func:`render` takes the snapshot + alerts and
returns a string), so tests never need a terminal or a socket.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from repro_torch.obs import live as obs_live

#: metrics promoted to the per-host table when present (everything else
#: is summarized in the "other series" count)
KEY_COLUMNS = (
    "proxy_syncs_total",
    "proxy_chunks_synced",
    "proxy_bytes_synced",
    "ckpt_checkpoints_total",
    "ckpt_bytes_written",
    "uvm_faults",
    "uvm_evictions",
)


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "?"
    if abs(v) >= 1e9:
        return f"{v / 1e9:.1f}G"
    if abs(v) >= 1e6:
        return f"{v / 1e6:.1f}M"
    if abs(v) >= 1e4:
        return f"{v / 1e3:.1f}k"
    if v == int(v):
        return str(int(v))
    return f"{v:.2f}"


def _rate(points: list) -> float | None:
    """Per-second rate over the tail of a cumulative series."""
    if len(points) < 2:
        return None
    (t0, v0), (t1, v1) = points[-2], points[-1]
    if t1 <= t0:
        return None
    return (v1 - v0) / (t1 - t0)


def _explained_by(alert: dict, injections: list) -> int | None:
    """The seq of the injection whose ``explains`` claims this alert
    inside its evidence window, or None (same rule as the soak verdict:
    kind + time, not host-strict)."""
    t = alert.get("t")
    if not isinstance(t, (int, float)):
        return None
    for inj in injections:
        expect = inj.expect or {}
        if alert.get("kind") in (expect.get("explains") or ()):
            w = float(expect.get("window_s", 120.0))
            if inj.t <= t <= inj.t + w:
                return inj.seq
    return None


def render(snapshot: dict | None, alerts: list[dict],
           *, injections: list | None = None, width: int = 100) -> str:
    """One frame of the dashboard as a plain string."""
    lines: list[str] = []
    injections = injections or []
    if not snapshot:
        lines.append("crum top — no live snapshot yet "
                     "(coordinator not started, or telemetry disabled)")
    else:
        t = snapshot.get("t")
        age = f" ({time.time() - t:.0f}s ago)" if isinstance(
            t, (int, float)) else ""
        lines.append(
            f"crum top — hosts={snapshot.get('hosts', [])} "
            f"ingested={snapshot.get('ingested', 0)} "
            f"dropped={snapshot.get('dropped', 0)}{age}"
        )
        series = snapshot.get("series") or {}
        shown = [c for c in KEY_COLUMNS if any(
            c in (m or {}) for m in series.values())]
        if shown:
            hdr = "host".ljust(6) + "".join(
                c.replace("proxy_", "p.").replace("ckpt_", "c.")
                 .replace("uvm_", "u.")[:14].rjust(15) for c in shown)
            lines.append(hdr[:width])
            for host_key in sorted(series, key=lambda h: (len(h), h)):
                metrics = series[host_key] or {}
                label = "coord" if host_key == "-1" else f"h{host_key}"
                row = label.ljust(6)
                for c in shown:
                    pts = metrics.get(c) or []
                    cell = _fmt(pts[-1][1]) if pts else "-"
                    r = _rate(pts)
                    if r is not None and r > 0:
                        cell += f"/{_fmt(r)}s"
                    row += cell.rjust(15)
                lines.append(row[:width])
        n_other = sum(
            1 for m in series.values() for k in (m or {}) if k not in shown
        )
        if n_other:
            lines.append(f"  … plus {n_other} more series "
                         f"(full dump: live_metrics.json)")
    if injections:
        now = time.time()
        active = [i for i in injections
                  if i.until is not None and i.until > now]
        lines.append(f"chaos: {len(injections)} injection(s), "
                     f"{len(active)} active")
        for i in injections[-8:]:
            state = "ACTIVE" if (i.until is not None and i.until > now) \
                else "fired"
            lines.append(
                f"  [{state:6s}] #{i.seq} {i.kind} -> {i.target}"[:width]
            )
    if alerts:
        lines.append(f"alerts ({len(alerts)}):")
        for a in alerts[-10:]:
            note = ""
            if injections:
                by = _explained_by(a, injections)
                note = (f" <- chaos #{by}" if by is not None
                        else " [UNEXPLAINED]")
            body = (f"  [{a.get('severity', '?'):8s}] {a.get('kind', '?')}"
                    f" host={a.get('host', '-')} step={a.get('step', '-')}"
                    f" {a.get('message', '')}")
            # the chaos annotation is the point: clip the message, not it
            lines.append(body[:width - len(note)] + note if note
                         else body[:width])
    else:
        lines.append("alerts: none")
    return "\n".join(lines)


# -- data sources ------------------------------------------------------------

def fetch_endpoint(host: str, port: int,
                   timeout: float = 5.0) -> tuple[dict | None, list[dict]]:
    """One METRICS round-trip against a live coordinator."""
    from repro_torch.coord import protocol

    conn = protocol.connect((host, port), timeout=timeout)
    try:
        conn.settimeout(timeout)
        conn.send(protocol.MSG_METRICS, op="snapshot")
        reply = conn.recv()
    finally:
        conn.close()
    if not isinstance(reply, dict):
        return None, []
    alerts = reply.get("alerts")
    return (
        reply.get("snapshot"),
        alerts if isinstance(alerts, list) else [],
    )


def load_injections(run_dir: str) -> list:
    """InjectLines from the run dir's (or its parent's) INJECT_LOG.jsonl
    — present when the run was a chaos soak, empty otherwise."""
    from repro_torch.obs import journal

    for cand in (
        os.path.join(run_dir, "INJECT_LOG.jsonl"),
        os.path.join(os.path.dirname(os.path.abspath(run_dir)),
                     "INJECT_LOG.jsonl"),
    ):
        if os.path.exists(cand):
            return [r for r in journal.read_journal(cand)
                    if isinstance(r, journal.InjectLine)]
    return []


def fetch_run_dir(run_dir: str) -> tuple[dict | None, list[dict], list]:
    """Snapshot + journaled alerts (+ injections) from a run dir."""
    from repro_torch.obs import journal
    from repro_torch.obs.report import find_journal

    snap = obs_live.read_snapshot(os.path.join(run_dir, "live_metrics.json"))
    if snap is None:  # soak layout: the snapshot lives under obs/
        snap = obs_live.read_snapshot(
            os.path.join(run_dir, "obs", "live_metrics.json"))
    jpath = find_journal(run_dir)
    if jpath is None:
        cand = os.path.join(run_dir, "ckpt", "CLUSTER_LOG.jsonl")
        jpath = cand if os.path.exists(cand) else None
    alert_lines = journal.alerts(jpath) if jpath else []
    alerts = [
        {"kind": a.kind, "severity": a.severity, "host": a.host,
         "step": a.step, "t": a.t, "message": a.message}
        for a in alert_lines
    ]
    return snap, alerts, load_injections(run_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--endpoint", metavar="HOST:PORT",
                     help="poll a running coordinator's METRICS channel")
    src.add_argument("--run-dir", metavar="DIR",
                     help="read live_metrics.json + CLUSTER_LOG.jsonl "
                          "from a checkpoint root")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (CI mode)")
    args = ap.parse_args(argv)

    if args.endpoint:
        host, _, port = args.endpoint.rpartition(":")
        if not host or not port.isdigit():
            ap.error("--endpoint must be HOST:PORT")

        def fetch():
            snap, alerts = fetch_endpoint(host, int(port))
            return snap, alerts, []
    else:
        def fetch():
            return fetch_run_dir(args.run_dir)

    while True:
        try:
            snapshot, alerts, injections = fetch()
        except (OSError, ValueError) as e:
            snapshot, alerts, injections = None, [], []
            print(f"[top] fetch failed: {e}", file=sys.stderr)
        frame = render(snapshot, alerts, injections=injections)
        if not args.once:
            print("\x1b[2J\x1b[H", end="")  # clear + home
        print(frame, flush=True)
        if args.once:
            return 0 if snapshot is not None else 1
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
