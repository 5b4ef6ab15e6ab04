"""Soak driver — a cluster of the port under a seeded chaos schedule.

``python -m repro_torch.chaos.soak --run-dir DIR --seconds 60 --hosts 2
--proxy-hosts 2`` brings up the whole stack (coordinator, supervised ranks,
proxy-host daemons; ``--device-capacity`` oversubscribes the proxies) with
the live telemetry, the SLO watchdog in recording mode
(``abort_on_critical`` off: a soak collects evidence) and leak-trend
sampling, and fires a :func:`repro_torch.chaos.schedule.build_schedule` plan
at it from a timer thread while it runs. The ranks compute on ``--device``
(``cuda`` unless the caller asks for the CPU): ``--loop numpy`` (fast),
``torch`` (a 2-layer transformer of ``--width``) or ``arch:<name>`` (a
``repro_torch.configs`` architecture, smoke-sized).

Everything the verdict needs lands in the run dir (the reference's layout):

========================  ====================================================
``ckpt/``                 cluster root (CLUSTER_LOG.jsonl, checkpoints)
``obs/``                  trace shards + ``live_metrics.json``
``chaos/``                armed-fault sentinels (``$CRUM_CHAOS_DIR``)
``INJECT_LOG.jsonl``      the injection journal (``crum-inject/1``)
``soak_run.json``         driver summary: config, seed, plan, convergence
========================  ====================================================

The run is judged separately: ``python -m repro_torch.obs.soak DIR --check``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from repro_torch.chaos.faults import CHAOS_ENV
from repro_torch.chaos.injectors import InjectionEngine
from repro_torch.chaos.schedule import build_schedule

SOAK_RUN_SCHEMA = "crum-soak-run/1"

__all__ = ["SOAK_RUN_SCHEMA", "chaos_hook", "main"]


def chaos_hook(run_dir: str, plan, *, chaos_dir: str | None = None,
               after_commits: int = 0):
    """The ``run_cluster(chaos=...)`` callable: an engine journaling into
    ``run_dir/INJECT_LOG.jsonl`` and a thread that fires ``plan``.

    The plan's offsets count from the hook's call, or, with
    ``after_commits``, from the moment that many rounds have committed
    (a fault window that must land on a running cluster, not on ranks
    still starting). A failed injection is printed and the run goes on;
    its journal line stays, so the verdict finds it unevidenced.
    """

    def hook(handles):
        eng = InjectionEngine(
            handles, os.path.join(run_dir, "INJECT_LOG.jsonl"),
            chaos_dir=chaos_dir,
        )
        stop = threading.Event()
        coord = handles.coordinator

        def runner() -> None:
            while len(coord.committed_rounds()) < after_commits:
                if coord.done.is_set() or stop.wait(0.05):
                    return
            t0 = time.monotonic()
            for pi in plan:
                delay = pi.offset_s - (time.monotonic() - t0)
                if delay > 0 and stop.wait(delay):
                    return
                if coord.done.is_set():
                    return
                try:
                    eng.inject(pi.kind, **pi.params)
                except Exception as e:  # an injector must not kill the run
                    print(f"soak: injection {pi.kind} failed: {e}",
                          file=sys.stderr)

        th = threading.Thread(target=runner, name="chaos-schedule",
                              daemon=True)
        th.start()

        class _Ctl:
            def stop(self) -> None:
                stop.set()
                th.join(timeout=10)
                eng.stop()

        return _Ctl()

    return hook


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos.soak", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--seconds", type=float, default=60.0,
                    help="target soak duration (the step count is derived;"
                         " recovery work stretches the actual run)")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--proxy-hosts", type=int, default=0,
                    help=">= 2 enables the cross-host fault menu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kinds", default=None,
                    help="comma list restricting the injection menu")
    ap.add_argument("--loop", default="numpy",
                    help='"numpy", "torch", or "arch:<name>" for a '
                         "repro_torch.configs architecture (smoke shape)")
    ap.add_argument("--device", default="cuda",
                    help="where the torch loops compute (default: cuda; a "
                         "rank that finds no card raises)")
    ap.add_argument("--device-capacity", default=None,
                    help='proxy UVM budget: bytes or "50%%" of state '
                         "(oversubscription x2); needs a proxy runner")
    ap.add_argument("--backend", default="thread",
                    choices=("thread", "fork"))
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--step-time", type=float, default=0.15)
    ap.add_argument("--steps", type=int, default=None,
                    help="override the derived total step count")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--max-clock-skew-s", type=float, default=30.0)
    ap.add_argument("--persist-timeout-s", type=float, default=10.0,
                    help="also the proxy op timeout: bounds how long a "
                         "partitioned proxy host goes undetected")
    args = ap.parse_args(argv)

    from repro_torch.coord.supervisor import run_cluster
    from repro_torch.obs.watch import WatchConfig

    run_dir = os.path.abspath(args.run_dir)
    chaos_dir = os.path.join(run_dir, "chaos")
    os.makedirs(chaos_dir, exist_ok=True)
    # exported before any spawn: every rank (and its persist children)
    # inherits the chaos dir, so armed sentinels reach their shims
    os.environ[CHAOS_ENV] = chaos_dir

    kinds = tuple(k for k in (args.kinds or "").split(",") if k) or None
    plan = build_schedule(
        seed=args.seed, duration_s=args.seconds, n_hosts=args.hosts,
        n_proxy_hosts=args.proxy_hosts, kinds=kinds,
    )
    worker_kills: dict[int, int] = {}
    for pi in plan:
        if pi.kind == "kill_worker":
            h = pi.params["host"]
            worker_kills[h] = worker_kills.get(h, 0) + 1
    print(f"soak: {len(plan)} planned injections over ~{args.seconds:.0f}s "
          f"(seed {args.seed}): "
          + ", ".join(f"{p.offset_s:.0f}s {p.kind}" for p in plan))

    total_steps = args.steps or max(
        args.ckpt_every * 5, int(args.seconds * 0.6 / args.step_time)
    )
    proxied = args.proxy_hosts > 0 or args.device_capacity is not None
    t0 = time.time()
    report = run_cluster(
        root=os.path.join(run_dir, "ckpt"),
        n_hosts=args.hosts,
        total_steps=total_steps,
        ckpt_every=args.ckpt_every,
        backend=args.backend,
        loop=args.loop,
        device_runner="proxy" if proxied else "inline",
        device=args.device,
        width=args.width,
        step_time_s=args.step_time,
        proxy_hosts=args.proxy_hosts,
        deadline_s=max(300.0, args.seconds * 4),
        max_restarts=max(worker_kills.values(), default=0) + 2,
        persist_timeout_s=args.persist_timeout_s,
        device_capacity=args.device_capacity,
        obs_dir=os.path.join(run_dir, "obs"),
        watch_cfg=WatchConfig(max_clock_skew_s=args.max_clock_skew_s),
        abort_on_critical=False,  # recording mode: judge later, fully
        chaos=chaos_hook(run_dir, plan, chaos_dir=chaos_dir),
    )
    wall_s = time.time() - t0

    summary = {
        "schema": SOAK_RUN_SCHEMA,
        "seed": args.seed,
        "seconds": args.seconds,
        "wall_s": round(wall_s, 3),
        "hosts": args.hosts,
        "proxy_hosts": args.proxy_hosts,
        "loop": args.loop,
        "device": args.device,
        "device_capacity": args.device_capacity,
        "total_steps": total_steps,
        "plan": [p.as_dict() for p in plan],
        "lockstep": report.lockstep(),
        "latest_committed": report.latest_committed,
        "final_digests": {str(h): d for h, d in
                          report.final_digests.items()},
        "restarts": {str(h): c for h, c in report.restarts.items()},
        "rounds_committed": len(report.committed),
        "rounds_aborted": len(report.aborted),
        "alerts": len(report.alerts),
        "proxy_placements": [[w, n] for w, n in report.proxy_placements],
    }
    path = os.path.join(run_dir, "soak_run.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"soak: done in {wall_s:.1f}s — "
          f"{summary['rounds_committed']} committed / "
          f"{summary['rounds_aborted']} aborted rounds, "
          f"{summary['alerts']} alerts, lockstep={summary['lockstep']}")
    print(f"soak: wrote {path}; judge with: "
          f"python -m repro_torch.obs.soak {run_dir} --check")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
