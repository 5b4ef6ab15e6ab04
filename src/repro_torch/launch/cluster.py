"""Coordinated multi-process cluster launcher with failure drills.

Runs N ranks as real OS processes under the CRUM coordinator: every rank
trains in lockstep on the card (``--device``, ``cuda`` by default),
persists its shard of each checkpoint via its local forked checkpointer,
and the coordinator two-phase-commits the merged image. Failure
injections exercise the recovery paths end to end:

    # 4 ranks; rank 2 is killed at step 6, respawned, restored, and the
    # cluster converges back to lockstep (the torch_tiny program on the card)
    PYTHONPATH=src python -m repro_torch.launch.cluster \\
        --hosts 4 --loop torch --kill-host 2 --kill-at-step 6

    # the same on the CPU, with the fast numpy program
    PYTHONPATH=src python -m repro_torch.launch.cluster \\
        --hosts 4 --loop numpy --device cpu --kill-host 2 --kill-at-step 6

    # crash-mid-commit drill: host 1 dies after its hostmeta is written
    # but before acking — the round aborts, the previous image stands
    PYTHONPATH=src python -m repro_torch.launch.cluster \\
        --hosts 3 --die-after-persist-host 1 --die-after-persist-step 6

    # a straggling host slows the round but never blocks correctness
    PYTHONPATH=src python -m repro_torch.launch.cluster \\
        --hosts 4 --straggle-host 3 --straggle-s 1.0

    # divergence-provenance drill: one byte of host 1's state is flipped
    # after step 4 — the watchdog's digest_divergence alert must name the
    # first divergent chunk and the culprit host
    PYTHONPATH=src python -m repro_torch.launch.cluster \\
        --hosts 2 --steps 6 --corrupt-host 1 --corrupt-at-step 4

    # remote proxies: each rank's proxy is a session on one of 2 proxy-host
    # daemons the coordinator places it on; daemon 0 is SIGKILLed after the
    # first commit and its ranks are rescheduled onto daemon 1 (API-log
    # replay), converging to the unkilled run's bits
    PYTHONPATH=src python -m repro_torch.launch.cluster --hosts 2 --steps 6 \\
        --ckpt-every 2 --loop numpy --device cpu --device-runner proxy \\
        --proxy-hosts 2 --kill-proxy-host 0

    # ELASTIC restart: run 4 hosts to step 4, then restore the committed
    # 4-host image onto 6 hosts and continue to step 8 (the manifest is
    # topology-independent; shards re-slice onto any count)
    PYTHONPATH=src python -m repro_torch.launch.cluster \\
        --hosts 4 --steps 8 --ckpt-every 2 \\
        --restart-at-step 4 --hosts-after-restart 6

Exits non-zero if the cluster fails to converge (hosts finish with
different state digests) or no checkpoint ever commits.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

from repro_torch.checkpoint.codecs import DEFAULT_CODEC
from repro_torch.coord.supervisor import run_cluster
from repro_torch.core.forked import list_persist_backends


def _loop(value: str) -> str:
    if value in ("numpy", "torch") or (value.startswith("arch:") and len(value) > 5):
        return value
    raise argparse.ArgumentTypeError(
        f"--loop must be numpy, torch or arch:<name>, got {value!r}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--steps", type=int, default=9)
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: fresh temp dir)")
    ap.add_argument("--backend", choices=list_persist_backends(),
                    default="thread")
    ap.add_argument("--loop", type=_loop, default="numpy",
                    metavar="{numpy,torch,arch:<name>}",
                    help="rank train loop: numpy (fast), torch (a tiny "
                         "transformer) or arch:<name> (a repro_torch.configs "
                         "architecture, smoke-sized)")
    ap.add_argument("--device", default="cuda",
                    help="where the torch loops compute (default: cuda; a "
                         "rank that finds no card raises)")
    ap.add_argument("--device-runner", choices=["inline", "proxy"],
                    default="inline",
                    help="inline: step in the worker process; proxy: each "
                         "worker hosts a restartable device-proxy process")
    ap.add_argument("--codec", default=DEFAULT_CODEC)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--chunk-bytes", type=int, default=1 << 16)
    ap.add_argument("--keep-last", type=int, default=0,
                    help="coordinator GC: keep last K committed steps (0=all)")
    ap.add_argument("--step-time-s", type=float, default=0.0)
    ap.add_argument("--heartbeat-timeout-s", type=float, default=10.0)
    ap.add_argument("--round-timeout-s", type=float, default=120.0)
    ap.add_argument("--deadline-s", type=float, default=600.0)
    # failure drills
    ap.add_argument("--kill-host", type=int, default=None)
    ap.add_argument("--kill-at-step", type=int, default=None)
    ap.add_argument("--die-after-persist-host", type=int, default=None)
    ap.add_argument("--die-after-persist-step", type=int, default=None)
    ap.add_argument("--straggle-host", type=int, default=None)
    ap.add_argument("--straggle-s", type=float, default=0.0)
    ap.add_argument("--stall-host", type=int, default=None)
    ap.add_argument("--stall-s", type=float, default=0.0)
    ap.add_argument("--stall-at-step", type=int, default=None)
    ap.add_argument("--corrupt-host", type=int, default=None,
                    help="flip one byte of this host's state after the "
                         "given step (divergence-provenance drill: the "
                         "watchdog must name the first forked chunk)")
    ap.add_argument("--corrupt-at-step", type=int, default=None)
    # remote proxies
    ap.add_argument("--proxy-hosts", type=int, default=0,
                    help="place rank proxies on this many proxy-host "
                         "daemons via the coordinator (needs --device-runner "
                         "proxy); 0 = spawn proxies locally")
    ap.add_argument("--proxy-transport", choices=["segment", "stream"],
                    default="stream",
                    help="data plane for placed proxies: stream = chunk "
                         "frames over TCP (cross-host); segment = shared "
                         "files (same machine only)")
    ap.add_argument("--kill-proxy-host", type=int, default=None,
                    help="SIGKILL proxy-host daemon #i mid-run (reschedule "
                         "drill; needs --proxy-hosts >= 2)")
    ap.add_argument("--kill-proxy-after-commits", type=int, default=1)
    # elastic restart
    ap.add_argument("--hosts-after-restart", type=int, default=None,
                    help="after --restart-at-step, restore the committed "
                         "image onto THIS many hosts and continue to --steps")
    ap.add_argument("--restart-at-step", type=int, default=None,
                    help="end phase 1 at this step (should be a checkpoint "
                         "boundary so a committed image exists)")
    ap.add_argument("--no-sweep", action="store_true",
                    help="keep aborted/partial step dirs for inspection")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="enable observability: per-process trace shards and "
                         "metrics snapshots land here (the reference's "
                         "`python -m repro.obs.report DIR` merges them)")
    # SLO watchdog policy
    ap.add_argument("--abort-on-critical", action="store_true",
                    help="a critical watchdog alert aborts the open "
                         "checkpoint round (the previous image stands)")
    ap.add_argument("--expect-no-alerts", action="store_true",
                    help="exit non-zero if the watchdog raised ANY alert — "
                         "the happy-path CI gate")
    args = ap.parse_args(argv)

    root = args.ckpt_dir or tempfile.mkdtemp(prefix="crum-cluster-")
    print(f"[cluster] hosts={args.hosts} steps={args.steps} "
          f"ckpt_every={args.ckpt_every} backend={args.backend} "
          f"loop={args.loop} device_runner={args.device_runner} "
          f"device={args.device} root={root}", flush=True)

    common = dict(
        root=root,
        ckpt_every=args.ckpt_every,
        backend=args.backend,
        loop=args.loop,
        device_runner=args.device_runner,
        device=args.device,
        codec=args.codec,
        chunk_bytes=args.chunk_bytes,
        width=args.width,
        step_time_s=args.step_time_s,
        keep_last=args.keep_last,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        round_timeout_s=args.round_timeout_s,
        deadline_s=args.deadline_s,
        sweep=not args.no_sweep,
        obs_dir=args.obs_dir,
        abort_on_critical=args.abort_on_critical,
        proxy_hosts=args.proxy_hosts,
        proxy_transport=args.proxy_transport,
    )

    if args.restart_at_step is not None and args.hosts_after_restart is None:
        ap.error("--restart-at-step needs --hosts-after-restart")
    if args.hosts_after_restart is not None:
        if args.restart_at_step is None:
            ap.error("--hosts-after-restart needs --restart-at-step")
        if args.ckpt_every <= 0 or args.restart_at_step % args.ckpt_every:
            ap.error("--restart-at-step must be a checkpoint boundary")
        drills = [
            args.kill_host, args.kill_at_step, args.die_after_persist_host,
            args.die_after_persist_step, args.straggle_host, args.stall_host,
            args.kill_proxy_host, args.corrupt_host,
        ]
        if any(d is not None for d in drills) or args.straggle_s or args.stall_s:
            # refusing beats silently running both phases without the
            # drill and reporting a "passed" run that never exercised it
            ap.error("failure drills cannot be combined with an elastic "
                     "restart run; drill each phase separately")
        # the numpy state's shape must not change with the rank count —
        # pin rows to the larger phase so both slicings cover one image
        common["rows"] = max(args.hosts, args.hosts_after_restart, 2) * 8
        print(f"[cluster] phase 1: {args.hosts} hosts to step "
              f"{args.restart_at_step}", flush=True)
        phase1 = run_cluster(
            n_hosts=args.hosts, total_steps=args.restart_at_step, **common
        )
        if phase1.latest_committed != args.restart_at_step:
            print(f"[cluster] FAIL: phase 1 never committed step "
                  f"{args.restart_at_step}", file=sys.stderr)
            return 1
        print(f"[cluster] phase 2 (elastic): {args.hosts_after_restart} "
              f"hosts restore step {phase1.latest_committed} and continue "
              f"to {args.steps}", flush=True)
        report = run_cluster(
            n_hosts=args.hosts_after_restart, total_steps=args.steps,
            **common,
        )
        n_hosts_final = args.hosts_after_restart
    else:
        report = run_cluster(
            n_hosts=args.hosts,
            total_steps=args.steps,
            kill_host=args.kill_host,
            kill_at_step=args.kill_at_step,
            die_after_persist_host=args.die_after_persist_host,
            die_after_persist_step=args.die_after_persist_step,
            straggle_host=args.straggle_host,
            straggle_s=args.straggle_s,
            stall_host=args.stall_host,
            stall_s=args.stall_s,
            stall_at_step=args.stall_at_step,
            corrupt_host=args.corrupt_host,
            corrupt_at_step=args.corrupt_at_step,
            kill_proxy_host=args.kill_proxy_host,
            kill_proxy_after_commits=args.kill_proxy_after_commits,
            **common,
        )
        n_hosts_final = args.hosts

    for r in report.rounds:
        line = (f"[round] step={r.step} {r.status} "
                f"participants={r.participants} acked={r.acked}")
        if r.status == "committed":
            line += (f" commit={r.commit_s*1e3:.1f}ms "
                     f"round={r.round_s*1e3:.0f}ms "
                     f"persist_max={r.persist_s_max*1e3:.0f}ms "
                     f"bytes={r.bytes_written}")
            if r.stragglers:
                line += f" stragglers={r.stragglers}"
        else:
            line += f" reason={r.reason!r}"
        print(line, flush=True)

    for a in report.alerts:
        print(f"[alert] {a.get('severity', '?')}: {a.get('kind', '?')} "
              f"host={a.get('host')} step={a.get('step')} "
              f"{a.get('message', '')}", flush=True)

    # every injected failure has an alert signature; a drill whose
    # signature never fired means the watchdog is blind to that failure
    expected_kinds: set[str] = set()
    if args.kill_host is not None and args.kill_at_step is not None:
        expected_kinds.add("worker_death")
    if args.die_after_persist_host is not None \
            and args.die_after_persist_step is not None:
        expected_kinds.add("worker_death")
    if args.stall_host is not None and args.stall_s:
        expected_kinds.add("worker_death")
    if args.straggle_host is not None and args.straggle_s:
        expected_kinds.add("straggler")
    if args.kill_proxy_host is not None:
        expected_kinds.add("proxy_host_death")
    corrupt_drill = (args.corrupt_host is not None
                     and args.corrupt_at_step is not None)
    if corrupt_drill:
        expected_kinds.add("digest_divergence")

    lockstep = report.lockstep()
    summary = {
        "hosts": n_hosts_final,
        "latest_committed": report.latest_committed,
        "rounds_committed": len(report.committed),
        "rounds_aborted": len(report.aborted),
        "restarts": report.restarts,
        "lockstep_converged": lockstep,
        "final_digest": next(iter(report.final_digests.values()), None),
        "log": report.log_path,
        "alerts": report.alerts,
        "alert_kinds": sorted(report.alert_kinds()),
    }
    if args.proxy_hosts:
        summary["proxy_placements"] = [
            [w, n] for w, n in report.proxy_placements
        ]
        summary["killed_proxy_hosts"] = report.killed_proxy_hosts
    print(json.dumps(summary, indent=2))

    if corrupt_drill:
        # the injection *makes* the hosts diverge — converging would mean
        # it never took; what must hold instead is that the watchdog's
        # divergence alert carries provenance: the first forked chunk
        if lockstep:
            print("[cluster] FAIL: corrupt drill ran but hosts still "
                  "converged (injection never took)", file=sys.stderr)
            return 1
        named = [a for a in report.alerts
                 if a.get("kind") == "digest_divergence"
                 and a.get("chunk") is not None]
        if not named:
            print("[cluster] FAIL: divergence alert fired but named no "
                  "chunk (provenance lost)", file=sys.stderr)
            return 1
        a = named[0]
        print(f"[cluster] divergence provenance OK: chunk={a['chunk']!r} "
              f"index={a.get('chunk_index')} host={a.get('host')}",
              flush=True)
    elif not lockstep:
        print("[cluster] FAIL: hosts finished with diverged state",
              file=sys.stderr)
        return 1
    if report.latest_committed is None and args.steps >= args.ckpt_every > 0:
        print("[cluster] FAIL: no checkpoint round ever committed",
              file=sys.stderr)
        return 1
    if args.expect_no_alerts and report.alerts:
        print(f"[cluster] FAIL: watchdog raised "
              f"{sorted(report.alert_kinds())} on a run expected to be "
              f"alert-free", file=sys.stderr)
        return 1
    missing = expected_kinds - report.alert_kinds()
    if missing:
        print(f"[cluster] FAIL: drill ran but watchdog never raised "
              f"{sorted(missing)} (got {sorted(report.alert_kinds())})",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
