"""End-to-end training entry point with CRUM fault tolerance (PyTorch port).

The reference's ``launch/train.py`` with its inline and proxy runners,
managed memory and their flags, plus ``--device`` (default ``cuda``; it
raises when there is no card, and the CPU runs only when asked for). With
``--device-runner proxy`` this process never touches the device: a
``train_arch`` step program runs in a supervised proxy process that owns
the card, and this process keeps the host mirror and checkpoints it. With
``--device-capacity BYTES|PCT%`` the device state lives in a paged managed
space whose frames on the device hold at most that many bytes (a
percentage is of the state's size): every step faults the state in,
evicting and writing back under the budget, and the checkpointer syncs
page deltas. ``--production-mesh`` raises: not ported. The
CheckpointedTrainer provides forked checkpointing, incremental persistence
and restart: re-running the same command resumes from the newest
committed step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 6 --batch 4 --seq 512 --ckpt-every 2 --backend fork \\
        --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 12 --batch 4 --seq 32 --device cpu --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 6 --batch 4 --seq 32 --ckpt-every 2 \\
        --device-runner proxy --device cpu --ckpt-dir /tmp/ck-proxy
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 6 --batch 4 --seq 32 --ckpt-every 2 \\
        --device-capacity 50% --device cpu --ckpt-dir /tmp/ck-uvm
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import DEFAULT_CODEC
from repro_torch.configs import get_config, list_archs
from repro_torch.core import (
    CheckpointedTrainer,
    CheckpointPolicy,
    PreemptionHandler,
    list_persist_backends,
)
from repro_torch.data import SyntheticBatches
from repro_torch.models import ModelConfig, build
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import get_optimizer, warmup_cosine
from repro_torch.runtime.steps import batch_to_device, make_train_step
from repro_torch.utils.dtypes import leaf_nbytes
from repro_torch.utils.tree import flatten_with_paths


def resolve_device(name: str) -> torch.device:
    """The device to run on; a CUDA device must exist (no silent CPU).

    A CUDA device comes back with its index, so code that places tensors
    from other threads (lazy restore's readers) names the card explicitly.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} asked for but no CUDA device is available "
                "(pass --device cpu to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class Training:
    """What a run needs besides its trainer: the step, a fresh state, and
    where restored leaves go."""

    cfg: ModelConfig
    device: torch.device
    step_fn: Callable[[Any, Any], tuple[Any, Any]]
    init_state: Callable[[], Any]

    def device_for(self, path: str, shape: tuple[int, ...]):
        return self.device if path.startswith("device/") else None


def build_training(cfg: ModelConfig, *, batch: int, seq: int, lr: float,
                   total_steps: int, device: torch.device) -> Training:
    model = build(cfg)
    optimizer = get_optimizer(cfg.optimizer, warmup_cosine(lr, 10, total_steps))

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = model.init(gen)
        return {
            "device": {
                "params": params,
                "opt": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=device),
            },
            "host": {
                "step": np.int64(0),
                "data": SyntheticBatches(cfg, batch=batch, seq_len=seq).state(),
            },
        }

    return Training(cfg=cfg, device=device,
                    step_fn=make_train_step(model, optimizer),
                    init_state=init_state)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro-ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--codec", default=DEFAULT_CODEC)
    ap.add_argument(
        "--backend", choices=list_persist_backends(), default="thread",
        help="persist backend: 'fork' = paper's COW child, 'thread' = pool",
    )
    ap.add_argument(
        "--device-runner", choices=["inline", "proxy"], default="inline",
        help="inline: step fn runs in-process; proxy: in a restartable "
             "proxy process that owns the device (this one stays device-clean)",
    )
    ap.add_argument(
        "--device-capacity", default=None, metavar="BYTES|PCT%",
        help="managed-memory (UVM) mode: hard device budget for the model "
             "state, either absolute bytes or a percentage of the state "
             "size (e.g. '50%%' = oversubscription ratio 2x). Pages "
             "migrate on fault; the checkpointer syncs page deltas",
    )
    ap.add_argument("--page-bytes", type=int, default=None,
                    help="managed-memory page size (default 64 KiB)")
    ap.add_argument("--eviction-policy", choices=["lru", "clock"],
                    default="lru", help="managed-memory eviction policy")
    ap.add_argument("--promote-threshold", type=int, default=0,
                    help="Volta-style access-counter promotion: a HOST page "
                         "read this many times within --promote-window is "
                         "migrated to device; colder reads are served "
                         "remotely without a migration (0/1 = migrate on "
                         "first touch)")
    ap.add_argument("--promote-window", type=int, default=0,
                    help="promotion counting window in ticks (0 = unbounded)")
    ap.add_argument("--no-incremental", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="multi-device mesh: not ported yet")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="enable observability: trace shards and metrics "
                         "snapshots land here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    return ap.parse_args(argv)


def train(argv=None) -> dict:
    """Run the CLI. Returns the final step, the checkpoint results, the final
    state, the last step's metrics and the phase timings."""
    args = parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError("--production-mesh is not ported yet")
    if args.device_runner == "proxy":
        return _train_proxy(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # restart must reproduce the uninterrupted run bit for bit, as in the
        # reference: atomics in some CUDA backward kernels and cuBLAS
        # workspaces would make even two uninterrupted runs differ. cuBLAS
        # reads the variable when the process first uses it.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    if args.obs_dir:
        obs_trace.enable(args.obs_dir, "app")

    cfg = get_config(args.arch, smoke=args.smoke)
    run = build_training(cfg, batch=args.batch, seq=args.seq, lr=args.lr,
                         total_steps=args.steps, device=device)
    trainer = CheckpointedTrainer(
        run.step_fn,
        store_root=args.ckpt_dir,
        policy=CheckpointPolicy(interval_steps=args.ckpt_every, keep_last=2),
        codec=args.codec,
        incremental=not args.no_incremental,
        chunk_bytes=1 << 20,
        backend=args.backend,
        page_bytes=args.page_bytes,
        eviction_policy=args.eviction_policy,
        promote_threshold=args.promote_threshold,
        promote_window=args.promote_window,
        device=device,
    )
    preempt = PreemptionHandler(trainer.policy).install()
    try:
        state, start = trainer.resume_or(run.init_state, device_for=run.device_for)
        data = SyntheticBatches.from_state(
            cfg, batch=args.batch, seq_len=args.seq, state=state["host"]["data"]
        )
        print(f"[train] arch={cfg.name} layers={cfg.num_layers} "
              f"start_step={start} device={device}", flush=True)
        if args.device_capacity is not None:
            return _run_managed(args, trainer, run, state, start, data, preempt)

        trainer.checkpointer.prepare(state)
        tr = obs_trace.get()
        step = start
        metrics = {}
        for _ in range(args.steps - start):
            t0 = time.perf_counter() if tr is not None else 0.0
            batch = batch_to_device(next(data), device)
            state["device"], metrics = run.step_fn(state["device"], batch)
            step += 1
            if tr is not None:
                tr.complete("app.step", t0, step=step)
            state["host"]["step"] = np.int64(step)
            state["host"]["data"] = data.state()
            if step % args.log_every == 0 or step == args.steps:
                print(
                    f"[train] step={step} loss={float(metrics['loss']):.4f} "
                    f"grad_norm={float(metrics['grad_norm']):.3f}",
                    flush=True,
                )
            if trainer.policy.should_checkpoint(step):
                r = trainer.checkpoint_now(step, state)
                print(
                    f"[ckpt] step={step} blocking={r.blocking_s*1e3:.1f}ms "
                    f"(persist continues in background)",
                    flush=True,
                )
            if preempt.received.is_set():
                print("[train] preemption: checkpointing and exiting")
                if _needs_preempt_ckpt(trainer, step):
                    trainer.checkpoint_now(step, state)
                break

        done = trainer.finish()
        for r in done:
            print(
                f"[ckpt-done] step={r.step} blocking={r.blocking_s*1e3:.1f}ms "
                f"persist={r.persist_s*1e3:.1f}ms synced={r.chunks_synced} "
                f"written={r.chunks_written} reused={r.chunks_reused}",
                flush=True,
            )
    finally:
        preempt.uninstall()
    return {"final_step": step, "results": done, "state": state,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "timings": trainer.timings.summary()}


def _tree_nbytes(tree) -> int:
    flat, _ = flatten_with_paths(tree)
    return sum(leaf_nbytes(leaf) for leaf in flat.values())


def _resolve_capacity(spec: str, state_nbytes: int) -> int:
    """'BYTES' or 'PCT%' (of the device state size) -> absolute bytes."""
    s = str(spec).strip()
    if s.endswith("%"):
        return max(1, int(state_nbytes * float(s[:-1]) / 100.0))
    return int(s)


def _run_managed(args, trainer, run: Training, state, start, data, preempt) -> dict:
    """Inline training through a ManagedSpace (the UVM oversubscription
    path): the device budget is hard, pages migrate on fault, and the
    checkpointer syncs page deltas instead of digest-scanning every leaf."""
    state_nbytes = _tree_nbytes(state["device"])
    cap = _resolve_capacity(args.device_capacity, state_nbytes)
    trainer.device_capacity_bytes = cap
    print(f"[uvm] device_capacity={cap}B state={state_nbytes}B "
          f"oversubscription=x{state_nbytes / cap:.2f} "
          f"policy={args.eviction_policy} device={run.device}", flush=True)

    def batches():
        while True:
            yield batch_to_device(next(data), run.device)

    last: dict = {}

    def on_metrics(step, metrics):
        state["host"]["data"] = data.state()
        last.clear()
        last.update(metrics)
        if step % args.log_every == 0 or step == args.steps:
            print(f"[train] step={step} loss={float(metrics['loss']):.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}", flush=True)

    state = trainer.run(
        state, batches(), num_steps=args.steps - start, start_step=start,
        on_metrics=on_metrics, stop=preempt.received.is_set,
    )
    step = int(np.asarray(state["host"]["step"]))
    if preempt.received.is_set() and _needs_preempt_ckpt(trainer, step):
        print("[train] preemption: checkpointing and exiting", flush=True)
        trainer.checkpoint_now(step, trainer.materialize(state))
    done = trainer.finish()
    for r in done:
        print(
            f"[ckpt-done] step={r.step} blocking={r.blocking_s*1e3:.1f}ms "
            f"persist={r.persist_s*1e3:.1f}ms synced={r.chunks_synced} "
            f"clean={r.chunks_clean} written={r.chunks_written} "
            f"reused={r.chunks_reused}",
            flush=True,
        )
    return {"final_step": step, "results": done, "state": state,
            "metrics": {k: float(v) for k, v in last.items()},
            "timings": trainer.timings.summary(),
            "paging": trainer.paging_stats()}


def _train_proxy(args: argparse.Namespace) -> dict:
    """The paper's architecture: this process never runs the step function.

    A ``train_arch`` step program (rebuilt from the CLI config inside the
    proxy — programs are replayable specs, not closures) executes in a
    supervised proxy process on ``--device``; this process forwards
    pipelined STEP calls, syncs the host mirror at checkpoint boundaries,
    and persists it with the same forked checkpointer. It never creates a
    CUDA context: the device is named in the spec and resolved in the
    proxy. Batches are deterministic in the step number, which is what
    makes kill-replay recovery bit-identical.
    """
    program = {
        "name": "train_arch",
        "arch": args.arch,
        "smoke": bool(args.smoke),
        "batch": args.batch,
        "seq": args.seq,
        "lr": args.lr,
        "total_steps": args.steps,
        "device": args.device,
    }
    if args.obs_dir:
        obs_trace.enable(args.obs_dir, "app")
    capacity = None
    if args.device_capacity is not None:
        spec = str(args.device_capacity).strip()
        if spec.endswith("%"):
            # percentage of the program's device state, sized on the meta
            # device: this process never materializes the state it keeps
            # out of its own process
            from repro_torch.proxy.programs import make_program

            nbytes = make_program(program).state_nbytes()
            capacity = _resolve_capacity(spec, nbytes)
            print(f"[uvm] proxy device_capacity={capacity}B "
                  f"state={nbytes}B", flush=True)
        else:
            capacity = int(spec)
    trainer = CheckpointedTrainer(
        None,
        store_root=args.ckpt_dir,
        policy=CheckpointPolicy(interval_steps=args.ckpt_every, keep_last=2),
        codec=args.codec,
        incremental=not args.no_incremental,
        chunk_bytes=1 << 20,
        backend=args.backend,
        device_runner="proxy",
        program=program,
        device_capacity_bytes=capacity,
        page_bytes=args.page_bytes,
        eviction_policy=args.eviction_policy,
        promote_threshold=args.promote_threshold,
        promote_window=args.promote_window,
    )
    preempt = PreemptionHandler(trainer.policy).install()
    metrics: dict = {}
    try:
        # device side None: the runner asks the program for its init, built
        # on the host here, and pushes it into the proxy
        state, start = trainer.resume_or(
            lambda: {"device": None, "host": {"step": np.int64(0)}})
        print(f"[train] arch={args.arch} device_runner=proxy start_step={start} "
              f"device={args.device} proxy_pid={trainer.runner.proxy.pid}",
              flush=True)

        def on_metrics(step, m):
            metrics.clear()
            metrics.update(m)
            loss = m.get("loss")
            loss_s = f"{loss:.4f}" if loss is not None else "n/a"
            print(f"[train] step={step} loss={loss_s} "
                  f"proxy_restarts={trainer.runner.restarts}", flush=True)

        state = trainer.run(
            state, num_steps=args.steps - start, start_step=start,
            on_metrics=on_metrics, stop=preempt.received.is_set,
        )
        step = int(np.asarray(state["host"]["step"]))
        if preempt.received.is_set() and _needs_preempt_ckpt(trainer, step):
            print("[train] preemption: checkpointing and exiting", flush=True)
            trainer.checkpoint_now(step, state)
        done = trainer.finish()
        for r in done:
            print(
                f"[ckpt-done] step={r.step} blocking={r.blocking_s*1e3:.1f}ms "
                f"persist={r.persist_s*1e3:.1f}ms stall={r.stall_us / 1e3:.1f}ms "
                f"written={r.chunks_written} reused={r.chunks_reused}",
                flush=True,
            )
    finally:
        preempt.uninstall()
        if trainer.runner is not None:
            trainer.runner.close()
    return {"final_step": step, "results": done, "state": state,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "timings": trainer.timings.summary()}


def _needs_preempt_ckpt(trainer, step: int) -> bool:
    """SIGTERM sets the policy's preempt flag too, so the train loop may
    already have checkpointed this very step before exiting — saving it
    again would run two concurrent persists of the same step directory."""
    return not trainer.results or trainer.results[-1].step != step


def main(argv=None) -> int:
    out = train(argv)
    final = {"final_step": out["final_step"]}
    if out.get("paging") is not None:
        final["paging"] = out["paging"]
    final["timings"] = out["timings"]
    print(json.dumps(final, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
