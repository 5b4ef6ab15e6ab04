"""End-to-end training entry point with CRUM fault tolerance (PyTorch port).

The inline runner of the reference's ``launch/train.py``, with its flags
plus ``--device`` (default ``cuda``; it raises when there is no card, and
the CPU runs only when asked for). The flags of unported modes
(``--device-runner proxy``, ``--device-capacity``, ``--production-mesh``)
raise; the managed-memory tuning flags are left out until that mode is
ported. The CheckpointedTrainer provides
forked checkpointing, incremental persistence and restart: re-running the
same command resumes from the newest committed step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 6 --batch 4 --seq 512 --ckpt-every 2 --backend fork \\
        --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 12 --batch 4 --seq 32 --device cpu --ckpt-dir /tmp/ck
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
        help="inline: step fn runs in-process; proxy: not ported yet",
    )
    ap.add_argument("--device-capacity", default=None, metavar="BYTES|PCT%",
                    help="managed-memory (UVM) mode: not ported yet")
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
    if args.device_runner != "inline":
        raise NotImplementedError("--device-runner proxy is not ported yet")
    if args.device_capacity is not None:
        raise NotImplementedError("--device-capacity (UVM) is not ported yet")
    if args.production_mesh:
        raise NotImplementedError("--production-mesh is not ported yet")
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
    )
    preempt = PreemptionHandler(trainer.policy).install()
    try:
        state, start = trainer.resume_or(run.init_state, device_for=run.device_for)
        data = SyntheticBatches.from_state(
            cfg, batch=args.batch, seq_len=args.seq, state=state["host"]["data"]
        )
        print(f"[train] arch={cfg.name} layers={cfg.num_layers} "
              f"start_step={start} device={device}", flush=True)

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


def _needs_preempt_ckpt(trainer, step: int) -> bool:
    """SIGTERM sets the policy's preempt flag too, so the train loop may
    already have checkpointed this very step before exiting — saving it
    again would run two concurrent persists of the same step directory."""
    return not trainer.results or trainer.results[-1].step != step


def main(argv=None) -> int:
    out = train(argv)
    print(json.dumps({"final_step": out["final_step"],
                      "timings": out["timings"]}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
