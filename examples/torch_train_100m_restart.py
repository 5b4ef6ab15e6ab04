"""End-to-end launcher, PyTorch port: train a ~100M-param LM with forked
checkpointing, kill it mid-run (SIGKILL: a real crash), restart, and check
that the restarted run resumes from a checkpoint and finishes.

The twin of ``examples/train_100m_restart.py``. The worker trains on the
card (``--device cpu`` for the CPU). The launcher kills it once 40% of the
run's estimated time has passed and a checkpoint has committed (on the
card the whole run takes seconds, so the reference's 20 s floor would
never come), then relaunches it.

    PYTHONPATH=src python examples/torch_train_100m_restart.py [--steps 200]

``--layers`` and ``--d-model`` shrink the worker (the reference's 12 x
768 by default), e.g. to exercise the launcher on the CPU in seconds.
"""
import argparse
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(steps: int, ckpt: str, device_name: str, layers: int, d_model: int) -> None:
    import numpy as np
    import torch

    from repro_torch.core import CheckpointedTrainer, CheckpointPolicy
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch.train import resolve_device
    from repro_torch.models import ModelConfig, build
    from repro_torch.optim import get_optimizer, warmup_cosine
    from repro_torch.runtime.steps import batch_to_device, make_train_step
    from repro_torch.utils.tree import flatten_with_paths

    device = resolve_device(device_name)
    # ~100M params: 12L x 768d, 32k vocab (gpt2-small-class)
    cfg = ModelConfig(
        name="lm-100m", family="dense", num_layers=layers, d_model=d_model,
        vocab_size=32000, num_heads=12, num_kv_heads=12, head_dim=d_model // 12,
        d_ff=4 * d_model, param_dtype="float32", compute_dtype="float32", remat="none",
    )
    model = build(cfg)
    opt = get_optimizer("adamw", warmup_cosine(3e-4, 20, steps))
    train_step = make_train_step(model, opt)
    trainer = CheckpointedTrainer(
        train_step, store_root=ckpt,
        policy=CheckpointPolicy(interval_steps=25, keep_last=2),
        chunk_bytes=8 << 20,
    )

    def init_state():
        params = model.init(torch.Generator(device=device).manual_seed(0))
        return {"device": {"params": params, "opt": opt.init(params),
                           "step": torch.zeros((), dtype=torch.int32, device=device)},
                "host": {"step": np.int64(0),
                         "data": SyntheticBatches(cfg, batch=4, seq_len=128).state()}}

    state, start = trainer.resume_or(
        init_state,
        device_for=lambda path, shape: device if path.startswith("device/") else None)
    n = sum(t.numel() for t in flatten_with_paths(state["device"]["params"])[0].values())
    data = SyntheticBatches.from_state(cfg, batch=4, seq_len=128,
                                       state=state["host"]["data"])
    print(f"[worker] {n/1e6:.0f}M params on {device}, starting at step {start}", flush=True)
    step = start
    t0 = time.time()
    for _ in range(steps - start):
        state["device"], m = train_step(state["device"], batch_to_device(next(data), device))
        step += 1
        state["host"]["step"] = np.int64(step)
        state["host"]["data"] = data.state()
        if step % 10 == 0:
            print(f"[worker] step {step} loss {float(m['loss']):.4f} "
                  f"({(time.time()-t0)/max(step-start,1):.3f}s/step)", flush=True)
        if trainer.policy.should_checkpoint(step):
            r = trainer.checkpoint_now(step, state)
            print(f"[worker] ckpt@{step} blocked {r.blocking_s*1e3:.0f}ms", flush=True)
    trainer.finish()
    print(f"[worker] DONE step={step}", flush=True)


def main(argv=None) -> int:
    """Returns the step the restarted run resumed from."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--kill-after", type=float, default=None,
                    help="seconds before SIGKILL, once a checkpoint has committed "
                         "(default: 40%% of the run)")
    ap.add_argument("--ckpt-dir", default="/tmp/train100m-torch-ckpt")
    ap.add_argument("--device", default="cuda", help="the worker's torch device")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.steps, args.ckpt_dir, args.device, args.layers, args.d_model)
        return 0

    from repro_torch.checkpoint.manifest import committed_steps

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def launch():
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", "--steps",
             str(args.steps), "--ckpt-dir", args.ckpt_dir, "--device", args.device,
             "--layers", str(args.layers), "--d-model", str(args.d_model)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, text=True, bufsize=1,
        )

    print("=== phase 1: train until killed ===", flush=True)
    p = launch()
    t0 = time.time()
    kill_after = args.kill_after
    for line in p.stdout:
        print(line, end="", flush=True)
        if kill_after is None and "s/step" in line:
            per = float(line.rsplit("(", 1)[1].split("s/step")[0])
            kill_after = per * args.steps * 0.4
            print(f"[launcher] will SIGKILL after ~{kill_after:.1f}s, once a checkpoint "
                  f"has committed", flush=True)
        if kill_after is not None and time.time() - t0 > kill_after and \
                committed_steps(args.ckpt_dir):
            print("[launcher] SIGKILL (simulated node failure)", flush=True)
            p.kill()
            break
    p.wait()
    if p.returncode != -signal.SIGKILL:
        raise SystemExit(f"the worker ended with {p.returncode} before the launcher killed it")

    print("=== phase 2: restart and finish ===", flush=True)
    p = launch()
    resumed_at = None
    for line in p.stdout:
        print(line, end="", flush=True)
        if "starting at step" in line:
            resumed_at = int(line.rsplit("step", 1)[1])
    p.wait()
    assert p.returncode == 0, "restarted run failed"
    assert resumed_at and resumed_at > 0, "restart did not resume from a checkpoint"
    print(f"=== OK: resumed from step {resumed_at}, finished {args.steps} steps ===",
          flush=True)
    return resumed_at


if __name__ == "__main__":
    main()
