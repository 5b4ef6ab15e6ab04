#!/usr/bin/env python3
"""Where a ``[hybrid]`` train step's time goes on the card.

    python3 tools/hybrid_step_profile.py

Builds ``chip_smoke.py``'s ``[hybrid]`` train state on the card
(zamba2-1.2b at full width, 12 of its 38 layers, AdamW; batch 4, seq 512,
the config's 4 microbatches, ``remat="dots"``) under the CLI's settings
(deterministic algorithms, TF32 off) and prints, after two warm steps:

* ``[step]``: the host-clock ms of three steps, each ending in a
  synchronize, under ``remat="dots"`` and ``"none"``;
* ``[split]``: one step's loss and grads (all microbatches) and the
  optimizer's update, each timed alone;
* ``[profile]``: one step under ``torch.profiler``: the device's busy
  time (the sum of its kernels' times) against the step's wall, the
  kernel count, and the ops with the most device time and the most host
  time.

Prints the card's name and power limit first.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import dataclasses  # noqa: E402

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticBatches  # noqa: E402
from repro_torch.launch.train import build_training  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import get_optimizer, warmup_cosine  # noqa: E402
from repro_torch.runtime.steps import batch_to_device, loss_and_grads  # noqa: E402


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("hybrid_step_profile: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    base = dataclasses.replace(get_config("zamba2-1.2b"), num_layers=12)
    for remat in ("dots", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        run = build_training(cfg, batch=4, seq=512, lr=3e-4, total_steps=6, device=dev)
        state = run.init_state()
        data = SyntheticBatches(cfg, batch=4, seq_len=512)
        batches = [batch_to_device(next(data), dev) for _ in range(6)]
        dev_state = state["device"]

        def step(i):
            nonlocal dev_state
            dev_state, _ = run.step_fn(dev_state, batches[i])

        ms = [_timed(lambda i=i: step(i)) for i in range(5)]
        torch.cuda.reset_peak_memory_stats()
        print(f"[step] remat={remat} ms={[round(m, 1) for m in ms]} (two warm-up steps "
              f"first)", flush=True)
        if remat != "dots":
            break
        model = build(cfg)
        params = dev_state["params"]
        grads_ms = _timed(lambda: loss_and_grads(model, params, batches[5], cfg.microbatches))
        _, _, grads = loss_and_grads(model, params, batches[5], cfg.microbatches)
        opt = get_optimizer("adamw", warmup_cosine(3e-4, 10, 6))
        update_ms = _timed(lambda: opt.update(grads, dev_state["opt"], params, dev_state["step"]))
        fwd_ms = _timed(lambda: model.loss(params, {k: v[:1] for k, v in batches[5].items()}))
        print(f"[split] loss_and_grads_ms={grads_ms:.1f} (4 microbatches) "
              f"optimizer_update_ms={update_ms:.1f} one_microbatch_loss_ms={fwd_ms:.1f}",
              flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = _timed(lambda: step(5))
        events = prof.key_averages()
        device_us = sum(e.self_device_time_total for e in events)
        kernels = sum(e.count for e in events if e.device_type.name == "CUDA")
        print(f"[profile] step_wall_ms={wall:.1f} device_busy_ms={device_us / 1e3:.1f} "
              f"busy_share={device_us / 1e3 / wall:.3f} device_events={kernels}", flush=True)
        by_dev = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
        for e in by_dev:
            print(f"[profile] device {e.key[:60]!r} calls={e.count} "
                  f"self_device_ms={e.self_device_time_total / 1e3:.2f}", flush=True)
        by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
        for e in by_cpu:
            print(f"[profile] host {e.key[:60]!r} calls={e.count} "
                  f"self_cpu_ms={e.self_cpu_time_total / 1e3:.2f}", flush=True)
        del run, state, dev_state, params, grads, batches
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
