"""Quickstart, PyTorch port: train a tiny LM with CRUM fault tolerance.

The twin of ``examples/quickstart.py``: the same model, 30 steps, a
checkpoint every 10 steps keeping the last 2. Persistence runs on the
``fork`` backend where the OS supports it (the paper's copy-on-write
child), falling back to the in-process writer pool. Re-running after a
crash resumes from the newest committed step and ends at step 30, the
same bits as a run that never crashed (the data cursor goes into every
checkpoint with the step).

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.core import CheckpointedTrainer, CheckpointPolicy
from repro_torch.data import SyntheticBatches
from repro_torch.launch.train import resolve_device
from repro_torch.models import ModelConfig, build
from repro_torch.optim import get_optimizer
from repro_torch.runtime.steps import batch_to_device, make_train_step

cfg = ModelConfig(
    name="quickstart", family="dense", num_layers=2, d_model=128,
    vocab_size=512, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
    param_dtype="float32", compute_dtype="float32",
)
STEPS, BATCH, SEQ = 30, 8, 64


def main(argv=None) -> dict:
    """Train to step 30 (resuming where a crash left off); returns the
    final state."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store-root", default="/tmp/quickstart-ckpt")
    ap.add_argument("--backend", choices=["fork", "thread"],
                    default="fork" if hasattr(os, "fork") else "thread")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":  # a resumed run the same bits as an unbroken one
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    model = build(cfg)
    opt = get_optimizer("adamw", 1e-3)
    trainer = CheckpointedTrainer(
        make_train_step(model, opt),
        store_root=args.store_root,
        policy=CheckpointPolicy(interval_steps=10, keep_last=2),
        chunk_bytes=1 << 20,
        backend=args.backend,
    )

    def init_state():
        params = model.init(torch.Generator(device=device).manual_seed(0))
        return {
            "device": {"params": params, "opt": opt.init(params),
                       "step": torch.zeros((), dtype=torch.int32, device=device)},
            "host": {"step": np.int64(0),
                     "data": SyntheticBatches(cfg, batch=BATCH, seq_len=SEQ).state()},
        }

    state, start = trainer.resume_or(  # picks up where a crash left off
        init_state,
        device_for=lambda path, shape: device if path.startswith("device/") else None)
    data = SyntheticBatches.from_state(cfg, batch=BATCH, seq_len=SEQ,
                                       state=state["host"]["data"])
    print(f"starting from step {start}", flush=True)

    def batches():
        for batch in data:  # the cursor after this batch, for the step's checkpoint
            state["host"]["data"] = data.state()
            yield batch_to_device(batch, device)

    state = trainer.run(state, batches(), num_steps=STEPS - start, start_step=start,
                        on_metrics=lambda s, m: s % 10 == 0 and print(
                            f"step {s}: loss={float(m['loss']):.3f}", flush=True))
    for r in trainer.finish():
        print(f"checkpoint@{r.step} [{args.backend}]: blocked {r.blocking_s*1e3:.1f}ms, "
              f"persisted {r.persist_s*1e3:.1f}ms in background "
              f"({r.chunks_reused} chunks reused)", flush=True)
    return state


if __name__ == "__main__":
    main()
