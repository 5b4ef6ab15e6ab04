"""PyTorch port: restart correctness and the digest-gated sync, on the CPU.

The twin of tests/integration/test_restart.py: a run that checkpoints,
dies and restores must end bitwise equal to a run that never died, over
both persist backends. On the CPU the shadow sync digests through the
kernel's plain version, so a second sync that fetches nothing proves those
digests equal the numpy digests the persist phase backfilled.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manifest import committed_steps
from repro_torch.core import CheckpointedTrainer, CheckpointPolicy, ShadowStateManager
from repro_torch.data import SyntheticBatches
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import build_training
from repro_torch.models import ModelConfig
from repro_torch.runtime.steps import batch_to_device
from repro_torch.utils.tree import tree_equal

BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])
CPU = torch.device("cpu")


def _cfg():
    return ModelConfig(
        name="t", family="dense", num_layers=2, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        param_dtype="float32", compute_dtype="float32",
    )


def _setup(cfg):
    return build_training(cfg, batch=4, seq=16, lr=1e-3, total_steps=10, device=CPU)


def _run(step_fn, state, data, n_steps, trainer=None):
    for _ in range(n_steps):
        state["device"], _ = step_fn(state["device"], batch_to_device(next(data), CPU))
        step = int(np.asarray(state["host"]["step"])) + 1
        state["host"]["step"] = np.int64(step)
        state["host"]["data"] = data.state()
        if trainer is not None and trainer.policy.should_checkpoint(step):
            trainer.checkpoint_now(step, state)
    return state


@pytest.mark.parametrize("backend", BACKENDS)
def test_restart_is_bitwise_identical(tmp_path, backend):
    cfg = _cfg()
    run = _setup(cfg)

    # reference: 10 uninterrupted steps
    ref_state = _run(run.step_fn, run.init_state(),
                     SyntheticBatches(cfg, batch=4, seq_len=16), 10)

    # interrupted: checkpoint every 4 steps, die at 7
    trainer = CheckpointedTrainer(
        run.step_fn, store_root=str(tmp_path / "ck"),
        policy=CheckpointPolicy(interval_steps=4, keep_last=3),
        chunk_bytes=1 << 12, backend=backend,
    )
    st = _run(run.step_fn, run.init_state(),
              SyntheticBatches(cfg, batch=4, seq_len=16), 7, trainer)
    trainer.checkpointer.wait_all()
    del st  # "crash" — everything after the last checkpoint is lost

    # restore (latest committed = step 4) and continue to 10
    restored, start = trainer.resume_or(run.init_state, device_for=run.device_for)
    assert start == 4
    assert isinstance(restored["device"]["params"]["embed"], torch.Tensor)
    data2 = SyntheticBatches.from_state(
        cfg, batch=4, seq_len=16, state=restored["host"]["data"]
    )
    restored = _run(run.step_fn, restored, data2, 10 - start)
    trainer.finish()

    assert tree_equal(ref_state["device"], restored["device"]), (
        "restored run diverged from uninterrupted run"
    )


def test_resume_or_fresh_when_no_checkpoint(tmp_path):
    run = _setup(_cfg())
    trainer = CheckpointedTrainer(run.step_fn, store_root=str(tmp_path / "empty"))
    state, start = trainer.resume_or(run.init_state, device_for=run.device_for)
    assert start == 0
    assert int(state["device"]["step"]) == 0
    trainer.finish()


def test_gc_respects_keep_last(tmp_path):
    cfg = _cfg()
    run = _setup(cfg)
    trainer = CheckpointedTrainer(
        run.step_fn, store_root=str(tmp_path / "gc"),
        policy=CheckpointPolicy(interval_steps=2, keep_last=2),
        incremental=False, chunk_bytes=1 << 12,
    )
    _run(run.step_fn, run.init_state(), SyntheticBatches(cfg, batch=4, seq_len=16),
         8, trainer)
    trainer.finish()
    assert committed_steps(str(tmp_path / "gc")) == [6, 8]


def _shadow_state(rng):
    return {
        "device": {
            "w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(100).astype(np.float32)).to(
                torch.bfloat16),
            "s": torch.zeros((), dtype=torch.int32),
        },
        "host": {"step": np.int64(3)},
    }


@pytest.mark.parametrize("defer_first", [False, True])
def test_unchanged_sync_fetches_nothing_and_one_chunk_change_fetches_one(rng, defer_first):
    cb = 1024  # device/w: 12288 bytes -> 12 chunks
    state = _shadow_state(rng)
    sh = ShadowStateManager(chunk_bytes=cb, defer_first_digests=defer_first)
    first = sh.sync(state)
    assert first.chunks_fetched == first.chunks_total == 12 + 1 + 1 + 1
    if defer_first:
        # the persist phase backfills numpy digests (core/forked.py)
        from repro_torch.checkpoint.chunking import chunk_digest_np

        for (path, ordinal), snap in sh.snapshot().items():
            data = snap["data"]
            sh.set_digests((path, ordinal), [
                chunk_digest_np(data[i * cb : (i + 1) * cb])
                for i in range(max(1, -(-data.nbytes // cb)))
            ])
    sh.mark_device_step()
    again = sh.sync(state)
    assert again.chunks_fetched == 0 and again.bytes_fetched == 0

    state["device"]["w"].view(-1)[300] += 1.0  # byte 1200 -> chunk 1
    sh.mark_device_step()
    one = sh.sync(state)
    assert one.chunks_fetched == 1
    assert one.changed == {("device/w", 0): [1]}
    snap = sh.snapshot()[("device/w", 0)]["data"]
    assert snap.tobytes() == state["device"]["w"].numpy().tobytes()


def test_cli_resumes_from_newest_checkpoint(tmp_path, capsys):
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "2", "--seq", "8",
            "--ckpt-every", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    out = train_cli.train([*argv, "--steps", "2"])
    assert out["final_step"] == 2 and np.isfinite(out["metrics"]["loss"])
    out = train_cli.train([*argv, "--steps", "4"])
    assert "start_step=2" in capsys.readouterr().out
    assert out["final_step"] == 4
    assert committed_steps(str(tmp_path)) == [2, 4]
