"""Oversubscribed training through the port's CheckpointedTrainer.

The twins of the reference's ``tests/uvm/test_managed_trainer.py`` on the
smoke qwen2-0.5b config, on the CPU: a device budget of half the model
state; train, checkpoint with page-delta syncs, restore bit for bit; the
managed image restores in the reference package too.
"""
import os

import numpy as np
import pytest
import torch

import repro.checkpoint as rck
import repro.core as rcore
from repro_torch.configs import get_config
from repro_torch.core import CheckpointedTrainer, CheckpointPolicy, PreemptionHandler
from repro_torch.data import SyntheticBatches
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import _needs_preempt_ckpt, build_training
from repro_torch.runtime.steps import batch_to_device
from repro_torch.utils.tree import flatten_with_paths, leaf_bytes, tree_equal

BACKENDS = ["thread"] + (["fork"] if hasattr(os, "fork") else [])
CPU = torch.device("cpu")
BATCH, SEQ = 2, 16


@pytest.fixture(scope="module")
def run():
    cfg = get_config("qwen2-0.5b", smoke=True)
    return build_training(cfg, batch=BATCH, seq=SEQ, lr=1e-3, total_steps=20, device=CPU)


def _state_bytes(run) -> int:
    flat, _ = flatten_with_paths(run.init_state()["device"])
    return sum(t.numel() * t.element_size() for t in flat.values())


def _batches(run, host_state):
    """The run's batches; each one consumed is recorded in the host state
    the checkpoints carry, so a restore resumes the stream."""
    data = SyntheticBatches.from_state(run.cfg, batch=BATCH, seq_len=SEQ,
                                       state=host_state["data"])
    while True:
        batch = batch_to_device(next(data), CPU)
        host_state["data"] = data.state()
        yield batch


def _trainer(root, run, backend="thread", capacity=None, **kw):
    return CheckpointedTrainer(
        run.step_fn, store_root=str(root),
        policy=CheckpointPolicy(interval_steps=2, keep_last=2),
        chunk_bytes=1 << 16, backend=backend,
        device_capacity_bytes=capacity, page_bytes=4096, device="cpu", **kw,
    )


def _unmanaged(run, n_steps):
    state = run.init_state()
    batches = _batches(run, state["host"])
    for _ in range(n_steps):
        state["device"], _ = run.step_fn(state["device"], next(batches))
    return state["device"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_oversubscribed_roundtrip_bit_identical(tmp_path, run, backend):
    cap = _state_bytes(run) // 2  # the acceptance ratio: 50% of state
    tr = _trainer(tmp_path / backend, run, backend, cap)
    state, start = tr.resume_or(run.init_state)
    state = tr.run(state, _batches(run, state["host"]), num_steps=5, start_step=start)
    tr.finish()
    tr.space.check_invariants()
    assert tr.space.stats.evictions > 0, "50% capacity must actually page"
    assert tr.space.stats.resident_high_water <= cap
    assert tree_equal(state["device"], _unmanaged(run, 5)), (
        "paging must be transparent: managed == unmanaged bit-for-bit")

    # restore (also oversubscribed) lands exactly on the step-4 checkpoint
    tr2 = _trainer(tmp_path / backend, run, backend, cap)
    restored, start2 = tr2.resume_or(run.init_state)
    assert start2 == 4
    restored = tr2.run(restored, _batches(run, restored["host"]), num_steps=1,
                       start_step=start2)
    tr2.finish()
    assert tree_equal(restored["device"], state["device"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_managed_checkpoints_use_page_delta_sync(tmp_path, run, backend, monkeypatch):
    """After the first image, phase 1 fetches the pages the steps wrote
    without digesting a device leaf; host leaves keep the digest path."""
    digested = []
    real = ops.host_chunk_digests

    def counting(leaves, chunk_bytes):
        digested.extend(leaves)
        return real(leaves, chunk_bytes)

    monkeypatch.setattr(ops, "host_chunk_digests", counting)
    cap = _state_bytes(run)  # x1.0: no paging, pure delta accounting
    tr = _trainer(tmp_path / "d", run, backend, cap)
    state, start = tr.resume_or(run.init_state)
    state = tr.run(state, _batches(run, state["host"]), num_steps=4, start_step=start)
    done = tr.finish()
    assert [r.step for r in done] == [2, 4]
    first, second = done
    assert first.chunks_clean == 0          # everything moves into image 1
    assert second.chunks_synced > 0         # the steps dirtied real chunks
    assert second.error is None and first.error is None
    assert digested == [], "a page-delta sync digested a device leaf"
    tr2 = _trainer(tmp_path / "d", run, backend, cap)
    restored, start2 = tr2.resume_or(run.init_state)
    assert start2 == 4
    assert tree_equal(restored["device"], state["device"])
    tr2.finish()


def test_managed_image_restores_in_the_reference(tmp_path, run):
    cap = _state_bytes(run) // 2
    tr = _trainer(tmp_path / "x", run, "fork", cap)
    state, start = tr.resume_or(run.init_state)
    state = tr.run(state, _batches(run, state["host"]), num_steps=4, start_step=start)
    tr.finish()
    got, manifest = rcore.RestoreManager(rck.ChunkStore(str(tmp_path / "x"))).restore()
    assert manifest.step == 4
    mine, _ = flatten_with_paths(state)
    theirs, _ = flatten_with_paths(got)
    assert mine.keys() == theirs.keys()
    for path, leaf in mine.items():
        assert leaf_bytes(leaf).tobytes() == np.asarray(theirs[path]).tobytes(), path


def test_managed_trainer_materialize_and_stats(tmp_path, run):
    cap = _state_bytes(run) // 2
    tr = _trainer(tmp_path / "m", run, "thread", cap)
    state, start = tr.resume_or(run.init_state)
    state = tr.run(state, _batches(run, state["host"]), num_steps=2, start_step=start)
    # materialize is idempotent and matches the space's coherent view
    m1 = tr.materialize(dict(state))
    assert tree_equal(m1["device"], state["device"])
    stats = tr.paging_stats()
    assert stats is not None and stats["faults"] > 0
    assert stats["device_capacity_bytes"] == cap
    tr.finish()
    assert _trainer(tmp_path / "u", run).paging_stats() is None


def test_preemption_checkpoints_step_exactly_once(tmp_path, run):
    """SIGTERM sets BOTH the policy preempt flag and the stop event: the
    loop checkpoints the step via the policy, and the caller-side guard
    must not save the same step a second time."""
    tr = _trainer(tmp_path / "p", run, "thread", _state_bytes(run) // 2)
    tr.policy.interval_steps = 50  # no cadence checkpoint in this window
    preempt = PreemptionHandler(tr.policy).install()
    try:
        state, start = tr.resume_or(run.init_state)

        def on_metrics(step, m):
            if step == 3:
                preempt.received.set()
                tr.policy.request_preempt_checkpoint()

        state = tr.run(state, _batches(run, state["host"]), num_steps=100,
                       start_step=start, on_metrics=on_metrics,
                       stop=preempt.received.is_set)
        step = int(np.asarray(state["host"]["step"]))
        assert step == 3
        assert [r.step for r in tr.results] == [3]
        assert not _needs_preempt_ckpt(tr, step)
        tr.finish()
    finally:
        preempt.uninstall()


def test_run_stop_hook_exits_early(tmp_path, run):
    tr = _trainer(tmp_path / "s", run, "thread", _state_bytes(run) // 2)
    state, start = tr.resume_or(run.init_state)
    seen = []
    state = tr.run(
        state, _batches(run, state["host"]), num_steps=1000, start_step=start,
        on_metrics=lambda s, m: seen.append(s), stop=lambda: len(seen) >= 3,
    )
    tr.finish()
    assert seen == [1, 2, 3]
    assert int(np.asarray(state["host"]["step"])) == 3


@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_paging_stress_large_oversubscription(tmp_path, run, policy):
    """x4 oversubscription, several checkpoint rounds, restore at the end."""
    cap = _state_bytes(run) // 4
    tr = _trainer(tmp_path / policy, run, "thread", cap, eviction_policy=policy)
    state, start = tr.resume_or(run.init_state)
    state = tr.run(state, _batches(run, state["host"]), num_steps=4, start_step=start)
    tr.finish()
    tr.space.check_invariants()
    assert tr.space.stats.evictions > 100
    tr2 = _trainer(tmp_path / policy, run, "thread", cap, eviction_policy=policy)
    restored, start2 = tr2.resume_or(run.init_state)
    assert start2 == 4
    assert tree_equal(restored["device"], state["device"])
    tr2.finish()


def test_train_cli_managed_matches_unmanaged_and_resumes(tmp_path, capsys):
    base = ["--arch", "qwen2-0.5b", "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
            "--ckpt-every", "2", "--device", "cpu", "--backend", "thread",
            "--log-every", "1"]
    plain = train_cli.train(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "p")])
    managed = train_cli.train(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "m"),
                                      "--device-capacity", "50%", "--page-bytes", "4096",
                                      "--eviction-policy", "clock"])
    out = capsys.readouterr().out
    assert "[uvm] device_capacity=" in out and "oversubscription=x2.00" in out
    assert managed["paging"]["evictions"] > 0
    assert managed["paging"]["policy"] == "clock"
    assert tree_equal(managed["state"]["device"], plain["state"]["device"])
    again = train_cli.train(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "m"),
                                    "--device-capacity", "50%", "--page-bytes", "4096"])
    assert "start_step=4" in capsys.readouterr().out
    assert again["final_step"] == 6 and [r.step for r in again["results"]] == [6]
    assert np.isfinite(again["metrics"]["loss"])
    assert train_cli._resolve_capacity("25%", 1000) == 250
    assert train_cli._resolve_capacity("4096", 1000) == 4096


def test_page_marks_fetch_only_the_chunks_written_since_the_last_sync(tmp_path):
    """Each phase 1 moves exactly the chunks of the pages written since its
    buffer's last sync, without a digest compare of the device leaf, plus
    the host step leaf, which keeps the compare; the delta images restore."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.core import ForkedCheckpointer, RestoreManager
    from repro_torch.uvm import ManagedSpace

    page = 4096
    sp = ManagedSpace(4 * page, page_bytes=page, device="cpu")
    sp.register({"w": torch.zeros(16 * page // 4, dtype=torch.float32)})
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=page,
                            dirty_source=sp.as_dirty_source("device/"))

    def save(step):
        r = ck.save_async(step, {"device": sp.peek_state(), "host": {"step": np.int64(step)}})
        return r.wait()  # the next save finds the same buffer free

    gen = torch.Generator().manual_seed(0)
    # random values: a constant chunk can digest like a zero chunk, and the
    # delta image would then reuse the stale one — a weakness of the shared
    # digest, pinned by test_torch_digest.py::test_constant_chunks_share_
    # the_zero_chunks_digest; this test is about the page marks
    assert save(1).chunks_synced == 17          # first sync: everything
    sp.write_range("w", 3 * page, torch.rand(10, generator=gen))
    assert save(2).chunks_synced == 2           # page 3, the host step
    sp.write_range("w", 5 * page + 8, torch.rand(4, generator=gen))
    sp.write_range("w", 9 * page, torch.rand(page // 4, generator=gen))
    assert save(3).chunks_synced == 3           # pages 5 and 9, the host step
    assert save(4).chunks_synced == 1           # the host step alone
    # a write of the same bytes is still a write: the marks fetch page 7
    # (a digest compare would have skipped it)
    sp.write_range("w", 7 * page, sp.peek_range("w", 7 * page, 8 * page))
    assert save(5).chunks_synced == 2
    ck.close()
    got, _ = RestoreManager(ChunkStore(str(tmp_path / "ck"))).restore(step=5)
    assert np.array_equal(leaf_bytes(got["device"]["w"]), leaf_bytes(sp.peek_leaf("w")))
