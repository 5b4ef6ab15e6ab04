"""PyTorch port on a CUDA card: the chunk_digest kernel and the main path.

Every test here needs a card (``gpu`` marker) and skips without one. The
file imports neither JAX nor the reference package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest -q -m gpu tests/test_torch_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CheckpointedTrainer, CheckpointPolicy
from repro_torch.data import SyntheticBatches
from repro_torch.kernels import chunk_digest, ops, ref
from repro_torch.launch.train import build_training
from repro_torch.models import ModelConfig
from repro_torch.runtime.steps import batch_to_device
from repro_torch.utils.tree import tree_equal

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def deterministic(cuda, monkeypatch):
    """Bitwise-reproducible training on the card: atomics in some backward
    kernels (and cuBLAS workspaces) otherwise vary from run to run, so even
    two uninterrupted runs differ. cuBLAS reads the variable when this
    process first uses it."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield cuda
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    item = torch.empty((), dtype=dtype).element_size()
    for n in [1, 3, 4097, 1 << 20]:
        raw = torch.randint(0, 256, (n * item,), dtype=torch.uint8, device=cuda,
                            generator=g)
        x = raw.view(dtype)
        for cb in [64, 4096, 1 << 20]:
            before = chunk_digest.chunk_digests.launches
            k = ops.chunk_digests(x, cb)
            assert chunk_digest.chunk_digests.launches == before + 1
            assert torch.equal(k, ref.chunk_digests_plain(x, cb))


def test_kernel_refuses_what_it_cannot_read(cuda):
    x = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        chunk_digest.chunk_digests(x[1:], 16)
    with pytest.raises(ValueError, match="contiguous"):
        chunk_digest.chunk_digests(x.reshape(8, 8).t(), 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        chunk_digest.chunk_digests(x, 6)
    empty = chunk_digest.chunk_digests(x[:0], 16)
    assert empty.tolist() == [[0, 0]]


@pytest.mark.parametrize("backend", ["thread", "fork"])
def test_restart_on_card_is_bitwise(deterministic, tmp_path, backend):
    cuda = deterministic
    cfg = ModelConfig(
        name="t", family="dense", num_layers=2, d_model=64, vocab_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    run = build_training(cfg, batch=4, seq=16, lr=1e-3, total_steps=10, device=cuda)

    def steps(state, data, n, trainer=None):
        for _ in range(n):
            state["device"], _ = run.step_fn(state["device"],
                                             batch_to_device(next(data), cuda))
            step = int(state["host"]["step"]) + 1
            state["host"]["step"] = np.int64(step)
            state["host"]["data"] = data.state()
            if trainer is not None and trainer.policy.should_checkpoint(step):
                trainer.checkpoint_now(step, state)
        return state

    ref_state = steps(run.init_state(), SyntheticBatches(cfg, batch=4, seq_len=16), 10)
    trainer = CheckpointedTrainer(
        run.step_fn, store_root=str(tmp_path / "ck"),
        policy=CheckpointPolicy(interval_steps=2, keep_last=3),
        chunk_bytes=1 << 12, backend=backend,
    )
    before = chunk_digest.chunk_digests.launches
    steps(run.init_state(), SyntheticBatches(cfg, batch=4, seq_len=16), 7, trainer)
    trainer.checkpointer.wait_all()
    # checkpoint 6 is the second sync of one shadow buffer: digests on the card
    assert chunk_digest.chunk_digests.launches > before
    restored, start = trainer.resume_or(run.init_state, device_for=run.device_for)
    assert start == 6
    data = SyntheticBatches.from_state(cfg, batch=4, seq_len=16,
                                       state=restored["host"]["data"])
    restored = steps(restored, data, 10 - start)
    trainer.finish()
    assert tree_equal(ref_state["device"], restored["device"])
