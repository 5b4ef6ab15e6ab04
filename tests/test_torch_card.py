"""PyTorch port on a CUDA card: the kernels, training and serving.

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
from repro_torch.kernels import chunk_digest, flash_attention, ops, ref
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


# (B, Hq, Hkv, Sq, Sk, D, causal): the reference test's shapes, non-causal,
# rows with no key (Sq > Sk), qwen2-0.5b's group of 7, ragged tiles, head
# dims 32 and 128 with ragged tiles and rows with no key
FLASH_CASES = [
    (1, 1, 1, 128, 128, 64, True),
    (2, 4, 2, 256, 256, 64, True),
    (1, 8, 1, 128, 128, 128, True),
    (1, 4, 4, 128, 512, 64, True),
    (2, 2, 2, 384, 384, 32, True),
    (1, 2, 1, 128, 256, 64, False),
    (1, 2, 1, 256, 128, 64, True),
    (1, 14, 2, 200, 200, 64, True),
    (1, 14, 2, 120, 200, 64, True),
    (1, 14, 2, 200, 120, 64, True),
    (1, 2, 1, 200, 120, 128, True),
    (1, 2, 1, 200, 200, 128, False),
    (1, 4, 2, 200, 120, 32, True),
    (1, 4, 2, 120, 200, 32, False),
]
# (atol, rtol): f32 for the two sum orders; bf16 / f16 one ulp of the
# output plus the sum order where the output is near 0
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7),
             torch.float16: (1e-4, 2.0 ** -10)}


def _flash_inputs(cuda, B, Hq, Hkv, Sq, Sk, D, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


def _block(n: int) -> int:
    return max(b for b in range(1, min(n, 128) + 1) if n % b == 0)


@pytest.mark.parametrize("dtype", list(FLASH_TOL))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    B, Hq, Hkv, Sq, Sk, D, causal = case
    q, k, v = _flash_inputs(cuda, B, Hq, Hkv, Sq, Sk, D, dtype)
    route = "simt" if dtype == torch.float32 else "wgmma"
    before = flash_attention.flash_attention.launches
    before_route = flash_attention.flash_attention.launches_by_route[route]
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.flash_attention.launches == before + 1
    assert flash_attention.flash_attention.launches_by_route[route] == before_route + 1
    want = ref.flash_attention_plain(q, k, v, causal=causal,
                                     block_q=_block(Sq), block_k=_block(Sk))
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    if causal and Sq > Sk:  # no key: the mean of v over all Sk
        mean = v.float().mean(dim=2).repeat_interleave(Hq // Hkv, dim=1)
        torch.testing.assert_close(got[:, :, : Sq - Sk].float(),
                                   mean[:, :, None].expand(-1, -1, Sq - Sk, -1),
                                   atol=atol, rtol=rtol)


def test_flash_kernel_scale_and_strided_v(cuda):
    q, k, v = _flash_inputs(cuda, 2, 14, 2, 256, 256, 64, torch.bfloat16)
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)  # the model's v view
    assert not vt.is_contiguous() and torch.equal(vt, v)
    got = flash_attention.flash_attention(q, k, vt, scale=0.5)
    want = ref.flash_attention_plain(q, k, v, scale=0.5)
    atol, rtol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _flash_inputs(cuda, 1, 2, 1, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim D"):
        flash_attention.flash_attention(*_flash_inputs(cuda, 1, 2, 1, 64, 64, 48,
                                                       torch.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention.flash_attention(q, k.half(), v)
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention.flash_attention(q, k, v.transpose(2, 3))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention.flash_attention(*_flash_inputs(cuda, 1, 3, 2, 64, 64, 64,
                                                       torch.float32))


def _misaligned_v_views(cuda, dtype):
    """The model's transposed v view with a head stride of D + 1 elements
    (not a multiple of 16 bytes in 16 bits), and one whose data pointer is
    one element past a 16-byte boundary, beside a v of the same values."""
    g = torch.Generator(device=cuda).manual_seed(3)
    wide = torch.randn((1, 256, 2, 65), generator=g, device=cuda).to(dtype)
    return wide[..., :64].transpose(1, 2), wide[..., 1:].transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_tensor_core_route_refuses_misaligned_v(cuda, dtype):
    q, k, _ = _flash_inputs(cuda, 1, 4, 2, 256, 256, 64, dtype)
    strided, offset = _misaligned_v_views(cuda, dtype)
    before = dict(flash_attention.flash_attention.launches_by_route)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        flash_attention.flash_attention(q, k, strided)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention.flash_attention(q, k, offset)
    assert flash_attention.flash_attention.launches_by_route == before


def test_flash_cuda_core_route_takes_misaligned_v(cuda):
    q, k, _ = _flash_inputs(cuda, 1, 4, 2, 256, 256, 64, torch.float32)
    for v in _misaligned_v_views(cuda, torch.float32):
        got = flash_attention.flash_attention(q, k, v)
        want = ref.flash_attention_plain(q, k, v.contiguous())
        atol, rtol = FLASH_TOL[torch.float32]
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_flash_kernel_same_bits_run_to_run(cuda):
    """No atomics and no split of a row's keys: one input, one output."""
    q, k, v = _flash_inputs(cuda, 1, 14, 2, 4096, 4096, 64, torch.bfloat16)
    v = v.transpose(1, 2).contiguous().transpose(1, 2)  # the model's v view
    first = flash_attention.flash_attention(q, k, v)
    for _ in range(3):
        assert torch.equal(flash_attention.flash_attention(q, k, v), first)


def test_ops_flash_on_card_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(ref, "flash_attention_plain", refuse)
    q, k, v = _flash_inputs(cuda, 1, 4, 2, 256, 256, 64, torch.bfloat16)
    before = flash_attention.flash_attention.launches
    out = ops.flash_attention(q, k, v)
    assert flash_attention.flash_attention.launches == before + 1
    assert out.shape == q.shape and bool(out.float().isfinite().all())


def test_long_s_attention_on_card_refuses_a_gradient(cuda):
    from repro_torch.models.layers import multihead_attention

    q, k, v = _flash_inputs(cuda, 1, 2, 1, 128, 128, 64, torch.float32)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        multihead_attention(q, k, v, chunked_threshold=64, block_q=32, block_k=32)
    with torch.no_grad():
        out = multihead_attention(q, k, v, chunked_threshold=64, block_q=32, block_k=32)
    assert out.shape == q.shape


def test_serve_on_card_lazy_equals_eager(deterministic, tmp_path):
    """A smoke image trained on the card, served eagerly and lazily: a
    128-token prompt takes the long-S lowering, so every layer's prefill
    attention is one flash launch, and both restores give the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train

    store = str(tmp_path / "ck")
    train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "2", "--batch", "2",
                "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", store])
    layers = get_config("qwen2-0.5b", smoke=True).num_layers
    outs = []
    for lazy in ([], ["--lazy"]):
        before = flash_attention.flash_attention.launches
        outs.append(serve.serve(["--arch", "qwen2-0.5b", "--smoke", "--ckpt-dir", store,
                                 "--prompt-len", "128", "--gen", "4"] + lazy))
        assert flash_attention.flash_attention.launches == before + layers
    eager, lazy = outs
    assert eager["step"] == lazy["step"] == 2
    assert eager["logits"].device.type == "cuda"
    assert np.array_equal(eager["tokens"], lazy["tokens"])
    assert torch.equal(eager["logits"], lazy["logits"])


def test_resolved_card_carries_its_index(cuda):
    """Lazy restore places leaves from reader threads, whose current device
    is not the caller's: the CLIs hand it a device with its index."""
    from repro_torch.launch.train import resolve_device

    dev = resolve_device("cuda")
    assert dev.type == "cuda" and dev.index == torch.cuda.current_device()
