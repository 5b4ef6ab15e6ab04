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


@pytest.mark.parametrize("cb", [4, 12, 20, 1028, 4096])
def test_grouped_kernel_matches_plain(cuda, cb):
    """Mixed dtypes and sizes, empty and 0-d leaves, views whose starts are
    off the 16-byte grid, and more leaves than one launch takes."""
    g = torch.Generator(device=cuda).manual_seed(1)
    words = torch.randint(-2**31, 2**31 - 1, (70_001,), dtype=torch.int32,
                          device=cuda, generator=g)
    leaves = [words[1:], words[:0], words[2:999], words[3:7], words[5].reshape(()),
              words.view(torch.bfloat16)[2:2002], words.view(torch.int8)[4:40_003]]
    sizes = torch.randint(0, 3000, (2 * chunk_digest.CAPACITY,), generator=g,
                          device=cuda).tolist()
    leaves += [words.view(torch.uint8)[4 * k : 4 * k + n] for k, n in enumerate(sizes)]
    busy = sum(1 for x in leaves if x.numel())
    before = chunk_digest.chunk_digests.launches
    table, b = ops.chunk_digest_table(leaves, cb)
    assert chunk_digest.chunk_digests.launches - before == -(-busy // chunk_digest.CAPACITY)
    for k, x in enumerate(leaves):
        assert torch.equal(table[b[k] : b[k + 1]], ref.chunk_digests_plain(x, cb))


def test_shadow_sync_over_mixed_devices(cuda):
    """A state may hold a CPU tensor (an RNG state) beside the card's
    leaves: each device gets its own grouped call, and the shadow equals a
    sync of the same bytes held all on the CPU."""
    from repro_torch.core.shadow import ShadowStateManager

    g = torch.Generator().manual_seed(2)
    cpu = {"w": torch.randn(3000, generator=g), "rng": torch.get_rng_state(),
           "b": torch.randn(77, generator=g).to(torch.bfloat16)}
    mixed = {"w": cpu["w"].to(cuda), "rng": cpu["rng"], "b": cpu["b"].to(cuda)}
    assert ops.host_chunk_digests(list(mixed.values()), 512) == \
        ops.host_chunk_digests(list(cpu.values()), 512)
    before = chunk_digest.chunk_digests.launches
    on_card, on_host = ShadowStateManager(chunk_bytes=512), ShadowStateManager(chunk_bytes=512)
    on_card.sync(mixed)
    on_host.sync(cpu)
    assert chunk_digest.chunk_digests.launches - before == 1
    want, got = on_host.snapshot(), on_card.snapshot()
    assert want.keys() == got.keys()
    for key in want:
        assert np.array_equal(got[key]["data"], want[key]["data"]), key
        assert got[key]["digests"] == want[key]["digests"], key


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
# dims 32 and 128 with ragged tiles and rows with no key, and the groups of
# granite-8b (4) and command-r-plus-104b (12)
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
    (1, 8, 2, 333, 200, 128, True),
    (1, 12, 1, 300, 200, 64, True),
    (1, 12, 1, 130, 257, 32, False),
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


# (B, Hq, Hkv, Sq, Sk, D, prefix_len): the prefix-LM mask at head dims 64,
# 128 and 256 (paligemma's): a prefix inside one key tile, across tiles,
# with rows that have no causal key (Sq > Sk), with ragged tiles, and at or
# past Sk (every key open to every row)
FLASH_PREFIX_CASES = [
    (1, 4, 2, 256, 256, 64, 16),
    (1, 14, 2, 200, 200, 64, 130),
    (1, 2, 1, 256, 128, 64, 40),
    (1, 8, 1, 320, 320, 128, 96),
    (1, 2, 1, 200, 120, 128, 200),
    (1, 8, 1, 256, 256, 256, 64),
    (2, 8, 1, 384, 384, 256, 256),
    (1, 4, 2, 200, 200, 256, 70),
    (1, 2, 1, 256, 128, 256, 5),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_PREFIX_CASES, ids=str)
def test_flash_kernel_with_a_prefix_matches_plain(cuda, dtype, case):
    B, Hq, Hkv, Sq, Sk, D, prefix = case
    q, k, v = _flash_inputs(cuda, B, Hq, Hkv, Sq, Sk, D, dtype, seed=3)
    got, m, l = flash_attention.flash_attention(q, k, v, prefix_len=prefix, stats=True)
    want, pm, pl = ref.flash_attention_plain(q, k, v, block_q=_block(Sq), block_k=_block(Sk),
                                             return_stats=True, prefix_len=prefix)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)
    assert bool((m > -1e29).all())  # with a prefix every row has a key


def test_flash_backward_refuses_a_prefix_and_head_dim_256(cuda):
    """Through ``ops.flash_attention`` with a gradient: raises before the
    forward runs, naming the ROADMAP item; never the plain version."""
    before = flash_attention.flash_attention.launches
    for D, prefix in ((64, 16), (256, 0)):
        q, k, v = (t.requires_grad_(True) for t in _flash_inputs(
            cuda, 1, 2, 1, 128, 128, D, torch.bfloat16))
        with pytest.raises(ValueError, match="ROADMAP Queue 2 item 4"):
            ops.flash_attention(q, k, v, prefix_len=prefix)
    assert flash_attention.flash_attention.launches == before


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
    """The long-S lowering on the card used to refuse a gradient; it now
    takes the backward kernel (one call per backward, on the CUDA-core
    route for f32), never the plain version, and without a gradient the
    forward alone runs."""
    from repro_torch.models.layers import multihead_attention

    q, k, v = _flash_inputs(cuda, 1, 2, 1, 128, 128, 64, torch.float32)
    q.requires_grad_(True)
    bwd = flash_attention.flash_attention_bwd
    before = (bwd.launches, bwd.launches_by_route["simt"])
    out = multihead_attention(q, k, v, chunked_threshold=64, block_q=32, block_k=32)
    (dq,) = torch.autograd.grad(out, (q,), torch.ones_like(out))
    assert (bwd.launches, bwd.launches_by_route["simt"]) == tuple(n + 1 for n in before)
    assert dq.shape == q.shape and bool(dq.isfinite().all())
    with torch.no_grad():
        plain = multihead_attention(q, k, v, chunked_threshold=64, block_q=32, block_k=32)
    assert torch.equal(plain, out.detach())
    assert (bwd.launches, bwd.launches_by_route["simt"]) == tuple(n + 1 for n in before)


# flash backward vs its plain version per gradient tensor, (a, r) in
# |got - want| <= a max|want| + r |want| (chip_smoke.py's FLASH_BWD_TOL, which
# says why)
FLASH_BWD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -7),
                 torch.float16: (2.0 ** -10, 2.0 ** -10)}


def _flash_bwd_inputs(cuda, case, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, D, causal = case
    q, k, v = _flash_inputs(cuda, B, Hq, Hkv, Sq, Sk, D, dtype, seed)
    v = v.transpose(1, 2).contiguous().transpose(1, 2)  # the model's v view
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    o, m, l = flash_attention.flash_attention(q, k, v, causal=causal, stats=True)
    return q, k, v, o, m, l, do


@pytest.mark.parametrize("dtype", list(FLASH_BWD_TOL))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, case):
    B, Hq, Hkv, Sq, Sk, D, causal = case
    ins = _flash_bwd_inputs(cuda, case, dtype)
    bwd = flash_attention.flash_attention_bwd
    route = "simt" if dtype == torch.float32 else "mma"
    before, before_route = bwd.launches, bwd.launches_by_route[route]
    got = bwd(*ins, causal=causal)
    assert bwd.launches == before + 1 and bwd.launches_by_route[route] == before_route + 1
    # the plain backward on the plain forward's output and statistics
    q, k, v, _, _, _, do = ins
    po, pm, pl = ref.flash_attention_plain(q, k, v, causal=causal, block_q=_block(Sq),
                                           block_k=_block(Sk), return_stats=True)
    want = ref.flash_attention_bwd_plain(q, k, v, po, pm, pl, do, causal=causal,
                                         block_q=_block(Sq), block_k=_block(Sk))
    a, r = FLASH_BWD_TOL[dtype]
    for g, w, t in zip(got, want, ins[:3]):
        assert g.dtype == dtype and g.shape == t.shape and g.is_contiguous()
        top = float(w.float().abs().max())
        assert bool(((g.float() - w.float()).abs() <= a * top + r * w.float().abs()).all())
    if causal and Sq > Sk:  # rows with no key: dS is 0 at every position
        assert bool((got[0][:, :, : Sq - Sk] == 0).all())


def test_flash_forward_statistics(cuda):
    """The statistics change no bit of the output and agree with the plain
    version's (m exactly -1e30 on rows with no key)."""
    for dtype in FLASH_TOL:
        q, k, v = _flash_inputs(cuda, 1, 4, 2, 200, 120, 64, dtype)
        out, m, l = flash_attention.flash_attention(q, k, v, stats=True)
        assert torch.equal(out, flash_attention.flash_attention(q, k, v))
        _, pm, pl = ref.flash_attention_plain(q, k, v, block_q=40, block_k=40,
                                              return_stats=True)
        assert bool((m[:, :, :80] == -1e30).all()) and bool((l[:, :, :80] == 120).all())
        torch.testing.assert_close(m, pm, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(l, pl, atol=0, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 4, 7, 12])
def test_flash_bwd_same_bits_run_to_run(cuda, group, d, dtype):
    """No atomics: dk and dv sum the group's q heads' partials in a fixed
    order; rows with no key (Sq > Sk) and ragged tiles included."""
    ins = _flash_bwd_inputs(cuda, (1, 2 * group, 2, 1040, 776, d, True), dtype)
    first = flash_attention.flash_attention_bwd(*ins)
    for _ in range(3):
        again = flash_attention.flash_attention_bwd(*ins)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_tensor_core_route_refuses_misaligned_rows(cuda, dtype):
    q, k, _, o, m, l, do = _flash_bwd_inputs(cuda, (1, 4, 2, 256, 256, 64, True), dtype)
    strided, offset = _misaligned_v_views(cuda, dtype)
    before = flash_attention.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        flash_attention.flash_attention_bwd(q, k, strided, o, m, l, do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention.flash_attention_bwd(q, k, offset, o, m, l, do)
    assert flash_attention.flash_attention_bwd.launches == before


def test_ops_flash_gradient_on_card_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(ref, "flash_attention_plain", refuse)
    monkeypatch.setattr(ref, "flash_attention_bwd_plain", refuse)
    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(
        cuda, 1, 4, 2, 256, 256, 64, torch.bfloat16))
    before = (flash_attention.flash_attention.launches,
              flash_attention.flash_attention_bwd.launches,
              flash_attention.thread_launches(), flash_attention.thread_bwd_launches())
    out = ops.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    # the backward ran on autograd's device thread, credited to this one
    assert (flash_attention.flash_attention.launches,
            flash_attention.flash_attention_bwd.launches,
            flash_attention.thread_launches(),
            flash_attention.thread_bwd_launches()) == tuple(n + 1 for n in before)
    assert all(g.shape == t.shape and bool(g.float().isfinite().all())
               for g, t in zip(grads, (q, k, v)))


@pytest.mark.parametrize("mb", [1, 2])
def test_long_s_train_step_on_card_remat_is_bitwise(deterministic, mb):
    """A bf16 model at S = 128 above its chunked threshold of 64: every
    layer's attention and its gradient run the kernels, and the step's
    state is the same bits under remat none, dots and full. Every launch,
    the ones remat recomputes on autograd's thread included, counts for
    this thread: per microbatch L backward calls and L forward launches,
    2 L under dots and full."""
    from repro_torch.models import build
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step

    cuda = deterministic
    cfg = ModelConfig(
        name="t", family="dense", num_layers=2, d_model=128, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, qkv_bias=True,
        attn_chunked_threshold=64, attn_block_q=32, attn_block_k=32,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, 256, (4, 129), generator=g, device=cuda, dtype=torch.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    states = []
    for remat in ("none", "dots", "full"):
        model = build(cfg.with_overrides(remat=remat))
        opt = adamw(1e-3)
        params = model.init(torch.Generator(device=cuda).manual_seed(1))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=cuda)}
        counters = (lambda: (flash_attention.flash_attention.launches,
                             flash_attention.flash_attention_bwd.launches,
                             flash_attention.thread_launches(),
                             flash_attention.thread_bwd_launches()))
        before = counters()
        state, metrics = make_train_step(model, opt, microbatches=mb)(state, batch)
        fwd = (1 if remat == "none" else 2) * mb * cfg.num_layers
        bwd = mb * cfg.num_layers
        assert tuple(n - b for n, b in zip(counters(), before)) == (fwd, bwd, fwd, bwd)
        assert bool(torch.isfinite(metrics["loss"]))
        states.append(state)
    assert tree_equal(states[0], states[1]) and tree_equal(states[0], states[2])


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


def test_proxy_on_card_replays_bitwise(deterministic):
    """The proxy owns the card: a smoke train_arch run with fused digests,
    SIGKILLed once and replayed from the API log, equals the same steps run
    inline on the card bit for bit. Every proxied step digests its output
    in one grouped chunk_digest launch in the proxy (counted in the SYNCED
    frame), every chunk arrives prehashed at the boundary, and the ack's
    per-chunk table equals the host oracle over the mirror."""
    from repro_torch.checkpoint.chunking import chunk_digest_np
    from repro_torch.proxy import ProxyRunner, make_program
    from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

    spec = {"name": "train_arch", "arch": "qwen2-0.5b", "smoke": True, "batch": 2,
            "seq": 32, "lr": 3e-4, "total_steps": 6, "device": "cuda"}
    prog = make_program(spec)
    want = prog.on_restore(prog.init_state())
    for s in range(1, 7):
        want, _ = prog.step(want, s)
    cb = 1 << 12
    n_chunks = sum(-(-leaf_bytes(t).nbytes // cb)
                   for t in flatten_with_paths(want)[0].values())
    r = ProxyRunner(spec, chunk_bytes=cb, fused_digests=True, max_restarts=2,
                    op_timeout_s=120.0, sync_timeout_s=120.0)
    r.start()
    try:
        for s in range(1, 4):
            r.step(s)
        infos = [r.sync_state()[1]]
        r.kill()
        for s in range(4, 7):
            r.step(s)
        state, info = r.sync_state()
        infos.append(info)
        assert r.restarts == 1
        assert tree_equal(state, want)
        for i in infos:
            phase = i["phase_us"]
            assert phase["prehashed_chunks"] == n_chunks and phase["digest"] == 0.0
            assert phase["digest_launches"] == phase["steps"] > 0
        host = {p: [chunk_digest_np(raw[i : i + cb]) for i in range(0, raw.nbytes, cb)]
                for p, raw in ((p, leaf_bytes(t))
                               for p, t in flatten_with_paths(state)[0].items())}
        assert info["chunk_digests"] == host
    finally:
        r.close()


def test_shard_windows_digest_on_card_in_one_grouped_launch(cuda):
    """A rank's HostShardView windows are views of the card tensors (off
    the 16-byte grid where a row is 308 bytes): one shadow sync digests
    every owned window in one grouped launch, and the digests and fetched
    bytes equal chunk_digest_np over the window's bytes."""
    from repro_torch.checkpoint.chunking import chunk_digest_np
    from repro_torch.coord.worker import shard_tree_for_host
    from repro_torch.core.shadow import ShadowStateManager
    from repro_torch.utils.tree import flatten_with_paths, leaf_bytes

    g = torch.Generator().manual_seed(3)
    host = {"w": torch.randn(333, 77, generator=g),
            "e": torch.randn(50, 31, generator=g).to(torch.bfloat16),
            "s": torch.tensor(3, dtype=torch.int32), "tiny": torch.randn(2, generator=g)}
    card = {k: v.to(cuda) for k, v in host.items()}
    cb = 1024
    for n in (2, 3):
        for h in range(n):
            view = shard_tree_for_host(card, h, n)
            owned = {p: v for p, v in flatten_with_paths(view)[0].items()
                     if v.data is not None}
            assert all(v.data.device.type == "cuda" for v in owned.values())
            sh = ShadowStateManager(chunk_bytes=cb)
            before = chunk_digest.chunk_digests.launches
            sh.sync(view)
            assert chunk_digest.chunk_digests.launches - before == 1
            snap = sh.snapshot()
            assert {p for p, _ in snap} == set(owned)
            for (p, _), entry in snap.items():
                raw = leaf_bytes(owned[p].data.cpu())
                assert bytes(entry["data"]) == bytes(raw), p
                assert entry["digests"] == [chunk_digest_np(raw[i : i + cb])
                                            for i in range(0, max(raw.nbytes, 1), cb)], p


def test_cluster_on_card_equals_inline(deterministic, tmp_path):
    """Two ranks train torch_tiny on the card, rank 1 killed at step 4 and
    restored from step 2: both finish on the bits of the same program run
    inline on the card, the step-4 image holds them, and every rank makes
    one chunk_digest launch per boundary for its provenance table and one
    per shadow sync but a rank process's first (whose digests the persist
    child backfills), none while it steps."""
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.coord import run_cluster
    from repro_torch.coord.worker import state_digest
    from repro_torch.core.restore import RestoreManager
    from repro_torch.proxy import make_program

    root = str(tmp_path / "cluster")
    report = run_cluster(root=root, n_hosts=2, total_steps=4, ckpt_every=2,
                         backend="fork", loop="torch", device="cuda",
                         chunk_bytes=1 << 12, deadline_s=300.0,
                         kill_host=1, kill_at_step=4)
    assert report.lockstep() and report.restarts[1] == 1
    assert [r.step for r in report.committed] == [2, 4]
    prog = make_program({"name": "torch_tiny", "width": 64, "seed": 0, "device": "cuda"})
    want = prog.on_restore(prog.init_state())
    for s in range(1, 5):
        want, _ = prog.step(want, s)
    assert set(report.final_digests.values()) == {state_digest(want)}
    image, _ = RestoreManager(ChunkStore(root)).restore(
        step=4, device_for=lambda p, s: "cuda:0" if p.startswith("device/") else None)
    assert tree_equal(image["device"], want)
    # rank 0's first sync is at step 2; rank 1's respawn syncs first at 4
    first = {(0, 2), (1, 2), (1, 4)}
    for r, acks in zip(report.committed, report.acks):
        for h, a in acks.items():
            assert a["step_launches"] == {"chunk_digest": 0, "flash_attention": 0}
            assert a["provenance_launches"] == 1
            assert a["sync_launches"] == (0 if (h, r.step) in first else 1), (h, r.step)


@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_managed_space_on_card_matches_cpu(cuda, policy):
    """One seeded sequence of device reads and writes, host loads and
    peeks, prefetches and whole-table evictions through a space whose
    frames live on the card and one whose frames live on the CPU: the same
    bytes, counters, page tables and host backing after every operation —
    the batched H2D/D2H/D2D moves on the card change no decision."""
    from repro_torch.utils.dtypes import byte_view
    from repro_torch.uvm import Advice, ManagedSpace

    rng = np.random.default_rng(7)
    page = 4096
    state = {"w": torch.from_numpy(rng.standard_normal(5 * page // 4 + 3).astype(np.float32)),
             "b": torch.from_numpy(rng.integers(0, 256, 3 * page, dtype=np.uint8))
             .view(torch.bfloat16), "s": torch.tensor(3, dtype=torch.int32)}
    spaces = [ManagedSpace(4 * page, page_bytes=page, eviction_policy=policy,
                           fault_window_pages=3, device=d) for d in (cuda, "cpu")]
    spaces[0].register({k: v.to(cuda) for k, v in state.items()})  # leaves on the card
    spaces[1].register(state)

    def same():
        a, b = spaces
        assert a.stats_dict() == b.stats_dict()
        for path in a.paths():
            ta, tb = a.table(path), b.table(path)
            for name in ("residency", "frame", "wb_dirty", "write_tick",
                         "access_tick", "access_count"):
                assert np.array_equal(getattr(ta, name), getattr(tb, name)), name
            assert np.array_equal(a._regions[path].host, b._regions[path].host)
        a.check_invariants()

    same()
    for _ in range(150):
        path = list(state)[int(rng.integers(len(state)))]
        nbytes = spaces[0]._regions[path].nbytes
        lo = int(rng.integers(0, nbytes + 1))
        hi = int(rng.integers(lo, nbytes + 1))
        kind = rng.choice(["read", "write", "load", "peek", "prefetch", "advise",
                           "evict", "leaf"])
        if kind in ("read", "peek"):
            got = [getattr(sp, f"{kind}_range")(path, lo, hi).cpu() for sp in spaces]
            assert torch.equal(got[0], got[1])
        elif kind in ("write", "load"):
            data = torch.from_numpy(rng.integers(0, 256, hi - lo, dtype=np.uint8))
            for sp in spaces:
                fn = sp.write_range if kind == "write" else sp.load_range
                fn(path, lo, data.to(sp.device))
        elif kind == "prefetch":
            a = int(rng.integers(0, spaces[0].table(path).n_pages))
            assert len({sp.prefetch_pages(path, a, a + 3) for sp in spaces}) == 1
        elif kind == "advise":
            flag = [Advice.NONE, Advice.READ_MOSTLY, Advice.PREFERRED_HOST][
                int(rng.integers(3))]
            for sp in spaces:
                sp.advise(path, flag)
        elif kind == "evict":
            for sp in spaces:
                sp.pager.evict_table(sp.table(path))
        else:
            leaves = [sp.read_leaf(path) for sp in spaces]
            assert leaves[0].device.type == "cuda"  # random bf16 bytes hold NaNs:
            assert torch.equal(byte_view(leaves[0]).cpu(), byte_view(leaves[1]))  # bytes
            for sp, leaf in zip(spaces, leaves):
                sp.write_leaf(path, leaf)
        same()
    assert spaces[0].stats.evictions > 0 and spaces[0].stats.writebacks > 0


def test_daemon_on_card_serves_decode_bitwise(deterministic):
    """A proxy-host daemon on the card serves a full-width, 2-layer
    ``decode_arch`` over the stream transport: its tokens equal the same
    program stepped inline on the card bit for bit, each proxied step
    makes one fused ``chunk_digest`` launch (counted in its session), and
    the final SYNC moves no params chunk."""
    from repro_torch.proxy import ProxyRunner, make_program
    from repro_torch.remote.host import ProxyHostHandle
    from repro_torch.utils.dtypes import leaf_nbytes
    from repro_torch.utils.tree import flatten_with_paths

    P, G = 32, 8
    spec = {"name": "decode_arch", "arch": "qwen2-0.5b", "smoke": False, "batch": 2,
            "prompt_len": P, "gen": G, "num_layers": 2, "device": "cuda"}
    prog = make_program(spec)
    init = prog.init_state()
    state = prog.on_restore(init)
    for n in range(1, P + G):
        state, _ = prog.step(state, n)
    want = state["toks"][:, P:].cpu().numpy()
    clean = sum(leaf_nbytes(t) for p, t in flatten_with_paths(prog.meta_state())[0].items()
                if not p.startswith("params/"))
    d = ProxyHostHandle("card-ph").start()  # device="cuda"
    try:
        r = ProxyRunner(spec, transport="stream", chunk_bytes=1 << 20, fused_digests=True,
                        endpoint_provider=lambda failed=False: d.addr,
                        op_timeout_s=300.0, sync_timeout_s=300.0)
        r.start(device_state=init)
        try:
            for n in range(1, P + G):
                r.step(n)
            got, info = r.sync_state()
        finally:
            r.close()
    finally:
        d.terminate()
    np.testing.assert_array_equal(np.asarray(got["toks"])[:, P:], want)
    assert int(got["cache"]["pos"]) == P + G - 1
    assert info["phase_us"]["digest_launches"] == info["phase_us"]["steps"] == P + G - 1
    assert 0 < info["bytes_synced"] <= clean
