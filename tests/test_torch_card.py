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
