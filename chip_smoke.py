#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--codec none|gzip|pgzip]

Phases, each printing its own lines; any failure raises and exits nonzero
(nothing is caught, nothing falls back):

1. the card: ``nvidia-smi`` name and power limit, device count, and the
   build of every hand-written kernel from the sources in this checkout
   (one ``nvcc`` per source, all started together);
2. the ``chunk_digest`` CUDA kernel against its plain PyTorch version on the
   card over a sweep of dtypes, sizes (empty, 0-d, ``nbytes % 4 != 0``,
   partial last chunks, one leaf over 2**31 bytes) and chunk sizes, and
   against the host oracle ``chunk_digest_np`` on a subset;
   the ``flash_attention`` CUDA kernel against ``flash_attention_plain``
   over the reference test's shapes (causal and not), f32 (the CUDA-core
   route) and bf16/f16 (the tensor-core route), head dims 32/64/128, a
   ``scale`` override, rows with no key (Sq > Sk), a group of 7 with ragged
   tiles and the serve path's own shapes, with a stated tolerance per dtype
   that must catch a dropped key tile (and the reading of a P rounded once
   to bf16, which is why the kernel splits P in two);
3. the training path through ``repro_torch.launch.train``: qwen2-0.5b at full
   width and depth, batch 4, seq 512, 6 steps, a checkpoint every 2 steps
   with the fork persist backend. The codec is ``none`` by default, not the
   CLI's ``pgzip``, on purpose: it measures the card's path and leaves out
   host compression, which at ``pgzip`` compresses 4.94 GB per checkpoint
   on the host and takes most of the time limit (``--codec pgzip`` runs the
   CLI default). Every kernel's launch count is zeroed just before and
   read just after; ``chunk_digest``'s must be > 0;
4. restart: restore step 4 onto the card, run steps 5 and 6, and require
   the state to equal the stored step-6 image bit for bit (that image is
   restored with ``verify``, which re-digests every chunk on the host);
5. the serving path through ``repro_torch.launch.serve``: lazy restore of
   the step-6 params onto the card, prefill of 2 x 8192 tokens (every
   layer's attention is one flash launch on the tensor-core route: 24 per
   prefill, zeroed just before and read just after), 32 greedy tokens; an eager serve must give
   the same bits, and the 32 served logits must lie no further from the
   f32 model's than one bf16 forward over prompt + 31 served tokens (the
   dense lowering) does (teacher forcing);
6. each kernel's time on the card at its path's shapes (``chunk_digest``:
   the 43 leaves of the train state, 1 MiB chunks; ``flash_attention``:
   one layer of the prefill), its bound, the plain version's time and,
   for attention, ``scaled_dot_product_attention``'s (the kernel's ratio to
   it and its share of the bound on the ``[timing] flash`` line), printed as
   one ``{"kernels": [...]}`` JSON line;
7. the last line: ``{"ok": true, "device": {...}}``.

It exits nonzero without a result when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads this when it initialises: set before the first CUDA call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, 32-bit operations outside
# the tensor cores, and dense BF16 tensor-core operations (f32 accumulate)
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
ARCH = "qwen2-0.5b"
STEPS, BATCH, SEQ, LR = 6, 4, 512, 3e-4
SERVE_BATCH, PROMPT, GEN = 2, 8192, 32
# flash kernel vs plain version, (atol, rtol) in |got - want| <= atol +
# rtol |want|: f32 within two sum orders (the reference test's 2e-5); bf16
# and f16 round two f32 values that differ by a sum order to the output's
# type, so one ulp of the output (rtol 2**-7, 2**-10) plus 1e-4 for the sum
# order over up to 8192 keys where the output is near 0
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7),
             torch.float16: (1e-4, 2.0 ** -10)}
# teacher forcing: the served logits (prefill through the kernel, then
# decode) may lie no further from the f32 model's logits than one bf16
# forward (dense lowering) of the same tokens does (PERF.md says why), and
# every position whose top two forward logits lie more than twice the
# served-vs-forward difference apart must pick the same token


def phase_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch={torch.__version__} cuda={torch.version.cuda} "
          f"name={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}", flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import chunk_digest, flash_attention

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source
        libs = list(pool.map(lambda k: k.build(), (chunk_digest, flash_attention)))
    print(f"[build] {' '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def _random_tensor(numel_shape, dtype, gen) -> torch.Tensor:
    numel = math.prod(numel_shape)
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    raw = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    if nbytes == 0:
        return torch.empty(numel_shape, dtype=dtype, device="cuda")
    return raw.view(dtype).reshape(numel_shape)


def _host_digests(x: torch.Tensor, cb: int) -> np.ndarray:
    from repro_torch.checkpoint.chunking import chunk_digest_np, num_chunks
    from repro_torch.utils.tree import leaf_bytes

    raw = leaf_bytes(x)
    out = []
    for i in range(num_chunks(raw.nbytes, cb)):
        d = chunk_digest_np(raw[i * cb : min(raw.nbytes, (i + 1) * cb)])
        out.append([d >> 32, d & 0xFFFFFFFF])
    return np.asarray(out, dtype=np.int64)


def phase_sweep() -> None:
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
              torch.int8, torch.uint8]
    shapes = [(0,), (), (1,), (3,), (7, 5), (1023,), (257, 33), (4096, 257),
              (1 << 20,), ((3 << 20) + 7,)]
    chunks = [64, 4096, 1 << 20, 4 << 20]
    cases = mismatches = host_checked = 0
    for dtype in dtypes:
        for shape in shapes:
            x = _random_tensor(shape, dtype, gen)
            for cb in chunks:
                k = ops.chunk_digests(x, cb)
                p = ref.chunk_digests_plain(x, cb)
                cases += 1
                mismatches += int(not torch.equal(k, p))
                if k.shape[0] <= 2048:
                    host_checked += 1
                    mismatches += int(not np.array_equal(
                        k.cpu().numpy(), _host_digests(x, cb)))
    # one leaf over 2**31 bytes: 64-bit offsets, > 65,535 chunks on grid x
    big = _random_tensor(((1 << 31) + 4099,), torch.int8, gen)
    for cb in (64, 4 << 20):
        k = ops.chunk_digests(big, cb)
        p = ref.chunk_digests_plain(big, cb)
        cases += 1
        mismatches += int(not torch.equal(k, p))
    del big, k, p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[sweep] cases={cases} host_checked={host_checked} "
          f"mismatches={mismatches} (tolerance: exact, integer digests)",
          flush=True)
    if mismatches:
        raise SystemExit(f"chunk_digest: {mismatches} mismatches")


def _flash_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen):
    """q, k contiguous; v the model's view: (B, Sk, Hkv, D) transposed."""
    q = torch.randn((B, Hq, Sq, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Hkv, Sk, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, Hkv, D), generator=gen, device="cuda").to(dtype)
    return q, k, v.transpose(1, 2)


def _plain_block(n: int) -> int:
    """The plain version's block: the largest divisor of n up to 128."""
    return max(b for b in range(1, min(n, 128) + 1) if n % b == 0)


def _plain(q, k, v, *, causal=True, scale=None) -> torch.Tensor:
    from repro_torch.kernels import ref

    return ref.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=_plain_block(q.shape[2]),
                                     block_k=_plain_block(k.shape[2]))


def _tol_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 is a breach."""
    atol, rtol = FLASH_TOL[want.dtype]
    want = want.float()
    return float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())


def _flash_vs_plain(q, k, v, *, causal=True, scale=None):
    """The kernel against the plain version: (max abs error, plain output)."""
    from repro_torch.kernels import flash_attention

    got = flash_attention.flash_attention(q, k, v, causal=causal, scale=scale)
    want = _plain(q, k, v, causal=causal, scale=scale)
    if got.dtype != q.dtype or got.shape != q.shape:
        raise SystemExit(f"flash_attention: got {got.dtype} {tuple(got.shape)}")
    atol, rtol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    Sq, Sk = q.shape[2], k.shape[2]
    if causal and Sq > Sk:  # rows with no key: the mean of v over all Sk
        mean = v.float().mean(dim=2).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
        torch.testing.assert_close(
            got[:, :, : Sq - Sk].float(),
            mean[:, :, None].expand(-1, -1, Sq - Sk, -1), atol=atol, rtol=rtol)
    return float((got.float() - want.float()).abs().max()), want


def _plain_p_rounded_once(q, k, v) -> torch.Tensor:
    """The plain version (causal, 128 x 128 blocks) with P rounded once to
    q's dtype before P V: what a kernel that skips the P_hi + P_lo split
    computes, up to the sum order. l stays the sum of the f32 P."""
    masked = -1e30  # the plain version's masked logit
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    for q0 in range(0, S, 128):
        qi = q[:, :, q0 : q0 + 128].float()
        acc = torch.zeros((B, Hq, 128, D), device=q.device)
        m = torch.full((B, Hq, 128, 1), masked, device=q.device)
        l = torch.zeros((B, Hq, 128, 1), device=q.device)
        for k0 in range(0, q0 + 128, 128):
            kj = k[:, :, k0 : k0 + 128].float().repeat_interleave(g, dim=1)
            vj = v[:, :, k0 : k0 + 128].float().repeat_interleave(g, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qi, kj) * scale
            rows = torch.arange(q0, q0 + 128, device=q.device)[:, None]
            cols = torch.arange(k0, k0 + 128, device=q.device)[None, :]
            s = torch.where(cols <= rows, s, masked)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pr = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pr.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", pr.to(q.dtype).float(), vj)
            m = m_new
        out[:, :, q0 : q0 + 128] = (acc / l).to(q.dtype)
    return out


def phase_flash_sweep() -> None:
    from repro_torch.kernels import flash_attention

    by_route = flash_attention.flash_attention.launches_by_route
    before = dict(by_route)
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [  # (B, Hq, Hkv, Sq, Sk, D)
        (1, 1, 1, 128, 128, 64), (2, 4, 2, 256, 256, 64), (1, 8, 1, 128, 128, 128),
        (1, 4, 4, 128, 512, 64), (2, 2, 2, 384, 384, 32),   # the reference test's
        (1, 2, 1, 256, 128, 64),                            # Sq > Sk: rows with no key
        (1, 14, 2, 200, 200, 64), (1, 14, 2, 120, 200, 64),  # group of 7, ragged tiles
    ]
    worst = {}
    cases = 0
    for dtype in FLASH_TOL:
        for shape in shapes:
            for causal in (True, False):
                err, _ = _flash_vs_plain(*_flash_inputs(*shape, dtype, gen), causal=causal)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                cases += 1
        err, _ = _flash_vs_plain(*_flash_inputs(1, 1, 1, 128, 128, 64, dtype, gen),
                                 scale=0.5)
        worst[dtype] = max(worst[dtype], err)
        cases += 1
    # the serve path's prefill, one layer: qwen2-0.5b heads at 8192 tokens
    q, k, v = _flash_inputs(SERVE_BATCH, 14, 2, PROMPT, PROMPT, 64, torch.bfloat16, gen)
    serve, want = _flash_vs_plain(q, k, v)
    cases += 1
    # why the kernel splits P in two: what one rounding of P would read
    once_ratio = _tol_ratio(_plain_p_rounded_once(q, k, v), want)
    # what the tolerance reads for a wrong kernel: the last 128 rows (the
    # longest, where one key tile weighs least) with their first key tile
    # dropped; the right-aligned mask keeps every other key of those rows
    T = 128
    want = want[:, :, -T:]
    dropped = _plain(q[:, :, -T:], k[:, :, T:], v[:, :, T:])
    drop_err = float((dropped.float() - want.float()).abs().max())
    drop_ratio = _tol_ratio(dropped, want)
    del q, k, v, want, dropped
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    routes = {r: n - before[r] for r, n in by_route.items()}
    print(f"[flash-sweep] cases={cases} routes={routes} " + " ".join(
        f"{str(d).replace('torch.', '')}_max_abs_err={e:.3g} (atol {FLASH_TOL[d][0]:g} "
        f"rtol {FLASH_TOL[d][1]:g})" for d, e in worst.items())
        + f" serve_shape_max_abs_err={serve:.3g}: within tolerance; one key tile "
        f"dropped reads max_abs_err={drop_err:.3g}, {drop_ratio:.3g}x the limit; "
        f"one rounding of P (no split) reads {once_ratio:.3g}x it", flush=True)
    if drop_ratio <= 1:
        raise SystemExit("the bf16 tolerance does not see a dropped key tile")


def _zero_counts() -> None:
    from repro_torch.kernels import chunk_digest, flash_attention

    chunk_digest.chunk_digests.launches = 0
    flash_attention.flash_attention.launches = 0
    for route in flash_attention.flash_attention.launches_by_route:
        flash_attention.flash_attention.launches_by_route[route] = 0


def _counts() -> dict:
    from repro_torch.kernels import chunk_digest, flash_attention

    return {"chunk_digest": chunk_digest.chunk_digests.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "flash_attention_by_route": dict(flash_attention.flash_attention.launches_by_route)}


def phase_main_path(store: str, codec: str):
    from repro_torch.launch import train

    argv = ["--arch", ARCH, "--steps", str(STEPS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--lr", str(LR), "--ckpt-every", "2", "--backend", "fork",
            "--codec", codec, "--log-every", "1", "--ckpt-dir", store]
    _zero_counts()
    t0 = time.perf_counter()
    out = train.train(argv)
    wall = time.perf_counter() - t0
    counts = _counts()
    launches = counts["chunk_digest"]
    for r in out["results"]:
        print(f"[ckpt] step={r.step} blocking_ms={r.blocking_s * 1e3:.1f} "
              f"persist_ms={r.persist_s * 1e3:.1f} digest_ms="
              f"{r.digest_us / 1e3:.1f} synced={r.chunks_synced} "
              f"written={r.chunks_written} reused={r.chunks_reused}")
    m = out["metrics"]
    print(f"[main] arch={ARCH} codec={codec} steps={out['final_step']} wall_s={wall:.1f} "
          f"loss={m['loss']:.4f} grad_norm={m['grad_norm']:.4f} "
          f"chunk_digest_launches={launches} "
          f"flash_attention_launches={counts['flash_attention']}", flush=True)
    if out["final_step"] != STEPS or not all(map(math.isfinite, m.values())):
        raise SystemExit(f"main path did not finish cleanly: {out['final_step']} {m}")
    if launches <= 0:
        raise SystemExit("main path never launched the chunk_digest kernel")
    return out["state"], launches


def phase_restart(store: str, final_state) -> dict:
    from repro_torch.checkpoint import ChunkStore
    from repro_torch.configs import get_config
    from repro_torch.core import RestoreManager
    from repro_torch.data import SyntheticBatches
    from repro_torch.launch.train import build_training
    from repro_torch.runtime.steps import batch_to_device
    from repro_torch.utils.tree import tree_equal

    cfg = get_config(ARCH)
    run = build_training(cfg, batch=BATCH, seq=SEQ, lr=LR,
                         total_steps=STEPS, device=torch.device("cuda"))
    rm = RestoreManager(ChunkStore(store))
    t0 = time.perf_counter()
    s6, _ = rm.restore(step=6, device_for=run.device_for, verify=True)
    t_restore = time.perf_counter() - t0
    if not tree_equal(final_state, s6):
        raise SystemExit("stored step-6 image differs from the trained state")
    del final_state
    state, _ = rm.restore(step=4, device_for=run.device_for)
    data = SyntheticBatches.from_state(cfg, batch=BATCH, seq_len=SEQ,
                                       state=state["host"]["data"])
    for step in (5, 6):
        state["device"], _ = run.step_fn(state["device"],
                                         batch_to_device(next(data), "cuda"))
        state["host"]["step"] = np.int64(step)
        state["host"]["data"] = data.state()
    torch.cuda.synchronize()
    same = tree_equal(state, s6)
    print(f"[restart] restored step 4, ran 5..6: bitwise_equal={same} "
          f"restore_verify_s={t_restore:.1f}", flush=True)
    if not same:
        raise SystemExit("restart diverged from the step-6 image")
    return s6["device"]


def _served_position_logits(cfg, params, seq: torch.Tensor) -> torch.Tensor:
    """The model's forward over ``seq``; f32 logits only at the positions
    whose next token was served (full-vocab logits everywhere would add
    10 GB)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import logits_from_embed

    with torch.device("meta"):
        module = tfm.Transformer(cfg)
    with torch.no_grad():
        h = torch.func.functional_call(module, tfm.module_params(params), (seq,))
        return logits_from_embed(tfm.lm_table(cfg, params), h[:, PROMPT - 1 :])


def phase_serve(store: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.utils.tree import flatten_with_paths, unflatten_from_paths

    cfg = get_config(ARCH)
    argv = ["--arch", ARCH, "--ckpt-dir", store, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN)]
    _zero_counts()
    out = serve.serve(argv + ["--lazy"])
    counts = _counts()
    launches = counts["flash_attention"]
    print(f"[serve] lazy restore_s={out['restore_s']:.3f} ttft_s={out['ttft_s']:.3f} "
          f"decode_tok_s={out['decode_tok_s']:.1f} step={out['step']} "
          f"flash_attention_launches={launches} "
          f"by_route={counts['flash_attention_by_route']} "
          f"chunk_digest_launches={counts['chunk_digest']}", flush=True)
    if out["step"] != STEPS:
        raise SystemExit(f"serve restored step {out['step']}, not {STEPS}")
    if launches != cfg.num_layers:
        raise SystemExit(f"prefill made {launches} flash launches, not one per "
                         f"layer ({cfg.num_layers})")
    if counts["flash_attention_by_route"]["wgmma"] != launches:
        raise SystemExit(f"prefill launches did not all take the tensor-core route: "
                         f"{counts['flash_attention_by_route']}")
    logits = out["logits"]
    if logits.shape != (SERVE_BATCH, GEN, cfg.vocab_size) or not bool(
            logits.isfinite().all()):
        raise SystemExit(f"served logits: {tuple(logits.shape)}, finite="
                         f"{bool(logits.isfinite().all())}")

    eager = serve.serve(argv)  # same image, eager restore: the same bits
    same = bool(np.array_equal(eager["tokens"], out["tokens"])
                and torch.equal(eager["logits"], logits))
    print(f"[serve] eager restore_s={eager['restore_s']:.3f} "
          f"ttft_s={eager['ttft_s']:.3f} decode_tok_s={eager['decode_tok_s']:.1f} "
          f"bitwise_equal_to_lazy={same}", flush=True)
    if not same:
        raise SystemExit("eager and lazy serving disagree")
    del eager

    # teacher forcing: one forward over the prompt and the first GEN - 1
    # served tokens, in the bf16 model and in its f32 upcast
    seq = torch.cat([out["prompt"], torch.from_numpy(out["tokens"][:, :-1]).to(
        out["prompt"].device, torch.int32)], dim=1)
    params = out["params"]
    want = _served_position_logits(cfg, params, seq)
    flat, treedef = flatten_with_paths(params)
    truth = _served_position_logits(
        cfg, unflatten_from_paths(treedef, {p: t.float() for p, t in flat.items()}), seq)
    err = float((logits - want).abs().max())
    # the served path must be at least as accurate as the dense forward:
    # no further from the f32 model's logits than the bf16 forward is
    tol = float((want - truth).abs().max())
    served_vs_f32 = float((logits - truth).abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = torch.from_numpy(out["tokens"]).to(want.device) == want.argmax(dim=-1)
    print(f"[serve] teacher_forced seq={seq.shape[1]} served_vs_f32={served_vs_f32:.4g} "
          f"(tol {tol:.4g} = dense-vs-f32) served_vs_dense={err:.4g} "
          f"max_abs_logit={float(want.abs().max()):.4g} "
          f"greedy_agree={int(agree.sum())}/{agree.numel()} "
          f"decided_agree={int((agree & decided).sum())}/{int(decided.sum())}",
          flush=True)
    if not served_vs_f32 <= tol or not bool(agree[decided].all()):
        raise SystemExit("served logits disagree with the teacher-forced forward")
    del want, truth
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"launches": launches}


def _time_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(device_state, main_launches: int) -> dict:
    from repro_torch.kernels import chunk_digest, ref
    from repro_torch.utils.tree import flatten_with_paths

    leaves = [t for t in flatten_with_paths(device_state)[0].values()
              if isinstance(t, torch.Tensor)]
    cb = 1 << 20  # the CLI's chunk size
    kernel = chunk_digest.chunk_digests

    def kernel_pass():
        return [kernel(t, cb) for t in leaves]

    def plain_pass():
        return [ref.chunk_digests_plain(t, cb) for t in leaves]

    before = kernel.launches
    got = kernel_pass()  # warm-up, and the comparison
    per_sync = kernel.launches - before
    want = plain_pass()
    err = max(int((a - b).abs().max()) for a, b in zip(got, want))
    del got, want
    ms = _time_ms(kernel_pass, 20)
    plain_ms = _time_ms(plain_pass, 2)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    words = sum(-(-t.numel() * t.element_size() // 4) for t in leaves)
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = words * 6 / OPS_PER_S * 1e3  # xor, mul, add per mix
    row = {
        "name": "chunk_digest", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunk_digest.cu",
        "replaces": "src/repro/kernels/chunk_digest.py:38",
        "launches": main_launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    print(f"[timing] leaves={len(leaves)} bytes={nbytes} launches_per_sync="
          f"{per_sync} kernel_ms={ms:.3f} plain_ms={plain_ms:.1f} "
          f"bound_ms={row['bound_ms']:.3f} GB/s={nbytes / ms / 1e6:.0f} "
          f"max_abs_err={err} (tolerance: exact)",
          flush=True)
    if err:
        raise SystemExit(f"chunk_digest disagrees with plain at main-path shapes: {err}")
    return row


def phase_flash_timing(serve_launches: int) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    B, Hq, Hkv, S, D = SERVE_BATCH, 14, 2, PROMPT, 64  # one prefill layer
    q, k, v = _flash_inputs(B, Hq, Hkv, S, S, D, torch.bfloat16,
                            torch.Generator(device="cuda").manual_seed(2))
    kernel = flash_attention.flash_attention
    got = kernel(q, k, v)  # warm-up, and the comparison
    want = ref.flash_attention_plain(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    ratio = _tol_ratio(got, want)
    del got, want
    ms = _time_ms(lambda: kernel(q, k, v), 10)
    plain_ms = _time_ms(lambda: ref.flash_attention_plain(q, k, v), 2)
    # the library's fused attention at Sq == Sk, where its top-left causal
    # mask is the right-aligned one, on the same values with v contiguous
    # (on the model's transposed view it leaves its fused path); timed
    # only, never on the path
    vc = v.contiguous()

    def library():
        return F.scaled_dot_product_attention(q, k, vc, is_causal=True, enable_gqa=True)

    # timed with this run's deterministic algorithms (its pick then) and
    # without them, where it may pick a faster backend; the faster is the
    # yardstick
    library()  # warm-up: its first call picks and loads a backend
    library_det_ms = _time_ms(library, 10)
    torch.use_deterministic_algorithms(False)
    library()
    library_free_ms = _time_ms(library, 10)
    torch.use_deterministic_algorithms(True)
    library_ms = min(library_det_ms, library_free_ms)
    del vc
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))  # out = q's
    flops = 4 * B * Hq * D * S * (S + 1) / 2  # q.k and p.v over causal pairs
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_TC_OPS_PER_S * 1e3
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": serve_launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    print(f"[timing] flash q={tuple(q.shape)} k=v={tuple(k.shape)} bf16 causal "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.1f} library_ms={library_ms:.4f} "
          f"(deterministic {library_det_ms:.4f}, not {library_free_ms:.4f}) "
          f"kernel/library={ms / library_ms:.3f} bound_ms={row['bound_ms']:.4f} "
          f"bound/kernel={row['bound_ms'] / ms:.3f} TFLOP/s={flops / ms / 1e9:.1f} "
          f"max_abs_err={err:.3g} ({ratio:.3g}x the bf16 limit)", flush=True)
    if not ratio <= 1:
        raise SystemExit(f"flash_attention disagrees with plain at serve shapes: {err}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--codec", default="none",
                    help="checkpoint codec of the main path (default: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import repro_torch.kernels  # noqa: F401  (fails first outside a checkout)

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_sweep()
    phase_flash_sweep()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        store = os.path.join(tmp, "ckpt")
        final_state, launches = phase_main_path(store, args.codec)
        device_state = phase_restart(store, final_state)
        del final_state
        served = phase_serve(store)
    rows = [phase_timing(device_state, launches)]
    del device_state
    rows.append(phase_flash_timing(served["launches"]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
